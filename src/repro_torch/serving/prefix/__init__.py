"""Prefix-sharing layer over ``PagedKVCache``: radix index + COW pages."""
from repro_torch.serving.prefix.radix import (MatchResult, PrefixNode,
                                              PrefixRadixIndex)

__all__ = ["MatchResult", "PrefixNode", "PrefixRadixIndex"]
