"""Prefix-affinity index: token-block fingerprints → owning replica; the
port of ``repro.fleet.affinity``.

The KV-aware routing signal: a replica that already served a prompt
prefix holds that prefix's KV pages, so sending the continuation (a
multi-turn follow-up, a shared system prompt, a few-shot header) to the
same replica keeps the pages hot.  The payload is both *locality* (warm
pages, warm kernel and library state) and **physical page reuse**: the
engine-side prefix radix (``serving/prefix/``) keys shared copy-on-write
KV pages by these same chained block fingerprints, so an affinity-routed
continuation attaches to the resident prefix pages instead of
re-prefilling them, and the router's least-pages score charges only the
replica's *marginal* (post-sharing) pages.

Fingerprints are **chained** blake2b digests per ``block`` tokens: the
fingerprint of blocks ``[0..k]`` hashes the fingerprint state of
``[0..k-1]`` plus block ``k``'s token bytes.  Chaining means a prompt's
fingerprint list is a prefix of every extension's list, and a lookup
miss at block ``k`` implies a miss for every longer prefix — lookups
stop at the first unknown block.

The index is a plain LRU ``OrderedDict`` and is **not** thread-safe on
its own; ``FleetRouter`` guards it with the router lock.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

DEFAULT_BLOCK = 16          # tokens per fingerprint block (= KV page size)
_DIGEST_BYTES = 8


def prefix_fingerprints(tokens, block: int = DEFAULT_BLOCK) -> List[str]:
    """Chained per-block fingerprints of a token sequence.

    Returns one hex digest per *complete* block — a 40-token prompt with
    ``block=16`` yields 2 fingerprints; the 8-token tail is not indexed
    (it is not a stable sharing unit).
    """
    toks = np.asarray(tokens, dtype=np.int32)
    if toks.ndim != 1:
        toks = toks.reshape(-1)
    h = hashlib.blake2b(digest_size=_DIGEST_BYTES)
    out: List[str] = []
    for start in range(0, (toks.size // block) * block, block):
        h.update(toks[start:start + block].tobytes())
        out.append(h.copy().hexdigest())
    return out


class PrefixAffinityIndex:
    """LRU map from chained block fingerprints to a replica key."""

    def __init__(self, block: int = DEFAULT_BLOCK, capacity: int = 4096):
        if block < 1:
            raise ValueError("block must be >= 1")
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.block = block
        self.capacity = capacity
        self._map: "OrderedDict[str, str]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._map)

    def record(self, tokens, replica: str) -> int:
        """Claim every complete block of ``tokens`` for ``replica``.

        Later claims win (the replica that served the prompt most
        recently holds the freshest pages).  Returns the number of
        blocks recorded.
        """
        fps = prefix_fingerprints(tokens, self.block)
        for fp in fps:
            self._map[fp] = replica
            self._map.move_to_end(fp)
        while len(self._map) > self.capacity:
            self._map.popitem(last=False)
        return len(fps)

    def lookup(self, tokens) -> Tuple[Optional[str], int]:
        """Longest-prefix match: ``(replica, matched_blocks)``.

        Returns ``(None, 0)`` when not even the first block is known.
        Chaining lets the scan stop at the first miss.
        """
        best: Optional[str] = None
        blocks = 0
        for i, fp in enumerate(prefix_fingerprints(tokens, self.block)):
            owner = self._map.get(fp)
            if owner is None:
                break
            best, blocks = owner, i + 1
            self._map.move_to_end(fp)
        return best, blocks

    def drop_replica(self, replica: str) -> int:
        """Invalidate every fingerprint owned by a lost replica."""
        dead = [fp for fp, owner in self._map.items() if owner == replica]
        for fp in dead:
            del self._map[fp]
        return len(dead)
