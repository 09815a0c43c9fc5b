"""Chained prefix fingerprints, copied from ``repro.fleet.affinity``.

Only ``prefix_fingerprints`` is ported so far: the prefix radix keys its
shared pages by these digests.  The affinity index and the fleet router
come with ROADMAP Queue A item 10.

Fingerprints are **chained** blake2b digests per ``block`` tokens: the
fingerprint of blocks ``[0..k]`` hashes the state of ``[0..k-1]`` plus
block ``k``'s token bytes, so a prompt's fingerprint list is a prefix of
every extension's list.
"""
from __future__ import annotations

import hashlib
from typing import List

import numpy as np

DEFAULT_BLOCK = 16          # tokens per fingerprint block (= KV page size)
_DIGEST_BYTES = 8


def prefix_fingerprints(tokens, block: int = DEFAULT_BLOCK) -> List[str]:
    """One hex digest per *complete* ``block``-token block of ``tokens``."""
    toks = np.asarray(tokens, dtype=np.int32)
    if toks.ndim != 1:
        toks = toks.reshape(-1)
    h = hashlib.blake2b(digest_size=_DIGEST_BYTES)
    out: List[str] = []
    for start in range(0, (toks.size // block) * block, block):
        h.update(toks[start:start + block].tobytes())
        out.append(h.copy().hexdigest())
    return out
