"""Draft-model speculator for speculative decoding: the port of
``repro.serving.spec_decode``.

A small draft model (same vocabulary, far fewer layers) proposes ``k``
tokens per decoding slot; the target scores all ``k+1`` positions in one
paged verify pass and commits the accepted prefix plus its own correction
token.  Greedy output equals non-speculative greedy output for any draft:
the draft changes throughput, never content.

``DraftSpeculator`` owns the draft side: a dense ``SlotKVCache`` whose
slot ids mirror the engine's paged slots, a bucketed whole-prompt prefill,
and ``propose``, a Python loop of ``k+1`` draft decode steps (the JAX
package scans them under one jit).

Sync invariant (per slot): draft ``cache_len`` == target ``cache_len`` C,
and draft positions ``0..C-1`` hold the tokens the target has cached; the
pending last token L (KV unwritten) is the engine's ``last_tokens``.
``propose`` feeds L, d1..dk — k+1 steps, so the last draft token's KV is
written too (position C+k) and a fully accepted round leaves the draft
cache complete.  After the verify the engine calls ``observe`` with its
post-commit lengths: the draft winds back to ``C+1+a``.  Positions ``<=
C+a`` already hold the accepted tokens, so the rewind is a length update;
the rejected suffix beyond it is masked garbage the next round overwrites.

The speculator has no lock: the engine calls it under its own lock.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model, cast_params, to_device
from repro_torch.serving.kv_cache import SlotKVCache

_MIN_BUCKET = 16        # smallest draft prefill bucket, as in the JAX package


def _bucket(n: int, lo: int, hi: int) -> int:
    b = lo
    while b < n and b < hi:
        b *= 2
    return min(b, hi)


class DraftSpeculator:
    """Draft model + dense slot KV mirroring the engine's slots."""

    def __init__(self, cfg: ModelConfig, max_slots: int, max_seq: int,
                 params: Optional[Dict] = None, seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.device = resolve_device(device)
        self.model = build_model(cfg, self.device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen)
        self.params = to_device(params, self.device)
        self._run_params = cast_params(self.params, cfg.cdtype)
        self.kv = SlotKVCache(cfg, max_slots, max_seq, dtype=cfg.cdtype,
                              device=self.device)

    def prefill(self, prompt: Sequence[int], slot: int) -> None:
        """Prefill the whole prompt (right-padded to a pow2 bucket) into a
        fresh batch-1 cache and copy it into ``slot``.  The draft has no
        prefix sharing, so a shared-prefix hit on the target still pays a
        full draft prefill, bounded by the draft being small."""
        plen = len(prompt)
        bucket = _bucket(plen, _MIN_BUCKET, self.max_seq)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :plen] = np.asarray(prompt)
        caches = self.model.init_caches(1, self.max_seq, self.cfg.cdtype)
        with torch.no_grad():
            self.model.prefill(
                self._run_params,
                {"tokens": torch.as_tensor(toks, device=self.device)},
                caches, last_index=torch.tensor([plen - 1],
                                                device=self.device))
        self.kv.insert(caches, slot, plen)

    def propose(self, last_tokens: torch.Tensor, active: torch.Tensor,
                k: int) -> torch.Tensor:
        """k greedy draft tokens per active slot → drafts [B, k].  Step i
        feeds token i and writes its KV at ``cache_len + i``; the extra
        (k+1)-th step writes d_k's KV.  Inactive rows rewrite their pending
        position in place and never advance."""
        toks, clen = last_tokens, self.kv.cache_len
        outs = []
        with torch.no_grad():
            for _ in range(k + 1):
                logits = self.model.decode(self._run_params, toks,
                                           self.kv.caches, clen)
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)
                toks = torch.where(active, nxt, toks)
                clen = torch.where(active, clen + 1, clen)
                outs.append(toks)
        self.kv.cache_len = clen
        return torch.stack(outs[:k], dim=1)      # drop the throwaway step

    def observe(self, new_len: torch.Tensor, active: torch.Tensor) -> None:
        """Adopt the target's post-commit lengths (rewind past rejects)."""
        self.kv.cache_len = torch.where(active, new_len, self.kv.cache_len)
