"""What each kernel call costs, from its shapes, and the hook through
which a counting mode sees it (``roofline.analysis.count``).

A kernel is not an aten op: launched through ``ctypes`` on the card it is
invisible to a ``TorchDispatchMode``, and on ``meta`` or the CPU its plain
version runs as many aten ops (with T² scores the kernel never writes).
So each entry point (``kernels/ops.py`` and the autograd function of
flash attention) runs its call through ``region`` with the FLOPs and the
HBM bytes of the work the kernel does, and a counting mode that wants the
kernels' cost (``attn_impl="kernel"``) counts those numbers in place of
whatever ran inside; the same call counts the same whether the card's
kernel or the plain version ran.  Outside a counting mode ``region`` is a
plain call.

The formulas count from shapes alone, so that a step on ``meta`` and the
same step on the card count alike (a meta tensor has no values):
- attention FLOPs are 2·(D + Dv) a visible (query, key) pair a query head
  (q·kᵀ and p·v), the backward 8·D + 6·Dv (its dq kernel recomputes q·kᵀ
  and p's gradient, dk/dv both again); a pair is visible under the causal
  mask and the window with queries at the last ``Tq`` of ``Tk`` positions
  (the train and prefill layout), and a dense decode sees every key of its
  cache (a dry-run's caches are full), a paged one every key of its
  table's span;
- the SSD scan's FLOPs are its chunk products, 2·Q²·(N + P) + 4·Q·N·P a
  chunk of Q a head; RMSNorm is elementwise, 0 FLOPs (as
  ``torch.utils.flop_counter`` counts elementwise ops);
- bytes are every input read once and every output written once.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

# the counting mode in force (``roofline.analysis``), or None
_counter = None


def region(name: str, flops: float, nbytes: float, run: Callable,
           inputs=()):
    """``run()``, seen by the counting mode in force as one call of kernel
    ``name`` doing ``flops`` and moving ``nbytes`` over ``inputs``."""
    c = _counter
    if c is None:
        return run()
    return c.kernel_call(name, float(flops), float(nbytes), run, inputs)


def _nb(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def visible_pairs(Tq: int, Tk: int, causal: bool, window: int) -> int:
    """(query, key) pairs a head computes: query i at position Tk − Tq + i
    sees keys at positions ≤ its own (causal) and within ``window``."""
    if not causal:
        return Tq * Tk if window <= 0 else Tq * min(Tk, window)
    # query i sees clamp(Tk − Tq + i + 1, 0, W) keys (W = Tk without a
    # window): from the first query that sees one, a run rising by one a
    # query up to W, then W each
    W = Tk if window <= 0 else window
    i0 = max(0, Tq - Tk)
    n, first = Tq - i0, Tk - Tq + i0 + 1
    n_lin = max(0, min(n, W - first + 1))
    return n_lin * first + n_lin * (n_lin - 1) // 2 + (n - n_lin) * W


def flash_fwd(q, k, v, causal, window, lse: bool, index=()):
    B, Tq, Hq, D = q.shape
    Tk, Dv = k.shape[1], v.shape[-1]
    pairs = visible_pairs(Tq, Tk, causal, window)
    out = B * Tq * Hq * Dv * q.element_size()
    return (2.0 * B * Hq * pairs * (D + Dv),
            _nb(q, k, v, *index) + out + (B * Tq * Hq * 4 if lse else 0))


def flash_bwd(q, k, v, out, lse, do, causal, window, index=()):
    B, Tq, Hq, D = q.shape
    Tk, Dv = k.shape[1], v.shape[-1]
    pairs = visible_pairs(Tq, Tk, causal, window)
    return (float(B * Hq * pairs * (8 * D + 6 * Dv)),
            _nb(q, k, v, out, lse, do, *index) + _nb(q, k, v))


def dense_decode(q, k_cache, v_cache, cache_len, lse: bool):
    B, Hq, D = q.shape
    S, Dv = k_cache.shape[1], v_cache.shape[-1]
    out = B * Hq * Dv * q.element_size()
    return (2.0 * B * Hq * S * (D + Dv),
            _nb(q, k_cache, v_cache, cache_len) + out
            + (B * Hq * 4 if lse else 0))


def paged(q, k_pages, v_pages, page_table, cache_len,
          k_scale: Optional[torch.Tensor] = None, v_scale=None):
    """A paged decode (q [B,Hq,D]) or verify (q [B,K1,Hq,D]) pass over
    its table's span of keys."""
    B, MP = page_table.shape
    page, Hkv = k_pages.shape[1], k_pages.shape[2]
    D, Dv = k_pages.shape[-1], v_pages.shape[-1]
    rows = q.numel() // D                  # B·K1·Hq
    keys = MP * page
    kv = B * keys * Hkv * (D + Dv) * k_pages.element_size()
    if k_scale is not None:
        kv += 2 * B * keys * Hkv * 4
    out = rows * Dv * q.element_size()
    return (2.0 * rows * keys * (D + Dv),
            _nb(q, page_table, cache_len) + kv + out)


def ssd_scan(x, dt, A, B_, C, chunk: int, initial_state, final: bool):
    Bb, T, H, P = x.shape
    N = B_.shape[-1]
    n_chunks = -(-T // chunk)
    per = 2 * chunk * chunk * (N + P) + 4 * chunk * N * P
    state = Bb * H * P * N * 4
    return (float(Bb * n_chunks * H * per),
            _nb(x, dt, A, B_, C, initial_state) + _nb(x)
            + (state if final else 0))


def rmsnorm(x, scale, ms=None):
    return 0.0, _nb(x, scale, ms) + _nb(x)
