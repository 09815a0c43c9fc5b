"""Paged multi-token verify attention as a hand-written CUDA kernel.

Replaces ``repro.kernels.paged_verify_attention.paged_verify_attention``
(the Pallas TPU kernel).  The kernel is the paged decode kernel's
(``csrc/paged_attention.cuh``), instantiated by
``csrc/paged_verify_attention.cu`` for all ``K1·G`` query rows of a KV
head, in row groups of up to 64 (32 at D 192 and 256) past that, so it
takes any K1 whose row groups fit the grid; its header says what bounds
it on the card and how it is laid out.
This wrapper checks the inputs, allocates the output with ``torch.empty``,
launches on PyTorch's current stream and counts the launch.  The plain
version is ``kernels.ref.paged_verify_attention``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import _aligned, _ptr, refuse_grad
from repro_torch.kernels.paged_decode_attention import _Q_CODE, pool_args

MAX_GRID_Y = 65535      # the grid's y: KV heads times row groups
_fn = None


def row_groups(K1: int, G: int, D: int) -> int:
    """The row groups the kernel splits a (sequence, KV head)'s ``K1·G``
    query rows over: blocks of up to 64 rows, 32 at D 192 and 256
    (``by_rows`` in ``csrc/paged_attention.cuh``)."""
    rows = 64 if D <= 128 else 32
    return -(-K1 * G // rows)


def _entry():
    global _fn
    if _fn is None:
        f = build.load("paged_verify_attention").paged_verify_attention_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i,
                      ctypes.c_float, ctypes.c_float, p]
        f.restype = i
        _fn = f
    return _fn


def paged_verify_attention(
    q: torch.Tensor,                  # [B, K1, Hq, D] the K1 newest tokens
    k_pages: torch.Tensor,            # [P, page, Hkv, D]
    v_pages: torch.Tensor,            # [P, page, Hkv, D]
    page_table: torch.Tensor,         # [B, MP] int32
    cache_len: torch.Tensor,          # [B] valid tokens (incl. all K1 new ones)
    *,
    softcap: float = 0.0,
    window: int = 0,
    sm_scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,   # [P, page, Hkv] f32 (int8)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors (raises on anything else).
    Pools are in the dtype of ``q``, or int8 with both scale planes; K1 is
    any count from 1 whose row groups times the KV heads stay within
    ``MAX_GRID_Y``.  Forward-only: raises under grad mode for an input
    that needs one."""
    refuse_grad("paged_verify_attention", q, k_pages, v_pages, k_scale,
                v_scale)
    if q.dim() != 4:
        raise ValueError(f"q must be [B, K1, Hq, D], got {tuple(q.shape)}")
    B, K1, Hq, D = q.shape
    if K1 < 1:
        raise ValueError(f"K1={K1} query tokens: the verify kernel takes "
                         f"at least 1")
    a = pool_args("paged_verify_attention", q, k_pages, v_pages, page_table,
                  cache_len, k_scale, v_scale)
    if a.Hkv * row_groups(K1, Hq // a.Hkv, D) > MAX_GRID_Y:
        raise ValueError(f"K1={K1} at G {Hq // a.Hkv}: "
                         f"{row_groups(K1, Hq // a.Hkv, D)} row groups of "
                         f"{a.Hkv} KV heads pass the grid's limit of "
                         f"{MAX_GRID_Y} blocks")
    q = _aligned(q)
    out = torch.empty((B, K1, Hq, D), dtype=q.dtype, device=q.device)
    scale = sm_scale if sm_scale is not None else D ** -0.5
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(_ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(a.k_scale),
                   _ptr(a.v_scale), _ptr(out), _ptr(a.table), _ptr(a.clen),
                   B, K1, Hq, a.Hkv, D, a.page, a.MP, _Q_CODE[q.dtype],
                   a.kv_code, int(window), float(softcap), float(scale),
                   ctypes.c_void_p(stream))
    if err != 0:
        raise build.KernelError(f"paged_verify_attention kernel launch "
                                f"failed: CUDA error {err}")
    build.count_launch(paged_verify_attention)
    return out


paged_verify_attention.launches = 0
