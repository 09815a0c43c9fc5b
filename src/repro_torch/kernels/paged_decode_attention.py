"""Paged single-token decode attention as a hand-written CUDA kernel.

Replaces ``repro.kernels.paged_decode_attention.paged_decode_attention``
(the Pallas TPU kernel).  The kernel lives in
``csrc/paged_attention.cuh``, instantiated by
``csrc/paged_decode_attention.cu``; its header says what bounds it on the
card and how it is laid out.  This wrapper checks the inputs, allocates
the output with ``torch.empty``, launches on PyTorch's current stream and
counts the launch.  The kernel shares each sequence's keys over a cluster
of blocks and combines their partials in the same launch, through
distributed shared memory: no workspace.  The plain version is
``kernels.ref.paged_decode_attention``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (HEAD_DIMS, _aligned, _int32,
                                                 _ptr, refuse_grad)

_Q_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _entry():
    global _fn
    if _fn is None:
        f = build.load("paged_decode_attention").paged_decode_attention_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                      ctypes.c_float, ctypes.c_float, p]
        f.restype = i
        _fn = f
    return _fn


class PoolArgs(NamedTuple):
    table: torch.Tensor               # [B, MP] int32
    clen: torch.Tensor                # [B] int32
    k_scale: Optional[torch.Tensor]   # [P, page, Hkv] f32, int8 pools only
    v_scale: Optional[torch.Tensor]
    kv_code: int                      # 0: pools in the q dtype, 2: int8
    Hkv: int
    page: int
    MP: int


def pool_args(name: str, q, k_pages, v_pages, page_table, cache_len,
              k_scale, v_scale) -> PoolArgs:
    """Check the page pools, table and lengths of a paged kernel call
    (``q`` is ``[B, ..., Hq, D]``) and bring the small tensors to the
    kernel's types.  Raises ``ValueError`` on anything the kernels do not
    take; the pools themselves are never copied."""
    dev = q.device
    tensors = [k_pages, v_pages, page_table, cache_len, k_scale, v_scale]
    if not q.is_cuda or any(t is not None and t.device != dev
                            for t in tensors):
        raise ValueError(f"{name} kernel needs every input on one CUDA "
                         f"device")
    if q.dtype not in _Q_CODE:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    scaled = k_pages.dtype == torch.int8
    if scaled:
        if k_scale is None or v_scale is None or v_pages.dtype != torch.int8:
            raise ValueError("int8 pools need int8 k/v and both scale planes")
    elif k_pages.dtype != q.dtype or v_pages.dtype != q.dtype \
            or k_scale is not None or v_scale is not None:
        raise ValueError(f"pools must be int8 (with scales) or {q.dtype}, "
                         f"got {k_pages.dtype}/{v_pages.dtype}")
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"bad pool shapes k{tuple(k_pages.shape)} "
                         f"v{tuple(v_pages.shape)}")
    B, Hq, D = q.shape[0], q.shape[-2], q.shape[-1]
    P, page, Hkv = k_pages.shape[:3]
    if k_pages.shape[3] != D or D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} (pool {k_pages.shape[3]}) not in "
                         f"{HEAD_DIMS}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"page_table must be [B={B}, MP], got "
                         f"{tuple(page_table.shape)}")
    MP = page_table.shape[1]
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()) or \
            k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("pools must be contiguous and 16-byte aligned "
                         "(copying a pool per call would hide its cost)")
    if scaled:
        k_scale = k_scale.to(torch.float32).contiguous()
        v_scale = v_scale.to(torch.float32).contiguous()
        if k_scale.shape != (P, page, Hkv) or v_scale.shape != (P, page, Hkv):
            raise ValueError(f"scales must be [{P}, {page}, {Hkv}]")
    return PoolArgs(_int32(page_table, (B, MP), dev),
                    _int32(cache_len, (B,), dev), k_scale, v_scale,
                    2 if scaled else 0, Hkv, page, MP)


def paged_decode_attention(
    q: torch.Tensor,                  # [B, Hq, D]
    k_pages: torch.Tensor,            # [P, page, Hkv, D]
    v_pages: torch.Tensor,            # [P, page, Hkv, D]
    page_table: torch.Tensor,         # [B, MP] int32
    cache_len: torch.Tensor,          # [B] valid tokens (incl. the new one)
    *,
    softcap: float = 0.0,
    window: int = 0,
    sm_scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,   # [P, page, Hkv] f32 (int8)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors (raises on anything else).
    Pools are in the dtype of ``q``, or int8 with both scale planes.
    Forward-only: raises under grad mode for an input that needs one."""
    refuse_grad("paged_decode_attention", q, k_pages, v_pages, k_scale,
                v_scale)
    if q.dim() != 3:
        raise ValueError(f"q must be [B, Hq, D], got {tuple(q.shape)}")
    a = pool_args("paged_decode_attention", q, k_pages, v_pages, page_table,
                  cache_len, k_scale, v_scale)
    B, Hq, D = q.shape
    q = _aligned(q)
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    scale = sm_scale if sm_scale is not None else D ** -0.5
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(_ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(a.k_scale),
                   _ptr(a.v_scale), _ptr(out), _ptr(a.table), _ptr(a.clen),
                   B, Hq, a.Hkv, D, a.page, a.MP, _Q_CODE[q.dtype],
                   a.kv_code, int(window), float(softcap), float(scale),
                   ctypes.c_void_p(stream))
    if err != 0:
        raise build.KernelError(f"paged_decode_attention kernel launch "
                                f"failed: CUDA error {err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
