"""Dense single-token decode attention as a hand-written CUDA kernel.

Replaces ``repro.kernels.decode_attention.decode_attention`` (the Pallas
TPU kernel).  The kernel is the one of ``csrc/paged_attention.cuh``, whose
``dense_decode`` kind reads a dense cache as B pages of S keys through the
identity table, instantiated by ``csrc/decode_attention.cu``; their
headers say what bounds it on the card and how it is laid out.  This
wrapper checks the inputs, allocates the output with ``torch.empty``,
launches on PyTorch's current stream and counts the launch.  The plain
version is ``kernels.ref.decode_attention``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (_DTYPE_CODE, _aligned,
                                                 _int32, _ptr, refuse_grad)

# the head dims the kernel instantiates (csrc/paged_attention.cuh)
HEAD_DIMS = (32, 64, 128, 192, 256)
_fn = None


def _entry():
    global _fn
    if _fn is None:
        f = build.load("decode_attention").decode_attention_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float,
                      ctypes.c_float, p]
        f.restype = i
        _fn = f
    return _fn


def decode_attention(
    q: torch.Tensor,                  # [B, Hq, D]
    k_cache: torch.Tensor,            # [B, S, Hkv, D]
    v_cache: torch.Tensor,            # [B, S, Hkv, D]
    cache_len: torch.Tensor,          # [B] valid slots (incl. the new token)
    *,
    softcap: float = 0.0,
    window: int = 0,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors (raises on anything else).
    The caches are in the dtype of ``q``, with values as wide as keys.
    Forward-only: raises under grad mode for an input that needs one."""
    refuse_grad("decode_attention", q, k_cache, v_cache)
    dev = q.device
    if not q.is_cuda or any(t.device != dev
                            for t in (k_cache, v_cache, cache_len)):
        raise ValueError("decode_attention kernel needs every input on one "
                         "CUDA device")
    if q.dtype not in _DTYPE_CODE or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"decode_attention takes float32 or bfloat16 "
                         f"q/k/v of one dtype, got {q.dtype}/"
                         f"{k_cache.dtype}/{v_cache.dtype}")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError(f"bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k_cache.shape)} v{tuple(v_cache.shape)}")
    B, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    if v_cache.shape != k_cache.shape:
        raise ValueError(f"values {tuple(v_cache.shape)} must match keys "
                         f"{tuple(k_cache.shape)} (Dv != D, the MLA case, "
                         f"is not ported)")
    if k_cache.shape[0] != B or k_cache.shape[3] != D or D not in HEAD_DIMS:
        raise ValueError(f"q{tuple(q.shape)} and cache "
                         f"{tuple(k_cache.shape)} disagree, or head dim "
                         f"{D} not in {HEAD_DIMS}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()) or \
            k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("caches must be contiguous and 16-byte aligned "
                         "(copying a cache per call would hide its cost)")
    q = _aligned(q)
    clen = _int32(cache_len, (B,), dev)
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=dev)
    scale = sm_scale if sm_scale is not None else D ** -0.5
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _entry()(_ptr(q), _ptr(k_cache), _ptr(v_cache), _ptr(out),
                   _ptr(clen), B, S, Hq, Hkv, D, _DTYPE_CODE[q.dtype],
                   int(window), float(softcap), float(scale),
                   ctypes.c_void_p(stream))
    if err != 0:
        raise build.KernelError(f"decode_attention kernel launch failed: "
                                f"CUDA error {err}")
    build.count_launch(decode_attention)
    return out


decode_attention.launches = 0
