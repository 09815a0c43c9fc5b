"""Dense single-token decode attention as a hand-written CUDA kernel.

Replaces ``repro.kernels.decode_attention.decode_attention`` (the Pallas
TPU kernel).  The kernel is the one of ``csrc/paged_attention.cuh``, whose
``dense_decode`` kind reads a dense cache as B pages of S keys through the
identity table, instantiated by ``csrc/decode_attention.cu``; their
headers say what bounds it on the card and how it is laid out.  This
wrapper checks the inputs, allocates the output with ``torch.empty``,
launches on PyTorch's current stream and counts the launch.  The plain
version is ``kernels.ref.decode_attention``.

MLA's weight-absorbed decode (deepseek-v2-236b: keys of 576 latent and
rope columns, values of the 512 latent ones, one KV head under 128 query
heads) runs a kernel of its own, in ``csrc/decode_attention.cu``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (_DTYPE_CODE, _aligned,
                                                 _int32, _ptr, refuse_grad)

# the head dims the kernel instantiates (csrc/paged_attention.cuh), with
# values as wide as keys, and the (key, value) widths of MLA's latent
# decode (csrc/decode_attention.cu)
HEAD_DIMS = (32, 64, 128, 192, 256)
NARROW_V = ((576, 512),)
DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + NARROW_V
_fn = None
_mla = None


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


def _mla_entry():
    """(the split count, the launch) of MLA's kernels."""
    global _mla
    if _mla is None:
        lib = build.load("decode_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        n, f = lib.mla_decode_splits, lib.mla_decode_attention_fwd
        n.argtypes, n.restype = [i] * 5, i
        f.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float,
                      ctypes.c_float, p]
        f.restype = i
        _mla = (n, f)
    return _mla


def decode_attention(
    q: torch.Tensor,                  # [B, Hq, D]
    k_cache: torch.Tensor,            # [B, S, Hkv, D]
    v_cache: torch.Tensor,            # [B, S, Hkv, Dv]
    cache_len: torch.Tensor,          # [B] valid slots (incl. the new token)
    *,
    softcap: float = 0.0,
    window: int = 0,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors (raises on anything else).
    The caches are in the dtype of ``q``; ``(D, Dv)`` is one of
    ``DIM_PAIRS``.  Returns ``[B, Hq, Dv]``.  Forward-only: raises under
    grad mode for an input that needs one."""
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
    S, Hkv, Dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[3]
    if v_cache.shape[:3] != k_cache.shape[:3]:
        raise ValueError(f"values {tuple(v_cache.shape)} and keys "
                         f"{tuple(k_cache.shape)} disagree")
    if k_cache.shape[0] != B or k_cache.shape[3] != D \
            or (D, Dv) not in DIM_PAIRS:
        raise ValueError(f"q{tuple(q.shape)} and cache "
                         f"{tuple(k_cache.shape)} disagree, or head dims "
                         f"({D}, {Dv}) of keys and values not in "
                         f"{DIM_PAIRS}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()) or \
            k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("caches must be contiguous and 16-byte aligned "
                         "(copying a cache per call would hide its cost)")
    q = _aligned(q)
    clen = _int32(cache_len, (B,), dev)
    out = torch.empty((B, Hq, Dv), dtype=q.dtype, device=dev)
    scale = sm_scale if sm_scale is not None else D ** -0.5
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    code = _DTYPE_CODE[q.dtype]
    if Dv == D:
        err = _entry()(_ptr(q), _ptr(k_cache), _ptr(v_cache), _ptr(out),
                       _ptr(clen), B, S, Hq, Hkv, D, code, int(window),
                       float(softcap), float(scale), stream)
    else:
        # MLA: the keys split over blocks, whose partials a second kernel
        # merges through an f32 workspace
        splits, fwd = _mla_entry()
        nsplit = splits(B, S, Hq, Hkv, code)
        ws = torch.empty((B * Hq * nsplit * (Dv + 2),),
                         dtype=torch.float32, device=dev) \
            if nsplit > 1 else None
        err = fwd(_ptr(q), _ptr(k_cache), _ptr(v_cache), _ptr(out),
                  _ptr(ws), _ptr(clen), B, S, Hq, Hkv, nsplit, code,
                  int(window), float(softcap), float(scale), stream)
    if err != 0:
        raise build.KernelError(f"decode_attention kernel launch failed: "
                                f"CUDA error {err}")
    build.count_launch(decode_attention)
    return out


decode_attention.launches = 0
