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
heads) runs a kernel of its own, in ``csrc/decode_attention.cu``; at the
reduced config's widths (keys of 48 over values of 32, G 4) it is the
template's, with values narrower than keys.

``decode_attention_lse`` launches the same kernels asking them also for
each row's f32 log-sum-exp (its output is the one ``decode_attention``
gives): the partials of a decode over a cache split along the sequence
across ranks are merged by it (``distributed.spmd.merge_partials``).  It
counts its launches apart, on ``decode_attention_lse.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import ATTENTION_DIMS, build
from repro_torch.kernels.flash_attention import (_DTYPE_CODE, _aligned,
                                                 _int32, _ptr, refuse_grad)

# the (key, value) widths of MLA's latent decode at the published config,
# which runs the kernels of namespace `mla` (csrc/decode_attention.cu);
# every other pair runs the template of csrc/paged_attention.cuh
MLA_DIMS = (576, 512)
_fn = None
_mla = None


def _entry():
    global _fn
    if _fn is None:
        f = build.load("decode_attention").decode_attention_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                      ctypes.c_float, ctypes.c_float, p]
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
        f.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                      ctypes.c_float, ctypes.c_float, p]
        f.restype = i
        _mla = (n, f)
    return _mla


def _launch(q, k_cache, v_cache, cache_len, softcap, window, sm_scale,
            lse: bool, name: str):
    """Check the inputs, launch, and return ``out`` (and the f32 ``lse``
    [B, Hq] with ``lse``)."""
    refuse_grad(name, q, k_cache, v_cache)
    dev = q.device
    if not q.is_cuda or any(t.device != dev
                            for t in (k_cache, v_cache, cache_len)):
        raise ValueError(f"{name} kernel needs every input on one CUDA "
                         f"device")
    if q.dtype not in _DTYPE_CODE or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"{name} takes float32 or bfloat16 q/k/v of one "
                         f"dtype, got {q.dtype}/{k_cache.dtype}/"
                         f"{v_cache.dtype}")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError(f"bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k_cache.shape)} v{tuple(v_cache.shape)}")
    B, Hq, D = q.shape
    S, Hkv, Dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[3]
    if v_cache.shape[:3] != k_cache.shape[:3]:
        raise ValueError(f"values {tuple(v_cache.shape)} and keys "
                         f"{tuple(k_cache.shape)} disagree")
    if k_cache.shape[0] != B or k_cache.shape[3] != D \
            or (D, Dv) not in ATTENTION_DIMS["decode"]:
        raise ValueError(f"q{tuple(q.shape)} and cache "
                         f"{tuple(k_cache.shape)} disagree, or head dims "
                         f"({D}, {Dv}) of keys and values not in "
                         f"{ATTENTION_DIMS['decode']}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()) or \
            k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("caches must be contiguous and 16-byte aligned "
                         "(copying a cache per call would hide its cost)")
    q = _aligned(q)
    clen = _int32(cache_len, (B,), dev)
    out = torch.empty((B, Hq, Dv), dtype=q.dtype, device=dev)
    row_lse = torch.empty((B, Hq), dtype=torch.float32, device=dev) \
        if lse else None
    scale = sm_scale if sm_scale is not None else D ** -0.5
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    code = _DTYPE_CODE[q.dtype]
    if (D, Dv) != MLA_DIMS:
        err = _entry()(_ptr(q), _ptr(k_cache), _ptr(v_cache), _ptr(out),
                       _ptr(row_lse), _ptr(clen), B, S, Hq, Hkv, D, Dv,
                       code, int(window), float(softcap), float(scale),
                       stream)
    else:
        # MLA: the keys split over blocks, whose partials a second kernel
        # merges through an f32 workspace
        splits, fwd = _mla_entry()
        nsplit = splits(B, S, Hq, Hkv, code)
        ws = torch.empty((B * Hq * nsplit * (Dv + 2),),
                         dtype=torch.float32, device=dev) \
            if nsplit > 1 else None
        err = fwd(_ptr(q), _ptr(k_cache), _ptr(v_cache), _ptr(out),
                  _ptr(ws), _ptr(row_lse), _ptr(clen), B, S, Hq, Hkv,
                  nsplit, code, int(window), float(softcap), float(scale),
                  stream)
    if err != 0:
        raise build.KernelError(f"{name} kernel launch failed: CUDA error "
                                f"{err}")
    return (out, row_lse) if lse else out


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
    ``ATTENTION_DIMS["decode"]``.  Returns ``[B, Hq, Dv]``.  Forward-only:
    raises under grad mode for an input that needs one."""
    out = _launch(q, k_cache, v_cache, cache_len, softcap, window, sm_scale,
                  False, "decode_attention")
    build.count_launch(decode_attention)
    return out


decode_attention.launches = 0


def decode_attention_lse(  # analysis: oracle=decode_attention
    q: torch.Tensor,                  # [B, Hq, D]
    k_cache: torch.Tensor,            # [B, S, Hkv, D]
    v_cache: torch.Tensor,            # [B, S, Hkv, Dv]
    cache_len: torch.Tensor,          # [B] valid slots
    *,
    softcap: float = 0.0,
    window: int = 0,
    sm_scale: Optional[float] = None,
):
    """``decode_attention``'s output and each row's f32 log-sum-exp ``[B,
    Hq]`` of its scaled (and capped) valid logits, ``NEG_INF`` for a row
    with no valid key, from one launch of the same kernels."""
    out = _launch(q, k_cache, v_cache, cache_len, softcap, window, sm_scale,
                  True, "decode_attention_lse")
    build.count_launch(decode_attention_lse)
    return out


decode_attention_lse.launches = 0
