"""RMSNorm as a hand-written CUDA kernel for Hopper.

Replaces ``repro.kernels.rmsnorm.rmsnorm`` (the Pallas TPU kernel).  The
kernel lives in ``csrc/rmsnorm.cu``; its header says what bounds it on the
card and how it is laid out.  This wrapper checks the inputs, allocates
the output with ``torch.empty``, launches on PyTorch's current stream and
counts the launch.  The plain version is ``kernels.ref.rmsnorm``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import _DTYPE_CODE, _ptr, refuse_grad

_fn = None


def _entry():
    global _fn
    if _fn is None:
        f = build.load("rmsnorm").rmsnorm_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p, p, p, p, i, i, ctypes.c_float, i, p]
        f.restype = i
        _fn = f
    return _fn


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6,
            ms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors (raises on anything else):
    each row of ``x [..., d]`` (bf16 or f32) normalized and scaled by
    ``scale [d]``, which is cast to x's dtype first.  ``ms`` (f32,
    ``x.shape[:-1]``) gives each row's mean of squares, which the kernel
    then reads in place of summing the row (a row split over ranks).
    Forward-only: raises under grad mode for an input that needs one."""
    refuse_grad("rmsnorm", x, scale, ms)
    if not x.is_cuda or scale.device != x.device or (
            ms is not None and ms.device != x.device):
        raise ValueError("rmsnorm kernel needs x, scale and ms on one CUDA "
                         "device")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"rmsnorm takes float32 or bfloat16, got {x.dtype}")
    if x.dim() == 0 or tuple(scale.shape) != tuple(x.shape[-1:]):
        raise ValueError(f"scale {tuple(scale.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if ms is not None and (ms.dtype != torch.float32
                           or tuple(ms.shape) != tuple(x.shape[:-1])):
        raise ValueError(f"ms must be float32 of shape "
                         f"{tuple(x.shape[:-1])}, got {ms.dtype} "
                         f"{tuple(ms.shape)}")
    d = x.shape[-1]
    # a contiguous but misaligned view goes as it is: the kernel then
    # reads by element instead of 16-byte vectors
    x = x.contiguous()
    scale = scale.to(x.dtype).contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:                       # no rows: nothing to launch
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if ms is not None:
        ms = ms.contiguous()
    err = _entry()(_ptr(x), _ptr(scale), _ptr(ms), _ptr(out), rows, d,
                   float(eps), _DTYPE_CODE[x.dtype], ctypes.c_void_p(stream))
    if err != 0:
        raise build.KernelError(f"rmsnorm kernel launch failed: CUDA error "
                                f"{err}")
    build.count_launch(rmsnorm)
    return out


rmsnorm.launches = 0
