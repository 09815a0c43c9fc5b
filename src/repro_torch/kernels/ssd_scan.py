"""Mamba2 SSD chunk scan as a hand-written CUDA kernel for Hopper.

Replaces ``repro.kernels.ssd_scan.ssd_scan`` (the Pallas TPU kernel).  The
kernel lives in ``csrc/ssd_scan.cu``; its header says what bounds it on
the card and how it is laid out.  This wrapper checks the inputs, allocates
the outputs with ``torch.empty``, launches on PyTorch's current stream and
counts the launch.  The plain version is ``kernels.ref.ssd_scan``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (_DTYPE_CODE, _aligned, _ptr,
                                                 refuse_grad)

HEAD_DIMS = (16, 32, 64)              # P
STATE_DIMS = (16, 32, 64, 128)        # N
MAX_CHUNK = 1024                      # Q: its dt and cum sit in shared memory
P_SLICE = 16                          # P rows a block takes (csrc PB)
_fn = None


def _entry():
    global _fn
    if _fn is None:
        f = build.load("ssd_scan").ssd_scan_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        f.restype = i
        _fn = f
    return _fn


def ssd_scan(
    x: torch.Tensor,                  # [B, T, H, P] bf16 or f32
    dt: torch.Tensor,                 # [B, T, H] f32
    A: torch.Tensor,                  # [H] f32
    B_: torch.Tensor,                 # [B, T, G, N] x's dtype
    C: torch.Tensor,                  # [B, T, G, N] x's dtype
    *,
    chunk: int = 64,
    initial_state: Optional[torch.Tensor] = None,   # [B, H, P, N] f32
    return_final_state: bool = False,
):
    """Launch the CUDA kernel on CUDA tensors (raises on anything else).
    Returns ``y [B, T, H, P]`` in x's dtype, and with
    ``return_final_state`` also the f32 state ``[B, H, P, N]`` after the
    last token.  Forward-only: raises under grad mode for an input that
    needs one."""
    refuse_grad("ssd_scan", x, dt, A, B_, C, initial_state)
    dev = x.device
    ins = (dt, A, B_, C) + ((initial_state,) if initial_state is not None
                            else ())
    if not x.is_cuda or any(t.device != dev for t in ins):
        raise ValueError("ssd_scan kernel needs every input on one CUDA "
                         "device")
    if x.dtype not in _DTYPE_CODE or B_.dtype != x.dtype \
            or C.dtype != x.dtype:
        raise ValueError(f"ssd_scan takes float32 or bfloat16 x/B/C of one "
                         f"dtype, got {x.dtype}/{B_.dtype}/{C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32 or (
            initial_state is not None
            and initial_state.dtype != torch.float32):
        raise ValueError("ssd_scan takes dt, A and the initial state in "
                         "float32")
    if x.dim() != 4 or B_.dim() != 4 or C.shape != B_.shape:
        raise ValueError(f"bad shapes x{tuple(x.shape)} B{tuple(B_.shape)} "
                         f"C{tuple(C.shape)}")
    Bb, T, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    if tuple(dt.shape) != (Bb, T, H) or tuple(A.shape) != (H,) \
            or B_.shape[:2] != x.shape[:2]:
        raise ValueError(f"x{tuple(x.shape)}, dt{tuple(dt.shape)}, "
                         f"A{tuple(A.shape)} and B{tuple(B_.shape)} disagree")
    if P not in HEAD_DIMS or N not in STATE_DIMS or H % G:
        raise ValueError(f"head dim {P} not in {HEAD_DIMS}, state dim {N} "
                         f"not in {STATE_DIMS}, or {H} heads not a multiple "
                         f"of {G} groups")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} not in [1, {MAX_CHUNK}]")
    if initial_state is not None and \
            tuple(initial_state.shape) != (Bb, H, P, N):
        raise ValueError(f"initial state {tuple(initial_state.shape)} is "
                         f"not {(Bb, H, P, N)}")
    x, B_, C = (_aligned(t) for t in (x, B_, C))
    dt, A = dt.contiguous(), A.contiguous()
    s0 = _aligned(initial_state) if initial_state is not None else None
    y = torch.empty_like(x)
    s_fin = torch.empty((Bb, H, P, N), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _entry()(_ptr(x), _ptr(dt), _ptr(A), _ptr(B_), _ptr(C), _ptr(s0),
                   _ptr(y), _ptr(s_fin), Bb, T, H, G, P, N, int(chunk),
                   _DTYPE_CODE[x.dtype], ctypes.c_void_p(stream))
    if err != 0:
        raise build.KernelError(f"ssd_scan kernel launch failed: CUDA "
                                f"error {err}")
    build.count_launch(ssd_scan)
    return (y, s_fin) if return_final_state else y


ssd_scan.launches = 0
