"""Flash attention (forward) as a hand-written CUDA kernel for Hopper.

Replaces ``repro.kernels.flash_attention.flash_attention`` (the Pallas TPU
kernel).  The kernel lives in ``csrc/flash_attention.cu``; its header says
what bounds it on the card and how it is laid out.  This wrapper checks
the inputs, allocates the outputs with ``torch.empty``, launches on
PyTorch's current stream and counts the launch.  The plain version is
``kernels.ref.mha``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _entry():
    global _fn
    if _fn is None:
        f = build.load("flash_attention").flash_attention_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                      ctypes.c_float, ctypes.c_float, p]
        f.restype = i
        _fn = f
    return _fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the kernels load 16 bytes at a
    time); a misaligned view is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """A forward-only kernel writes into a fresh tensor, which would cut
    the autograd graph without a word: raise instead when grad mode is on
    and an input needs a gradient."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise ValueError(f"{name} kernel is forward-only: call it under "
                         f"torch.no_grad() or on inputs that need no "
                         f"gradient")


def _int32(t: Optional[torch.Tensor], shape, device) -> Optional[torch.Tensor]:
    if t is None:
        return None
    t = t.to(device=device, dtype=torch.int32).contiguous()
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"expected int shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    return t


def flash_attention(
    q: torch.Tensor,                  # [B, Tq, Hq, D]
    k: torch.Tensor,                  # [B, Tk, Hkv, D]
    v: torch.Tensor,                  # [B, Tk, Hkv, D]
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    kv_valid_len: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Launch the CUDA kernel on CUDA tensors (raises on anything else):
    bf16 on the tensor cores, fp32 on the CUDA cores.

    ``kv_positions=None`` means the key positions are the key indices.
    Either way the kernel skips the key tiles whose positions no query of
    a block can see, and with index positions it reads no key at or past
    ``kv_valid_len``.  Returns ``out [B,Tq,Hq,D]`` (and ``lse [B,Tq,Hq]``
    f32 if asked)."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention kernel needs q, k, v on one "
                         "CUDA device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bfloat16 q/k/v "
                         f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q{tuple(q.shape)} and k{tuple(k.shape)} disagree")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    dev = q.device
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    if q_positions is None:
        q_positions = torch.arange(Tq, device=dev)[None].expand(B, Tq)
    q_pos = _int32(q_positions, (B, Tq), dev)
    kv_pos = _int32(kv_positions, (B, Tk), dev)
    valid = _int32(kv_valid_len, (B,), dev)
    out = torch.empty((B, Tq, Hq, D), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, Tq, Hq), dtype=torch.float32, device=dev)
           if return_lse else None)
    scale = sm_scale if sm_scale is not None else D ** -0.5
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _entry()(_ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse),
                   _ptr(q_pos), _ptr(kv_pos), _ptr(valid), B, Tq, Tk, Hq,
                   Hkv, D, _DTYPE_CODE[q.dtype], int(causal), int(window),
                   float(softcap), float(scale), ctypes.c_void_p(stream))
    if err != 0:
        raise build.KernelError(f"flash_attention kernel launch failed: "
                                f"CUDA error {err}")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
