"""Flash attention backward as two hand-written CUDA kernels for Hopper,
and ``flash_mha``, the autograd function of flash attention.

Replaces ``repro.kernels.flash_attention_bwd`` (the Pallas TPU kernels
``_dq_kernel`` and ``_dkv_kernel`` and the ``flash_mha`` custom_vjp).  The
kernels live in ``csrc/flash_attention_bwd.cu`` (bf16 on the tensor
cores with ``wgmma``, fp32 on the CUDA cores); its header says what
bounds them on the card and how they are laid out.  Each wrapper checks
its inputs, allocates its outputs with ``torch.empty``, launches on
PyTorch's current stream and counts its launch.  The plain version of
both is ``kernels.ref.flash_attention_bwd``.

``flash_mha`` runs the forward kernel (on the CPU ``ref.mha``) and, when
grad mode is on and an input needs a gradient, asks it for ``lse`` and
saves what the backward recomputes from; its backward launches the dq
and dk/dv kernels (on the CPU their plain version).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import (_DTYPE_CODE, HEAD_DIMS,
                                                 _aligned, _int32, _ptr)
from repro_torch.kernels.flash_attention import \
    flash_attention as _flash_fwd

_fns = {}


def _entry(name: str):
    f = _fns.get(name)
    if f is None:
        f = getattr(build.load("flash_attention_bwd"), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        n_out = 1 if name.endswith("_dq") else 2
        f.argtypes = ([p] * (9 + n_out) + [i] * 9
                      + [ctypes.c_float, ctypes.c_float, p])
        f.restype = i
        _fns[name] = f
    return f


def _prepare(q, k, v, lse, do, dsum, q_positions, kv_positions,
             kv_valid_len):
    """Check a backward call's inputs (raises ``ValueError`` on what the
    kernels do not take) and bring them to the kernels' layouts."""
    dev = q.device
    if not (q.is_cuda and all(t.device == dev for t in (k, v, lse, do, dsum))):
        raise ValueError("flash_attention_bwd kernels need every input on "
                         "one CUDA device")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype
                                         for t in (k, v, do)):
        raise ValueError(f"flash_attention_bwd takes float32 or bfloat16 "
                         f"q/k/v/do of one dtype, got {q.dtype}/{k.dtype}/"
                         f"{v.dtype}/{do.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or do.shape != q.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} do{tuple(do.shape)}")
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q{tuple(q.shape)} and k{tuple(k.shape)} disagree")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    if lse.shape != (B, Tq, Hq) or dsum.shape != (B, Tq, Hq):
        raise ValueError(f"lse and dsum must be [{B}, {Tq}, {Hq}]")
    if q_positions is None:
        q_positions = torch.arange(Tq, device=dev)[None].expand(B, Tq)
    return dict(
        q=_aligned(q), k=_aligned(k), v=_aligned(v), do=_aligned(do),
        lse=lse.to(torch.float32).contiguous(),
        dsum=dsum.to(torch.float32).contiguous(),
        q_pos=_int32(q_positions, (B, Tq), dev),
        kv_pos=_int32(kv_positions, (B, Tk), dev),
        valid=_int32(kv_valid_len, (B,), dev),
        dims=(B, Tq, Tk, Hq, Hkv, D))


def _launch(name: str, a: dict, outs, causal, window, softcap, sm_scale):
    B, Tq, Tk, Hq, Hkv, D = a["dims"]
    scale = sm_scale if sm_scale is not None else D ** -0.5
    stream = torch.cuda.current_stream(a["q"].device).cuda_stream
    err = _entry(name)(
        *(_ptr(a[n]) for n in ("q", "k", "v", "do", "lse", "dsum", "q_pos",
                               "kv_pos", "valid")),
        *(_ptr(o) for o in outs), B, Tq, Tk, Hq, Hkv, D,
        _DTYPE_CODE[a["q"].dtype], int(causal), int(window), float(softcap),
        float(scale), ctypes.c_void_p(stream))
    if err != 0:
        raise build.KernelError(f"{name} kernel launch failed: CUDA error "
                                f"{err}")


def flash_attention_bwd_dq(q, k, v, lse, do, dsum, *, causal=True, window=0,
                           softcap=0.0, q_positions=None, kv_positions=None,
                           kv_valid_len=None, sm_scale=None) -> torch.Tensor:
    """Launch the dq kernel on CUDA tensors (raises on anything else):
    ``dq [B,Tq,Hq,D]`` in q's dtype from ``dsum = rowsum(do·out)``."""
    a = _prepare(q, k, v, lse, do, dsum, q_positions, kv_positions,
                 kv_valid_len)
    if 0 in a["dims"]:
        return torch.zeros_like(q)
    dq = torch.empty_like(a["q"])
    _launch("flash_attention_bwd_dq", a, (dq,), causal, window, softcap,
            sm_scale)
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, lse, do, dsum, *, causal=True,
                            window=0, softcap=0.0, q_positions=None,
                            kv_positions=None, kv_valid_len=None,
                            sm_scale=None):
    """Launch the dk/dv kernel on CUDA tensors (raises on anything else):
    ``(dk, dv) [B,Tk,Hkv,D]`` in k's dtype, each summed over the G query
    heads of its KV head."""
    a = _prepare(q, k, v, lse, do, dsum, q_positions, kv_positions,
                 kv_valid_len)
    if 0 in a["dims"]:
        return torch.zeros_like(k), torch.zeros_like(v)
    dk, dv = torch.empty_like(a["k"]), torch.empty_like(a["v"])
    _launch("flash_attention_bwd_dkv", a, (dk, dv), causal, window, softcap,
            sm_scale)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, out, lse, do, *, causal=True, window=0,
                        softcap=0.0, q_positions=None, kv_positions=None,
                        kv_valid_len=None, sm_scale=None):
    """``(dq, dk, dv)`` by the two kernels, with the signature of
    ``ref.flash_attention_bwd``.  ``dsum = rowsum(do·out)`` is one f32
    PyTorch reduction here, as the JAX wrapper computes it outside its
    kernels."""
    dsum = (do.float() * out.float()).sum(-1)
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_positions=q_positions, kv_positions=kv_positions,
              kv_valid_len=kv_valid_len, sm_scale=sm_scale)
    dq = flash_attention_bwd_dq(q, k, v, lse, do, dsum, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, lse, do, dsum, **kw)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class _FlashMHA(torch.autograd.Function):
    """Flash attention with its backward; the counterpart of the JAX
    ``flash_mha`` custom_vjp.  ``save`` says whether a backward can follow
    (decided by the caller: inside ``forward`` grad mode is always off)."""

    @staticmethod
    def forward(ctx, q, k, v, save, causal, window, softcap, q_positions,
                kv_positions, kv_valid_len, sm_scale):
        kw = dict(causal=causal, window=window, softcap=softcap,
                  q_positions=q_positions, kv_positions=kv_positions,
                  kv_valid_len=kv_valid_len, sm_scale=sm_scale)
        fwd = _flash_fwd if q.is_cuda else ref.mha
        if not save:
            return fwd(q, k, v, **kw)
        out, lse = fwd(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse, q_positions, kv_positions,
                              kv_valid_len)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      sm_scale=sm_scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, q_pos, kv_pos, valid = ctx.saved_tensors
        bwd = flash_attention_bwd if q.is_cuda else ref.flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, out, lse, do, q_positions=q_pos,
                         kv_positions=kv_pos, kv_valid_len=valid, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None, None, None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0,
              q_positions: Optional[torch.Tensor] = None,
              kv_positions: Optional[torch.Tensor] = None,
              kv_valid_len: Optional[torch.Tensor] = None,
              sm_scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable flash attention, ``[B,Tq,Hq,D] x [B,Tk,Hkv,D] ->
    [B,Tq,Hq,D]``: the CUDA kernels on CUDA tensors, the plain versions
    on CPU tensors.  Under ``torch.no_grad()`` (serving) it launches the
    forward kernel alone, without ``lse``, and saves nothing.  Positions
    and valid lengths get no gradient."""
    save = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    return _FlashMHA.apply(q, k, v, save, causal, window, softcap,
                           q_positions, kv_positions, kv_valid_len, sm_scale)
