"""Mamba2 (SSD, state-space duality) block: the port of
``repro.models.mamba2``, full-sequence and decode paths.

The full-sequence path runs the chunked SSD scan (``kernels.ops.ssd_scan``:
the CUDA kernel on the card, the plain version on the CPU); decode is the
O(1) recurrent step on the carried state.  Leaf names, layouts and the
order in which each product is rounded to the compute dtype follow the
JAX functions step by step.  ``kernel_norm`` sends the gated out-norm
through ``ops.rmsnorm`` (the serving path's choice; the training forward
keeps ``layers.rms_norm``).  The functions return a new state and leave
the one they were given as it is; the stack writes it into the cache.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
# F32_LEAVES (Mamba2's f32 leaves among them) is re-exported here
from repro_torch.models.layers import (F32_LEAVES, dense_init,  # noqa: F401
                                       rand, randn, rms_norm_simple)


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    di = cfg.d_inner
    return s, di, cfg.ssm_heads, di + 2 * s.n_groups * s.d_state


def _softplus(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(v, 0)``: exact for large
    ``v``, where ``F.softplus`` switches to ``v`` above its threshold."""
    return torch.clamp(v, min=0.0) + torch.log1p(torch.exp(-v.abs()))


def init_mamba2(gen: torch.Generator, cfg: ModelConfig):
    """The JAX distributions (different numbers): ``dt_bias`` the inverse
    softplus of a log-uniform timestep in ``[dt_min, dt_max]``, ``A``
    uniform in ``a_init_range`` (stored as ``a_log``), ``d_skip`` ones."""
    s, di, H, conv_dim = _dims(cfg)
    d, dt, dev = cfg.d_model, cfg.pdtype, gen.device
    proj_dim = 2 * di + 2 * s.n_groups * s.d_state + H   # z, x, B, C, dt
    in_proj = dense_init(gen, (d, proj_dim), dt)
    conv_w = randn(gen, (conv_dim, s.d_conv)) * s.d_conv ** -0.5
    u = rand(gen, (H,))
    lo, hi = math.log(s.dt_min), math.log(s.dt_max)
    dt_init = torch.exp(u * (hi - lo) + lo)
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))   # inverse softplus
    a_lo, a_hi = s.a_init_range
    A = rand(gen, (H,)) * (a_hi - a_lo) + a_lo
    return {
        "in_proj": in_proj,
        "conv_w": conv_w.to(dt),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=dev),
        "dt_bias": dt_bias,
        "a_log": torch.log(A),
        "d_skip": torch.ones((H,), dtype=torch.float32, device=dev),
        "out_norm": torch.ones((di,), dtype=dt, device=dev),
        "out_proj": dense_init(gen, (di, d), dt, fan_in=di),
    }


def init_mamba2_state(cfg: ModelConfig, batch: int, device=None):
    """``conv`` [B, d_conv-1, conv_dim] holds the pre-conv stream's tail,
    ``ssm`` [B, H, P, N] the recurrent state; both zero and f32, as the
    JAX function makes them by default."""
    s, di, H, conv_dim = _dims(cfg)
    device = resolve_device(device)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim),
                            dtype=torch.float32, device=device),
        "ssm": torch.zeros((batch, H, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }


def _causal_depthwise_conv(x, w, b):
    """x [B, T, C], w [C, W]: causal depthwise conv by shifted adds, in the
    JAX order (each product and sum rounded to x's dtype)."""
    W, T = w.shape[1], x.shape[1]
    out = x * w[:, W - 1]
    for i in range(1, W):
        shifted = F.pad(x, (0, 0, i, 0))[:, :T]
        out = out + shifted * w[:, W - 1 - i]
    return out + b


def _split_proj(zxbcdt, cfg: ModelConfig):
    s, di, H, conv_dim = _dims(cfg)
    return (zxbcdt[..., :di], zxbcdt[..., di:di + conv_dim],
            zxbcdt[..., di + conv_dim:])


def _split_xbc(xBC, cfg: ModelConfig):
    s, di, H, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    return xBC[..., :di], xBC[..., di:di + gn], xBC[..., di + gn:]


def apply_mamba2(p, x: torch.Tensor, cfg: ModelConfig,
                 state: Optional[dict] = None, *, kernel_norm: bool = False
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence SSD pass, x [B, T, d] → (out [B, T, d], new state or
    None).  With ``state`` the carried conv tail is prepended to the conv
    input and the scan starts from the carried SSM state, so a prefill
    resumes mid-prompt (chunked prefill); a zero state gives the
    stateless result."""
    s, di, H, conv_dim = _dims(cfg)
    B, T, _ = x.shape
    dt_c = cfg.cdtype
    zxbcdt = x.to(dt_c) @ p["in_proj"].to(dt_c)
    z, xBC_raw, dt_raw = _split_proj(zxbcdt, cfg)
    w, b = p["conv_w"].to(dt_c), p["conv_b"].to(dt_c)
    if state is not None:
        pre = torch.cat([state["conv"].to(dt_c), xBC_raw], dim=1)
        conv_out = _causal_depthwise_conv(pre, w, b)[:, s.d_conv - 1:]
    else:
        conv_out = _causal_depthwise_conv(xBC_raw, w, b)
    x_in, B_, C_ = _split_xbc(F.silu(conv_out), cfg)

    dt = _softplus(dt_raw.float() + p["dt_bias"])         # [B, T, H]
    A = -torch.exp(p["a_log"])
    xh = x_in.reshape(B, T, H, s.head_dim)
    Bh = B_.reshape(B, T, s.n_groups, s.d_state)
    Ch = C_.reshape(B, T, s.n_groups, s.d_state)
    if state is not None:
        y, final = ops.ssd_scan(xh, dt, A, Bh, Ch, chunk=s.chunk_size,
                                initial_state=state["ssm"],
                                return_final_state=True)
    else:
        y = ops.ssd_scan(xh, dt, A, Bh, Ch, chunk=s.chunk_size)

    y = y + xh * p["d_skip"][None, None, :, None].to(y.dtype)
    y = rms_norm_simple(y.reshape(B, T, di) * F.silu(z), p["out_norm"],
                        cfg.norm_eps, kernel=kernel_norm)
    out = y @ p["out_proj"].to(dt_c)
    if state is None:
        return out, None
    # the conv state holds the tail of the *pre-conv* xBC stream
    new_conv = torch.cat([state["conv"].to(dt_c), xBC_raw],
                         dim=1)[:, -(s.d_conv - 1):]
    return out, {"conv": new_conv, "ssm": final}


def decode_step_mamba2(p, x: torch.Tensor, cfg: ModelConfig, state: dict,
                       *, kernel_norm: bool = False
                       ) -> Tuple[torch.Tensor, dict]:
    """x [B, 1, d] → (out [B, 1, d], new state).  O(1) per token."""
    s, di, H, conv_dim = _dims(cfg)
    B = x.shape[0]
    dt_c = cfg.cdtype
    zxbcdt = x[:, 0].to(dt_c) @ p["in_proj"].to(dt_c)     # [B, proj]
    z, xBC, dt_raw = _split_proj(zxbcdt, cfg)
    window = torch.cat([state["conv"].to(dt_c), xBC[:, None]], dim=1)
    # window[:, i] holds x_{t-(W-1-i)}: tap weight w[:, i]
    conv_out = torch.einsum("bwc,cw->bc", window, p["conv_w"].to(dt_c))
    x_in, B_, C_ = _split_xbc(F.silu(conv_out + p["conv_b"].to(dt_c)), cfg)

    dt = _softplus(dt_raw.float() + p["dt_bias"])         # [B, H]
    A = -torch.exp(p["a_log"])
    xh = x_in.reshape(B, H, s.head_dim)
    y, new_ssm = ops.ssd_decode_step(
        xh, dt, A, B_.reshape(B, s.n_groups, s.d_state),
        C_.reshape(B, s.n_groups, s.d_state), state["ssm"])
    y = y + xh * p["d_skip"][None, :, None].to(y.dtype)
    y = rms_norm_simple(y.reshape(B, di) * F.silu(z), p["out_norm"],
                        cfg.norm_eps, kernel=kernel_norm)
    out = (y @ p["out_proj"].to(dt_c))[:, None]
    return out, {"conv": window[:, 1:], "ssm": new_ssm}
