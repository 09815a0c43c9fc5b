"""AdamW with fp32 or 8-bit (block-quantized) moment states, as
``repro.optim.adamw``.

With ``state_dtype="int8"`` the first moment is stored as linear
blockwise int8 and the second in log space (uniform relative precision),
each with per-block f32 scales over the flattened leaf, dequantized for
the update and quantized again after it; rounding is half to even, as
``jnp.round`` and ``torch.round`` both do.  Weight decay applies to every
leaf with two or more dimensions, which includes the stacked ``[L, d]``
norm scales, as in JAX.

Unlike the JAX function, ``apply_updates`` updates the parameters and the
fp32 moments in place, under ``torch.no_grad()``: at full tinyllama width
they are 4.4 GB each, and a functional update would hold two copies of
each at once.  ``state_partition_specs`` comes with sharding (ROADMAP
Queue A item 13).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.tree import leaves, tree_map

Params = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4                 # peak lr (schedules multiply this)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    state_dtype: str = "float32"     # float32 | int8
    quant_block: int = 256


class QuantMoment(NamedTuple):
    """int8 payload ``[blocks, block]`` + per-block f32 scale."""
    q: torch.Tensor
    scale: torch.Tensor


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    return torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)


def _quantize(x: torch.Tensor, block: int) -> QuantMoment:
    """Linear blockwise int8 (signed values: the first moment)."""
    blocks = _blocks(x, block)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return QuantMoment(q=q, scale=scale.to(torch.float32))


def _dequantize(qm: QuantMoment, shape: Tuple[int, ...]) -> torch.Tensor:
    flat = (qm.q.to(torch.float32) * qm.scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


_LOG_TINY = 1e-30


def _quantize_log(x: torch.Tensor, block: int) -> QuantMoment:
    """Blockwise int8 in log space (non-negative values: the second
    moment); the scale holds each block's ``[mid, half]``."""
    blocks = torch.log(torch.clamp(_blocks(x, block), min=0.0) + _LOG_TINY)
    lo = torch.amin(blocks, dim=1, keepdim=True)
    hi = torch.amax(blocks, dim=1, keepdim=True)
    mid = (hi + lo) * 0.5
    half = torch.clamp((hi - lo) * 0.5, min=1e-8)
    q = torch.clamp(torch.round((blocks - mid) / half * 127.0),
                    -127, 127).to(torch.int8)
    return QuantMoment(q=q, scale=torch.cat([mid, half], dim=1)
                       .to(torch.float32))


def _dequantize_log(qm: QuantMoment, shape: Tuple[int, ...]) -> torch.Tensor:
    mid, half = qm.scale[:, :1], qm.scale[:, 1:]
    u = qm.q.to(torch.float32) / 127.0 * half + mid
    flat = torch.clamp(torch.exp(u) - _LOG_TINY, min=0.0).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def init_state(params: Params, cfg: AdamWConfig) -> Dict[str, Any]:
    def zero(p, quant):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return quant(z, cfg.quant_block) if cfg.state_dtype == "int8" else z

    device = leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "m": tree_map(lambda p: zero(p, _quantize), params),
            "v": tree_map(lambda p: zero(p, _quantize_log), params)}


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


@torch.no_grad()
def apply_updates(params: Params, grads: Params, state: Dict[str, Any],
                  cfg: AdamWConfig, lr_scale=1.0):
    """One AdamW step.  Returns ``(params, state, metrics)``: the same
    parameter tensors and fp32 moments, updated in place (int8 moments
    are quantized anew), and metrics ``grad_norm`` and ``lr``."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip_norm / torch.clamp(gnorm, min=1e-9),
                       max=1.0) if cfg.grad_clip_norm > 0 else 1.0
    f32 = dict(dtype=torch.float32, device=step.device)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, **f32), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, **f32), stepf)
    lr = cfg.lr * torch.as_tensor(lr_scale, **f32)
    is_q = cfg.state_dtype == "int8"

    def upd(p, g, m, v):
        g = g.to(torch.float32) * clip
        mf = _dequantize(m, p.shape) if is_q else m
        vf = _dequantize_log(v, p.shape) if is_q else v
        mf.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
        vf.mul_(cfg.b2).add_((1.0 - cfg.b2) * torch.square(g))
        delta = (mf / b1c) / (torch.sqrt(vf / b2c) + cfg.eps)
        pf = p.to(torch.float32)
        if p.dim() >= 2 and cfg.weight_decay > 0:   # decay matrices only
            delta.add_(cfg.weight_decay * pf)
        p.copy_(pf - lr * delta)
        if is_q:
            return _quantize(mf, cfg.quant_block), \
                _quantize_log(vf, cfg.quant_block)
        return mf, vf

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_state = {"step": step,
                 "m": tree_map(lambda _, mv: mv[0], params, out),
                 "v": tree_map(lambda _, mv: mv[1], params, out)}
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, new_state, metrics
