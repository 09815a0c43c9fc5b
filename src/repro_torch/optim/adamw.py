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
each at once.  On a mesh (``placement``) each rank steps its shards: fp32
moments share their parameter's spec, so the update is elementwise on the
shard; int8 moments are blocked over the whole flattened leaf and their
block axis is sharded on its own (``launch.programs.opt_state
_shardings``), so a rank gathers the leaf and its gradient, steps its
rows of blocks and the ranks gather the stepped rows back.
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


# int8 moments are dequantized, stepped and quantized again in chunks of
# whole quantization blocks, so that a leaf's f32 temporaries never pass
# this many elements: a deepseek-v2-236b expert leaf holds 1.26 G, whose
# update whole would hold some 40 GB of them
_CHUNK = 1 << 26


def _adam_step(p, ndim: int, g, mf, vf, cfg: AdamWConfig, b1c, b2c, lr):
    """The moments ``mf``, ``vf`` (f32) and the parameter ``p`` (a leaf,
    or a chunk of one whose leaf has ``ndim`` dimensions) stepped in
    place by the clipped gradient ``g``."""
    mf.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
    vf.mul_(cfg.b2).add_((1.0 - cfg.b2) * torch.square(g))
    delta = (mf / b1c) / (torch.sqrt(vf / b2c) + cfg.eps)
    pf = p.to(torch.float32)
    if ndim >= 2 and cfg.weight_decay > 0:      # decay matrices only
        delta.add_(cfg.weight_decay * pf)
    p.copy_(pf - lr * delta)


def _step_int8(p, g, m: QuantMoment, v: QuantMoment, cfg: AdamWConfig,
               clip, b1c, b2c, lr, ndim=None) -> Tuple[QuantMoment,
                                                       QuantMoment]:
    """One leaf's step with int8 moments, ``_CHUNK`` elements at a time:
    every op is elementwise or within a quantization block, so the
    numbers are those of the whole leaf at once.  ``p`` may be the flat
    run of a leaf of ``ndim`` dimensions that ``m``'s blocks cover."""
    block, n = cfg.quant_block, p.numel()
    ndim = p.dim() if ndim is None else ndim
    rows, step = m.q.shape[0], max(_CHUNK // cfg.quant_block, 1)
    flat, gflat = p.view(-1), g.reshape(-1)
    out_m = QuantMoment(torch.empty_like(m.q), torch.empty_like(m.scale))
    out_v = QuantMoment(torch.empty_like(v.q), torch.empty_like(v.scale))
    for r0 in range(0, rows, step):
        r1 = min(r0 + step, rows)
        e0, e1 = r0 * block, min(r1 * block, n)
        shape = (e1 - e0,)
        mf = _dequantize(QuantMoment(m.q[r0:r1], m.scale[r0:r1]), shape)
        vf = _dequantize_log(QuantMoment(v.q[r0:r1], v.scale[r0:r1]),
                             shape)
        _adam_step(flat[e0:e1], ndim,
                   gflat[e0:e1].to(torch.float32) * clip, mf, vf, cfg,
                   b1c, b2c, lr)
        for out, qm in ((out_m, _quantize(mf, block)),
                        (out_v, _quantize_log(vf, block))):
            out.q[r0:r1] = qm.q
            out.scale[r0:r1] = qm.scale
    return out_m, out_v


def _step_int8_sharded(p, g, m: QuantMoment, v: QuantMoment,
                       cfg: AdamWConfig, clip, b1c, b2c, lr, placement):
    """``_step_int8`` of one leaf on a mesh: ``p`` and ``g`` are this
    rank's shards (``pspec``), ``m`` and ``v`` its rows of the whole
    leaf's blocks (``mspec``).  The leaf and its gradient are gathered,
    this rank's rows stepped, and the stepped rows gathered back."""
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import spec_axes

    comm, pspec, mspec = placement
    whole = spmd.gather_of(p, pspec, comm)
    gwhole = spmd.gather_of(g, pspec, comm)
    block, n, rows = cfg.quant_block, whole.numel(), m.q.shape[0]
    axes = spec_axes(mspec[0]) if mspec and mspec[0] is not None else ()
    e0 = comm.index(axes) * rows * block
    e1 = min(e0 + rows * block, n)
    piece = whole.reshape(-1)[e0:e1].clone()
    out = _step_int8(piece, gwhole.reshape(-1)[e0:e1], m, v, cfg, clip,
                     b1c, b2c, lr, ndim=whole.dim())
    piece = torch.nn.functional.pad(piece, (0, rows * block - piece.numel()))
    flat = spmd.all_gather_dim(piece, 0, comm.group(axes))[:n]
    p.copy_(spmd.shard_of(flat.reshape(whole.shape), pspec, comm))
    return out


@torch.no_grad()
def apply_updates(params: Params, grads: Params, state: Dict[str, Any],
                  cfg: AdamWConfig, lr_scale=1.0, *, gnorm=None,
                  placement=None):
    """One AdamW step.  Returns ``(params, state, metrics)``: the same
    parameter tensors and fp32 moments, updated in place (int8 moments
    are quantized anew, chunk by chunk), and metrics ``grad_norm`` and
    ``lr``.  ``gnorm``: the gradients' global norm, where the caller has
    it (a sharded step reduces it over the mesh).  ``placement``: ``(comm,
    parameter specs, moment specs)`` in leaf order, for a step on a mesh
    of more than one rank (``_step_int8_sharded``)."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    specs = iter(zip(*placement[1:])) if placement is not None else None
    clip = torch.clamp(cfg.grad_clip_norm / torch.clamp(gnorm, min=1e-9),
                       max=1.0) if cfg.grad_clip_norm > 0 else 1.0
    f32 = dict(dtype=torch.float32, device=step.device)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, **f32), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, **f32), stepf)
    lr = cfg.lr * torch.as_tensor(lr_scale, **f32)

    def upd(p, g, m, v):
        if cfg.state_dtype == "int8" and specs is not None:
            return _step_int8_sharded(p, g, m, v, cfg, clip, b1c, b2c, lr,
                                      (placement[0], *next(specs)))
        if cfg.state_dtype == "int8":
            return _step_int8(p, g, m, v, cfg, clip, b1c, b2c, lr)
        _adam_step(p, p.dim(), g.to(torch.float32) * clip, m, v, cfg, b1c,
                   b2c, lr)
        return m, v

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_state = {"step": step,
                 "m": tree_map(lambda _, mv: mv[0], params, out),
                 "v": tree_map(lambda _, mv: mv[1], params, out)}
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, new_state, metrics
