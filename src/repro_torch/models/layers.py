"""Shared layers: norms, rotary embeddings, MLP variants, initializers.

Counterpart of ``repro.models.layers``.  ``init_*`` returns a nested dict
of tensors with the JAX leaf names; apply functions take (params, inputs,
cfg).  The forward numerics follow the JAX functions step by step,
including where each product is rounded to the compute dtype.  RMSNorm's
gradient comes from autograd: the JAX custom VJP
(``src/repro/models/layers.py:71``) is the same math, rounded to bf16 at
other points in a bf16 backward; in fp32 the two agree
(``tests/test_torch_train.py``).  LayerNorm (the encoders') is a
``torch.autograd.Function`` whose backward follows the JAX custom VJP
``_layernorm_bwd`` (``layers.py:120-137``) rounding for rounding; no
Pallas kernel computes it in either package, so it is plain PyTorch on
the card too.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import spmd
from repro_torch.kernels import ops, ref
from repro_torch.models.config import ModelConfig

# leaves the JAX package keeps in float32 whatever the parameter dtype:
# Mamba2's timestep bias, decay and skip (``mamba2.py:43-45``) and the MoE
# router (``moe.py:50``), whose logits are f32 products
F32_LEAVES = frozenset({"dt_bias", "a_log", "d_skip", "router"})


# ---------------------------------------------------------------------------
# initializers (same distributions as the JAX package; different numbers)
# ---------------------------------------------------------------------------

class MetaGenerator:
    """A generator stand-in whose draws are ``meta`` tensors: ``init``
    given one builds the abstract parameter tree (shapes and dtypes, no
    storage), which the sharding specs are resolved on."""
    device = torch.device("meta")


def randn(gen, shape) -> torch.Tensor:
    """f32 N(0, 1) draws on the generator's device (``meta``: none)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)


def rand(gen, shape) -> torch.Tensor:
    """f32 U[0, 1) draws on the generator's device (``meta``: none)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.rand(shape, generator=gen, dtype=torch.float32,
                      device=gen.device)


def dense_init(gen: torch.Generator, shape, dtype, fan_in: Optional[int] = None):
    """N(0, 1/fan_in) drawn in f32 and scaled in place (one f32 copy of
    the leaf at a time: nemotron-4-340b's head is 18.9 GB of it), then
    cast to ``dtype``."""
    fan = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan, 1))
    return randn(gen, shape).mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype):
    return randn(gen, shape).mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, device, dim: Optional[int] = None):
    d = dim or cfg.d_model
    p = {"scale": torch.ones((d,), dtype=cfg.pdtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=cfg.pdtype, device=device)
    return p


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 mean of squares and rsqrt, then the products in ``x.dtype``:
    ``x * inv.to(dt) * scale.to(dt)`` (``layers.py:_rmsnorm_fwd``), the
    plain version of the RMSNorm kernel, differentiable by autograd."""
    return ref.rmsnorm(x, scale, eps)


def rms_norm_simple(x, scale, eps: float = 1e-6, *, kernel: bool = False):
    """Bare rmsnorm (the Mamba2 out-norm).  ``kernel`` sends it through
    ``ops.rmsnorm``, the CUDA kernel on the card (forward only): the
    serving path of the SSM families takes it, every training forward and
    the dense family keep ``rms_norm``."""
    if kernel:
        return ops.rmsnorm(x, scale, eps=eps)
    return rms_norm(x, scale, eps)


def _layer_norm_fwd(x, scale, bias, eps):
    """The JAX ``_layernorm_fwd`` (``layers.py:110-117``): the mean and
    the mean of squares in f32, ``var = ms - mean²`` and its rsqrt in f32,
    then ``xhat = (x - mean) * inv`` and ``xhat * scale + bias`` in
    ``x.dtype``, each f32 factor rounded to it first.  Returns ``y`` and
    the f32 ``mean`` and ``inv`` [..., 1] the backward reads."""
    dt = x.dtype
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    inv = torch.rsqrt(ms - torch.square(mean) + eps)
    xhat = (x - mean.to(dt)) * inv.to(dt)
    return xhat * scale.to(dt) + bias.to(dt), mean, inv


class _LayerNorm(torch.autograd.Function):
    """LayerNorm with the JAX custom VJP's backward (``_layernorm_bwd``,
    ``layers.py:120-137``): ``xhat``, ``gs = g·scale`` and ``dx`` in the
    compute dtype; ``m1 = Σ gs / d`` and ``m2 = Σ gs·xhat / d`` as f32
    sums over d, each rounded to it before use; ``dscale = Σ g·xhat`` and
    ``dbias = Σ g`` as f32 sums over every leading axis, in the parameter
    dtype."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, mean, inv = _layer_norm_fwd(x, scale, bias, eps)
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.bias_dtype = bias.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, mean, inv = ctx.saved_tensors
        dt, d = x.dtype, x.shape[-1]
        xhat = (x - mean.to(dt)) * inv.to(dt)
        gs = g * scale.to(dt)
        m1 = gs.float().sum(-1, keepdim=True) / d
        m2 = (gs.float() * xhat.float()).sum(-1, keepdim=True) / d
        dx = (gs - m1.to(dt) - xhat * m2.to(dt)) * inv.to(dt)
        lead = tuple(range(g.dim() - 1))
        dscale = (g.float() * xhat.float()).sum(lead).to(scale.dtype)
        dbias = g.float().sum(lead).to(ctx.bias_dtype)
        return dx, dscale, dbias, None


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with the JAX package's rounding in
    both passes (``_layer_norm_fwd``, ``_LayerNorm``).  No Pallas kernel
    computes it, so it stays plain PyTorch on the card too."""
    return _LayerNorm.apply(x, scale, bias, eps)


def apply_norm(p, x, cfg: ModelConfig, *, kernel: bool = False):
    """``cfg.norm``: LayerNorm (plain on both devices, its backward the
    JAX custom VJP's), or RMSNorm, with ``kernel`` through the CUDA
    kernel on the card."""
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm_simple(x, p["scale"], cfg.norm_eps, kernel=kernel)


# ---------------------------------------------------------------------------
# rotary position embeddings (half-split, f32 angles)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs          # [..., seq, half]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen, cfg: ModelConfig, d_ff: Optional[int] = None):
    d, dff = cfg.d_model, (d_ff or cfg.d_ff)
    dt = cfg.pdtype
    if cfg.activation in ("swiglu", "geglu"):
        p = {
            "w_gate": dense_init(gen, (d, dff), dt),
            "w_up": dense_init(gen, (d, dff), dt),
            "w_down": dense_init(gen, (dff, d), dt, fan_in=dff),
        }
    else:  # relu2 | gelu — plain 2-matrix MLP
        p = {
            "w_up": dense_init(gen, (d, dff), dt),
            "w_down": dense_init(gen, (dff, d), dt, fan_in=dff),
        }
    if cfg.mlp_bias:
        p["b_up"] = torch.zeros((dff,), dtype=dt, device=gen.device)
        p["b_down"] = torch.zeros((d,), dtype=dt, device=gen.device)
    return p


def apply_mlp(p, x, cfg: ModelConfig, d_ff: Optional[int] = None):
    """``d_ff``: the MLP's global width (``cfg.d_ff`` by default).  Under
    a mesh whose rules shard ``ffn`` over ``model`` the leaves are this
    rank's columns (rows of ``w_down``): the input enters through
    ``spmd.copy_to`` and the partial output is summed over the axis
    before ``b_down``."""
    dt = cfg.cdtype
    group = spmd.model_split("ffn", d_ff or cfg.d_ff)[0]
    x = spmd.copy_to(x.to(dt), group)
    if cfg.activation == "swiglu":
        h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
    elif cfg.activation == "geglu":
        h = F.gelu(x @ p["w_gate"].to(dt), approximate="tanh") * (
            x @ p["w_up"].to(dt))
    elif cfg.activation == "relu2":
        h = torch.square(F.relu(x @ p["w_up"].to(dt)))
    elif cfg.activation == "gelu":
        h = F.gelu(x @ p["w_up"].to(dt), approximate="tanh")
    else:
        raise ValueError(cfg.activation)
    if "b_up" in p:
        h = h + p["b_up"].to(dt)
    out = spmd.reduce_from(h @ p["w_down"].to(dt), group)
    if "b_down" in p:
        out = out + p["b_down"].to(dt)
    return out


# ---------------------------------------------------------------------------
# embeddings / heads
# ---------------------------------------------------------------------------

def init_embedding(gen, cfg: ModelConfig):
    return {"embedding": embed_init(gen, (cfg.vocab_size, cfg.d_model),
                                    cfg.pdtype)}


def apply_embedding(p, tokens, cfg: ModelConfig):
    """The rows of ``tokens``.  Under a vocabulary sharded over ``model``
    each rank holds ``V / tp`` rows: it looks up the tokens in its range,
    zeros the rest, and the ranks' rows are summed."""
    group, _, r = spmd.model_split("vocab", cfg.vocab_size)
    if group is None:
        x = p["embedding"][tokens]
    else:
        emb = p["embedding"]
        t = tokens - r * emb.shape[0]
        ok = (t >= 0) & (t < emb.shape[0])
        rows = emb[torch.clamp(t, 0, emb.shape[0] - 1)]
        x = spmd.reduce_from(torch.where(ok[..., None], rows,
                                         torch.zeros_like(rows)), group)
    x = x.to(cfg.cdtype)
    if cfg.embed_scale:
        # the scale is rounded to the compute dtype first, as in JAX
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.cdtype,
                             device=x.device)
    return x


def apply_lm_head(embed_params, head_params, x, cfg: ModelConfig):
    """Logits [..., V]; under a vocabulary sharded over ``model`` this
    rank's ``V / tp`` columns of them (``Model.loss`` reduces over the
    axis)."""
    dt = cfg.cdtype
    x = spmd.copy_to(x, spmd.model_split("vocab", cfg.vocab_size)[0])
    if cfg.tie_embeddings or head_params is None:
        logits = x @ embed_params["embedding"].to(dt).T
    else:
        logits = x @ head_params["w_head"].to(dt)
    if cfg.final_logit_softcap > 0.0:
        c = cfg.final_logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


def init_lm_head(gen, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return None
    return {"w_head": dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                 cfg.pdtype)}
