"""Shared layers: norms, rotary embeddings, MLP variants, initializers.

Counterpart of ``repro.models.layers``.  ``init_*`` returns a nested dict
of tensors with the JAX leaf names; apply functions take (params, inputs,
cfg).  The forward numerics follow the JAX functions step by step,
including where each product is rounded to the compute dtype.  Gradients
come from autograd: the JAX norm's custom VJP
(``src/repro/models/layers.py:71``) is the same math, rounded to bf16 at
other points in a bf16 backward; in fp32 the two agree
(``tests/test_torch_train.py``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.models.config import ModelConfig


# ---------------------------------------------------------------------------
# initializers (same distributions as the JAX package; different numbers)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype, fan_in: Optional[int] = None):
    fan = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan, 1))
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype):
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, device, dim: Optional[int] = None):
    return {"scale": torch.ones((dim or cfg.d_model,), dtype=cfg.pdtype,
                                device=device)}


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


def apply_norm(p, x, cfg: ModelConfig, *, kernel: bool = False):
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


def apply_mlp(p, x, cfg: ModelConfig):
    dt = cfg.cdtype
    x = x.to(dt)
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
    out = h @ p["w_down"].to(dt)
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
    x = p["embedding"][tokens].to(cfg.cdtype)
    if cfg.embed_scale:
        # the scale is rounded to the compute dtype first, as in JAX
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.cdtype,
                             device=x.device)
    return x


def apply_lm_head(embed_params, head_params, x, cfg: ModelConfig):
    dt = cfg.cdtype
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
