"""Dense decoder stack: the ``repro.models.transformer`` dense family.

Parameters keep the JAX layout: every block leaf is stacked along a
leading layer axis (``[L, ...]``), so the weight bridge is a plain copy.
The ``lax.scan`` over layers becomes a Python loop over those slices.
Modes: ``train`` (full sequence, no cache), ``prefill`` (one paged chunk)
and ``decode`` (one paged token).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention
from repro_torch.models.config import ModelConfig, check_ported
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm

Params = Dict[str, Any]


def init_attn_block(gen: torch.Generator, cfg: ModelConfig) -> Params:
    p = {"attn": attention.init_attention(gen, cfg),
         "norm1": init_norm(cfg, gen.device)}
    if not cfg.parallel_block:
        p["norm2"] = init_norm(cfg, gen.device)
    p["mlp"] = init_mlp(gen, cfg)
    return p


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def layer(tree, i: int):
    """Layer ``i``'s slice of a stacked tree (views: writes go through)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def init_stack(gen: torch.Generator, cfg: ModelConfig) -> Params:
    check_ported(cfg)
    blocks = _stack([init_attn_block(gen, cfg)
                     for _ in range(cfg.num_layers)])
    return {"blocks": blocks, "final_norm": init_norm(cfg, gen.device)}


def init_paged_cache_tree(cfg: ModelConfig, num_pages: int, page_size: int,
                          dtype=torch.bfloat16, device=None) -> Params:
    """Paged pools stacked along the layer axis (``[L, P, page, H, D]``)."""
    check_ported(cfg)
    device = resolve_device(device)
    one = attention.init_paged_pool(cfg, num_pages, page_size, dtype, device)
    return {"attn": {k: torch.zeros((cfg.num_layers,) + tuple(a.shape),
                                    dtype=a.dtype, device=device)
                     for k, a in one.items()}}


def attn_block(bp: Params, x, cfg: ModelConfig, *, positions, mode: str,
               pool=None, cache_len=None, page_table=None):
    h = apply_norm(bp["norm1"], x, cfg)
    if mode == "decode":
        attn_out = attention.decode_step_paged(bp["attn"], h, cfg, pool,
                                               page_table, cache_len)
    elif mode == "prefill":
        attn_out = attention.prefill_chunk_paged(bp["attn"], h, cfg, pool,
                                                 page_table, positions,
                                                 cache_len)
    else:
        attn_out = attention.attend(bp["attn"], h, cfg, positions=positions,
                                    causal=not cfg.encoder_only)
    if cfg.parallel_block:
        return x + attn_out + apply_mlp(bp["mlp"], h, cfg)
    x = x + attn_out
    return x + apply_mlp(bp["mlp"], apply_norm(bp["norm2"], x, cfg), cfg)


def forward_stack(params: Params, x, cfg: ModelConfig, *, positions,
                  mode: str = "train", caches: Optional[Params] = None,
                  cache_len=None, page_table=None):
    """Returns the final-normed hidden states; paged pools update in place.
    ``prefill``/``decode`` need ``caches`` and ``page_table``; in prefill
    ``cache_len`` carries the post-chunk valid length."""
    if mode not in ("train", "prefill", "decode"):
        raise NotImplementedError(
            f"mode {mode!r}: the verify mode comes with speculative "
            "decoding (ROADMAP Queue A item 8)")
    if mode != "train" and (caches is None or page_table is None):
        raise NotImplementedError(
            "only the paged data plane is ported; dense slot caches are "
            "ROADMAP Queue A item 11")
    blocks = params["blocks"]
    n = next(iter(blocks["norm1"].values())).shape[0]
    for i in range(n):
        pool = layer(caches["attn"], i) if mode != "train" else None
        x = attn_block(layer(blocks, i), x, cfg, positions=positions,
                       mode=mode, pool=pool, cache_len=cache_len,
                       page_table=page_table)
    return apply_norm(params["final_norm"], x, cfg)
