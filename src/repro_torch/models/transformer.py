"""Dense decoder stack: the ``repro.models.transformer`` dense family.

Parameters keep the JAX layout: every block leaf is stacked along a
leading layer axis (``[L, ...]``), so the weight bridge is a plain copy.
The ``lax.scan`` over layers becomes a Python loop over those slices.
Modes: ``train`` (full sequence, no cache), ``prefill`` (one paged chunk,
or a whole prompt into a dense cache), ``decode`` (one token, paged or
dense) and ``verify`` (the K1 tokens of a speculative block, paged).
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


def unstack(tree) -> list:
    """Every layer's slice of a stacked tree, by one ``unbind`` per leaf
    (views: writes go through).  Under autograd its backward stacks the
    layers' gradients once; indexing layer by layer would instead add a
    full-size zero tensor per layer into each stacked leaf's gradient."""
    if isinstance(tree, dict):
        parts = {k: unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    return tree.unbind(0)


def init_stack(gen: torch.Generator, cfg: ModelConfig) -> Params:
    check_ported(cfg)
    blocks = _stack([init_attn_block(gen, cfg)
                     for _ in range(cfg.num_layers)])
    return {"blocks": blocks, "final_norm": init_norm(cfg, gen.device)}


def _stack_tree(one: Params, n: int, device) -> Params:
    return {k: torch.zeros((n,) + tuple(a.shape), dtype=a.dtype,
                           device=device) for k, a in one.items()}


def init_paged_cache_tree(cfg: ModelConfig, num_pages: int, page_size: int,
                          dtype=torch.bfloat16, device=None) -> Params:
    """Paged pools stacked along the layer axis (``[L, P, page, H, D]``)."""
    check_ported(cfg)
    device = resolve_device(device)
    one = attention.init_paged_pool(cfg, num_pages, page_size, dtype, "meta")
    return {"attn": _stack_tree(one, cfg.num_layers, device)}


def init_cache_tree(cfg: ModelConfig, batch: int, max_seq: int,
                    dtype=torch.bfloat16, device=None) -> Params:
    """Dense caches stacked along the layer axis (``[L, B, S, H, D]``)."""
    check_ported(cfg)
    device = resolve_device(device)
    one = attention.init_cache(cfg, batch, max_seq, dtype, "meta")
    return {"attn": _stack_tree(one, cfg.num_layers, device)}


def attn_block(bp: Params, x, cfg: ModelConfig, *, positions, mode: str,
               cache=None, cache_len=None, page_table=None):
    """One block; ``cache`` is this layer's page pool when ``page_table``
    is given, else its dense cache (``None`` in train mode)."""
    h = apply_norm(bp["norm1"], x, cfg)
    p = bp["attn"]
    if mode == "verify":
        attn_out = attention.verify_step_paged(p, h, cfg, cache, page_table,
                                               cache_len)
    elif mode == "decode" and page_table is not None:
        attn_out = attention.decode_step_paged(p, h, cfg, cache, page_table,
                                               cache_len)
    elif mode == "decode":
        attn_out = attention.decode_step(p, h, cfg, cache, cache_len)
    elif mode == "prefill" and page_table is not None:
        attn_out = attention.prefill_chunk_paged(p, h, cfg, cache,
                                                 page_table, positions,
                                                 cache_len)
    else:
        attn_out = attention.attend(p, h, cfg, positions=positions,
                                    causal=not cfg.encoder_only,
                                    cache=cache)
    if cfg.parallel_block:
        return x + attn_out + apply_mlp(bp["mlp"], h, cfg)
    x = x + attn_out
    return x + apply_mlp(bp["mlp"], apply_norm(bp["norm2"], x, cfg), cfg)


def forward_stack(params: Params, x, cfg: ModelConfig, *, positions,
                  mode: str = "train", caches: Optional[Params] = None,
                  cache_len=None, page_table=None):
    """Returns the final-normed hidden states; pools and caches update in
    place.  ``prefill``/``decode``/``verify`` need ``caches``: paged pools
    with a ``page_table`` (``verify`` is paged only), else dense caches.
    In paged prefill ``cache_len`` carries the post-chunk valid length."""
    if mode not in ("train", "prefill", "decode", "verify"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode != "train" and caches is None:
        raise ValueError(f"mode {mode!r} needs caches")
    if mode == "verify" and page_table is None:
        raise ValueError("verify mode is paged only (speculative decoding)")
    blocks = unstack(params["blocks"])
    pools = unstack(caches["attn"]) if mode != "train" else [None] * len(blocks)
    for bp, cache in zip(blocks, pools, strict=True):
        x = attn_block(bp, x, cfg, positions=positions,
                       mode=mode, cache=cache, cache_len=cache_len,
                       page_table=page_table)
    return apply_norm(params["final_norm"], x, cfg)
