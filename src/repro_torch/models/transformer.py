"""Block stacks of ``repro.models.transformer`` for the ported families.

Layouts (the JAX ones):
  dense  : L × [attn + MLP]
  ssm    : L × [mamba2]
  hybrid : ⌊L/e⌋ super-blocks of (e × mamba2, then one application of a
           shared attn+MLP block) + (L mod e) trailing mamba2 blocks.

Parameters keep the JAX layout: every block leaf is stacked along a
leading layer axis (``[L, ...]``; the hybrid's super-blocks
``[n_super, e, ...]``), so the weight bridge is a plain copy.  The
``lax.scan`` over layers becomes a Python loop over those slices.
Modes: ``train`` (full sequence, no cache), ``prefill`` (one paged chunk,
a whole prompt into a dense cache, or with ``chunked`` one exact-length
chunk resuming a dense staging cache), ``decode`` (one token, paged or
dense) and ``verify`` (the K1 tokens of a speculative block, paged).
Caches and SSM states update in place.  On the serving modes of the ssm
and hybrid families every norm goes through ``ops.rmsnorm`` (the CUDA
kernel on the card); the dense family and the train mode keep
``layers.rms_norm``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention, mamba2
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


def init_mamba_block(gen: torch.Generator, cfg: ModelConfig) -> Params:
    return {"mamba": mamba2.init_mamba2(gen, cfg),
            "norm": init_norm(cfg, gen.device)}


def _hybrid_split(cfg: ModelConfig):
    """(e, n_super, rem): the hybrid's super-block width, count and the
    trailing mamba2 blocks."""
    e = cfg.hybrid_attn_every
    n_super = cfg.num_layers // e
    return e, n_super, cfg.num_layers - n_super * e


def init_stack(gen: torch.Generator, cfg: ModelConfig) -> Params:
    check_ported(cfg)
    final = init_norm(cfg, gen.device)
    if cfg.family == "dense":
        blocks = _stack([init_attn_block(gen, cfg)
                         for _ in range(cfg.num_layers)])
        return {"blocks": blocks, "final_norm": final}
    if cfg.family == "ssm":
        blocks = _stack([init_mamba_block(gen, cfg)
                         for _ in range(cfg.num_layers)])
        return {"blocks": blocks, "final_norm": final}
    e, n_super, rem = _hybrid_split(cfg)
    p = {"super_blocks": _stack([
            _stack([init_mamba_block(gen, cfg) for _ in range(e)])
            for _ in range(n_super)]),
         "shared_attn": init_attn_block(gen, cfg),
         "final_norm": final}
    if rem:
        p["tail_blocks"] = _stack([init_mamba_block(gen, cfg)
                                   for _ in range(rem)])
    return p


def _stack_tree(one: Params, n: int, device) -> Params:
    return {k: torch.zeros((n,) + tuple(a.shape), dtype=a.dtype,
                           device=device) for k, a in one.items()}


def init_paged_cache_tree(cfg: ModelConfig, num_pages: int, page_size: int,
                          dtype=torch.bfloat16, device=None) -> Params:
    """Paged pools stacked along the layer axis (``[L, P, page, H, D]``).
    Only the dense family pages; the stateful ones keep dense slots."""
    check_ported(cfg)
    if cfg.family != "dense":
        raise ValueError(f"paged KV cache unsupported for family "
                         f"{cfg.family!r}")
    device = resolve_device(device)
    one = attention.init_paged_pool(cfg, num_pages, page_size, dtype, "meta")
    return {"attn": _stack_tree(one, cfg.num_layers, device)}


def init_cache_tree(cfg: ModelConfig, batch: int, max_seq: int,
                    dtype=torch.bfloat16, device=None) -> Params:
    """Dense caches stacked along the layer axis: ``attn`` [L, B, S, H, D]
    for the dense family; ``mamba`` states (conv f32 and ssm f32, as the
    JAX ``init_mamba2_state`` makes them) [L, B, ...] for ssm; for the
    hybrid ``mamba`` [n_super, e, B, ...], ``attn`` [n_super, B, S, H, D]
    in ``dtype`` and ``mamba_tail`` [rem, B, ...]."""
    check_ported(cfg)
    device = resolve_device(device)
    if cfg.family == "dense":
        one = attention.init_cache(cfg, batch, max_seq, dtype, "meta")
        return {"attn": _stack_tree(one, cfg.num_layers, device)}
    mstate = mamba2.init_mamba2_state(cfg, batch, device="meta")
    if cfg.family == "ssm":
        return {"mamba": _stack_tree(mstate, cfg.num_layers, device)}
    e, n_super, rem = _hybrid_split(cfg)
    astate = attention.init_cache(cfg, batch, max_seq, dtype, "meta")
    c = {"mamba": _stack_tree(_stack_tree(mstate, e, "meta"), n_super,
                              device),
         "attn": _stack_tree(astate, n_super, device)}
    if rem:
        c["mamba_tail"] = _stack_tree(mstate, rem, device)
    return c


def attn_block(bp: Params, x, cfg: ModelConfig, *, positions, mode: str,
               cache=None, cache_len=None, page_table=None,
               chunked: bool = False, kernel_norm: bool = False):
    """One block; ``cache`` is this layer's page pool when ``page_table``
    is given, else its dense cache (``None`` in train mode).  A
    ``chunked`` prefill resumes the dense cache's prefix."""
    h = apply_norm(bp["norm1"], x, cfg, kernel=kernel_norm)
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
    elif mode == "prefill" and chunked:
        attn_out = attention.prefill_chunk_dense(p, h, cfg, cache, positions,
                                                 cache_len)
    else:
        attn_out = attention.attend(p, h, cfg, positions=positions,
                                    causal=not cfg.encoder_only,
                                    cache=cache)
    if cfg.parallel_block:
        return x + attn_out + apply_mlp(bp["mlp"], h, cfg)
    x = x + attn_out
    h2 = apply_norm(bp["norm2"], x, cfg, kernel=kernel_norm)
    return x + apply_mlp(bp["mlp"], h2, cfg)


def mamba_block(bp: Params, x, cfg: ModelConfig, *, mode: str, state=None,
                kernel_norm: bool = False):
    """One pre-norm Mamba2 block; ``state`` (this layer's views of the
    cache, ``None`` in train mode) is advanced in place."""
    h = apply_norm(bp["norm"], x, cfg, kernel=kernel_norm)
    if mode == "decode":
        out, new = mamba2.decode_step_mamba2(bp["mamba"], h, cfg, state,
                                             kernel_norm=kernel_norm)
    else:
        out, new = mamba2.apply_mamba2(bp["mamba"], h, cfg, state=state,
                                       kernel_norm=kernel_norm)
    if new is not None:
        for k, v in new.items():
            state[k].copy_(v)
    return x + out


def _mamba_blocks(blocks: Params, x, cfg: ModelConfig, *, mode: str,
                  states: Optional[Params], kernel_norm: bool):
    layers = unstack(blocks)
    views = unstack(states) if states is not None else [None] * len(layers)
    for bp, st in zip(layers, views, strict=True):
        x = mamba_block(bp, x, cfg, mode=mode, state=st,
                        kernel_norm=kernel_norm)
    return x


def forward_stack(params: Params, x, cfg: ModelConfig, *, positions,
                  mode: str = "train", caches: Optional[Params] = None,
                  cache_len=None, page_table=None, chunked: bool = False):
    """Returns the final-normed hidden states; pools, caches and states
    update in place.  ``prefill``/``decode``/``verify`` need ``caches``:
    paged pools with a ``page_table`` (dense family only; ``verify`` is
    paged only), else dense caches.  In paged and chunked prefill
    ``cache_len`` carries the post-chunk valid length."""
    if mode not in ("train", "prefill", "decode", "verify"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode != "train" and caches is None:
        raise ValueError(f"mode {mode!r} needs caches")
    if mode == "verify" and page_table is None:
        raise ValueError("verify mode is paged only (speculative decoding)")
    fam = cfg.family
    if page_table is not None and fam != "dense":
        raise ValueError(f"paged attention unsupported for family {fam!r}")
    if mode == "train":
        caches = None
    kn = mode != "train" and fam != "dense"
    kw = dict(positions=positions, mode=mode, cache_len=cache_len,
              kernel_norm=kn)
    if fam == "dense":
        blocks = unstack(params["blocks"])
        pools = unstack(caches["attn"]) if caches else [None] * len(blocks)
        for bp, cache in zip(blocks, pools, strict=True):
            x = attn_block(bp, x, cfg, cache=cache, page_table=page_table,
                           chunked=chunked, **kw)
    elif fam == "ssm":
        x = _mamba_blocks(params["blocks"], x, cfg, mode=mode,
                          states=caches["mamba"] if caches else None,
                          kernel_norm=kn)
    else:
        supers = unstack(params["super_blocks"])
        n = len(supers)
        mstates = unstack(caches["mamba"]) if caches else [None] * n
        acaches = unstack(caches["attn"]) if caches else [None] * n
        for sp, ms, ac in zip(supers, mstates, acaches, strict=True):
            x = _mamba_blocks(sp, x, cfg, mode=mode, states=ms,
                              kernel_norm=kn)
            x = attn_block(params["shared_attn"], x, cfg, cache=ac,
                           chunked=chunked, **kw)
        if "tail_blocks" in params:
            x = _mamba_blocks(params["tail_blocks"], x, cfg, mode=mode,
                              states=caches["mamba_tail"] if caches
                              else None, kernel_norm=kn)
    return apply_norm(params["final_norm"], x, cfg, kernel=kn)
