"""Block stacks of ``repro.models.transformer`` for the ported families.

Layouts (the JAX ones):
  dense / encoder : L × [attn + MLP] (the encoder's attention non-causal;
           with ``parallel_block`` one norm feeds both, x + attn + MLP)
  moe    : n_dense × [attn + MLP of ``first_dense_d_ff``] (DeepSeek's
           leading dense blocks, ``dense_blocks``), then (L − n_dense) ×
           [attn + MoE] (any attention; each layer's load-balancing loss
           summed into the stack's ``aux``)
  ssm    : L × [mamba2]
  hybrid : ⌊L/e⌋ super-blocks of (e × mamba2, then one application of a
           shared attn+MLP block) + (L mod e) trailing mamba2 blocks.

Parameters keep the JAX layout: every block leaf is stacked along a
leading layer axis (``[L, ...]``; the hybrid's super-blocks
``[n_super, e, ...]``), so the weight bridge is a plain copy.  The
``lax.scan`` over layers (``cfg.scan_layers``) stays a Python loop over
those slices, whatever the flag says: eager PyTorch has no scan to trade
compile time against.  In train mode each block runs under ``_remat``,
the JAX ``jax.checkpoint`` policies: ``"full"`` saves only the block's
inputs and recomputes the rest in the backward pass, ``"minimal"``
(``dots_with_no_batch_dims_saveable``) also saves the outputs of the
products without a batch dim (``aten.mm``/``aten.addmm``: the
projections) and recomputes the rest, flash attention included, and
``"none"`` saves everything; the numbers are the same under all three.
``shard`` marks the residual stream's logical dims at the JAX points (a
no-op on the local view the sharded step runs).
Modes: ``train`` (full sequence, no cache), ``prefill`` (one paged chunk,
a whole prompt into a dense cache, or with ``chunked`` one exact-length
chunk resuming a dense staging cache), ``decode`` (one token, paged or
dense) and ``verify`` (the K1 tokens of a speculative block, paged).
Caches and SSM states update in place.  On the serving modes of the ssm
and hybrid families every norm goes through ``ops.rmsnorm`` (the CUDA
kernel on the card); the dense and moe families and the train mode keep
``layers.rms_norm``, and the encoder's LayerNorm is plain PyTorch
everywhere, trained through the JAX custom VJP's backward
(``layers._LayerNorm``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (current_rules, shard,
                                              with_rules)
from repro_torch.models import attention, mamba2, moe
from repro_torch.models.config import ModelConfig, check_ported
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm

Params = Dict[str, Any]


def init_attn_block(gen: torch.Generator, cfg: ModelConfig,
                    d_ff: Optional[int] = None,
                    use_moe: bool = False) -> Params:
    """A parallel block has no ``norm2`` (JAX ``transformer.py:40-49``); a
    moe block has ``moe`` in place of ``mlp``; ``d_ff`` sets the MLP's
    width (DeepSeek's leading dense blocks)."""
    p = {"attn": attention.init_attention(gen, cfg),
         "norm1": init_norm(cfg, gen.device)}
    if not cfg.parallel_block:
        p["norm2"] = init_norm(cfg, gen.device)
    if use_moe:
        p["moe"] = moe.init_moe(gen, cfg)
    else:
        p["mlp"] = init_mlp(gen, cfg, d_ff=d_ff)
    return p


def _stack(trees):
    """Stack per-layer trees leaf by leaf, taking each leaf out of its
    layer's tree as it goes: the layers' copy of a leaf is freed once its
    stack exists, so the peak is one full copy plus one leaf's layers."""
    if isinstance(trees[0], dict):
        return {k: _stack([t.pop(k) for t in trees])
                for k in list(trees[0])}
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
    if cfg.family in ("dense", "encoder"):
        blocks = _stack([init_attn_block(gen, cfg)
                         for _ in range(cfg.num_layers)])
        return {"blocks": blocks, "final_norm": final}
    if cfg.family == "moe":
        nd = cfg.moe.first_dense_layers
        p = {"blocks": _stack([init_attn_block(gen, cfg, use_moe=True)
                               for _ in range(cfg.num_layers - nd)]),
             "final_norm": final}
        if nd:
            p["dense_blocks"] = _stack([
                init_attn_block(gen, cfg, d_ff=cfg.moe.first_dense_d_ff)
                for _ in range(nd)])
        return p
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
    """Paged pools stacked along the layer axis (``[L, P, page, H, D]``):
    ``attn`` for the dense block stack (as in JAX, the encoder's too), and
    for the moe family ``attn`` over the routed blocks and ``attn_dense``
    over the leading dense ones (JAX ``transformer.py:181-197``).  One
    page-table row addresses the same logical pages in every pool.  The
    stateful families keep dense slots."""
    check_ported(cfg)
    if cfg.family not in ("dense", "encoder", "moe"):
        raise ValueError(f"paged KV cache unsupported for family "
                         f"{cfg.family!r}")
    device = resolve_device(device)
    one = attention.init_paged_pool(cfg, num_pages, page_size, dtype, "meta")
    return _layer_stacks(cfg, one, device)


def _layer_stacks(cfg: ModelConfig, one: Params, device) -> Params:
    """``one`` layer's cache stacked for the dense and moe block stacks:
    ``attn`` [L or L - n_dense, ...], and ``attn_dense`` [n_dense, ...]
    beside it for a moe model's leading dense blocks."""
    nd = cfg.moe.first_dense_layers if cfg.family == "moe" else 0
    c = {"attn": _stack_tree(one, cfg.num_layers - nd, device)}
    if nd:
        c["attn_dense"] = _stack_tree(one, nd, device)
    return c


def init_cache_tree(cfg: ModelConfig, batch: int, max_seq: int,
                    dtype=torch.bfloat16, device=None) -> Params:
    """Dense caches stacked along the layer axis: ``attn`` [L, B, S, H, D]
    for the dense and moe families (a ring of ``S =
    attention.cache_capacity`` slots where the config has a window; MLA's
    latent pair ``c_kv``/``k_rope`` [L, B, S, ·]), with ``attn_dense``
    [n_dense, B, S, ·] for a moe model's leading dense blocks, ``attn``
    then holding the moe blocks'; ``mamba`` states (conv f32 and ssm f32,
    as the JAX ``init_mamba2_state`` makes them) [L, B, ...] for ssm (the
    encoder takes the dense family's tree, as in JAX); for the hybrid
    ``mamba`` [n_super, e, B, ...], ``attn`` (the shared block's cache of
    any attention type) [n_super, B, ...] in ``dtype`` and
    ``mamba_tail`` [rem, B, ...]."""
    check_ported(cfg)
    device = resolve_device(device)
    if cfg.family in ("dense", "encoder", "moe"):
        one = attention.init_cache(cfg, batch, max_seq, dtype, "meta")
        return _layer_stacks(cfg, one, device)
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
    """One block → (x, aux); ``cache`` is this layer's page pool when
    ``page_table`` is given, else its dense cache (``None`` in train
    mode).  A ``chunked`` prefill resumes the dense cache's prefix.  A
    parallel block (command-r) adds the attention and the MLP of the same
    normed input to x (JAX ``transformer.py:94-96``).  ``aux`` is a moe
    block's load-balancing loss, ``None`` for an MLP block."""
    x = shard(x, "batch", "act_seq", "embed")
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
    d_ff = cfg.moe.first_dense_d_ff if cfg.family == "moe" else cfg.d_ff
    aux = None
    if cfg.parallel_block:
        x = x + attn_out + apply_mlp(bp["mlp"], h, cfg, d_ff)
    else:
        x = x + attn_out
        h2 = apply_norm(bp["norm2"], x, cfg, kernel=kernel_norm)
        if "moe" in bp:
            ff, aux = moe.apply_moe(bp["moe"], h2, cfg)
        else:
            ff = apply_mlp(bp["mlp"], h2, cfg, d_ff)
        x = x + ff
    return shard(x, "batch", "act_seq", "embed"), aux


def mamba_block(bp: Params, x, cfg: ModelConfig, *, mode: str, state=None,
                kernel_norm: bool = False):
    """One pre-norm Mamba2 block; ``state`` (this layer's views of the
    cache, ``None`` in train mode) is advanced in place."""
    x = shard(x, "batch", "act_seq", "embed")
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


def _save_dots(ctx, op, *args, **kwargs):
    """``"minimal"``'s policy: keep what a product without a batch dim
    returns, recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig, mode: str):
    """``fn`` (one block) under ``cfg.remat_policy`` in train mode (JAX
    ``transformer.py:234-241``); as it is otherwise."""
    if mode != "train" or cfg.remat_policy == "none":
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    kw = {}
    if cfg.remat_policy == "minimal":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    elif cfg.remat_policy != "full":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")

    def run(*args, **kwargs):
        rules = current_rules()

        def block(*a, **k):        # the recompute may run on another thread
            with with_rules(rules):
                return fn(*a, **k)
        return checkpoint(block, *args, use_reentrant=False, **kw, **kwargs)
    return run


def _mamba_blocks(blocks: Params, x, cfg: ModelConfig, *, mode: str,
                  states: Optional[Params], kernel_norm: bool):
    layers = unstack(blocks)
    views = unstack(states) if states is not None else [None] * len(layers)
    block = _remat(mamba_block, cfg, mode)
    for bp, st in zip(layers, views, strict=True):
        x = block(bp, x, cfg, mode=mode, state=st, kernel_norm=kernel_norm)
    return x


def forward_stack(params: Params, x, cfg: ModelConfig, *, positions,
                  mode: str = "train", caches: Optional[Params] = None,
                  cache_len=None, page_table=None, chunked: bool = False):
    """Returns (the final-normed hidden states, aux): ``aux`` the moe
    layers' load-balancing losses summed (f32), ``None`` for the other
    families.  Pools, caches and states update in place.
    ``prefill``/``decode``/``verify`` need ``caches``: paged pools with a
    ``page_table`` (the dense and moe block stacks; ``verify`` is paged
    only), else dense caches.  In paged and chunked prefill ``cache_len``
    carries the post-chunk valid length."""
    if mode not in ("train", "prefill", "decode", "verify"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode != "train" and caches is None:
        raise ValueError(f"mode {mode!r} needs caches")
    if mode == "verify" and page_table is None:
        raise ValueError("verify mode is paged only (speculative decoding)")
    fam = cfg.family
    dense = fam in ("dense", "encoder")
    if page_table is not None and not (dense or fam == "moe"):
        raise ValueError(f"paged attention unsupported for family {fam!r}")
    if mode == "train":
        caches = None
    kn = mode != "train" and fam in ("ssm", "hybrid")
    kw = dict(positions=positions, mode=mode, cache_len=cache_len,
              kernel_norm=kn)
    aux = None
    block = _remat(attn_block, cfg, mode)
    if dense or fam == "moe":
        # DeepSeek's leading dense blocks first, over their own caches
        stacks = [("blocks", "attn")]
        if "dense_blocks" in params:
            stacks.insert(0, ("dense_blocks", "attn_dense"))
        for pkey, ckey in stacks:
            blocks = unstack(params[pkey])
            pools = unstack(caches[ckey]) if caches \
                else [None] * len(blocks)
            for bp, cache in zip(blocks, pools, strict=True):
                x, a = block(bp, x, cfg, cache=cache, page_table=page_table,
                             chunked=chunked, **kw)
                if a is not None:
                    aux = a if aux is None else aux + a
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
            x, _ = block(params["shared_attn"], x, cfg, cache=ac,
                         chunked=chunked, **kw)
        if "tail_blocks" in params:
            x = _mamba_blocks(params["tail_blocks"], x, cfg, mode=mode,
                              states=caches["mamba_tail"] if caches
                              else None, kernel_norm=kn)
    return apply_norm(params["final_norm"], x, cfg, kernel=kn), aux
