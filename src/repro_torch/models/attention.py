"""Full attention: the serving path of ``repro.models.attention``.

Layouts are the JAX package's: projections ``w_q [d, H, hd]``,
``w_k``/``w_v [d, Hkv, hd]``, ``w_o [H, hd, d]``; pools
``[P, page, Hkv, D]`` and dense caches ``[B, S, Hkv, D]`` per layer.
Pools and caches are device tensors written in place (the JAX functions
return a new pool or cache and donate the old one; the effect is the
same).  Page 0 of every pool is the allocator's trash page.  The dense
cache serves the speculative draft model and the dense slot plane (with
its staging cache for chunked prefill); MLA and sliding-window attention
are not ported.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import gather_pages
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init

Pool = Dict[str, torch.Tensor]


def init_attention(gen: torch.Generator, cfg: ModelConfig):
    d, hd = cfg.d_model, cfg.head_dim_
    dt = cfg.pdtype
    return {
        "w_q": dense_init(gen, (d, cfg.num_heads, hd), dt),
        "w_k": dense_init(gen, (d, cfg.num_kv_heads, hd), dt),
        "w_v": dense_init(gen, (d, cfg.num_kv_heads, hd), dt),
        "w_o": dense_init(gen, (cfg.num_heads, hd, d), dt,
                          fan_in=cfg.num_heads * hd),
    }


def init_paged_pool(cfg: ModelConfig, num_pages: int, page_size: int,
                    dtype=torch.bfloat16, device=None) -> Pool:
    """Per-layer paged KV pool, zero-filled (a stale row must be a finite
    number; ``torch.empty`` could hold NaN bit patterns).  ``torch.int8``
    adds the per-token f32 scale planes ``k_scale``/``v_scale``."""
    if cfg.attn_type != "full":
        raise NotImplementedError(f"paged pools need full attention, got "
                                  f"{cfg.attn_type!r} (ROADMAP Queue A "
                                  f"item 11)")
    device = resolve_device(device)
    shape = (num_pages, page_size, cfg.num_kv_heads, cfg.head_dim_)
    pool = {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        pool["k_scale"] = torch.zeros(shape[:3], dtype=torch.float32,
                                      device=device)
        pool["v_scale"] = torch.zeros(shape[:3], dtype=torch.float32,
                                      device=device)
    return pool


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> Pool:
    """Per-layer dense cache ``[batch, max_seq, Hkv, D]``, zero-filled.
    Full attention only: the sliding-window ring of the JAX cache comes
    with the SWA slice."""
    if cfg.attn_type != "full" or cfg.sliding_window > 0:
        raise NotImplementedError(f"dense caches need full attention, got "
                                  f"{cfg.attn_type!r} (ROADMAP Queue A "
                                  f"item 11)")
    device = resolve_device(device)
    shape = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------

def _proj(x, w, dt):
    """einsum("btd,dhk->bthk") as one matmul over the flattened heads."""
    d, H, hd = w.shape
    return (x @ w.to(dt).reshape(d, H * hd)).unflatten(-1, (H, hd))


def _qkv(params, x, cfg: ModelConfig, positions):
    dt = cfg.cdtype
    q = _proj(x, params["w_q"], dt)
    k = _proj(x, params["w_k"], dt)
    v = _proj(x, params["w_v"], dt)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(params, o, cfg: ModelConfig):
    """einsum("bthk,hkd->btd")."""
    H, hd, d = params["w_o"].shape
    return o.flatten(-2) @ params["w_o"].to(cfg.cdtype).reshape(H * hd, d)


# ---------------------------------------------------------------------------
# full-sequence attention (train / prefill)
# ---------------------------------------------------------------------------

def attend(params, x, cfg: ModelConfig, *, positions, causal: bool = True,
           cache: Optional[Pool] = None):
    """[B, T, d] → [B, T, d] over the sequence itself; with ``cache`` (the
    dense prefill) the sequence's KV is also written into it."""
    x = x.to(cfg.cdtype)
    q, k, v = _qkv(params, x, cfg, positions)
    o = ops.flash_attention(q, k, v, causal=causal, window=0,
                            softcap=cfg.attn_logit_softcap,
                            q_positions=positions, kv_positions=positions)
    if cache is not None:
        _fill_cache(cache, k, v, positions)
    return _out_proj(params, o, cfg)


def _fill_cache(cache: Pool, k, v, positions):
    """Write KV [B, T, H, D] into the dense cache at ``positions % S``, in
    place.  With full attention the wrap is reached only by a free draft
    slot whose stale length sits at ``max_seq`` (a request that filled
    its cache in a speculative round): its masked rewrite lands on slot 0,
    which the next request's prefill overwrites."""
    S = cache["k"].shape[1]
    slots = positions.long() % S                          # [B, T]
    bidx = torch.arange(k.shape[0], device=k.device)[:, None]
    cache["k"][bidx, slots] = k.to(cache["k"].dtype)
    cache["v"][bidx, slots] = v.to(cache["v"].dtype)


# ---------------------------------------------------------------------------
# paged / chunked prefill + decode
# ---------------------------------------------------------------------------

def _quantize(x: torch.Tensor):
    """Per-token symmetric int8 over the head dim: ``scale = amax/127``
    (at least 1e-8), round half to even, clip to ±127."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def _page_scatter(pool: Pool, k, v, page_table, positions, valid_len):
    """Write chunk KV [B, T, H, D] into the pool at the positions' pages,
    in place.  Padded tokens (``positions >= valid_len``) and positions past
    the table's span go to physical page 0, the trash page; the logical
    page is clamped to ``MP - 1`` first, so no index is ever out of range
    (a CUDA ``index_put_`` would fault where JAX's ``.at[].set`` drops)."""
    ps = pool["k"].shape[1]
    MP = page_table.shape[1]
    positions = positions.long()
    lpage_raw = positions // ps
    lpage = torch.clamp(lpage_raw, max=MP - 1)
    valid = (positions < valid_len.long()[:, None]) & (lpage_raw < MP)
    pids = torch.where(valid, torch.gather(page_table.long(), 1, lpage), 0)
    offs = torch.where(valid, positions % ps, 0)
    if "k_scale" in pool:
        kq, ks = _quantize(k)
        vq, vs = _quantize(v)
        pool["k"][pids, offs] = kq
        pool["v"][pids, offs] = vq
        pool["k_scale"][pids, offs] = ks
        pool["v_scale"][pids, offs] = vs
        return
    pool["k"][pids, offs] = k.to(pool["k"].dtype)
    pool["v"][pids, offs] = v.to(pool["v"].dtype)


def prefill_chunk_paged(params, x, cfg: ModelConfig, pool: Pool, page_table,
                        positions, new_len):
    """One prefill chunk against a paged pool: scatter the chunk's KV into
    the request's pages, then attend the chunk's queries over the whole
    cached prefix gathered through the table.  ``new_len`` [B] = tokens
    valid after this chunk.  Returns out [B, T, d]; the pool is updated."""
    dt = cfg.cdtype
    x = x.to(dt)
    q, k, v = _qkv(params, x, cfg, positions)
    _page_scatter(pool, k, v, page_table, positions, new_len)
    kd = gather_pages(pool["k"], page_table)              # [B, MP*ps, H, D]
    vd = gather_pages(pool["v"], page_table)
    if "k_scale" in pool:
        kd = kd.float() * gather_pages(pool["k_scale"], page_table)[..., None]
        vd = vd.float() * gather_pages(pool["v_scale"], page_table)[..., None]
        kd, vd = kd.to(dt), vd.to(dt)
    # key positions are the gathered indices (kv_positions=None)
    o = ops.flash_attention(q, kd, vd, causal=True, window=0,
                            softcap=cfg.attn_logit_softcap,
                            q_positions=positions, kv_valid_len=new_len)
    return _out_proj(params, o, cfg)


def prefill_chunk_dense(params, x, cfg: ModelConfig, cache: Pool, positions,
                        new_len):
    """One exact-length prefill chunk into a dense cache (the stateful
    families' staging cache): write the chunk's KV at its positions, then
    attend the chunk's queries over the cache prefix and the chunk, keys
    valid below ``new_len``.  The key positions are the cache indices
    (``kv_positions=None``), so the flash kernel stops its key loop at the
    last key a query tile sees.  Returns out [B, T, d]; the cache is
    updated."""
    x = x.to(cfg.cdtype)
    q, k, v = _qkv(params, x, cfg, positions)
    _fill_cache(cache, k, v, positions)
    o = ops.flash_attention(q, cache["k"], cache["v"], causal=True, window=0,
                            softcap=cfg.attn_logit_softcap,
                            q_positions=positions, kv_valid_len=new_len)
    return _out_proj(params, o, cfg)


def decode_step_paged(params, x, cfg: ModelConfig, pool: Pool, page_table,
                      cache_len):
    """Single-token decode: append the token's KV at ``cache_len`` through
    the table, then run the paged decode kernel.  Rows with an all-zero
    table row write to and read from the trash page, harmlessly."""
    x = x.to(cfg.cdtype)
    positions = cache_len[:, None]
    q, k, v = _qkv(params, x, cfg, positions)
    _page_scatter(pool, k, v, page_table, positions, cache_len + 1)
    o = ops.paged_decode_attention(
        q[:, 0], pool["k"], pool["v"], page_table, cache_len + 1,
        softcap=cfg.attn_logit_softcap,
        k_scale=pool.get("k_scale"), v_scale=pool.get("v_scale"))
    return _out_proj(params, o[:, None], cfg)


def verify_step_paged(params, x, cfg: ModelConfig, pool: Pool, page_table,
                      cache_len):
    """Speculative verify: append the K1 new tokens' KV [B, K1, d] at
    ``cache_len .. cache_len+K1-1`` through the table, then score every
    position in one paged verify kernel with a causal intra-block mask.
    The engine winds ``cache_len`` back past rejected tokens afterwards;
    their KV stays behind as masked garbage."""
    x = x.to(cfg.cdtype)
    K1 = x.shape[1]
    positions = cache_len[:, None] + torch.arange(
        K1, device=x.device, dtype=cache_len.dtype)[None]
    q, k, v = _qkv(params, x, cfg, positions)
    _page_scatter(pool, k, v, page_table, positions, cache_len + K1)
    o = ops.paged_verify_attention(
        q, pool["k"], pool["v"], page_table, cache_len + K1,
        softcap=cfg.attn_logit_softcap,
        k_scale=pool.get("k_scale"), v_scale=pool.get("v_scale"))
    return _out_proj(params, o, cfg)


# ---------------------------------------------------------------------------
# single-token decode over a dense cache
# ---------------------------------------------------------------------------

def decode_step(params, x, cfg: ModelConfig, cache: Pool, cache_len):
    """Single-token decode: write the token's KV at ``cache_len`` (its ring
    slot), then run the dense decode kernel over the valid slots."""
    x = x.to(cfg.cdtype)
    positions = cache_len[:, None]
    q, k, v = _qkv(params, x, cfg, positions)
    _fill_cache(cache, k, v, positions)
    valid = torch.clamp(cache_len + 1, max=cache["k"].shape[1])
    o = ops.decode_attention(q[:, 0], cache["k"], cache["v"], valid,
                             softcap=cfg.attn_logit_softcap)
    return _out_proj(params, o[:, None], cfg)
