"""Full, sliding-window and DeepSeek's latent (MLA) attention: the
serving path of ``repro.models.attention``.

Layouts are the JAX package's: projections ``w_q [d, H, hd]``,
``w_k``/``w_v [d, Hkv, hd]``, ``w_o [H, hd, d]``; pools
``[P, page, Hkv, D]`` and dense caches ``[B, S, Hkv, D]`` per layer.
Pools and caches are device tensors written in place (the JAX functions
return a new pool or cache and donate the old one; the effect is the
same).  Page 0 of every pool is the allocator's trash page.  The dense
cache serves the speculative draft model and the dense slot plane (with
its staging cache for chunked prefill).  Sliding-window attention
(``attn_type == "swa"``) keeps a ring of ``cache_capacity`` slots: a
position's KV lives at ``position % S``, prefill attends with the
window, and decode reads the whole valid ring with no window (the ring
already bounds it), as in JAX.  MLA (``attn_type == "mla"``) keeps a
latent cache per layer, ``c_kv [B, S, kv_lora]`` and ``k_rope [B, S,
rope]`` (no ring), expands it through ``w_uk``/``w_uv`` in prefill and
decodes in latent space with the weights absorbed into the query and the
output (``_decode_step_mla``); it never pages.  The projections
carry the JAX options: biases (``attn_bias``: ``b_q [H, hd]``,
``b_k``/``b_v [Hkv, hd]``, ``b_o [d]``) and an RMSNorm of q and k over
the head dim (``qk_norm``: ``q_norm``, ``k_norm [hd]``) between the
biases and RoPE; every path (train, paged, dense and verify) goes
through ``_qkv`` and ``_out_proj``.

Under sharding rules (``distributed.sharding``) a layer computes this
rank's query heads when they divide the ``model`` axis.  A dense cache
sharded along the sequence over ``model`` (``cache_partition_specs``:
KV heads that do not divide the axis, and MLA's latent pair always) holds
every KV head's keys for this rank's block of positions (``_seq_split``).
A prefill then writes into its block the positions that fall in it, of
every KV head (the KV leaves are whole over ``model`` whenever the cache
is split so: each rank computes every KV head's keys itself), and a
decode step writes the new token's keys on the rank that owns its slot,
computes every query head's partial attention over its own block with
its log-sum-exp (``ops.decode_attention_lse``; the query heads gathered
over ``model`` first), merges the partials across the axis
(``spmd.merge_partials``) and keeps its own heads: the one-device
function, a block with no valid key adding nothing.  The rule assumes the
cache's length divides over the axis (``cache_partition_specs``
replicates it otherwise; every ``launch.shapes`` length divides).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import current_rules, spec_axes
from repro_torch.kernels import ops
from repro_torch.kernels.ref import gather_pages
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init, rms_norm_simple

Pool = Dict[str, torch.Tensor]


def init_attention(gen: torch.Generator, cfg: ModelConfig):
    """The JAX leaves (``attention.py:33-69``): MLA's low-rank projections
    and unit norm scales, or the full projections with zero biases and
    unit qk-norm scales where the config has them."""
    d, hd = cfg.d_model, cfg.head_dim_
    dt, dev = cfg.pdtype, gen.device
    if cfg.attn_type == "mla":
        m, H = cfg.mla, cfg.num_heads
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        return {
            "w_dq": dense_init(gen, (d, m.q_lora_rank), dt),
            "q_norm": torch.ones((m.q_lora_rank,), dtype=dt, device=dev),
            "w_uq": dense_init(gen, (m.q_lora_rank, H, qk), dt,
                               fan_in=m.q_lora_rank),
            "w_dkv": dense_init(gen, (d, m.kv_lora_rank), dt),
            "kv_norm": torch.ones((m.kv_lora_rank,), dtype=dt, device=dev),
            "w_kr": dense_init(gen, (d, m.qk_rope_head_dim), dt),
            "w_uk": dense_init(gen, (m.kv_lora_rank, H, m.qk_nope_head_dim),
                               dt, fan_in=m.kv_lora_rank),
            "w_uv": dense_init(gen, (m.kv_lora_rank, H, m.v_head_dim), dt,
                               fan_in=m.kv_lora_rank),
            "w_o": dense_init(gen, (H, m.v_head_dim, d), dt,
                              fan_in=H * m.v_head_dim),
        }
    p = {
        "w_q": dense_init(gen, (d, cfg.num_heads, hd), dt),
        "w_k": dense_init(gen, (d, cfg.num_kv_heads, hd), dt),
        "w_v": dense_init(gen, (d, cfg.num_kv_heads, hd), dt),
        "w_o": dense_init(gen, (cfg.num_heads, hd, d), dt,
                          fan_in=cfg.num_heads * hd),
    }
    if cfg.attn_bias:
        p["b_q"] = torch.zeros((cfg.num_heads, hd), dtype=dt, device=dev)
        p["b_k"] = torch.zeros((cfg.num_kv_heads, hd), dtype=dt, device=dev)
        p["b_v"] = torch.zeros((cfg.num_kv_heads, hd), dtype=dt, device=dev)
        p["b_o"] = torch.zeros((d,), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=dev)
    return p


def init_paged_pool(cfg: ModelConfig, num_pages: int, page_size: int,
                    dtype=torch.bfloat16, device=None) -> Pool:
    """Per-layer paged KV pool, zero-filled (a stale row must be a finite
    number; ``torch.empty`` could hold NaN bit patterns).  ``torch.int8``
    adds the per-token f32 scale planes ``k_scale``/``v_scale``."""
    if cfg.attn_type != "full":
        raise NotImplementedError(f"paged pools need full attention, got "
                                  f"{cfg.attn_type!r}: JAX's "
                                  f"init_paged_pool asserts attn_type == "
                                  f"'full' (AssertionError)")
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


def cache_capacity(cfg: ModelConfig, max_seq: int) -> int:
    """Slots a dense cache holds: a sliding-window arch keeps a ring of
    ``min(window, max_seq)`` (JAX ``attention.py:72-76``)."""
    if cfg.sliding_window > 0:
        return min(cfg.sliding_window, max_seq)
    return max_seq


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> Pool:
    """Per-layer dense cache ``[batch, S, Hkv, D]`` with ``S =
    cache_capacity(cfg, max_seq)``, zero-filled; for MLA the latent cache
    ``c_kv [batch, S, kv_lora]`` and ``k_rope [batch, S, rope]`` (JAX
    ``attention.py:79-92``).  ``attn_type`` "none" raises: JAX's cache
    has no leaf then, and its first prefill fails on the missing ``k``."""
    if cfg.attn_type == "none":
        raise NotImplementedError(
            "attn_type 'none' keeps no cache: JAX's init_cache returns no "
            "leaf and its first prefill raises KeyError 'k'")
    device = resolve_device(device)
    if cfg.attn_type == "mla":
        S, m = cache_capacity(cfg, max_seq), cfg.mla
        return {"c_kv": torch.zeros((batch, S, m.kv_lora_rank), dtype=dtype,
                                    device=device),
                "k_rope": torch.zeros((batch, S, m.qk_rope_head_dim),
                                      dtype=dtype, device=device)}
    shape = (batch, cache_capacity(cfg, max_seq), cfg.num_kv_heads,
             cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------

def _proj(x, w, dt):
    """einsum("btd,dhk->bthk") as one matmul over the flattened heads."""
    d, H, hd = w.shape
    return (x @ w.to(dt).reshape(d, H * hd)).unflatten(-1, (H, hd))


def local_kv_heads(cfg: ModelConfig, tp: int, rank: int) -> list:
    """The KV heads that rank ``rank``'s query heads read when the query
    heads are sharded over a model axis of ``tp`` and the KV heads are
    not (they do not divide it): the global pairing, query head h with KV
    head h // G, kept under the kernel's local pairing (local query head
    i with local KV head i // G_local).  A contiguous run of whole groups
    when the rank's heads cover them, the one head they share when they
    sit inside one group, else one KV head per query head."""
    H, G = cfg.num_heads, cfg.num_heads // cfg.num_kv_heads
    h_loc = H // tp
    q0 = rank * h_loc
    if h_loc % G == 0:
        return list(range(q0 // G, q0 // G + h_loc // G))
    if G % h_loc == 0:
        return [q0 // G]
    return [(q0 + i) // G for i in range(h_loc)]


def _kv_leaves(params, cfg: ModelConfig, group, tp, rank):
    """(w_k, w_v, b_k, b_v) as this rank's heads use them: the leaves as
    they are, or, with query heads sharded over ``model`` and KV heads
    replicated, the ``local_kv_heads`` of the replicated leaves, which
    enter through ``spmd.copy_to`` (each rank's gradient covers only its
    heads)."""
    names = ("w_k", "w_v", "b_k", "b_v")
    got = [params.get(n) for n in names]
    if group is None or params["w_k"].shape[1] < cfg.num_kv_heads:
        return got
    idx = torch.tensor(local_kv_heads(cfg, tp, rank),
                       device=params["w_k"].device)
    return [None if w is None else
            spmd.copy_to(w, group).index_select(0 if n[0] == "b" else 1,
                                                idx)
            for n, w in zip(names, got)]


def _qkv(params, x, cfg: ModelConfig, positions, every_kv: bool = False):
    """The JAX order (``attention.py:140-150``): projections, biases, the
    qk RMSNorm over the head dim, RoPE; each step in the compute dtype.
    Under rules that shard the heads over ``model``, this rank's heads:
    x and the replicated leaves enter through ``spmd.copy_to``.  With
    ``every_kv`` (a cache split along the sequence, no gradient) k and v
    hold every KV head, from the whole leaves."""
    dt = cfg.cdtype
    group, tp, rank = spmd.model_split("heads", cfg.num_heads)
    x = spmd.copy_to(x, group)
    if every_kv:
        w_k, w_v, b_k, b_v = (params.get(n)
                              for n in ("w_k", "w_v", "b_k", "b_v"))
    else:
        w_k, w_v, b_k, b_v = _kv_leaves(params, cfg, group, tp, rank)
    q = _proj(x, params["w_q"], dt)
    k = _proj(x, w_k, dt)
    v = _proj(x, w_v, dt)
    if cfg.attn_bias:
        q = q + params["b_q"].to(dt)
        k = k + b_k.to(dt)
        v = v + b_v.to(dt)
    if cfg.qk_norm:
        q = rms_norm_simple(q, spmd.copy_to(params["q_norm"], group),
                            cfg.norm_eps)
        k = rms_norm_simple(k, spmd.copy_to(params["k_norm"], group),
                            cfg.norm_eps)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(params, o, cfg: ModelConfig):
    """einsum("bthk,hkd->btd"), then ``b_o`` (JAX ``attention.py:156``);
    a rank's heads give a partial sum, summed over ``model`` first."""
    H, hd, d = params["w_o"].shape
    out = o.flatten(-2) @ params["w_o"].to(cfg.cdtype).reshape(H * hd, d)
    out = spmd.reduce_from(
        out, spmd.model_split("heads", cfg.num_heads)[0])
    if cfg.attn_bias:
        out = out + params["b_o"].to(cfg.cdtype)
    return out


def _mla_q(params, x, cfg: ModelConfig, positions):
    """MLA's queries (JAX ``attention.py:161-169``): the low-rank
    projection, its RMSNorm, the up-projection to every head, and RoPE on
    the last ``rope`` columns → (q_nope [B,T,H,nope], q_rope
    [B,T,H,rope])."""
    dt, m = cfg.cdtype, cfg.mla
    cq = rms_norm_simple(x @ params["w_dq"].to(dt), params["q_norm"],
                         cfg.norm_eps)
    cq = spmd.copy_to(cq, spmd.model_split("heads", cfg.num_heads)[0])
    q = _proj(cq, params["w_uq"], dt)
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    return q[..., :m.qk_nope_head_dim], q_rope


def _mla_kv_compressed(params, x, cfg: ModelConfig, positions):
    """The latent KV (JAX ``attention.py:172-179``): the normed ``c_kv``
    [B,T,kv_lora] and the shared ``k_rope`` [B,T,rope], roped through a
    dummy head axis."""
    dt = cfg.cdtype
    c_kv = rms_norm_simple(x @ params["w_dkv"].to(dt), params["kv_norm"],
                           cfg.norm_eps)
    k_rope = apply_rope((x @ params["w_kr"].to(dt))[:, :, None, :],
                        positions, cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


# ---------------------------------------------------------------------------
# full-sequence attention (train / prefill)
# ---------------------------------------------------------------------------

def _attend_mla(params, x, cfg: ModelConfig, positions, causal, cache):
    """MLA over the sequence (JAX ``attention.py:199-218``): keys and
    values expanded from the latent ``c_kv`` through ``w_uk``/``w_uv``,
    the shared ``k_rope`` broadcast over the heads (so Hkv = Hq), flash at
    q/k width nope + rope and v width ``v_head_dim``, scaled by (nope +
    rope)^-0.5; ``cache`` takes the latent pair."""
    dt, m = cfg.cdtype, cfg.mla
    group = spmd.model_split("heads", cfg.num_heads)[0]
    q_nope, q_rope = _mla_q(params, x, cfg, positions)
    c_kv, k_rope = _mla_kv_compressed(params, x, cfg, positions)
    k_nope = _proj(spmd.copy_to(c_kv, group), params["w_uk"], dt)
    v = _proj(spmd.copy_to(c_kv, group), params["w_uv"], dt)
    k_rope_h = spmd.copy_to(k_rope, group)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h[:, :, None, :].expand(
        *k_nope.shape[:3], m.qk_rope_head_dim)], dim=-1)
    o = ops.flash_attention(q, k, v, causal=causal, window=0,
                            softcap=cfg.attn_logit_softcap,
                            q_positions=positions, kv_positions=positions,
                            sm_scale=(m.qk_nope_head_dim
                                      + m.qk_rope_head_dim) ** -0.5)
    if cache is not None:
        split = _seq_split(cfg)
        if split is None:
            _fill_cache_mla(cache, c_kv, k_rope, positions)
        else:
            for name, val in (("c_kv", c_kv), ("k_rope", k_rope)):
                _fill_block(cache[name], val, positions, split)
    H, hv, d = params["w_o"].shape
    return spmd.reduce_from(
        o.flatten(-2) @ params["w_o"].to(dt).reshape(H * hv, d), group)


def attend(params, x, cfg: ModelConfig, *, positions, causal: bool = True,
           cache: Optional[Pool] = None):
    """[B, T, d] → [B, T, d] over the sequence itself, with the sliding
    window for ``attn_type == "swa"``; with ``cache`` (the dense prefill)
    the sequence's KV (MLA: its latent pair) is also written into it."""
    x = x.to(cfg.cdtype)
    if cfg.attn_type == "mla":
        return _attend_mla(params, x, cfg, positions, causal, cache)
    split = _seq_split(cfg) if cache is not None else None
    q, k, v = _qkv(params, x, cfg, positions, every_kv=split is not None)
    kl, vl = k, v
    if split is not None:
        # flash pairs this rank's query heads with its local KV heads
        group, tp, rank = spmd.model_split("heads", cfg.num_heads)
        if group is not None:
            idx = torch.tensor(local_kv_heads(cfg, tp, rank),
                               device=k.device)
            kl, vl = k.index_select(2, idx), v.index_select(2, idx)
    window = cfg.sliding_window if cfg.attn_type == "swa" else 0
    o = ops.flash_attention(q, kl, vl, causal=causal, window=window,
                            softcap=cfg.attn_logit_softcap,
                            q_positions=positions, kv_positions=positions)
    if split is not None:
        _fill_block(cache["k"], k, positions, split)
        _fill_block(cache["v"], v, positions, split)
    elif cache is not None:
        _fill_cache(cache, k, v, positions)
    return _out_proj(params, o, cfg)


def _fill_cache(cache: Pool, k, v, positions):
    """Write KV [B, T, H, D] into the dense cache at ``positions % S``, in
    place.  A write of T > S positions (increasing along T, as every
    caller's are) keeps only the last S: two positions S apart share a
    slot, and an index assignment with repeated indices leaves either
    one (the CPU's threads race, the card gives no order), where JAX's
    sequential scatter keeps the later.  The wrap is reached by every
    sliding-window prompt longer than its ring, and with full attention
    by a free draft slot whose stale length sits at ``max_seq`` (its
    masked rewrite lands on slot 0, which the next prefill overwrites)."""
    S = cache["k"].shape[1]
    if k.shape[1] > S:
        k, v, positions = k[:, -S:], v[:, -S:], positions[:, -S:]
    slots = positions.long() % S                          # [B, T]
    bidx = torch.arange(k.shape[0], device=k.device)[:, None]
    cache["k"][bidx, slots] = k.to(cache["k"].dtype)
    cache["v"][bidx, slots] = v.to(cache["v"].dtype)


def _seq_split(cfg: ModelConfig):
    """``(group, tp, rank)`` of the ``model`` axis when the current rules
    shard a dense cache of this config along the sequence over it (the
    ``cache_partition_specs`` rule: KV heads that do not divide the
    ``kv_heads`` axes, MLA's latent pair always); else None."""
    rules = current_rules()
    if rules is None or rules.shape.get("model", 1) == 1 or \
            "model" not in spec_axes(rules.rules.get("kv_seq")):
        return None
    if cfg.attn_type != "mla" and cfg.num_kv_heads % max(
            rules.mesh_axis_size(rules.rules.get("kv_heads")), 1) == 0:
        return None
    comm = spmd.current()
    if comm is None:
        return None
    return comm.group(("model",)), comm.sizes["model"], comm.coord["model"]


def _fill_block(buf: torch.Tensor, val, positions, split) -> None:
    """Write ``val`` [B, T, ...] at ``positions % S`` into this rank's
    block ``buf`` [B, S/tp, ...] of a cache of S slots split along the
    sequence over ``tp`` ranks: the slots in ``[rank·S/tp, (rank+1)·S/tp)``,
    each taking the latest position that lands on it (a ring keeps the
    last S; positions increase along T, as every caller's do).  The block
    is rewritten whole, the slots no position lands on with their own
    values: a write of the positions outside the block would collide
    with those inside, and which slots a row's positions fill is known on
    the device only."""
    _, tp, rank = split
    B, S_loc = buf.shape[:2]
    T = positions.shape[1]
    li = positions.long() % (S_loc * tp) - rank * S_loc
    own = (li >= 0) & (li < S_loc)
    t = torch.arange(T, device=buf.device).expand(B, T)
    last = torch.full((B, S_loc + 1), -1, dtype=torch.long,
                      device=buf.device).scatter_reduce_(
        1, torch.where(own, li, S_loc), t, "amax")[:, :S_loc]
    tail = (1,) * (val.dim() - 2)
    src = torch.gather(val, 1, last.clamp(min=0).view(B, S_loc, *tail)
                       .expand(B, S_loc, *val.shape[2:]))
    buf.copy_(torch.where((last >= 0).view(B, S_loc, *tail),
                          src.to(buf.dtype), buf))


def _write_token(buf: torch.Tensor, val, slot, tp: int, rank: int) -> None:
    """One token's ``val`` [B, ...] at global slot ``slot`` [B] of a cache
    split along the sequence, written by the rank whose block holds it;
    every other rank writes a slot of its block back unchanged (one write
    a row, so no two collide)."""
    B, S_loc = buf.shape[:2]
    li = slot.long() - rank * S_loc
    own = ((li >= 0) & (li < S_loc)).view(B, *(1,) * (val.dim() - 1))
    li = li.clamp(0, S_loc - 1)
    bidx = torch.arange(B, device=buf.device)
    buf[bidx, li] = torch.where(own, val.to(buf.dtype), buf[bidx, li])


def _fill_cache_mla(cache: Pool, c_kv, k_rope, positions):
    """Write the latent pair [B, T, ·] at ``positions % S``, in place (JAX
    ``attention.py:244-251``).  A prefill's bucket is at most ``max_seq``
    = S positions, so no write repeats a slot."""
    S = cache["c_kv"].shape[1]
    slots = positions.long() % S
    bidx = torch.arange(c_kv.shape[0], device=c_kv.device)[:, None]
    cache["c_kv"][bidx, slots] = c_kv.to(cache["c_kv"].dtype)
    cache["k_rope"][bidx, slots] = k_rope.to(cache["k_rope"].dtype)


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
    updated.  MLA has no chunked prefill (nor has JAX): its prompts
    prefill whole, through ``attend``."""
    if cfg.attn_type == "mla":
        raise ValueError("MLA prefills a whole prompt at once (attend with "
                         "a cache); it has no chunked prefill")
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
    slot), then run the dense decode kernel over the valid slots with no
    window: a sliding-window ring of ``window`` slots holds exactly the
    keys the window keeps (JAX ``attention.py:419-424``).  MLA decodes
    in latent space (``_decode_step_mla``)."""
    x = x.to(cfg.cdtype)
    positions = cache_len[:, None]
    if cfg.attn_type == "mla":
        return _decode_step_mla(params, x, cfg, cache, cache_len, positions)
    split = _seq_split(cfg)
    q, k, v = _qkv(params, x, cfg, positions, every_kv=split is not None)
    if split is None:
        _fill_cache(cache, k, v, positions)
        valid = torch.clamp(cache_len + 1, max=cache["k"].shape[1])
    else:
        valid = _split_write({"k": k[:, 0], "v": v[:, 0]}, cache,
                             cache_len, split)
    o = _attend_cache(cfg, q[:, 0], cache["k"], cache["v"], valid, split,
                      softcap=cfg.attn_logit_softcap)
    return _out_proj(params, o[:, None], cfg)


def _split_write(new: Pool, cache: Pool, cache_len, split):
    """The new token's ``new`` leaves [B, ...] written at slot
    ``cache_len % S`` of a cache split along the sequence, by the rank
    that owns it; returns the valid slots of this rank's block [B]."""
    _, tp, rank = split
    S_loc = next(iter(cache.values())).shape[1]
    S = S_loc * tp
    for name, val in new.items():
        _write_token(cache[name], val, cache_len.long() % S, tp, rank)
    return torch.clamp(torch.clamp(cache_len + 1, max=S) - rank * S_loc,
                       min=0, max=S_loc)


def _attend_cache(cfg: ModelConfig, q, k_cache, v_cache, valid, split,
                  **kw):
    """One query token [B, H_local, D] against a dense cache's ``valid``
    slots: the dense decode kernel over the whole cache, or for a cache
    split along the sequence every query head's partial attention over
    this rank's block (``q`` gathered over the heads' group first), the
    partials merged across ``model`` and this rank's heads kept → [B,
    H_local, Dv]."""
    if split is None:
        return ops.decode_attention(q, k_cache, v_cache, valid, **kw)
    hgroup = spmd.model_split("heads", cfg.num_heads)[0]
    q_all = spmd.all_gather_dim(q, 1, hgroup)
    o, lse = ops.decode_attention_lse(q_all, k_cache, v_cache, valid, **kw)
    return spmd.narrow_dim(spmd.merge_partials(o, lse, split[0]), 1, hgroup)


def _latent_keys(cache: Pool):
    """The absorbed decode's key operand ``[c_kv, k_rope]`` [B, S, L+R]:
    a copy of the layer's whole latent cache, made every step as JAX
    makes it (a profile can time it through this function)."""
    return torch.cat([cache["c_kv"], cache["k_rope"]], dim=-1)


def _decode_step_mla(params, x, cfg: ModelConfig, cache: Pool, cache_len,
                     positions):
    """Weight-absorbed MLA decode (JAX ``attention.py:429-454``): the
    attention runs entirely in latent space, as one KV head of
    ``kv_lora + rope`` key columns and ``kv_lora`` value columns that all
    H query heads share (G = H).

        q_lat[b,h,l] = Σ_k q_nope[b,h,k] w_uk[l,h,k]
        logit[b,h,s] = q_lat·c_kv[b,s] + q_rope[b,h]·k_rope[b,s]
        out[b,h,v]   = (Σ_s p[b,h,s] c_kv[b,s,l]) w_uv[l,h,v]
    """
    dt, m = cfg.cdtype, cfg.mla
    q_nope, q_rope = _mla_q(params, x, cfg, positions)       # [B,1,H,·]
    c_kv_new, k_rope_new = _mla_kv_compressed(params, x, cfg, positions)
    q_lat = torch.einsum("bhk,lhk->bhl", q_nope[:, 0],
                         params["w_uk"].to(dt))
    q_cat = torch.cat([q_lat, q_rope[:, 0]], dim=-1)          # [B,H,L+R]
    kw = dict(softcap=cfg.attn_logit_softcap,
              sm_scale=(m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5)
    split = _seq_split(cfg)
    if split is None:
        _fill_cache_mla(cache, c_kv_new, k_rope_new, positions)
        valid = torch.clamp(cache_len + 1, max=cache["c_kv"].shape[1])
    else:
        valid = _split_write({"c_kv": c_kv_new[:, 0],
                              "k_rope": k_rope_new[:, 0]}, cache, cache_len,
                             split)
    kv_cat = _latent_keys(cache)
    o_lat = _attend_cache(cfg, q_cat, kv_cat[:, :, None, :],
                          cache["c_kv"][:, :, None, :], valid, split, **kw)
    o = torch.einsum("bhl,lhv->bhv", o_lat, params["w_uv"].to(dt))
    out = torch.einsum("bhv,hvd->bd", o, params["w_o"].to(dt))
    # this rank's heads give a partial sum over ``model``
    out = spmd.reduce_from(out, spmd.model_split("heads", cfg.num_heads)[0])
    return out[:, None, :]
