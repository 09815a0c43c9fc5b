"""Mixture-of-Experts FFN with sort-based top-k dispatch (Mixtral /
DeepSeek-V2): the local path of ``repro.models.moe``.

    out, aux = apply_moe(params, x, cfg)        # x [B, T, d]

Every step follows ``_apply_moe_local`` (JAX ``moe.py:159-177``): router
logits as an f32 product with the f32 router, a softmax in f32, the
top-k probabilities renormalised over the k, the switch-style load
balancing loss, then the (token, expert) pairs stably sorted by expert
into an ``[E, C, d]`` buffer of ``C = _capacity(n_tok)`` rows an expert,
the expert FFN as three batched products over E, and the weighted sum
back to each token, plus the shared experts where the config has them.
A pair past its expert's capacity is dropped and adds nothing.

Two points keep the outputs the JAX function's, bit for bit in fp32:

- JAX scatters a dropped pair with ``mode="drop"`` to slot ``n_pairs +
  1`` (``moe.py:110-114``).  That slot lies inside the buffer whenever
  ``C·E > n_pairs + 1`` (always once a pair drops at a capacity factor of
  at least 1), so the dropped pairs overwrite it in sorted order, the
  last one winning, and the kept pair that owns it (if any) reads that
  token.  ``_dispatch`` writes the same rows, with one deterministic
  winner per slot (the last pair in sorted order that targets it).
- The combine adds each token's k contributions in sorted order (by
  expert id), one addition at a time, as the JAX scatter-add on the CPU
  does: no atomics, so fp32 streams repeat on the card.

Ties in the top-k go to the lower expert id, as ``lax.top_k`` does.

Under a mesh's rules ``apply_moe`` takes the JAX ``shard_map`` paths on
this rank's local view (``distributed.spmd``): ``_apply_moe_shardmap``
dispatches the rank's own tokens into an ``[E, C_local, d]`` buffer,
then either regroups it over ``model`` with an all-to-all so each rank
computes its E/tp experts (expert parallelism, E % tp == 0; the payload
int8 with ``dispatch_quant="int8"``, ``a2a_int8``), or computes every
expert on its ``d_expert / tp`` columns and sums the partial outputs over
``model`` (per-expert tensor parallelism).  ``_apply_moe_tp2d`` is the
serve2d path: weights sharded over both axes, never moved, each product
summed over the contracted axis.  The load-balancing loss is the one over
every rank's tokens (the expert counts and the probability sums reduced
over the batch axes), returned as this rank's share of it, so that the
shares over the batch axes add up to the single-device value and its
gradient; JAX's sharded path averages per-shard losses instead, which
its single-device path does not.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import current_rules
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_mlp, dense_init, init_mlp


def init_moe(gen: torch.Generator, cfg: ModelConfig):
    """The JAX leaves (``moe.py:39-56``): ``router [d, E]`` in f32 and
    ``w_gate``/``w_up [E, d, f]``, ``w_down [E, f, d]`` in the parameter
    dtype, each drawn with the fan-in of its product (d, or f for
    ``w_down``), and ``shared`` (an MLP of ``d_shared_expert``) where the
    config has shared experts."""
    m, d, dt = cfg.moe, cfg.d_model, cfg.pdtype
    p = {"router": dense_init(gen, (d, m.num_experts), torch.float32)}
    if cfg.activation in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, (m.num_experts, d, m.d_expert), dt,
                                 fan_in=d)
    p["w_up"] = dense_init(gen, (m.num_experts, d, m.d_expert), dt, fan_in=d)
    p["w_down"] = dense_init(gen, (m.num_experts, m.d_expert, d), dt,
                             fan_in=m.d_expert)
    if m.num_shared_experts > 0:
        p["shared"] = init_mlp(gen, cfg, d_ff=m.d_shared_expert)
    return p


def router_topk(logits: torch.Tensor, top_k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax in f32, the k largest probabilities (ties to the lower
    expert id: a stable descending sort), renormalised over the k.
    Returns (gate [n, k] f32, idx [n, k] int64)."""
    probs = torch.softmax(logits.float(), dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :top_k], idx[:, :top_k]
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)
    return gate, idx


def aux_load_balance_loss(logits: torch.Tensor, idx: torch.Tensor,
                          num_experts: int) -> torch.Tensor:
    """Switch-style load balancing: ``E · Σ_e frac_tokens_e ·
    mean_prob_e`` (JAX ``moe.py:67-73``)."""
    probs = torch.softmax(logits.float(), dim=-1)
    counts = _expert_counts(idx, num_experts).float()
    frac_tokens = counts / max(idx.numel(), 1)
    return num_experts * torch.sum(frac_tokens * probs.mean(dim=0))


def _expert_counts(idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Pairs routed to each expert, by comparison: ``torch.bincount``
    on the card reads its input's maximum back to the host, a sync in
    every layer."""
    experts = torch.arange(num_experts, device=idx.device)
    return (idx.reshape(-1, 1) == experts).sum(dim=0)


def _capacity(n_tok: int, cfg: ModelConfig) -> int:
    """Rows an expert's buffer holds: ``max(ceil(n·k/E·factor), 8)``."""
    m = cfg.moe
    c = int(math.ceil(n_tok * m.top_k / m.num_experts * m.capacity_factor))
    return max(c, 8)


def _dispatch(xt, gate, idx, capacity: int, cfg: ModelConfig):
    """Sort the (token, expert) pairs by expert (stable) → the ``[E, C,
    d]`` buffer and the combine's metadata ``(slot, keep, t_sorted,
    g_sorted, order)``.  A slot's row is the token of the last pair in
    sorted order that writes it, dropped pairs included (they write slot
    ``n_pairs + 1`` when it is inside the buffer, as the JAX scatter
    does); a slot nothing writes stays zero."""
    m = cfg.moe
    n_tok, d = xt.shape
    n_pairs = n_tok * m.top_k
    E_C = m.num_experts * capacity
    dev = xt.device

    e_flat = idx.reshape(-1)
    t_flat = torch.arange(n_tok, device=dev).repeat_interleave(m.top_k)
    order = torch.argsort(e_flat, stable=True)
    e_sorted, t_sorted = e_flat[order], t_flat[order]
    counts = _expert_counts(e_flat, m.num_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_expert = torch.arange(n_pairs, device=dev) - starts[e_sorted]
    keep = pos_in_expert < capacity
    slot = torch.where(keep, e_sorted * capacity + pos_in_expert,
                       n_pairs + 1)

    # the last pair in sorted order to write each slot; a slot past the
    # buffer (mode="drop") lands in one extra trash entry, cut off after
    writer = torch.full((E_C + 1,), -1, dtype=torch.long, device=dev)
    writer.scatter_reduce_(0, torch.clamp(slot, max=E_C),
                           torch.arange(n_pairs, device=dev), reduce="amax")
    writer = writer[:E_C]
    rows = xt[t_sorted[torch.clamp(writer, min=0)]]
    buf = torch.where((writer >= 0)[:, None], rows, torch.zeros_like(rows))
    meta = (slot, keep, t_sorted, gate.reshape(-1)[order], order)
    return buf.reshape(m.num_experts, capacity, d), meta


def _combine(y, meta, idx, dtype):
    """The inverse of ``_dispatch``: each token's k kept outputs times
    their gates (in ``dtype``), added in sorted order (by expert id) one
    at a time; a dropped pair adds zero."""
    slot, keep, t_sorted, g_sorted, order = meta
    n_tok, k = idx.shape
    E_C, d = y.shape[0] * y.shape[1], y.shape[2]
    yf = y.reshape(E_C, d)
    y_pairs = torch.where(keep[:, None], yf[torch.clamp(slot, 0, E_C - 1)],
                          torch.zeros((), dtype=yf.dtype, device=yf.device))
    contrib = y_pairs * g_sorted[:, None].to(dtype)
    # back to (token, choice), then each token's choices by expert id:
    # the order the sorted pairs reach the token in
    flat = torch.empty_like(contrib)
    flat[order] = contrib
    flat = flat.reshape(n_tok, k, d)
    flat = torch.gather(flat, 1, torch.argsort(idx, dim=1)[..., None]
                        .expand(n_tok, k, d))
    out = torch.zeros((n_tok, d), dtype=dtype, device=y.device)
    for j in range(k):
        out = out + flat[:, j]
    return out


def _expert_ffn(buf, w_gate, w_up, w_down, cfg: ModelConfig):
    """[E, C, d] → [E, C, d] through each expert's FFN: batched products
    over E (``einsum("ecd,edf->ecf")`` and back), the activation between
    them in the compute dtype."""
    up = torch.bmm(buf, w_up)
    if cfg.activation in ("swiglu", "geglu"):
        g = torch.bmm(buf, w_gate)
        act = F.silu(g) if cfg.activation == "swiglu" else F.gelu(
            g, approximate="tanh")
        h = act * up
    elif cfg.activation == "relu2":
        h = torch.square(F.relu(up))
    else:
        h = F.gelu(up, approximate="tanh")
    return torch.bmm(h, w_down)


def _apply_moe_local(p, x, cfg: ModelConfig):
    """The single-device path (JAX ``moe.py:159-177``): x [B, T, d] →
    (out [B, T, d], ``router_aux_weight`` × the load-balancing loss)."""
    m = cfg.moe
    B, T, d = x.shape
    dt = cfg.cdtype
    n_tok = B * T
    xt = x.reshape(n_tok, d).to(dt)

    logits = xt.float() @ p["router"].float()
    gate, idx = router_topk(logits, m.top_k)
    aux = aux_load_balance_loss(logits, idx, m.num_experts)

    buf, meta = _dispatch(xt, gate, idx, _capacity(n_tok, cfg), cfg)
    y = _expert_ffn(buf,
                    p["w_gate"].to(dt) if "w_gate" in p else None,
                    p["w_up"].to(dt), p["w_down"].to(dt), cfg)
    out = _combine(y, meta, idx, dt)
    if m.num_shared_experts > 0:
        out = out + apply_mlp(p["shared"], xt, cfg)
    return out.reshape(B, T, d), aux * m.router_aux_weight


# ---------------------------------------------------------------------------
# int8 all-to-all (the expert-parallel dispatch payload)
# ---------------------------------------------------------------------------
# The EP all-to-all moves every routed token's d-vector twice a layer.
# Quantizing the payload to int8 with a per-row f32 scale quarters the
# bytes of an f32 payload; the backward pass is a plain all-to-all of the
# gradient (the quantization noise is forward-only, at most row-max/254).

class _A2AInt8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        xf = x.float()
        scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0,
                            min=1e-12)
        q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
        q2 = spmd._a2a(q, split_axis, concat_axis, group)
        s2 = spmd._a2a(scale, split_axis, concat_axis, group)
        return (q2.float() * s2).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        # the transpose of a tiled all_to_all swaps split and concat
        return (spmd._a2a(g.contiguous(), concat_axis, split_axis, group),
                None, None, None)


def a2a_int8(x, group, split_axis: int, concat_axis: int):
    """JAX's tiled ``all_to_all`` of ``x`` over ``group`` (a process group,
    ``None`` for one rank, or the name of an axis of the current mesh)
    with an int8 payload and per-row f32 scales (``max|row|/127``, at
    least 1e-12, rounding half to even); the gradient goes back through
    a plain all-to-all."""
    if isinstance(group, str):
        group = spmd.current().group((group,))
    return _A2AInt8.apply(x, group, split_axis, concat_axis)


# ---------------------------------------------------------------------------
# the sharded paths
# ---------------------------------------------------------------------------

def _dp_axes(rules):
    """The mesh axes the tokens are sharded over."""
    return spmd.dp_axes(rules)


def _gather_fsdp(w, dim: int, d: int, dt, comm):
    """A weight in the compute dtype, its ``fsdp`` dim (``dim``, d rows
    in the whole weight) all-gathered over ``data`` where it arrives
    sharded; its gradient is reduce-scattered back.  The trainer's step
    hands the layers weights gathered already, which pass through."""
    w = w.to(dt)
    if w.shape[dim] < d:
        w = spmd.gather_scatter(w, dim, comm.group(("data",)))
    return w


def _aux_share(logits, idx, num_experts: int, dpg, dp_size: int):
    """This rank's share of the load-balancing loss over every rank's
    tokens: the expert fractions from the counts summed over the batch
    axes, the probabilities summed here and divided by the global token
    count (the shares add up to ``aux_load_balance_loss`` of all
    tokens)."""
    if dpg is None:
        return aux_load_balance_loss(logits, idx, num_experts)
    probs = torch.softmax(logits.float(), dim=-1)
    counts = spmd.all_reduce(_expert_counts(idx, num_experts).float(), dpg)
    frac_tokens = counts / max(idx.numel() * dp_size, 1)
    frac_probs = probs.sum(dim=0) / (probs.shape[0] * dp_size)
    return num_experts * torch.sum(frac_tokens * frac_probs)


def _mesh_comm(rules):
    c = spmd.current()
    if c is None:
        raise ValueError(
            f"the MoE layer's sharded paths need a device mesh with a "
            f"process group (a DeviceMesh or a LocalMesh), not "
            f"{type(rules.mesh).__name__}")
    return c


def _apply_moe_shardmap(p, x, cfg: ModelConfig, rules):
    """The JAX ``_apply_moe_shardmap`` (``moe.py:232-358``) on this rank's
    view: ``x`` [B, T, d] its tokens (replicated over ``model``), the
    expert weights its experts (EP) or its ``d_expert`` columns (TP), the
    router and the shared experts' ``fsdp`` dims gathered or not."""
    m = cfg.moe
    B, T, d = x.shape
    dt = cfg.cdtype
    n_loc = B * T
    comm = _mesh_comm(rules)

    # serve2d rules (batch replicated, embed → data): the decode path
    embed = rules.rules.get("embed")
    if (rules.rules.get("batch") is None and embed is not None
            and "model" in rules.shape
            and d % rules.mesh_axis_size(embed) == 0):
        return _apply_moe_tp2d(p, x, cfg, rules)

    dp = _dp_axes(rules)
    dpg, dp_size = comm.group(dp), comm.size(dp)
    tpg, tp = comm.group(("model",)), comm.size(("model",))
    ep_mode = m.num_experts % tp == 0
    glu = cfg.activation in ("swiglu", "geglu")
    cap = _capacity(n_loc, cfg)

    xt = x.reshape(n_loc, d).to(dt)
    logits = xt.float() @ p["router"].float()
    gate, idx = router_topk(logits, m.top_k)
    aux = _aux_share(logits, idx, m.num_experts, dpg, dp_size)
    if not ep_mode:
        gate = spmd.copy_to(gate, tpg)       # the combine below is partial
    buf, meta = _dispatch(xt, gate, idx, cap, cfg)          # [E, C, d]
    buf = spmd.copy_to(buf, tpg)
    wg = _gather_fsdp(p["w_gate"], 1, d, dt, comm) if glu else None
    wu = _gather_fsdp(p["w_up"], 1, d, dt, comm)
    wd = _gather_fsdp(p["w_down"], 2, d, dt, comm)
    if ep_mode:
        # regroup: every model rank gets its E/tp experts, every rank's rows
        if m.dispatch_quant == "int8":
            buf = a2a_int8(buf, tpg, 0, 1)                  # [E/tp, C·tp, d]
        else:
            buf = spmd.all_to_all(buf, 0, 1, tpg)
        y = _expert_ffn(buf, wg, wu, wd, cfg)
        if m.dispatch_quant == "int8":
            y = a2a_int8(y, tpg, 1, 0)                      # [E, C, d]
        else:
            y = spmd.all_to_all(y, 1, 0, tpg)
        # every model rank computed the same tokens: one rank's worth of
        # gradient reaches the experts, and copy_to sums buf's back
        y = spmd.scale_grad(y, 1.0 / tp)
        out = _combine(y, meta, idx, dt)
    else:
        # per-expert TP: all experts, d_expert/tp columns each
        y = _expert_ffn(buf, wg, wu, wd, cfg)
        out = spmd.reduce_from(_combine(y, meta, idx, dt), tpg)
    if m.num_shared_experts > 0:
        out = out + apply_mlp(p["shared"], xt, cfg, m.d_shared_expert)
    return out.reshape(B, T, d), aux * m.router_aux_weight


def _apply_moe_tp2d(p, x, cfg: ModelConfig, rules):
    """The JAX ``_apply_moe_tp2d`` (``moe.py:361-444``), the decode path
    under serve2d rules: every rank holds all tokens with this rank's
    slice of d (the ``embed`` axes) in ``x`` [B, T, d_loc]; the router
    ``[d_loc, E]``, the experts ``[E, d_loc, f_loc]`` / ``[E, f_loc,
    d_loc]`` and the shared experts are its shards over both axes and
    never move; each product is summed over the axis it contracts.
    Returns its d-slice of the output.  Forward only (decode)."""
    m = cfg.moe
    B, T, d_loc = x.shape
    dt = cfg.cdtype
    n_tok = B * T
    comm = _mesh_comm(rules)
    glu = cfg.activation in ("swiglu", "geglu")
    embed = rules.rules["embed"]
    rowg = comm.group((embed,) if isinstance(embed, str) else embed)
    tpg = comm.group(("model",))
    cap = _capacity(n_tok, cfg)

    def act(g, up):
        if cfg.activation == "swiglu":
            return F.silu(g) * up
        if cfg.activation == "geglu":
            return F.gelu(g, approximate="tanh") * up
        if cfg.activation == "relu2":
            return torch.square(F.relu(up))
        return F.gelu(up, approximate="tanh")

    xt = x.reshape(n_tok, d_loc).to(dt)
    logits = spmd.reduce_from(xt.float() @ p["router"].float(), rowg)
    gate, idx = router_topk(logits, m.top_k)
    aux = aux_load_balance_loss(logits, idx, m.num_experts)
    buf, meta = _dispatch(xt, gate, idx, cap, cfg)         # [E, C, d_loc]
    up = spmd.reduce_from(torch.bmm(buf, p["w_up"].to(dt)), rowg)
    g = spmd.reduce_from(torch.bmm(buf, p["w_gate"].to(dt)), rowg) \
        if glu else None
    y = spmd.reduce_from(torch.bmm(act(g, up), p["w_down"].to(dt)), tpg)
    out = _combine(y, meta, idx, dt)                       # [n, d_loc]
    if m.num_shared_experts > 0:
        sh = p["shared"]
        hs = spmd.reduce_from(xt @ sh["w_up"].to(dt), rowg)
        gs = spmd.reduce_from(xt @ sh["w_gate"].to(dt), rowg) \
            if "w_gate" in sh else None
        out = out + spmd.reduce_from(act(gs, hs) @ sh["w_down"].to(dt), tpg)
    return out.reshape(B, T, d_loc), aux * m.router_aux_weight


def apply_moe(p, x, cfg: ModelConfig):
    """x [B, T, d] → (out [B, T, d], aux loss scalar f32): the local path,
    or under rules whose mesh spans more than one rank on ``model`` or on
    the batch axes the sharded path (JAX ``moe.py:447-454``)."""
    rules = current_rules()
    if rules is not None and rules.mesh is not None and (
            rules.mesh_axis_size(("model",)) > 1
            or rules.mesh_axis_size(rules.rules.get("batch")) > 1):
        return _apply_moe_shardmap(p, x, cfg, rules)
    return _apply_moe_local(p, x, cfg)
