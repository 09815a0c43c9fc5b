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
The shard_map paths (expert and tensor parallelism over a mesh) are not
ported; the port runs on one card (ROADMAP Queue A item 13).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

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


def apply_moe(p, x, cfg: ModelConfig):
    """x [B, T, d] → (out [B, T, d], aux loss scalar f32).  JAX takes its
    shard_map paths under sharding rules over more than one device; the
    port runs the local path on one card and raises in a process group of
    more than one rank (ROADMAP Queue A item 13)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            "MoE over a device mesh (expert or tensor parallel shard_map "
            "paths) is not ported yet (ROADMAP Queue A item 13)")
    return _apply_moe_local(p, x, cfg)
