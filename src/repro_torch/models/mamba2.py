"""Mamba2 (SSD, state-space duality) block: the port of
``repro.models.mamba2``, full-sequence and decode paths.

The full-sequence path runs the chunked SSD scan (``kernels.ops.ssd_scan``:
the CUDA kernel on the card, the plain version on the CPU); decode is the
O(1) recurrent step on the carried state.  Leaf names, layouts and the
order in which each product is rounded to the compute dtype follow the
JAX functions step by step.  ``kernel_norm`` sends the gated out-norm
through ``ops.rmsnorm`` (the serving path's choice; the training forward
keeps ``layers.rms_norm``).  The functions return a new state and leave
the one they were given as it is; the stack writes it into the cache.

Under rules that split the SSM heads over ``model`` (``spmd.model_split``
of ``"inner"`` over ``cfg.ssm_heads``), a rank computes its own heads,
as GSPMD splits the JAX layer (``_Split``): its columns of the gathered
``in_proj`` (its heads' z, x and dt, the B and C of every group), its
channels of the conv, the scan on its heads, its rows of ``out_proj``
summed over the axis, and the gated norm over the whole row's mean of
squares.  Its caches take JAX's shards (``cache_partition_specs``): the
SSM state its heads, the conv tail an even cut of the channels.  Heads
that do not divide the axis leave the layer replicated, its cut leaves
and conv tail gathered whole.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.distributed import spmd
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
# F32_LEAVES (Mamba2's f32 leaves among them) is re-exported here
from repro_torch.models.layers import (F32_LEAVES, dense_init,  # noqa: F401
                                       rand, randn, rms_norm_simple)


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    di = cfg.d_inner
    return s, di, cfg.ssm_heads, di + 2 * s.n_groups * s.d_state


def _softplus(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(v, 0)``: exact for large
    ``v``, where ``F.softplus`` switches to ``v`` above its threshold."""
    return torch.clamp(v, min=0.0) + torch.log1p(torch.exp(-v.abs()))


def init_mamba2(gen: torch.Generator, cfg: ModelConfig):
    """The JAX distributions (different numbers): ``dt_bias`` the inverse
    softplus of a log-uniform timestep in ``[dt_min, dt_max]``, ``A``
    uniform in ``a_init_range`` (stored as ``a_log``), ``d_skip`` ones."""
    s, di, H, conv_dim = _dims(cfg)
    d, dt, dev = cfg.d_model, cfg.pdtype, gen.device
    proj_dim = 2 * di + 2 * s.n_groups * s.d_state + H   # z, x, B, C, dt
    in_proj = dense_init(gen, (d, proj_dim), dt)
    conv_w = randn(gen, (conv_dim, s.d_conv)) * s.d_conv ** -0.5
    u = rand(gen, (H,))
    lo, hi = math.log(s.dt_min), math.log(s.dt_max)
    dt_init = torch.exp(u * (hi - lo) + lo)
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))   # inverse softplus
    a_lo, a_hi = s.a_init_range
    A = rand(gen, (H,)) * (a_hi - a_lo) + a_lo
    return {
        "in_proj": in_proj,
        "conv_w": conv_w.to(dt),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=dev),
        "dt_bias": dt_bias,
        "a_log": torch.log(A),
        "d_skip": torch.ones((H,), dtype=torch.float32, device=dev),
        "out_norm": torch.ones((di,), dtype=dt, device=dev),
        "out_proj": dense_init(gen, (di, d), dt, fan_in=di),
    }


def init_mamba2_state(cfg: ModelConfig, batch: int, device=None):
    """``conv`` [B, d_conv-1, conv_dim] holds the pre-conv stream's tail,
    ``ssm`` [B, H, P, N] the recurrent state; both zero and f32, as the
    JAX function makes them by default."""
    s, di, H, conv_dim = _dims(cfg)
    device = resolve_device(device)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim),
                            dtype=torch.float32, device=device),
        "ssm": torch.zeros((batch, H, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }


def _causal_depthwise_conv(x, w, b):
    """x [B, T, C], w [C, W]: causal depthwise conv by shifted adds, in the
    JAX order (each product and sum rounded to x's dtype)."""
    W, T = w.shape[1], x.shape[1]
    out = x * w[:, W - 1]
    for i in range(1, W):
        shifted = F.pad(x, (0, 0, i, 0))[:, :T]
        out = out + shifted * w[:, W - 1 - i]
    return out + b


def _split_proj(zxbcdt, d_in: int, heads: int):
    """(z, xBC, dt) of ``in_proj``'s output over ``d_in`` channels and
    ``heads`` heads (a rank's share of them under a split)."""
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:-heads],
            zxbcdt[..., -heads:])


def _split_xbc(xBC, d_in: int, cfg: ModelConfig):
    gn = cfg.ssm.n_groups * cfg.ssm.d_state
    return xBC[..., :d_in], xBC[..., d_in:d_in + gn], xBC[..., d_in + gn:]


# ---------------------------------------------------------------------------
# the local view over the model axis
# ---------------------------------------------------------------------------

def local_groups(cfg: ModelConfig, tp: int, rank: int) -> list:
    """The B/C groups that rank ``rank``'s heads read when the SSM heads
    split over ``tp`` ranks, kept under the scan's local pairing (local
    head i reads local group i // (H_local / G_local)): a run of whole
    groups when the rank's heads cover them, the one group they sit in,
    else one group a head (``attention.local_kv_heads``' rule)."""
    H, G = cfg.ssm_heads, cfg.ssm.n_groups
    per, h_loc = H // G, H // tp
    h0 = rank * h_loc
    if h_loc % per == 0:
        return list(range(h0 // per, h0 // per + h_loc // per))
    if per % h_loc == 0:
        return [h0 // per]
    return [(h0 + i) // per for i in range(h_loc)]


@dataclasses.dataclass(frozen=True)
class _Split:
    """The ``model`` axis as one Mamba2 layer sees it.  ``group`` is set
    when the layer's heads split over the axis (rank ``rank`` of ``tp``
    computes H / tp of them), ``mg`` whenever the axis spans more than
    one rank (what a cut leaf or conv tail is gathered over).  ``conv``:
    the rank's conv channels (its heads' x, every group's B and C);
    ``cols``: its ``in_proj`` columns (its z, those channels, its dt);
    ``groups``: the groups its scan reads, ``None`` for all of them."""
    group: object = None
    mg: object = None
    tp: int = 1
    rank: int = 0
    conv: Optional[torch.Tensor] = None
    cols: Optional[torch.Tensor] = None
    groups: Optional[torch.Tensor] = None


@functools.lru_cache(maxsize=64)
def _indices(di: int, P: int, gn: int, tp: int, rank: int, groups: tuple,
             all_groups: bool, device):
    """``_Split``'s index tensors (conv, cols, groups) on ``device``."""
    h_loc = di // P // tp
    x0 = rank * h_loc * P
    conv = torch.cat([torch.arange(x0, x0 + h_loc * P),
                      torch.arange(di, di + 2 * gn)])
    cols = torch.cat([torch.arange(x0, x0 + h_loc * P), di + conv,
                      2 * di + 2 * gn + rank * h_loc + torch.arange(h_loc)])
    g = None if all_groups else torch.tensor(groups).to(device)
    return conv.to(device), cols.to(device), g


def _split(cfg: ModelConfig, device) -> _Split:
    s, di, H, _ = _dims(cfg)
    group, tp, rank = spmd.model_split("inner", H)
    c = spmd.current()
    mg = None if c is None else c.group(("model",))
    if group is None:
        return _Split(mg=mg)
    groups = tuple(local_groups(cfg, tp, rank))
    return _Split(group, mg, tp, rank, *_indices(
        di, s.head_dim, s.n_groups * s.d_state, tp, rank, groups,
        groups == tuple(range(s.n_groups)), device))


def _leaves(p, cfg: ModelConfig, sp: _Split) -> dict:
    """The layer's leaves as this rank's heads use them.  A leaf cut over
    ``model`` is gathered whole; under a split every leaf then enters
    through ``spmd.copy_to`` (each rank's gradient covers its own columns,
    and B and C every rank's: the sum is the whole gradient) before the
    rank takes its columns, channels, heads or rows of it.  Without a
    split every rank computes the whole layer and its whole gradient."""
    s, di, H, conv_dim = _dims(cfg)

    def whole(name, dim, size):
        w = p[name]
        if w.shape[dim] != size:
            w = spmd.gather(w, dim, sp.mg)
        return spmd.copy_to(w, sp.group)

    proj = 2 * di + 2 * s.n_groups * s.d_state + H
    if sp.group is None:
        return dict(p, in_proj=whole("in_proj", 1, proj),
                    conv_w=whole("conv_w", 0, conv_dim),
                    conv_b=whole("conv_b", 0, conv_dim),
                    out_proj=whole("out_proj", 0, di))
    h_loc = H // sp.tp
    h0, P = sp.rank * h_loc, s.head_dim
    out = {"in_proj": whole("in_proj", 1, proj).index_select(1, sp.cols),
           "conv_w": whole("conv_w", 0, conv_dim).index_select(0, sp.conv),
           "conv_b": whole("conv_b", 0, conv_dim).index_select(0, sp.conv),
           "out_proj": p["out_proj"] if p["out_proj"].shape[0] < di
           else whole("out_proj", 0, di).narrow(0, h0 * P, h_loc * P),
           "out_norm": spmd.copy_to(p["out_norm"], sp.group).narrow(
               0, h0 * P, h_loc * P)}
    for name in ("dt_bias", "a_log", "d_skip"):
        out[name] = spmd.copy_to(p[name], sp.group).narrow(0, h0, h_loc)
    return out


def _conv_tail(conv: torch.Tensor, cfg: ModelConfig, sp: _Split):
    """The carried conv tail on this rank's channels: the cache's even cut
    of the channels gathered whole over ``model`` (3 x conv_dim values a
    row), then the rank's own taken."""
    if conv.shape[-1] != _dims(cfg)[3]:
        conv = spmd.all_gather_dim(conv, 2, sp.mg)
    return conv if sp.conv is None else conv.index_select(2, sp.conv)


def _conv_shard(tail: torch.Tensor, like: torch.Tensor, d_in: int,
                sp: _Split):
    """The new pre-conv tail on the rank's channels → the cache's layout
    (``like``'s): the x channels of every rank's heads gathered first
    (the even cut of the channels crosses the heads), then this rank's
    cut of the whole."""
    if sp.group is not None:
        tail = torch.cat([spmd.all_gather_dim(tail[..., :d_in], 2, sp.group),
                          tail[..., d_in:]], dim=-1)
    if like.shape[-1] != tail.shape[-1]:
        tail = spmd.narrow_dim(tail, 2, sp.mg)
    return tail


def _gated_norm(y, z, scale, cfg: ModelConfig, sp: _Split, kernel: bool):
    """``rms_norm_simple(y * silu(z))`` over all ``d_inner`` channels.
    Under a split a rank holds its heads' channels: their f32 sum of
    squares is summed over ``model`` both ways (``copy_to`` of
    ``reduce_from``: forward the row's total; backward each rank's
    gradient of the statistic, which reaches it only through its own
    channels, summed) and the norm takes the row's mean of squares from
    outside, through the kernel's ``ms`` form with ``kernel``."""
    v = y * F.silu(z)
    if sp.group is None:
        return rms_norm_simple(v, scale, cfg.norm_eps, kernel=kernel)
    ss = torch.sum(torch.square(v.float()), dim=-1)
    ms = spmd.copy_to(spmd.reduce_from(ss, sp.group), sp.group) / cfg.d_inner
    return rms_norm_simple(v, scale, cfg.norm_eps, kernel=kernel, ms=ms)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def apply_mamba2(p, x: torch.Tensor, cfg: ModelConfig,
                 state: Optional[dict] = None, *, kernel_norm: bool = False
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence SSD pass, x [B, T, d] → (out [B, T, d], new state or
    None).  With ``state`` the carried conv tail is prepended to the conv
    input and the scan starts from the carried SSM state, so a prefill
    resumes mid-prompt (chunked prefill); a zero state gives the
    stateless result."""
    s = cfg.ssm
    B, T, _ = x.shape
    dt_c = cfg.cdtype
    sp = _split(cfg, x.device)
    p = _leaves(p, cfg, sp)
    d_in, H = p["out_norm"].shape[0], p["a_log"].shape[0]
    zxbcdt = spmd.copy_to(x.to(dt_c), sp.group) @ p["in_proj"].to(dt_c)
    z, xBC_raw, dt_raw = _split_proj(zxbcdt, d_in, H)
    w, b = p["conv_w"].to(dt_c), p["conv_b"].to(dt_c)
    if state is not None:
        tail = _conv_tail(state["conv"], cfg, sp).to(dt_c)
        pre = torch.cat([tail, xBC_raw], dim=1)
        conv_out = _causal_depthwise_conv(pre, w, b)[:, s.d_conv - 1:]
    else:
        conv_out = _causal_depthwise_conv(xBC_raw, w, b)
    x_in, B_, C_ = _split_xbc(F.silu(conv_out), d_in, cfg)

    dt = _softplus(dt_raw.float() + p["dt_bias"])         # [B, T, H]
    A = -torch.exp(p["a_log"])
    xh = x_in.reshape(B, T, H, s.head_dim)
    Bh = B_.reshape(B, T, s.n_groups, s.d_state)
    Ch = C_.reshape(B, T, s.n_groups, s.d_state)
    if sp.groups is not None:
        Bh, Ch = Bh.index_select(2, sp.groups), Ch.index_select(2, sp.groups)
    if state is not None:
        y, final = ops.ssd_scan(xh, dt, A, Bh, Ch, chunk=s.chunk_size,
                                initial_state=state["ssm"],
                                return_final_state=True)
    else:
        y = ops.ssd_scan(xh, dt, A, Bh, Ch, chunk=s.chunk_size)

    y = y + xh * p["d_skip"][None, None, :, None].to(y.dtype)
    y = _gated_norm(y.reshape(B, T, d_in), z, p["out_norm"], cfg, sp,
                    kernel_norm)
    out = spmd.reduce_from(y @ p["out_proj"].to(dt_c), sp.group)
    if state is None:
        return out, None
    # the conv state holds the tail of the *pre-conv* xBC stream
    new_conv = torch.cat([tail, xBC_raw], dim=1)[:, -(s.d_conv - 1):]
    return out, {"conv": _conv_shard(new_conv, state["conv"], d_in, sp),
                 "ssm": final}


def decode_step_mamba2(p, x: torch.Tensor, cfg: ModelConfig, state: dict,
                       *, kernel_norm: bool = False
                       ) -> Tuple[torch.Tensor, dict]:
    """x [B, 1, d] → (out [B, 1, d], new state).  O(1) per token."""
    s = cfg.ssm
    B = x.shape[0]
    dt_c = cfg.cdtype
    sp = _split(cfg, x.device)
    p = _leaves(p, cfg, sp)
    d_in, H = p["out_norm"].shape[0], p["a_log"].shape[0]
    zxbcdt = spmd.copy_to(x[:, 0].to(dt_c), sp.group) \
        @ p["in_proj"].to(dt_c)                           # [B, proj]
    z, xBC, dt_raw = _split_proj(zxbcdt, d_in, H)
    window = torch.cat([_conv_tail(state["conv"], cfg, sp).to(dt_c),
                        xBC[:, None]], dim=1)
    # window[:, i] holds x_{t-(W-1-i)}: tap weight w[:, i]
    conv_out = torch.einsum("bwc,cw->bc", window, p["conv_w"].to(dt_c))
    x_in, B_, C_ = _split_xbc(F.silu(conv_out + p["conv_b"].to(dt_c)), d_in,
                              cfg)

    dt = _softplus(dt_raw.float() + p["dt_bias"])         # [B, H]
    A = -torch.exp(p["a_log"])
    xh = x_in.reshape(B, H, s.head_dim)
    Bh = B_.reshape(B, s.n_groups, s.d_state)
    Ch = C_.reshape(B, s.n_groups, s.d_state)
    if sp.groups is not None:
        Bh, Ch = Bh.index_select(1, sp.groups), Ch.index_select(1, sp.groups)
    y, new_ssm = ops.ssd_decode_step(xh, dt, A, Bh, Ch, state["ssm"])
    y = y + xh * p["d_skip"][None, :, None].to(y.dtype)
    y = _gated_norm(y.reshape(B, d_in), z, p["out_norm"], cfg, sp,
                    kernel_norm)
    out = spmd.reduce_from(y @ p["out_proj"].to(dt_c), sp.group)[:, None]
    return out, {"conv": _conv_shard(window[:, 1:], state["conv"], d_in, sp),
                 "ssm": new_ssm}
