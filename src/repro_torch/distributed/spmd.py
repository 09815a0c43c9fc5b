"""The local view of a sharded program: process groups of a mesh's axes,
the differentiable collectives the model's sharded path runs, and the
placement of whole tensors onto shards and back.

The port runs a sharded step the way the JAX package's MoE ``shard_map``
body runs: every rank computes on plain local tensors and the collectives
are explicit.  Parameters arrive gathered over the data axes (``fsdp``
dims) and still sharded over ``model``; a layer whose heads, ``ffn`` or
vocabulary are model-sharded enters its region through ``copy_to``
(identity forward, all-reduce of the gradient) and leaves it through
``reduce_from`` (all-reduce forward, identity backward), Megatron's
``f`` and ``g``.  A replicated activation then carries the whole gradient
on every rank of the model axis, and a replicated weight that the ranks
use for different heads (KV heads that do not divide the axis, the qk
norms) goes through ``copy_to`` itself, so its gradient is summed.
Every collective over a group of one rank is the identity and sends
nothing.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (axis_sizes, current_rules,
                                              spec_axes)

Axes = Tuple[str, ...]


class MeshComm:
    """A mesh's axis sizes, this rank's coordinate and one process group
    for every set of its axes that spans more than one rank (created
    eagerly, by every rank in the same order)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.sizes: Dict[str, int] = axis_sizes(mesh)
        self.names: Axes = tuple(self.sizes)
        self._groups: Dict[Axes, object] = {}
        if not hasattr(mesh, "mesh_dim_names"):
            self.coord = dict.fromkeys(self.names, 0)
            return
        self.coord = dict(zip(self.names, mesh.get_coordinate()))
        ranks = mesh.mesh
        for n in range(1, len(self.names) + 1):
            for subset in itertools.combinations(range(len(self.names)), n):
                axes = tuple(self.names[i] for i in subset)
                if self.size(axes) == 1:
                    continue
                if n == 1:
                    self._groups[axes] = mesh.get_group(axes[0])
                    continue
                rest = [i for i in range(len(self.names)) if i not in subset]
                rows = ranks.permute(*rest, *subset).reshape(
                    -1, self.size(axes)).tolist()
                assert all(r == sorted(r) for r in rows), rows
                self._groups[axes], _ = dist.new_subgroups_by_enumeration(
                    rows)

    def axes(self, axes: Sequence[str]) -> Axes:
        """``axes`` that this mesh has, in the mesh's order."""
        return tuple(a for a in self.names if a in tuple(axes))

    def size(self, axes: Sequence[str]) -> int:
        return math.prod(self.sizes[a] for a in self.axes(axes))

    def index(self, axes: Sequence[str]) -> int:
        """This rank's row-major index over ``axes`` (major first)."""
        i = 0
        for a in self.axes(axes):
            i = i * self.sizes[a] + self.coord[a]
        return i

    def group(self, axes: Sequence[str]):
        """The group over ``axes`` that holds this rank; ``None`` when it
        spans one rank."""
        return self._groups.get(self.axes(axes))


_COMMS: Dict[int, Tuple[object, MeshComm]] = {}


def comm_of(mesh) -> MeshComm:
    """The ``MeshComm`` of ``mesh``, made once a mesh."""
    hit = _COMMS.get(id(mesh))
    if hit is None or hit[0] is not mesh:
        hit = (mesh, MeshComm(mesh))
        _COMMS[id(mesh)] = hit
    return hit[1]


def current() -> Optional[MeshComm]:
    """The current rules' mesh as a ``MeshComm``; ``None`` outside a rules
    context or for a shape stand-in with no devices."""
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return None
    m = rules.mesh
    if not (hasattr(m, "mesh_dim_names") or hasattr(m, "device_type")):
        return None
    return comm_of(m)


def dp_axes(rules) -> Axes:
    """The mesh axes the batch is sharded over (JAX ``moe._dp_axes``)."""
    ax = rules.rules.get("batch")
    if ax is None:
        return ()
    ax = (ax,) if isinstance(ax, str) else tuple(ax)
    return tuple(a for a in ax if a in rules.shape)


def dp_group():
    """The group of the current rules' batch axes, ``None`` for one rank."""
    c = current()
    return None if c is None else c.group(dp_axes(current_rules()))


# ---------------------------------------------------------------------------
# plain collectives (no autograd)
# ---------------------------------------------------------------------------

def all_reduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """Sum (or ``op``) over ``group``, into a new tensor."""
    out = x.detach().clone()
    if group is not None:
        dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=group)
    return out


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's pieces concatenated along ``dim`` in group-rank order."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    xc = x.detach().contiguous()
    parts = [torch.empty_like(xc) for _ in range(n)]
    dist.all_gather(parts, xc, group=group)
    return torch.cat(parts, dim=dim)


def narrow_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's piece of ``x`` along ``dim`` over ``group``."""
    if group is None:
        return x
    n, r = dist.get_world_size(group), dist.get_rank(group)
    k = x.shape[dim] // n
    return x.narrow(dim, r * k, k)


def merge_partials(o: torch.Tensor, lse: torch.Tensor, group) -> torch.Tensor:
    """The attention of every row over keys split across ``group``, from
    each rank's partial: ``o [..., Dv]`` over its own keys and the f32
    log-sum-exp ``lse [...]`` of its logits (``NEG_INF`` where it holds no
    valid key).  The log-sum-exp rule with a max and a sum all-reduce:
    ``m = max lse``, ``o = Σ o_r·e^(lse_r − m) / Σ e^(lse_r − m)``, in
    f32, returned in o's dtype.  A rank without a key adds nothing; a row
    no rank has a key for stays 0.  The identity on one rank.  No
    autograd (decode needs none)."""
    if group is None:
        return o
    m = all_reduce(lse, group, dist.ReduceOp.MAX)
    w = torch.exp(lse - m)[..., None]
    num = all_reduce(torch.cat([o.float() * w, w], dim=-1), group)
    return (num[..., :-1] / num[..., -1:]).to(o.dtype)


def _a2a(x: torch.Tensor, split: int, concat: int, group) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: ``x`` cut into n pieces along ``split``,
    piece j sent to group rank j, the received pieces concatenated along
    ``concat`` in group-rank order."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    parts = torch.stack(torch.chunk(x, n, dim=split)).contiguous()
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=group)
    return torch.cat(out.unbind(0), dim=concat)


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Enter a region whose ranks use ``x`` for different parts: identity
    forward, the gradient summed over ``group`` backward."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Leave such a region: partial results summed over ``group``; the
    (replicated) gradient passes through."""
    return x if group is None else _ReduceFrom.apply(x, group)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return narrow_dim(g, ctx.dim, ctx.group).contiguous(), None, None


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather along ``dim``; backward, this rank's piece of the
    gradient as it is (each rank computed the whole one)."""
    return x if group is None else _Gather.apply(x, dim, group)


def gather_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather along ``dim``; backward, the gradient summed over the
    group and cut back to this rank's piece (a reduce-scatter)."""
    return copy_to(gather(x, dim, group), group)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, concat, group):
        ctx.args = (split, concat, group)
        return _a2a(x, split, concat, group)

    @staticmethod
    def backward(ctx, g):
        split, concat, group = ctx.args
        # the transpose of a tiled all_to_all swaps split and concat
        return _a2a(g.contiguous(), concat, split, group), None, None, None


def all_to_all(x: torch.Tensor, split: int, concat: int, group):
    return x if group is None else _AllToAll.apply(x, split, concat, group)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def scale_grad(x: torch.Tensor, s: float) -> torch.Tensor:
    """Identity forward; the gradient times ``s`` backward."""
    return x if s == 1.0 else _ScaleGrad.apply(x, s)


# ---------------------------------------------------------------------------
# whole tensors ↔ shards
# ---------------------------------------------------------------------------

def shard_of(full: torch.Tensor, spec, comm: MeshComm,
             axes: Optional[Sequence[str]] = None) -> torch.Tensor:
    """This rank's shard of ``full`` under ``spec``, cut over the spec's
    entries whose axes all lie in ``axes`` (every axis by default).  The
    whole tensor itself when nothing is cut."""
    out = full
    for i, entry in enumerate(spec):
        names = spec_axes(entry)
        if not names or (axes is not None
                         and not set(names) <= set(axes)):
            continue
        n = comm.size(names)
        if n > 1:
            k = out.shape[i] // n
            out = out.narrow(i, comm.index(names) * k, k)
    return out


def gather_of(local: torch.Tensor, spec, comm: MeshComm,
              axes: Optional[Sequence[str]] = None) -> torch.Tensor:
    """The inverse of ``shard_of``: the pieces gathered (no autograd) over
    the entries whose axes lie in ``axes`` (every axis by default)."""
    out = local
    for i, entry in enumerate(spec):
        names = spec_axes(entry)
        if not names or (axes is not None
                         and not set(names) <= set(axes)):
            continue
        out = all_gather_dim(out, i, comm.group(names))
    return out


def model_split(logical: str, size: int) -> Tuple[Optional[object], int, int]:
    """(group, size, rank) of the ``model`` axis when the current rules
    shard a dim of the logical name ``logical`` and global ``size`` over
    it (the divisibility fallback included); (None, 1, 0) otherwise."""
    rules = current_rules()
    if rules is None or rules.shape.get("model", 1) == 1:
        return None, 1, 0
    spec = rules.resolve((logical,), (size,))
    if not spec or "model" not in spec_axes(spec[0]):
        return None, 1, 0
    c = current()
    if c is None:
        return None, 1, 0
    return c.group(("model",)), c.sizes["model"], c.coord["model"]
