"""Logical-axis sharding rules, as ``repro.distributed.sharding``.

Model code names an activation's dims with *logical* axes (``shard(x,
"batch", "seq", "embed")``); parameter trees get logical dims from a
name-keyed rule table.  A ``ShardingRules`` resolves logical names to mesh
axes, so the same tables serve the single-pod ``("data", "model")`` mesh,
the multi-pod ``("pod", "data", "model")`` mesh and a one-rank test mesh.

Resolution is divisibility-safe: a logical dim maps to a mesh axis only if
its size divides evenly (8 KV heads on a 16-way model axis fall back to
replication).  A resolved spec is a tuple with one entry per leading
tensor dim: ``None`` (replicated), a mesh-axis name, or a tuple of names
(major to minor), trailing ``None``s trimmed: the JAX ``PartitionSpec``'s
entries.  ``placements`` turns a spec into DTensor placements on a
``DeviceMesh`` with named dims.

The mesh may be a ``torch.distributed.device_mesh.DeviceMesh`` (named
dims) or any object with a ``shape`` mapping of axis name → size (what
the rule tables and the spec functions need; no process group).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]


# default logical-axis → mesh-axis tables -----------------------------------

def single_pod_rules() -> Dict[str, MeshAxes]:
    return {
        "batch": ("data",),
        "cache_batch": ("data",),  # KV-cache batch dim (may differ from act)
        "seq": None,
        "embed": None,
        "fsdp": "data",          # ZeRO-3 param/optimizer sharding
        "heads": "model",
        "kv_heads": "model",
        "kv_seq": "model",       # context-parallel KV cache fallback
        "ffn": "model",
        "inner": "model",        # mamba d_inner
        "experts": "model",      # expert parallelism
        "vocab": "model",
        "act_seq": None,         # sequence parallelism (off by default)
    }


def multi_pod_rules() -> Dict[str, MeshAxes]:
    r = single_pod_rules()
    r["batch"] = ("pod", "data")
    r["cache_batch"] = ("pod", "data")
    return r


def seqpar_rules(multi_pod: bool = False) -> Dict[str, MeshAxes]:
    """Megatron-style sequence parallelism: the residual stream sharded
    over ``model`` along the sequence between attention and FFN."""
    r = multi_pod_rules() if multi_pod else single_pod_rules()
    r["act_seq"] = "model"
    return r


def serve2d_rules(multi_pod: bool = False) -> Dict[str, MeshAxes]:
    """Decode-oriented 2-D tensor parallelism: weights sharded over both
    axes (the contraction dim over ``data``, heads/ffn over ``model``),
    activations replicated over batch; the KV cache keeps its batch →
    data sharding through ``cache_batch``."""
    r = multi_pod_rules() if multi_pod else single_pod_rules()
    r["batch"] = None
    r["embed"] = "data" if not multi_pod else ("pod", "data")
    r["cache_batch"] = ("data",) if not multi_pod else ("pod", "data")
    return r


RULE_TABLES = {
    "default": lambda multi: multi_pod_rules() if multi else single_pod_rules(),
    "seqpar": seqpar_rules,
    "serve2d": serve2d_rules,
}


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name → size, for a ``DeviceMesh`` (its dim names) or a
    stand-in with a ``shape`` mapping."""
    if mesh is None:
        return {}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.mesh.shape)))
    return dict(mesh.shape)


class ShardingRules:
    def __init__(self, mesh, rules: Dict[str, MeshAxes]):
        self.mesh = mesh
        self.rules = dict(rules)
        self.shape = axis_sizes(mesh)

    def mesh_axis_size(self, axes: MeshAxes) -> int:
        if axes is None or self.mesh is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        return int(math.prod(self.shape[a] for a in axes))

    def resolve(self, logical_dims: Sequence[Optional[str]],
                shape: Optional[Sequence[int]] = None) -> Spec:
        out: List[MeshAxes] = []
        used = set()
        for i, name in enumerate(logical_dims):
            axes = self.rules.get(name) if name else None
            if axes is None:
                out.append(None)
                continue
            ax_tuple = (axes,) if isinstance(axes, str) else tuple(axes)
            ax_tuple = tuple(a for a in ax_tuple if a not in used
                             and a in self.shape) if self.mesh is not None \
                else ()
            if not ax_tuple:
                out.append(None)
                continue
            if shape is not None:
                if shape[i] % self.mesh_axis_size(ax_tuple) != 0:
                    out.append(None)
                    continue
            used.update(ax_tuple)
            out.append(ax_tuple[0] if len(ax_tuple) == 1 else ax_tuple)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)


def spec_axes(entry: MeshAxes) -> Tuple[str, ...]:
    """A spec entry's mesh axes, major to minor."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on a ``DeviceMesh`` with named dims:
    tensor dim ``i`` mapped to one or more mesh dims is ``Shard(i)`` on
    each of them, every other mesh dim ``Replicate()``.  A dim over
    several mesh axes must name them in the mesh's order (major first), as
    every rule table does."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        axes = spec_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {i}'s axes {axes} are not in "
                             f"the mesh's order {tuple(names)}")
        for j in idx:
            out[j] = Shard(i)
    return out


# rules context --------------------------------------------------------------

_local = threading.local()


def current_rules() -> Optional[ShardingRules]:
    return getattr(_local, "rules", None)


@contextlib.contextmanager
def with_rules(rules: Optional[ShardingRules]):
    """Make ``rules`` (or none) current in this thread.  Code that runs a
    block again on another thread takes the rules its first run saw: the
    autograd engine recomputes a checkpointed layer on the card's
    backward thread (``transformer._remat``)."""
    prev = current_rules()
    _local.rules = rules
    try:
        yield rules
    finally:
        _local.rules = prev


@contextlib.contextmanager
def use_rules(mesh, rules: Optional[Dict[str, MeshAxes]] = None):
    """Make ``ShardingRules(mesh, rules)`` current in this thread (the
    default table for the mesh when ``rules`` is None; no rules at all for
    ``mesh=None``)."""
    if rules is None:
        rules = (multi_pod_rules() if mesh is not None
                 and "pod" in axis_sizes(mesh) else single_pod_rules())
    with with_rules(ShardingRules(mesh, rules) if mesh is not None
                    else None) as r:
        yield r


def shard(x, *logical_dims: Optional[str]):
    """Constrain an activation's placement: a DTensor is redistributed to
    the resolved spec; a plain tensor (the model's local view) and any
    tensor outside a rules context pass through unchanged."""
    ctx = current_rules()
    if ctx is None or ctx.mesh is None \
            or not hasattr(ctx.mesh, "mesh_dim_names"):
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = ctx.resolve(logical_dims, x.shape)
    return x.redistribute(ctx.mesh, placements(spec, ctx.mesh))


# ---------------------------------------------------------------------------
# parameter logical dims (keyed on leaf path names)
# ---------------------------------------------------------------------------

# leaf name → logical dims of the *unstacked* (one-layer) parameter;
# stacked leaves get leading ``None`` (layer) dims
_PARAM_DIMS: Dict[str, Tuple[Optional[str], ...]] = {
    # embeddings / heads
    "embedding": ("vocab", "fsdp"),
    "w_head": ("fsdp", "vocab"),
    "w_frontend": (None, "fsdp"),
    # attention
    "w_q": ("fsdp", "heads", None),
    "w_k": ("fsdp", "kv_heads", None),
    "w_v": ("fsdp", "kv_heads", None),
    "w_o": ("heads", None, "fsdp"),
    "b_q": ("heads", None), "b_k": ("kv_heads", None),
    "b_v": ("kv_heads", None), "b_o": (None,),
    "q_norm": (None,), "k_norm": (None,), "kv_norm": (None,),
    # MLA
    "w_dq": ("fsdp", None), "w_uq": (None, "heads", None),
    "w_dkv": ("fsdp", None), "w_kr": ("fsdp", None),
    "w_uk": (None, "heads", None), "w_uv": (None, "heads", None),
    # mlp
    "w_gate": ("fsdp", "ffn"), "w_up": ("fsdp", "ffn"), "w_down": ("ffn", "fsdp"),
    "b_up": ("ffn",), "b_down": (None,),
    # moe
    "router": (None, None),
    # mamba2
    "in_proj": ("fsdp", "inner"), "out_proj": ("inner", "fsdp"),
    "conv_w": ("inner", None), "conv_b": ("inner",),
    "dt_bias": (None,), "a_log": (None,), "d_skip": (None,), "out_norm": (None,),
    # norms
    "scale": (None,), "bias": (None,),
}

# expert weights: experts → model (EP) when divisible; otherwise the
# resolver leaves experts unsharded and "ffn" takes the model axis
# (per-expert tensor parallelism)
_MOE_DIMS: Dict[str, Tuple[Optional[str], ...]] = {
    "w_gate": ("experts", "fsdp", "ffn"),
    "w_up": ("experts", "fsdp", "ffn"),
    "w_down": ("experts", "ffn", "fsdp"),
}


def _leaf_dims(names: Sequence[str], ndim: int) -> Tuple[Optional[str], ...]:
    """Logical dims of the leaf at the dict path ``names``."""
    leaf_name = names[-1]
    in_moe = any(n == "moe" for n in names[:-1])
    in_shared = any(n == "shared" for n in names)
    table = _MOE_DIMS if (in_moe and not in_shared
                          and leaf_name in _MOE_DIMS) else _PARAM_DIMS
    dims = table.get(leaf_name, ())
    if len(dims) < ndim:
        dims = (None,) * (ndim - len(dims)) + tuple(dims)
    elif len(dims) > ndim:
        dims = tuple(dims[-ndim:]) if ndim else ()
    return tuple(dims)


def map_with_names(fn, tree, names: Tuple[str, ...] = ()):
    """``fn(names, leaf)`` over a tree of dicts (and NamedTuples, whose
    fields extend the path), ``names`` the keys down to the leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_names(fn, v, names + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_names(fn, getattr(tree, f),
                                           names + (f,))
                            for f in tree._fields))
    return fn(names, tree)


def param_partition_specs(params, rules: ShardingRules):
    """One spec per leaf of a parameter tree (real or ``meta`` tensors)."""
    return map_with_names(
        lambda n, leaf: rules.resolve(_leaf_dims(n, leaf.dim()),
                                      tuple(leaf.shape)), params)


# cache logical dims ---------------------------------------------------------

def cache_partition_specs(cache, rules: ShardingRules):
    """KV caches: batch → data; kv_heads → model when divisible, else
    seq → model; MLA's latent pair seq → model; Mamba2 states by batch and
    their inner or head dim."""
    def spec(names, leaf) -> Spec:
        name = names[-1]
        shape = tuple(leaf.shape)
        if name in ("k", "v"):
            lead = (None,) * (len(shape) - 4)
            h = shape[-2]
            if h % max(rules.mesh_axis_size(rules.rules.get("kv_heads")),
                       1) == 0:
                return rules.resolve(
                    lead + ("cache_batch", None, "kv_heads", None), shape)
            return rules.resolve(
                lead + ("cache_batch", "kv_seq", None, None), shape)
        if name in ("c_kv", "k_rope"):
            lead = (None,) * (len(shape) - 3)
            return rules.resolve(lead + ("cache_batch", "kv_seq", None),
                                 shape)
        if name == "conv":
            lead = (None,) * (len(shape) - 3)
            return rules.resolve(lead + ("cache_batch", None, "inner"), shape)
        if name == "ssm":
            lead = (None,) * (len(shape) - 4)
            return rules.resolve(
                lead + ("cache_batch", "heads", None, None), shape)
        return ()
    return map_with_names(spec, cache)


def is_spec(x) -> bool:
    """A spec (a tuple of entries), not a subtree."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)
