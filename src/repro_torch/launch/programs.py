"""Program builders, as ``repro.launch.programs``: the training
configuration bundle, the step functions, their input specs and their
shardings, in one place, so that what the trainer, the executors and the
drivers run is what the specs describe.

Input specs are ``meta`` tensors (shapes and dtypes, never allocated).
Shardings are spec trees (``distributed.sharding``: one tuple of mesh
axes a leaf); ``sharding.placements`` turns a spec into DTensor
placements.  A step runs on this rank's shards: ``build_train_step``
gathers each parameter's data-sharded (``fsdp``) dims, runs the loss
under the mesh's rules (the model-sharded heads, ``ffn``, vocabulary and
experts computed locally, ``distributed.spmd``), sums the gradients over
the batch axes, cuts them back to the shards and steps AdamW on the
shards; on a one-rank mesh every collective is the identity and the
step is the single-device one.  The JAX ``lower_program`` (its dry-run's
compile) has no counterpart yet (ROADMAP Queue A item 14).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.distributed import sharding as shlib, spmd
from repro_torch.launch.mesh import as_mesh
from repro_torch.launch.shapes import SHAPES, ShapeSpec
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.optim import adamw, grad as gradlib, schedule
from repro_torch.tree import leaves, unflatten_like


# ---------------------------------------------------------------------------
# training configuration bundle
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: adamw.AdamWConfig = adamw.AdamWConfig()
    sched: schedule.ScheduleConfig = schedule.ScheduleConfig()
    num_microbatches: int = 1
    compress_grads: bool = False      # int8 error-feedback gradient payload


def default_train_config(cfg: ModelConfig) -> TrainConfig:
    """8-bit optimizer state for the archs above 30B parameters."""
    big = cfg.num_params() > 30e9
    return TrainConfig(
        adamw=adamw.AdamWConfig(state_dtype="int8" if big else "float32"))


# ---------------------------------------------------------------------------
# input specs (meta tensors: never allocate)
# ---------------------------------------------------------------------------

def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    B, T = shape.global_batch, shape.seq_len
    if cfg.frontend == "audio_frames":
        return {"features": _meta((B, T, cfg.frontend_dim), torch.bfloat16),
                "targets": _meta((B, T), torch.int32),
                "mask": _meta((B, T), torch.bool)}
    return {"tokens": _meta((B, T), torch.int32),
            "labels": _meta((B, T), torch.int32)}


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    B, T = shape.global_batch, shape.seq_len
    if cfg.frontend == "audio_frames":
        return {"features": _meta((B, T, cfg.frontend_dim), torch.bfloat16)}
    return {"tokens": _meta((B, T), torch.int32)}


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int,
                dtype=torch.bfloat16):
    return transformer.init_cache_tree(cfg, batch, max_seq, dtype, "meta")


def decode_arg_specs(cfg: ModelConfig, shape: ShapeSpec):
    B, S = shape.global_batch, shape.seq_len
    return {"tokens": _meta((B,), torch.int32),
            "caches": cache_specs(cfg, B, S),
            "cache_len": _meta((B,), torch.int32)}


def param_specs_abstract(cfg: ModelConfig):
    return build_model(cfg, "meta").init_abstract()


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict[str, Any]:
    """All (non-parameter) inputs of the step the shape runs, as specs."""
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"batch": prefill_batch_specs(cfg, shape),
                "caches": cache_specs(cfg, shape.global_batch, shape.seq_len)}
    return decode_arg_specs(cfg, shape)


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------

def flat_specs(spec_tree) -> list:
    """A spec tree's specs in leaf order (the order of ``tree.leaves`` of
    the tree they describe)."""
    if spec_tree is None:
        return []
    if shlib.is_spec(spec_tree):
        return [spec_tree]
    if isinstance(spec_tree, dict):
        return [s for k in sorted(spec_tree)
                for s in flat_specs(spec_tree[k])]
    return [s for x in spec_tree for s in flat_specs(x)]


def moment_specs(spec_tree) -> list:
    """One spec a parameter leaf, in leaf order, from a moment spec tree
    (an int8 moment's ``QuantMoment`` of specs gives its payload's)."""
    if isinstance(spec_tree, dict):
        return [s for k in sorted(spec_tree)
                for s in moment_specs(spec_tree[k])]
    return [spec_tree.q if hasattr(spec_tree, "_fields") else spec_tree]


def batch_shardings(batch_specs, rules: shlib.ShardingRules):
    return shlib.map_with_names(
        lambda _, leaf: rules.resolve(
            ("batch",) + (None,) * (leaf.dim() - 1), tuple(leaf.shape)),
        batch_specs)


def opt_state_shardings(abstract_state, param_spec_tree,
                        rules: shlib.ShardingRules, acfg: adamw.AdamWConfig):
    """fp32 moments take their parameter's spec; int8 moments' block axis
    is sharded over every mesh axis there is (the update is elementwise in
    block space), else over the last of them, else replicated."""
    if acfg.state_dtype == "int8":
        axes = tuple(a for a in ("pod", "data", "model")
                     if rules.mesh is not None and a in rules.shape)
        size = rules.mesh_axis_size(axes) if axes else 1

        def qspec(_, leaf):
            n = leaf.shape[0]
            if axes and n % size == 0:
                return (axes,)
            if axes and n % rules.shape[axes[-1]] == 0:
                return (axes[-1],)
            return (None,)
        mspec = shlib.map_with_names(qspec, abstract_state["m"])
        vspec = shlib.map_with_names(qspec, abstract_state["v"])
    else:
        mspec, vspec = param_spec_tree, param_spec_tree
    return {"step": (), "m": mspec, "v": vspec}


def rules_for(mesh, rules_name: str = "default") -> shlib.ShardingRules:
    return shlib.ShardingRules(
        mesh, shlib.RULE_TABLES[rules_name]("pod" in shlib.axis_sizes(mesh)))


def program_shardings(cfg: ModelConfig, shape_name: str, mesh,
                      tcfg: Optional[TrainConfig] = None,
                      rules_name: str = "default"):
    """Returns (in_specs, out_specs, arg_specs, step_fn, donate): spec
    trees of the step's arguments and results, its abstract arguments,
    the step and the donated argument indices."""
    shape = SHAPES[shape_name]
    rules = rules_for(mesh, rules_name)
    abstract_params = param_specs_abstract(cfg)
    psh = shlib.param_partition_specs(abstract_params, rules)

    if shape.kind == "train":
        tcfg = tcfg or default_train_config(cfg)
        abstract_opt = adamw.init_state(abstract_params, tcfg.adamw)
        osh = opt_state_shardings(abstract_opt, psh, rules, tcfg.adamw)
        bspecs = train_batch_specs(cfg, shape)
        bsh = batch_shardings(bspecs, rules)
        fn = build_train_step(cfg, tcfg, "meta", mesh=mesh,
                              rules_name=rules_name)
        return ((psh, osh, bsh), (psh, osh, None),
                (abstract_params, abstract_opt, bspecs), fn, (0, 1))

    logit_sh = rules.resolve(("batch", "vocab"),
                             (shape.global_batch, cfg.vocab_size))
    tok_sh = rules.resolve(("batch",), (shape.global_batch,))
    if shape.kind == "prefill":
        bspecs = prefill_batch_specs(cfg, shape)
        bsh = batch_shardings(bspecs, rules)
        cspecs = cache_specs(cfg, shape.global_batch, shape.seq_len)
        csh = shlib.cache_partition_specs(cspecs, rules)
        fn = build_prefill_step(cfg, "meta")
        return ((psh, bsh, csh), (logit_sh, csh, tok_sh),
                (abstract_params, bspecs, cspecs), fn, (2,))

    aspecs = decode_arg_specs(cfg, shape)
    csh = shlib.cache_partition_specs(aspecs["caches"], rules)
    fn = build_decode_step(cfg, "meta")
    return ((psh, tok_sh, csh, tok_sh), (logit_sh, csh, tok_sh),
            (abstract_params, aspecs["tokens"], aspecs["caches"],
             aspecs["cache_len"]), fn, (2,))


# ---------------------------------------------------------------------------
# the local view of sharded parameters
# ---------------------------------------------------------------------------

def _replicated_over_model(cfg: ModelConfig) -> bool:
    """The SSM families run replicated over ``model``: Mamba2's ``inner``
    split of ``in_proj`` is not a local view its layer computes."""
    return cfg.family in ("ssm", "hybrid")


def view_axes(cfg: ModelConfig, comm: spmd.MeshComm) -> tuple:
    """The mesh axes a step gathers its parameters over: every axis but
    ``model`` for the families whose layers run model-sharded (dense, moe,
    encoder); every axis for the SSM families."""
    if _replicated_over_model(cfg):
        return comm.names
    return tuple(a for a in comm.names if a != "model")


def forward_rules(cfg: ModelConfig, table: dict) -> dict:
    """The rule table a step's forward runs under: ``table``, or for a
    family that runs replicated over ``model`` the table with every
    logical axis that maps to ``model`` unmapped (its layers then see
    whole leaves and take no model-axis region)."""
    if not _replicated_over_model(cfg):
        return table
    return {k: None if "model" in shlib.spec_axes(v) else v
            for k, v in table.items()}


def _cut(spec, comm: spmd.MeshComm, axes) -> bool:
    """Whether ``spec`` splits a dim over more than one rank of ``axes``."""
    return any(names and set(names) <= set(axes) and comm.size(names) > 1
               for names in map(shlib.spec_axes, spec))


def param_views(params, pspecs, comm: spmd.MeshComm, axes, grad: bool):
    """Each parameter gathered over ``axes`` (no autograd through the
    gather); a leaf nothing gathers is passed as it is.  With ``grad`` a
    gathered view is a new leaf that requires grad."""
    return unflatten_like(params, [
        spmd.gather_of(p.detach(), s, comm, axes).requires_grad_(grad)
        if _cut(s, comm, axes) else p
        for p, s in zip(leaves(params), flat_specs(pspecs))])


def _spec_shards(spec, comm: spmd.MeshComm) -> int:
    return math.prod(comm.size(shlib.spec_axes(e)) for e in spec)


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def build_train_step(cfg: ModelConfig, tcfg: TrainConfig, device=None,
                     mesh=None, rules_name: str = "default") -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on this rank's shards of ``mesh`` (a ``LocalMesh`` on
    ``device`` when None): ``batch`` holds this rank's rows of the global
    batch; every metric is the global one.  The LR multiplier reads the
    step before the optimizer increments it, so step 0 trains at lr 0, as
    in JAX.  Parameters and fp32 moments update in place."""
    model = build_model(cfg, device)
    mesh = as_mesh(mesh if mesh is not None else device)
    rules = rules_for(mesh, rules_name)
    abstract = model.init_abstract()
    pspecs = shlib.param_partition_specs(abstract, rules)
    ospecs = opt_state_shardings(adamw.init_state(abstract, tcfg.adamw),
                                 pspecs, rules, tcfg.adamw)
    unread = model.unread_leaves()

    def train_step(params, opt_state, batch):
        comm = spmd.comm_of(mesh)
        axes = view_axes(cfg, comm)
        flat = flat_specs(pspecs)
        with shlib.use_rules(mesh, forward_rules(cfg, rules.rules)):
            views = param_views(params, pspecs, comm, axes, grad=True)
            (loss, metrics), grads = gradlib.accumulate_grads(
                model.loss, views, batch, tcfg.num_microbatches,
                unread=unread)
        dpg = comm.group(spmd.dp_axes(rules))
        gs = [spmd.shard_of(spmd.all_reduce(g, dpg) if dpg is not None
                            else g, s, comm, axes).contiguous()
              for g, s in zip(leaves(grads), flat)]
        if tcfg.compress_grads:
            # the int8 blocks run over whole leaves, as on one device
            whole = [spmd.gather_of(g, s, comm) for g, s in zip(gs, flat)]
            whole, _ = gradlib.compress_decompress(whole)
            gs = [spmd.shard_of(g, s, comm).contiguous()
                  for g, s in zip(whole, flat)]
        W = comm.size(comm.names)
        sq = torch.sum(torch.stack([
            torch.sum(torch.square(g.to(torch.float32)))
            / float(W // _spec_shards(s, comm)) for g, s in zip(gs, flat)]))
        gnorm = torch.sqrt(spmd.all_reduce(sq, comm.group(comm.names)))
        grads = unflatten_like(params, gs)
        lr_scale = schedule.lr_multiplier(opt_state["step"], tcfg.sched)
        placement = None
        if W > 1:
            placement = (comm, flat, moment_specs(ospecs["m"]))
        params, opt_state, om = adamw.apply_updates(
            params, grads, opt_state, tcfg.adamw, lr_scale, gnorm=gnorm,
            placement=placement)
        metrics = dict(metrics)
        metrics.update(om)
        return params, opt_state, metrics

    train_step.param_specs = pspecs
    train_step.opt_specs = ospecs
    train_step.rules = rules
    return train_step


def _gathered(model, step):
    """``step`` run on parameters gathered over the current mesh's data
    axes (a no-op outside a rules context or on one rank)."""
    def run(params, *args):
        comm = spmd.current()
        if comm is None or comm.size(comm.names) == 1:
            return step(params, *args)
        rules = shlib.current_rules()
        pspecs = shlib.param_partition_specs(model.init_abstract(), rules)
        params = param_views(params, pspecs, comm,
                             view_axes(model.cfg, comm), grad=False)
        with shlib.use_rules(rules.mesh, forward_rules(model.cfg,
                                                       rules.rules)):
            return step(params, *args)
    return run


def build_prefill_step(cfg: ModelConfig, device=None) -> Callable:
    """``prefill_step(params, batch, caches) -> (logits, caches,
    cache_len)``: the whole prompt into dense caches."""
    model = build_model(cfg, device)

    def prefill_step(params, batch, caches):
        logits, cache_len = model.prefill(params, batch, caches)
        return logits, caches, cache_len

    return _gathered(model, prefill_step)


def build_decode_step(cfg: ModelConfig, device=None) -> Callable:
    """``decode_step(params, tokens, caches, cache_len) -> (logits,
    caches, cache_len + 1)`` over dense caches."""
    model = build_model(cfg, device)

    def decode_step(params, tokens, caches, cache_len):
        logits = model.decode(params, tokens, caches, cache_len)
        return logits, caches, cache_len + 1

    return _gathered(model, decode_step)
