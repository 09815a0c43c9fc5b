"""The port's sharding specs against the JAX package's, with no devices
and no processes: JAX's ``ShardingRules`` and the port's both take a mesh
stand-in that has only a ``shape`` mapping.

For every registered arch, the rule tables ``default``, ``seqpar`` and
``serve2d``, and the meshes (16, 16), (2, 16, 16), (2, 4) and (1, 1):
``param_partition_specs``, ``cache_partition_specs`` of the arch's dense
cache tree, ``opt_state_shardings`` with fp32 and int8 moments and the
batch specs of the train and prefill shapes, entry for entry.  Also
``shapes.applicable`` for every arch and shape, ``plan_elastic_mesh``
over a grid, and the specs' DTensor placements.
"""
import functools

import jax
import pytest

from repro.configs import get_config as jget_config
from repro.distributed import sharding as jsh
from repro.distributed.fault_tolerance import plan_elastic_mesh as jplan
from repro.launch import programs as jprograms
from repro.launch import shapes as jshapes
from repro.models.model import build_model as jax_build
from repro.optim import adamw as jadamw
from repro_torch.checkpointing.checkpoint import _spec_paths
from repro_torch.configs import _MODULES, get_config
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed.fault_tolerance import plan_elastic_mesh
from repro_torch.launch import programs, shapes
from repro_torch.optim import adamw

ARCHS = sorted(_MODULES)
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4},
          "1x1": {"data": 1, "model": 1}}


class ShapeOnly:
    """A mesh that is only its axis sizes."""

    def __init__(self, shape):
        self.shape = dict(shape)


@functools.lru_cache(maxsize=None)
def _jax_abstract(arch):
    cfg = jget_config(arch)
    params = jax_build(cfg).init_abstract()
    opt = {dt: jax.eval_shape(functools.partial(
        jadamw.init_state, cfg=jadamw.AdamWConfig(state_dtype=dt)), params)
        for dt in ("float32", "int8")}
    return cfg, params, opt


@functools.lru_cache(maxsize=None)
def _port_abstract(arch):
    cfg = get_config(arch)
    params = programs.param_specs_abstract(cfg)
    opt = {dt: adamw.init_state(params, adamw.AdamWConfig(state_dtype=dt))
           for dt in ("float32", "int8")}
    return cfg, params, opt


def _jax_specs(tree):
    """{keystr path: spec entries} of a JAX tree of PartitionSpecs."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}


def _same(jtree, ttree):
    want, got = _jax_specs(jtree), _spec_paths(ttree)
    assert sorted(want) == sorted(got)
    bad = {p: (want[p], got[p]) for p in want if want[p] != got[p]}
    assert not bad, list(bad.items())[:5]
    return len(want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_jax(arch, mesh, monkeypatch):
    # JAX wraps its specs in NamedShardings over the real mesh; keep the
    # specs themselves
    monkeypatch.setattr(jprograms, "_named", lambda rules, tree: tree)
    jcfg, jparams, jopt = _jax_abstract(arch)
    cfg, params, opt = _port_abstract(arch)
    stand_in = ShapeOnly(MESHES[mesh])
    multi = "pod" in MESHES[mesh]
    n = 0
    for table in ("default", "seqpar", "serve2d"):
        jr = jsh.ShardingRules(stand_in, jsh.RULE_TABLES[table](multi))
        tr = tsh.ShardingRules(stand_in, tsh.RULE_TABLES[table](multi))
        jp = jsh.param_partition_specs(jparams, jr)
        tp = tsh.param_partition_specs(params, tr)
        n += _same(jp, tp)
        for dt in ("float32", "int8"):
            acfg = (jadamw.AdamWConfig(state_dtype=dt),
                    adamw.AdamWConfig(state_dtype=dt))
            n += _same(jprograms.opt_state_shardings(jopt[dt], jp, jr,
                                                     acfg[0]),
                       programs.opt_state_shardings(opt[dt], tp, tr,
                                                    acfg[1]))
        for B, S in ((128, 32768), (1, 4096), (32, 1024)):
            jc = jprograms.cache_specs(jcfg, B, S)
            tc = programs.cache_specs(cfg, B, S)
            n += _same(jsh.cache_partition_specs(jc, jr),
                       tsh.cache_partition_specs(tc, tr))
        for name in ("train_4k", "prefill_32k"):
            s = jshapes.SHAPES[name]
            jb = (jprograms.train_batch_specs if s.kind == "train"
                  else jprograms.prefill_batch_specs)(jcfg, s)
            tb = (programs.train_batch_specs if s.kind == "train"
                  else programs.prefill_batch_specs)(cfg, shapes.SHAPES[name])
            n += _same(jprograms.batch_shardings(jb, jr),
                       programs.batch_shardings(tb, tr))
    assert n > 100


def test_resolve_falls_back_and_trims():
    r = tsh.ShardingRules(ShapeOnly({"data": 2, "model": 4}),
                          tsh.single_pod_rules())
    assert r.resolve(("fsdp", "heads", None), (8, 6, 4)) == ("data",)
    assert r.resolve(("fsdp", "heads", None), (8, 8, 4)) == ("data", "model")
    assert r.resolve(("batch", "cache_batch")) == ("data",)
    assert r.resolve((None, None)) == ()
    mp = tsh.ShardingRules(ShapeOnly({"pod": 2, "data": 2, "model": 1}),
                           tsh.multi_pod_rules())
    assert mp.resolve(("batch",), (8,)) == (("pod", "data"),)
    assert mp.resolve(("batch",), (6,)) == ()           # 6 % 4: replicated


def test_placements_on_a_named_mesh():
    from torch.distributed.tensor import Replicate, Shard

    class Names:
        mesh_dim_names = ("pod", "data", "model")

    m = Names()
    assert tsh.placements((("pod", "data"), None, "model"), m) == [
        Shard(0), Shard(0), Shard(2)]
    assert tsh.placements(("data",), m) == [Replicate(), Shard(0),
                                            Replicate()]
    assert tsh.placements((), m) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        tsh.placements((("data", "pod"),), m)


def test_shard_is_a_no_op_on_the_local_view():
    import torch

    x = torch.ones(2, 3)
    assert tsh.shard(x, "batch", None) is x
    with tsh.use_rules(ShapeOnly({"data": 2, "model": 2})):
        assert tsh.shard(x, "batch", None) is x
        assert tsh.current_rules().rules["batch"] == ("data",)
    assert tsh.current_rules() is None
    with tsh.use_rules(ShapeOnly({"pod": 2, "data": 2, "model": 2})) as r:
        assert r.rules["batch"] == ("pod", "data")


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_applicable_equal_jax(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    assert shapes.is_subquadratic(cfg) == jshapes.is_subquadratic(jcfg)
    for name, s in shapes.SHAPES.items():
        assert (s.seq_len, s.global_batch, s.kind) == (
            jshapes.SHAPES[name].seq_len, jshapes.SHAPES[name].global_batch,
            jshapes.SHAPES[name].kind)
        assert shapes.applicable(cfg, s) == jshapes.applicable(
            jcfg, jshapes.SHAPES[name])
    assert shapes.cells([arch], get_config) == jshapes.cells([arch],
                                                             jget_config)


def test_plan_elastic_mesh_equal_jax():
    n = 0
    for pods in (1, 2):
        for chips in (4, 8, 16):
            total = 16 * 16 * pods // chips
            for failed in range(0, total + 1, max(total // 12, 1)):
                args = (total, failed, chips, (16, 16), pods)
                try:
                    want = jplan(*args)
                except RuntimeError as e:
                    with pytest.raises(RuntimeError, match=str(e)):
                        plan_elastic_mesh(*args)
                    n += 1
                    continue
                got = plan_elastic_mesh(*args)
                assert (got.data_axis, got.model_axis, got.pods,
                        got.global_batch_scale, got.note) == (
                    want.data_axis, want.model_axis, want.pods,
                    want.global_batch_scale, want.note), args
                n += 1
    assert n > 50
    with pytest.raises(RuntimeError, match="no surviving"):
        plan_elastic_mesh(64, 64)
    with pytest.raises(AssertionError):
        plan_elastic_mesh(10, 1)
    plan = plan_elastic_mesh(64, 1, pods=2, base_mesh=(16, 8))
    assert (plan.data_axis, plan.pods, plan.model_axis) == (16, 1, 8)
