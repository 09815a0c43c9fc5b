"""The port's encoder family (``edge-cv-heavy``, ``hubert-xlarge``) against
the JAX package, on the same inputs made from a numpy seed, on the CPU:

- ``layer_norm`` against JAX ``_layernorm_cv`` in fp32 and bf16;
- the plain ``ref.mha`` at head dims 48 and 80 against JAX ``ref.mha`` and
  the Pallas kernel in interpret mode (the widths the CUDA forward gained
  for these models; the card holds the kernel against ``ref.mha``);
- reduced ``edge-cv-heavy`` and ``hubert-xlarge`` (head dims 32, 48 and
  80) in fp32: ``Model.forward`` logits within 2e-4 relative and ``loss``
  with a mask, from the JAX parameters through the weight bridge, which
  copies the encoder tree one to one and back;
- the golden fixture's ``encoder_*`` logits and losses replayed;
- ``num_params`` of both full configs, ``make_encoder_iterator``'s batches
  byte for byte;
- ``examples/hybrid_edge_serving.py``'s scenario (4 workers, 2 CV and 2
  stream replicas, 6 frames, a node failure, a scale-up) through both
  packages' ``EdgeSystem``: the same placements, events and predictions;
- the gates: ``check_ported`` takes ``parallel_block``, ``qk_norm`` and
  attention biases on a decoder and an encoder (logits equal to JAX's)
  and refuses MoE and sliding-window attention outside mixtral's pairing
  of them (item 11), MLA (item 11.4) and combinations no registered
  config has; the engine refuses an
  encoder with a ``ValueError``, and the container's prefill/decode
  refuse it too.

Tolerances: 2e-5 (fp32) and 3.5e-2 (bf16) for the norm and attention,
relative to the largest output; 2e-4 for logits and losses (the two
packages sum in other orders over 2 layers).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
import torch_port_golden as golden
from repro.configs import get_config as jax_config
from repro.configs import get_reduced_config as jax_reduced
from repro.data import stream as jstream
from repro.data.tokens import make_encoder_iterator as jax_encoder_iter
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import layers as jlayers
from repro.models.model import build_model as jax_build
from repro.serving import router as jrouter
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.data import stream as tstream
from repro_torch.data.tokens import make_encoder_iterator
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as tlayers
from repro_torch.models.config import ModelConfig, check_ported
from repro_torch.models.model import Model
from repro_torch.models.weights import (from_numpy_tree, to_numpy_tree,
                                        unflatten)
from repro_torch.serving import router as trouter
from repro_torch.serving.engine import ServingEngine

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 3.5e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LOGIT_TOL = 2e-4
ENCODERS = ("edge-cv-heavy", "hubert-xlarge")


def _rel(want, got) -> float:
    w = np.asarray(want, np.float32)
    g = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                   np.float32)
    return float(np.max(np.abs(w - g)) / max(np.max(np.abs(w)), 1e-6))


def _cfgs(arch, **over):
    jcfg = dataclasses.replace(jax_reduced(arch), compute_dtype="float32",
                               **over)
    return jcfg, ModelConfig.from_dict(jcfg.to_dict())


def _batch(cfg, B=2, T=24, seed=0):
    """Features, targets and a mask from a numpy seed (each row has some
    masked frames and some not)."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, T, cfg.frontend_dim)).astype(np.float32)
    targets = rng.integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    mask = rng.random((B, T)) < 0.3
    mask[:, 0], mask[:, 1] = True, False
    return feats, targets, mask


# ---------------------------------------------------------------------------
# LayerNorm and attention at the new head dims
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 7, 128), (2, 1280), (5, 100)])
def test_layer_norm_matches_jax(dtype, shape):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(len(shape) + shape[-1])
    x = (rng.normal(size=shape) * 3 + 1.5).astype(np.float32)
    scale = rng.normal(size=shape[-1:]).astype(np.float32)
    bias = rng.normal(size=shape[-1:]).astype(np.float32)
    want = jlayers._layernorm_cv(jnp.asarray(x, jdt), jnp.asarray(scale),
                                 jnp.asarray(bias), 1e-5)
    got = tlayers.layer_norm(torch.as_tensor(x).to(tdt),
                             torch.as_tensor(scale), torch.as_tensor(bias),
                             1e-5)
    assert got.dtype == tdt
    assert _rel(np.asarray(want, np.float32), got) < TOL[dtype]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [48, 80])
def test_plain_mha_at_head_dims_48_and_80(D, causal):
    """fp32, B 2 x T 37 (not a multiple of a tile), G 1 as the encoders
    run it and G 2; against JAX ``ref.mha`` and the Pallas kernel."""
    rng = np.random.default_rng(D)
    for Hq, Hkv in ((4, 4), (4, 2)):
        q, k, v = (rng.normal(size=(2, 37, h, D)).astype(np.float32)
                   for h in (Hq, Hkv, Hkv))
        want = jref.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal)
        pallas = pallas_flash(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal, interpret=True,
                              block_q=16, block_k=16)
        got = tref.mha(torch.as_tensor(q), torch.as_tensor(k),
                       torch.as_tensor(v), causal=causal)
        assert got.shape == (2, 37, Hq, D)
        assert _rel(want, got) < TOL["float32"]
        assert _rel(pallas, got) < TOL["float32"]


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head_dim", [32, 48, 80])
@pytest.mark.parametrize("arch", ENCODERS)
def test_encoder_forward_and_loss_match_jax(arch, head_dim):
    jcfg, tcfg = _cfgs(arch, head_dim=head_dim)
    check_ported(tcfg)
    jp = jax_build(jcfg).init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, jp)
    tp = from_numpy_tree(tree, tcfg, "cpu")
    feats, targets, mask = _batch(tcfg)
    model = Model(tcfg, "cpu")
    jbatch = {"features": jnp.asarray(feats), "targets": jnp.asarray(targets),
              "mask": jnp.asarray(mask)}
    tbatch = {"features": torch.as_tensor(feats),
              "targets": torch.as_tensor(targets),
              "mask": torch.as_tensor(mask)}
    with torch.no_grad():
        # without a mask (serving) and with one (masked prediction)
        for keys in (("features",), ("features", "mask")):
            want, _ = jax_build(jcfg).forward(
                jp, {k: jbatch[k] for k in keys})
            got = model.forward(tp, {k: tbatch[k] for k in keys})
            assert got.shape == (2, 24, tcfg.vocab_size)
            assert _rel(want, got) < LOGIT_TOL
            assert np.array_equal(np.argmax(np.asarray(want), -1),
                                  got.argmax(-1).numpy())
        jloss, jm = jax_build(jcfg).loss(jp, jbatch)
        tloss, tm = model.loss(tp, tbatch)
    assert abs(float(tloss) - float(jloss)) <= LOGIT_TOL * abs(float(jloss))
    assert float(tm["tokens"]) == float(jm["tokens"]) == mask.sum()
    # no mask: every frame weighs 1
    jloss, _ = jax_build(jcfg).loss(jp, {k: jbatch[k]
                                         for k in ("features", "targets")})
    with torch.no_grad():
        tloss, tm = model.loss(tp, {k: tbatch[k]
                                    for k in ("features", "targets")})
    assert abs(float(tloss) - float(jloss)) <= LOGIT_TOL * abs(float(jloss))
    assert float(tm["tokens"]) == targets.size


@pytest.mark.parametrize("arch", ENCODERS)
def test_weight_bridge_copies_the_encoder_tree(arch):
    """The frontend leaves, the LayerNorm biases, the untied prediction
    head and the unused embedding cross one to one, and back."""
    jcfg, tcfg = _cfgs(arch, param_dtype="bfloat16")
    jp = jax_build(jcfg).init(jax.random.key(1))
    tree = jax.tree.map(np.asarray, jp)
    tp = from_numpy_tree(tree, tcfg, "cpu")
    own = Model(tcfg, "cpu").init(torch.Generator().manual_seed(0))
    jflat = jax.tree_util.tree_flatten_with_path(tree)[0]
    paths = {"/".join(k.key for k in p): a for p, a in jflat}
    assert {"frontend/w_frontend", "frontend/mask_embed", "head/w_head",
            "embed/embedding", "stack/final_norm/bias",
            "stack/blocks/norm1/bias", "stack/blocks/norm2/bias"} <= \
        set(paths)

    def flat(t, pre=""):
        if isinstance(t, dict):
            out = {}
            for k, v in t.items():
                out.update(flat(v, f"{pre}{k}/"))
            return out
        return {pre[:-1]: t}
    for mine in (tp, own):             # bridged and the port's own init
        got = flat(mine)
        assert set(got) == set(paths)
        for k, a in paths.items():
            assert tuple(got[k].shape) == a.shape, k
            assert got[k].dtype == torch.bfloat16, k
    back = flat(to_numpy_tree(tp))
    for k, a in paths.items():
        np.testing.assert_array_equal(back[k], np.asarray(a, np.float32))


def test_golden_encoder_logits_replay_on_the_cpu():
    """The fixture's ``encoder_*`` entries (reduced fp32 edge-cv-heavy at
    head dims 48 and 80): the port, fed the file alone, gives the JAX
    logits and loss; ``chip_smoke.py`` replays them on the card."""
    with np.load(golden.PATH) as f:
        g = {k: f[k] for k in f.files if k.startswith("encoder_")}
    for hd in golden.ENCODER_HEAD_DIMS:
        pre = f"encoder_{hd}_"
        cfg = ModelConfig.from_dict(json.loads(str(g[pre + "config"])))
        assert cfg.head_dim == hd and cfg.compute_dtype == "float32"
        params = from_numpy_tree(unflatten(
            {k[len(pre + "params/"):]: v for k, v in g.items()
             if k.startswith(pre + "params/")}), cfg, "cpu")
        batch = {"features": torch.as_tensor(g[pre + "features"]),
                 "targets": torch.as_tensor(g[pre + "targets"]),
                 "mask": torch.as_tensor(g[pre + "mask"])}
        model = Model(cfg, "cpu")
        with torch.no_grad():
            logits = model.forward(params, {"features": batch["features"]})
            loss, _ = model.loss(params, batch)
        assert _rel(g[pre + "logits"], logits) < LOGIT_TOL
        assert np.array_equal(np.argmax(g[pre + "logits"], -1),
                              logits.argmax(-1).numpy())
        assert abs(float(loss) - float(g[pre + "loss"])) <= \
            LOGIT_TOL * abs(float(g[pre + "loss"]))


@pytest.mark.parametrize("arch", ENCODERS)
def test_full_configs_and_param_counts_match_jax(arch):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    assert tcfg.to_dict() == jcfg.to_dict()
    assert tcfg.num_params() == jcfg.num_params()
    assert tcfg.active_params() == jcfg.active_params()
    red = get_reduced_config(arch)
    assert red.to_dict() == jax_reduced(arch).to_dict()
    assert red.num_params() == jax_reduced(arch).num_params()
    check_ported(tcfg)
    assert tcfg.head_dim_ == {"edge-cv-heavy": 64, "hubert-xlarge": 80}[arch]
    # the count is the constructed tree's
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        jax_build(jax_reduced(arch)).init_abstract()))
    assert red.num_params() == n


def test_encoder_iterator_matches_jax_byte_for_byte():
    cfg = get_reduced_config("hubert-xlarge")
    mine = make_encoder_iterator(cfg, 3, 20, seed=7)
    theirs = jax_encoder_iter(jax_reduced("hubert-xlarge"), 3, 20, seed=7)
    for _ in range(3):
        a, b = next(mine), next(theirs)
        assert sorted(a) == sorted(b) == ["features", "mask", "targets"]
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), k


# ---------------------------------------------------------------------------
# the paper's hybrid scenario through both EdgeSystems
# ---------------------------------------------------------------------------

def _hybrid_scenario(core, router, stream, heavy, light, params_heavy,
                     params_light, to_array, frames=6, **dev):
    """``examples/hybrid_edge_serving.py``: 4 workers, the standard specs
    with 2 CV and 2 stream replicas, 6 frames and 6 record batches, a
    failure of the node the third batch ran on, then the stream service
    scaled to 3.  Returns what both packages must agree on."""
    system = core.EdgeSystem(policy=core.LeastLoadedPolicy())
    for i in range(4):
        system.add_node(f"worker{i}", core.NodeCapacity(hbm_bytes=16 << 30))
    scfg = stream.StreamConfig(num_users=16, batch_records=32)
    router.assemble_edge_system(system, heavy_cfg=heavy, light_cfg=light,
                                scfg=scfg, params_heavy=params_heavy,
                                params_light=params_light, **dev)
    placed = []
    for spec in router.standard_specs(heavy, replicas_heavy=2,
                                      replicas_stream=2):
        placed.append((spec.name, [d.node_id for d in system.apply(spec)]))
    rng = np.random.default_rng(0)
    records = stream.make_record_stream(scfg)
    state = stream.init_state(scfg, **dev)
    routes, preds, maxima = [], [], []
    for i in range(frames):
        feats = rng.normal(size=(1, 32, heavy.frontend_dim)) \
            .astype(np.float32)
        w = core.Workload(f"frame{i}", core.WorkloadKind.GENERIC, heavy,
                          batch=1, seq_len=32,
                          est_flops=2.0 * heavy.num_params() * 32 * 300)
        res = system.submit(w, (to_array(feats),))
        routes.append((w.name, res.workload_class.value, res.node_id,
                       res.executor_name))
        preds.append(np.asarray(res.output).astype(np.int64))
        rec = {k: to_array(v) for k, v in next(records).items()}
        res2 = system.submit(core.Workload(f"sensor{i}",
                                           core.WorkloadKind.STREAM),
                             (state, rec))
        state, out = res2.output
        routes.append((f"sensor{i}", res2.workload_class.value,
                       res2.node_id, res2.executor_name))
        maxima.append(float(out["max_avg_steps"]))
        if i == 2:
            moved = system.orchestrator.on_node_failure(res2.node_id)
            placed.append(("failover", sorted(moved)))
    placed.append(("scaled", system.scale("stream-analytics", 3)))
    deps = sorted((d.name, d.node_id)
                  for d in system.orchestrator.deployments.values())
    return placed, routes, preds, maxima, deps, list(system.events)


def test_hybrid_edge_scenario_matches_jax():
    jheavy, theavy = _cfgs("edge-cv-heavy")
    jlight, tlight = _cfgs("edge-stream-light")
    jph = jax_build(jheavy).init(jax.random.key(0))
    jpl = jax_build(jlight).init(jax.random.key(1))
    tph = from_numpy_tree(jax.tree.map(np.asarray, jph), theavy, "cpu")
    tpl = from_numpy_tree(jax.tree.map(np.asarray, jpl), tlight, "cpu")
    want = _hybrid_scenario(jcore, jrouter, jstream, jheavy, jlight, jph,
                            jpl, jnp.asarray)
    got = _hybrid_scenario(tcore, trouter, tstream, theavy, tlight, tph,
                           tpl, torch.as_tensor, device="cpu")
    names = ("placements", "routes", "predictions", "analytics",
             "deployments", "events")
    for name, w, g in zip(names, want, got):
        if name == "predictions":
            assert all(a.shape == (1, 32) for a in g)
            assert all(np.array_equal(a, b) for a, b in zip(w, g))
        elif name == "analytics":
            np.testing.assert_allclose(g, w, rtol=1e-5)
        else:
            assert g == w, name
    # every frame ran on a CV container, every batch on a stream image
    assert {r[1] for r in got[1] if r[0].startswith("frame")} == {"heavy"}
    assert {r[1] for r in got[1] if r[0].startswith("sensor")} == {"light"}


# ---------------------------------------------------------------------------
# the gates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("over", [dict(parallel_block=True),
                                  dict(qk_norm=True), dict(attn_bias=True)])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "edge-cv-heavy"])
def test_check_ported_accepts_item_11_2_features(arch, over):
    """``parallel_block`` (command-r), ``qk_norm`` (chameleon) and
    attention biases, on a decoder and on an encoder: accepted, and the
    logits from the JAX parameters (their zero biases and unit scales
    seeded nonzero) equal JAX's.  ``tests/test_torch_dense_variants.py``
    serves the registered archs that have them."""
    jcfg, tcfg = _cfgs(arch, **over)
    check_ported(tcfg)
    flat = golden.seeded(jax_build(jcfg).init(jax.random.key(7)), 7)
    jp, tp = jax.tree.map(jnp.asarray, flat), from_numpy_tree(flat, tcfg,
                                                             "cpu")
    if tcfg.encoder_only:
        feats = _batch(jcfg)[0]
        want, _ = jax_build(jcfg).forward(jp, {"features":
                                               jnp.asarray(feats)})
        batch = {"features": torch.as_tensor(feats)}
    else:
        tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size,
                                                   size=(2, 24))
        want, _ = jax_build(jcfg).forward(jp, {"tokens":
                                               jnp.asarray(tokens)})
        batch = {"tokens": torch.as_tensor(tokens)}
    with torch.no_grad():
        got = Model(tcfg, "cpu").forward(tp, batch)
    assert _rel(want, got) < LOGIT_TOL


def test_check_ported_refuses_moe_swa_mla_and_unused_variants():
    """MoE and sliding-window attention outside mixtral's pairing of
    them name item 11, as does MLA outside the moe family (mixtral and
    DeepSeek are ported); an encoder without
    LayerNorm or ``audio_frames`` and a decoder with ``audio_frames`` are
    combinations no registered config has; ``encoder_only`` belongs to
    the encoder family.  The four dense variants pass."""
    cv = get_config("edge-cv-heavy")
    tiny = get_config("tinyllama-1.1b")
    check_ported(get_config("mixtral-8x7b"))
    check_ported(ModelConfig.from_dict(jax_config("mixtral-8x7b").to_dict()))
    check_ported(get_config("deepseek-v2-236b"))
    check_ported(ModelConfig.from_dict(
        jax_config("deepseek-v2-236b").to_dict()))
    for over, item in ((dict(sliding_window=8), r"item 11\b"),
                       (dict(attn_type="swa", sliding_window=64),
                        r"item 11\b"),
                       (dict(family="moe"), r"item 11\b"),
                       (dict(attn_type="mla"), r"item 11\b")):
        for cfg in (dataclasses.replace(tiny, **over),
                    dataclasses.replace(cv, **over)):
            with pytest.raises(NotImplementedError, match=item):
                check_ported(cfg)
            with pytest.raises(NotImplementedError, match=item):
                Model(cfg, "cpu")
    for cfg in (dataclasses.replace(cv, norm="rmsnorm"),
                dataclasses.replace(cv, frontend="none"),
                dataclasses.replace(tiny, frontend="audio_frames")):
        with pytest.raises(NotImplementedError,
                           match="no registered config"):
            check_ported(cfg)
    for cfg in (dataclasses.replace(cv, encoder_only=False),
                dataclasses.replace(tiny, encoder_only=True)):
        with pytest.raises(NotImplementedError, match="item 11"):
            check_ported(cfg)
    for arch in ("gemma-2b", "command-r-35b", "chameleon-34b",
                 "nemotron-4-340b"):
        check_ported(get_config(arch))
    for cfg in (dataclasses.replace(tiny, norm="layernorm"),
                dataclasses.replace(tiny, frontend="vq_tokens")):
        check_ported(cfg)


@pytest.mark.parametrize("arch", ENCODERS)
def test_engine_refuses_encoders(arch):
    """An encoder serves through a container's ``generic`` entry point,
    never the token engine (it trains through ``launch/train.py``:
    ``tests/test_torch_encoder_train.py``)."""
    cfg = get_reduced_config(arch)
    with pytest.raises(ValueError, match="generic"):
        ServingEngine(cfg, device="cpu")


def test_container_serves_an_encoder_through_generic_only():
    jcfg, tcfg = _cfgs("hubert-xlarge")
    tp = from_numpy_tree(jax.tree.map(np.asarray, jax_build(jcfg).init(
        jax.random.key(0))), tcfg, "cpu")
    ex, _ = trouter.make_container_builder(tcfg, params=tp, device="cpu")(
        tcore.Workload("c", tcore.WorkloadKind.GENERIC), None)
    feats, _, _ = _batch(tcfg, B=1, T=16)
    pred = ex.dispatch(tcore.Workload("g", tcore.WorkloadKind.GENERIC,
                                      batch=1, seq_len=16),
                       (torch.as_tensor(feats),))
    assert pred.shape == (1, 16) and pred.dtype == torch.int32
    assert 0 <= int(pred.min()) and int(pred.max()) < tcfg.vocab_size
    for kind, args in (("prefill", (torch.zeros((1, 4), dtype=torch.int32),
                                    {})),
                       ("decode", (torch.zeros((1,), dtype=torch.int32), {},
                                   torch.zeros((1,), dtype=torch.int32)))):
        with pytest.raises(ValueError, match="encoder-only"):
            ex.dispatch(tcore.Workload(kind, tcore.WorkloadKind(kind),
                                       batch=1, seq_len=4), args)
