"""The port's SSM families (Mamba2 ``ssm`` and zamba2 ``hybrid``) and the
dense-slot data plane against the JAX package, on the same inputs made
from a numpy seed.

- the plain ``ssd_scan`` (y and final state) against JAX ``ref.ssd_scan``
  and the Pallas kernel in interpret mode; the plain decode step; the
  plain ``rmsnorm`` against the Pallas kernel in interpret mode and the
  model norm;
- ``apply_mamba2`` (chunked resume against monolithic) and
  ``decode_step_mamba2`` against JAX;
- ``Model.forward``/``prefill``/``prefill_chunk``/``decode`` logits;
- ``ServingEngine`` fp32 token streams equal the JAX engine's on dense
  slots for reduced mamba2, zamba2 and tinyllama (``paged=False``), the
  warmup leaves the slot tree untouched, and a failing stateful chunk
  fails only its own request.

Tolerances: 2e-5 (fp32) and 3.5e-2 (bf16) for kernels, 2e-4 for logits,
relative to the largest output.  The CUDA kernels are held against the
plain versions on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``)."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_golden as golden
from repro.configs import get_config as jax_config
from repro.configs import get_reduced_config as jax_reduced
from repro.kernels import ref as jref
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro.models import layers as jlayers
from repro.models import mamba2 as jmamba
from repro.models.model import build_model as jax_build
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba2 as tmamba
from repro_torch.models.config import ModelConfig, check_ported
from repro_torch.models.model import Model, cast_params
from repro_torch.models.weights import (from_numpy_tree, to_numpy_tree,
                                        unflatten)
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_cache import SlotKVCache
from repro_torch.tree import flatten_with_path
from test_torch_gpu import RMSNORM_CASES, SSD_CASES

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 3.5e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ENGINE = dict(max_slots=2, max_seq=64, prefill_chunk=16, prefill_budget=32)


def _rel(want, got) -> float:
    w = np.asarray(want, np.float32)
    g = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                   np.float32)
    return float(np.max(np.abs(w - g)) / max(np.max(np.abs(w)), 1e-6))


def _cfgs(arch, **over):
    jcfg = dataclasses.replace(jax_reduced(arch), compute_dtype="float32",
                               **over)
    return jcfg, ModelConfig.from_dict(jcfg.to_dict())


# ---------------------------------------------------------------------------
# plain kernels
# ---------------------------------------------------------------------------

def _ssd_inputs(case, seed=0):
    B, T, H, P, G, N, chunk, init = case
    rng = np.random.default_rng(seed + T)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = 0.5 * np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(
        np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, T, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, G, N)).astype(np.float32)
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32) if init \
        else None
    return (x, dt, A, Bm, Cm), s0, chunk


@pytest.mark.parametrize("case", SSD_CASES)
def test_plain_ssd_scan_matches_jax_ref_and_pallas(case):
    """y and the final state, with and without an initial state, T not a
    multiple of the chunk, groups 1 and 2."""
    arrays, s0, chunk = _ssd_inputs(case)
    jkw = dict(chunk=chunk, return_final_state=True,
               initial_state=None if s0 is None else jnp.asarray(s0))
    jargs = [jnp.asarray(a) for a in arrays]
    want_y, want_s = jref.ssd_scan(*jargs, **jkw)
    pal_y, pal_s = pallas_ssd(*jargs, interpret=True, **jkw)
    got_y, got_s = tref.ssd_scan(
        *(torch.from_numpy(a) for a in arrays), chunk=chunk,
        initial_state=None if s0 is None else torch.from_numpy(s0),
        return_final_state=True)
    assert got_y.shape == arrays[0].shape
    assert got_s.shape == (case[0], case[2], case[3], case[5])
    for want, got in ((want_y, got_y), (want_s, got_s), (pal_y, got_y),
                      (pal_s, got_s)):
        assert _rel(want, got) < TOL["float32"]


@pytest.mark.parametrize("G", [1, 2])
def test_plain_ssd_decode_step_matches_jax(G):
    rng = np.random.default_rng(G)
    B, H, P, N = 3, 4, 16, 32
    arrays = [rng.standard_normal(s).astype(np.float32) for s in
              ((B, H, P), (B, H), (H,), (B, G, N), (B, G, N), (B, H, P, N))]
    arrays[1] = np.abs(arrays[1])
    arrays[2] = -np.abs(arrays[2])
    wy, ws = jref.ssd_decode_step(*map(jnp.asarray, arrays))
    gy, gs = tref.ssd_decode_step(*map(torch.from_numpy, arrays))
    assert _rel(wy, gy) < TOL["float32"] and _rel(ws, gs) < TOL["float32"]


def test_ssd_decode_steps_continue_the_scan():
    """A scan over T tokens then decode steps equals one scan over all of
    them (the prefill → decode handoff of the state)."""
    arrays, s0, chunk = _ssd_inputs((1, 40, 4, 16, 2, 16, 16, True))
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in arrays)
    s0 = torch.from_numpy(s0)
    y_all, s_all = tref.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                                 initial_state=s0, return_final_state=True)
    _, s = tref.ssd_scan(x[:, :30], dt[:, :30], A, Bm[:, :30], Cm[:, :30],
                         chunk=chunk, initial_state=s0,
                         return_final_state=True)
    for t in range(30, 40):
        y, s = tref.ssd_decode_step(x[:, t], dt[:, t], A, Bm[:, t],
                                    Cm[:, t], s)
        assert _rel(y_all[:, t].numpy(), y) < TOL["float32"]
    assert _rel(s_all.numpy(), s) < TOL["float32"]


@pytest.mark.parametrize("case", RMSNORM_CASES[:3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_rmsnorm_matches_pallas_and_the_model_norm(case, dtype):
    """Products in x's dtype: the Pallas kernel and the model's norm
    (``layers.rms_norm_simple``), not ``ref.rmsnorm``'s f32 product."""
    rows, d = case
    rng = np.random.default_rng(d)
    x = rng.standard_normal((rows, d)).astype(np.float32) * 3
    s = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    jx = jnp.asarray(x, jdt)
    got = tref.rmsnorm(torch.from_numpy(x).to(tdt), torch.from_numpy(s),
                       1e-5)
    assert got.dtype == tdt
    pal = pallas_rmsnorm(jx, jnp.asarray(s, jdt), eps=1e-5, interpret=True)
    model = jlayers.rms_norm_simple(jx, jnp.asarray(s), 1e-5)
    assert _rel(pal, got) < TOL[dtype]
    assert _rel(model, got) < TOL[dtype]
    # the port's model norm is the same function
    assert torch.equal(tlayers.rms_norm(torch.from_numpy(x).to(tdt),
                                        torch.from_numpy(s), 1e-5), got)


def test_ssm_kernel_wrappers_refuse_grad_and_cpu_tensors():
    """The CUDA wrappers say "forward-only" under grad mode, before
    anything else, and refuse CPU tensors (no silent plain path)."""
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_scan

    arrays, s0, chunk = _ssd_inputs(SSD_CASES[0])
    args = [torch.from_numpy(a) for a in arrays]
    args[0].requires_grad_()
    x = torch.zeros(2, 8, requires_grad=True)
    for call in (lambda: ssd_scan(*args, chunk=chunk),
                 lambda: rmsnorm(x, torch.ones(8))):
        with pytest.raises(ValueError, match="forward-only"):
            call()
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
            call()


# ---------------------------------------------------------------------------
# configs, weights, the Mamba2 block
# ---------------------------------------------------------------------------

def test_configs_and_param_counts_match_jax():
    for arch in ("mamba2-2.7b", "zamba2-1.2b"):
        jcfg, tcfg = jax_config(arch), get_config(arch)
        assert tcfg.to_dict() == jcfg.to_dict()
        assert tcfg.num_params() == jcfg.num_params()
        assert tcfg.d_inner == jcfg.d_inner
        assert tcfg.ssm_heads == jcfg.ssm_heads
        red = get_reduced_config(arch)
        assert red.to_dict() == jax_reduced(arch).to_dict()
        assert red.num_params() == jax_reduced(arch).num_params()
        check_ported(tcfg)
    assert get_config("mamba2-2.7b").ssm_heads == 80
    with pytest.raises(NotImplementedError, match="item 11"):
        check_ported(dataclasses.replace(get_config("zamba2-1.2b"),
                                         sliding_window=64))
    with pytest.raises(KeyError, match="not ported"):
        get_config("deepseek-v2-236b")


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_weight_bridge_carries_ssm_trees(arch):
    """Nested super-block stacks and the f32 SSM leaves cross the bridge;
    with bf16 parameters those leaves stay f32, as in JAX, and
    ``cast_params`` keeps them f32 too."""
    jcfg, tcfg = _cfgs(arch, param_dtype="bfloat16")
    jp = jax_build(jcfg).init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, jp)
    tp = from_numpy_tree(tree, tcfg, "cpu")
    own = Model(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa
    assert {k: v.shape for k, v in flat(tp).items()} == \
        {k: v.shape for k, v in flat(own).items()}
    for tr in (tp, own, cast_params(tp, torch.bfloat16)):
        for path, leaf in flat(tr).items():
            want = torch.float32 if path[-1].key in tmamba.F32_LEAVES \
                else torch.bfloat16
            assert leaf.dtype == want, path
    for path, leaf in flat(tree).items():
        assert str(leaf.dtype) == str(flat(tp)[path].dtype).replace(
            "torch.", "")
    back = flat(to_numpy_tree(tp))
    for path, leaf in flat(tree).items():
        np.testing.assert_array_equal(np.asarray(leaf, np.float32),
                                      back[path])


@pytest.fixture(scope="module")
def block():
    jcfg, tcfg = _cfgs("mamba2-2.7b")
    jp = jmamba.init_mamba2(jax.random.key(3), jcfg)
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    x = np.random.default_rng(3).standard_normal(
        (2, 37, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def test_apply_mamba2_resumes_chunks_and_matches_jax(block):
    """Monolithic (no state) against JAX, and chunks of 16, 5 and 16
    resuming the conv tail and SSM state against the monolithic pass."""
    jcfg, tcfg, jp, tp, x = block
    want, _ = jmamba.apply_mamba2(jp, jnp.asarray(x), jcfg)
    whole, _ = tmamba.apply_mamba2(tp, torch.from_numpy(x), tcfg)
    assert _rel(want, whole) < 2e-4
    state = tmamba.init_mamba2_state(tcfg, 2, device="cpu")
    jstate = jmamba.init_mamba2_state(jcfg, 2)
    outs = []
    for a, b in ((0, 16), (16, 21), (21, 37)):
        out, state = tmamba.apply_mamba2(tp, torch.from_numpy(x[:, a:b]),
                                         tcfg, state=state)
        jout, jstate = jmamba.apply_mamba2(jp, jnp.asarray(x[:, a:b]), jcfg,
                                           state=jstate)
        assert _rel(jout, out) < 2e-4
        outs.append(out)
    assert _rel(whole.numpy(), torch.cat(outs, 1)) < 2e-4
    for k in ("conv", "ssm"):
        assert _rel(jstate[k], state[k]) < 2e-4


def test_decode_step_mamba2_matches_jax(block):
    jcfg, tcfg, jp, tp, x = block
    _, state = tmamba.apply_mamba2(
        tp, torch.from_numpy(x[:, :30]), tcfg,
        state=tmamba.init_mamba2_state(tcfg, 2, device="cpu"))
    _, jstate = jmamba.apply_mamba2(jp, jnp.asarray(x[:, :30]), jcfg,
                                    state=jmamba.init_mamba2_state(jcfg, 2))
    whole, _ = tmamba.apply_mamba2(tp, torch.from_numpy(x), tcfg)
    for t in range(30, 37):
        out, state = tmamba.decode_step_mamba2(
            tp, torch.from_numpy(x[:, t:t + 1]), tcfg, state)
        jout, jstate = jmamba.decode_step_mamba2(
            jp, jnp.asarray(x[:, t:t + 1]), jcfg, jstate)
        assert _rel(jout, out) < 2e-4
        assert _rel(whole[:, t:t + 1].numpy(), out) < 2e-4
    assert _rel(jstate["ssm"], state["ssm"]) < 2e-4


def test_softplus_is_jax_logaddexp():
    """``F.softplus`` returns x above 20; JAX's is exact there."""
    v = np.array([-30.0, -3.0, 0.0, 2.5, 19.0, 21.0, 40.0], np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(v)))
    np.testing.assert_array_equal(
        tmamba._softplus(torch.from_numpy(v)).numpy(), want)


# ---------------------------------------------------------------------------
# the whole model, fp32
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["mamba2-2.7b", "zamba2-1.2b"])
def pair(request):
    jcfg, tcfg = _cfgs(request.param)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.key(0))
    tm = Model(tcfg, device="cpu")
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 37))
    return jcfg, jm, jp, tcfg, tm, tp, toks


def test_forward_logits_match(pair):
    jcfg, jm, jp, tcfg, tm, tp, toks = pair
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.no_grad():
        got = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 37, jcfg.vocab_size)
    assert _rel(want, got) < 2e-4


def test_prefill_and_decode_logits_match(pair):
    jcfg, jm, jp, tcfg, tm, tp, toks = pair
    jc = jm.init_caches(2, 64, jnp.float32)
    jlog, jc, jlen = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                                jc)
    tc = tm.init_caches(2, 64, torch.float32)
    with torch.no_grad():
        tlog, tlen = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    assert _rel(jlog, tlog) < 2e-4
    assert tlen.tolist() == np.asarray(jlen).tolist() == [37, 37]
    nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for _ in range(4):
        jlog, jc = jm.decode(jp, jnp.asarray(nxt), jc, jlen)
        with torch.no_grad():
            tlog = tm.decode(tp, torch.from_numpy(nxt), tc, tlen)
        assert _rel(jlog, tlog) < 2e-4
        jlen, tlen = jlen + 1, tlen + 1
        nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)


def test_chunked_prefill_matches_jax_and_the_forward(pair):
    """Exact-length chunks (16, 16, 5) resuming a batch-1 staging cache:
    each chunk's logits against JAX, the last against the forward."""
    jcfg, jm, jp, tcfg, tm, tp, toks = pair
    jc = jm.init_caches(1, 64, jnp.float32)
    tc = tm.init_caches(1, 64, torch.float32)
    for c0 in range(0, 37, 16):
        ch = toks[:1, c0:c0 + 16]
        n = ch.shape[1]
        jlog, jc = jm.prefill_chunk(
            jp, {"tokens": jnp.asarray(ch, jnp.int32)}, jc,
            jnp.asarray([c0], jnp.int32), jnp.asarray([c0 + n], jnp.int32))
        with torch.no_grad():
            tlog = tm.prefill_chunk(
                tp, {"tokens": torch.from_numpy(ch)}, tc,
                torch.tensor([c0], dtype=torch.int32),
                torch.tensor([c0 + n], dtype=torch.int32))
        assert _rel(jlog, tlog) < 2e-4
    with torch.no_grad():
        full = tm.forward(tp, {"tokens": torch.from_numpy(toks[:1])})
    assert _rel(full[:, -1].numpy(), tlog) < 2e-4


# ---------------------------------------------------------------------------
# the dense-slot data plane
# ---------------------------------------------------------------------------

def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 256, size=n) for n in (40, 7, 23, 33, 5)]


def flat_tree(tree) -> dict:
    return dict(flatten_with_path(tree))


def _streams(eng, prompts, max_new=6):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    eng.run_until_drained()
    return [r.generated for r in sorted(eng.completed.values(),
                                        key=lambda r: r.rid)]


@pytest.mark.parametrize("arch,extra", [
    ("mamba2-2.7b", {}), ("zamba2-1.2b", {}),
    ("tinyllama-1.1b", {"paged": False})])
def test_engine_streams_equal_jax_engine(arch, extra):
    """Five prompts (three longer than the 16-token chunk) on two slots.
    The JAX engine is warmed up first: its slot tree starts in bf16 and
    takes the compute dtype at its first decode (``SlotKVCache`` default
    dtype, ROADMAP Queue C), where the port's is in the compute dtype
    from the start."""
    jcfg, tcfg = _cfgs(arch)
    jeng = JaxEngine(jcfg, seed=0, **ENGINE, **extra).warmup()
    want = _streams(jeng, _prompts())
    params = from_numpy_tree(jax.tree.map(np.asarray, jeng.params), tcfg,
                             "cpu")
    eng = ServingEngine(tcfg, params=params, device="cpu", **ENGINE, **extra)
    assert _streams(eng, _prompts()) == want
    st = eng.stats()
    assert not st["paged"] and st["failed"] == 0
    if arch != "tinyllama-1.1b":   # exact-length chunks of at most 16
        assert st["prefill_chunks"] == sum(-(-len(p) // 16)
                                           for p in _prompts())
    assert eng.kv.free_slots and len(eng.kv.free_slots) == 2


def test_jax_slot_tree_starts_in_bf16():
    """Pins the reference quirk the comparison above works around."""
    jcfg, tcfg = _cfgs("zamba2-1.2b")
    jeng = JaxEngine(jcfg, **ENGINE)
    assert jeng.kv.caches["attn"]["k"].dtype == jnp.bfloat16
    jeng.warmup()
    assert jeng.kv.caches["attn"]["k"].dtype == jnp.float32
    assert ServingEngine(tcfg, device="cpu", **ENGINE).kv.caches[
        "attn"]["k"].dtype == torch.float32


@pytest.mark.parametrize("arch,extra", [
    ("zamba2-1.2b", {}), ("tinyllama-1.1b", {"paged": False})])
def test_dense_warmup_leaves_state_untouched(arch, extra):
    _, tcfg = _cfgs(arch)
    cold = ServingEngine(tcfg, device="cpu", seed=3, **ENGINE, **extra)
    warm = ServingEngine(tcfg, device="cpu", seed=3, **ENGINE, **extra)
    before = {k: v.clone() for k, v in
              flat_tree(warm.kv.caches).items()}
    warm.warmup().warmup()
    assert warm._warm and warm.ticks == 0 and warm.warmup_s > 0
    after = flat_tree(warm.kv.caches)
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert torch.equal(warm.kv.cache_len, cold.kv.cache_len)
    assert torch.equal(warm.last_tokens, cold.last_tokens)
    assert _streams(warm, _prompts()) == _streams(cold, _prompts())


def test_failing_stateful_chunk_fails_only_its_request():
    """A chunk that raises fails its own request (it wrote only its
    staging cache) and returns its slot; the others are served as if it
    had never come."""
    _, tcfg = _cfgs("mamba2-2.7b")
    prompts = _prompts()
    ref_streams = _streams(ServingEngine(tcfg, device="cpu", seed=1,
                                         **ENGINE), prompts[1:])
    eng = ServingEngine(tcfg, device="cpu", seed=1, **ENGINE)
    real = eng._chunk_stateful
    bad = int(prompts[0][16])

    def flaky(staging, tokens, start, new_len):
        if int(start[0]) == 16 and int(tokens[0, 0]) == bad:
            raise RuntimeError("injected chunk fault")
        return real(staging, tokens, start, new_len)

    eng._chunk_stateful = flaky
    handles = [eng.submit(p, max_new_tokens=6) for p in prompts]
    with pytest.raises(RuntimeError, match="injected chunk fault"):
        handles[0].result(timeout=60)
    assert [h.result(timeout=60).generated for h in handles[1:]] \
        == ref_streams
    assert list(eng.failed) == [handles[0].rid]
    assert len(eng.kv.free_slots) == 2 and not eng.active


def test_slot_cache_finds_batch_axes_and_casts_on_insert():
    """The hybrid's leaves hold the batch axis at different depths; an
    insert copies one slot and casts to the slot tree's dtype."""
    _, tcfg = _cfgs("zamba2-1.2b")
    kv = SlotKVCache(tcfg, 3, 32, dtype=torch.float32, device="cpu")
    assert kv.batch_axes == {"attn": {"k": 1, "v": 1},
                             "mamba": {"conv": 2, "ssm": 2}}
    small = Model(tcfg, device="cpu").init_caches(1, 32, torch.bfloat16)
    for leaf in flat_tree(small).values():
        leaf.normal_()
    kv.insert(small, 1, 17)
    assert kv.cache_len.tolist() == [0, 17, 0]
    for name, big in flat_tree(kv.caches).items():
        axis = 1 if "attn" in name else 2
        assert big.dtype == torch.float32
        one = flat_tree(small)[name]
        assert torch.equal(big.select(axis, 1), one.select(axis, 0).float())
        assert not big.select(axis, 0).any() and \
            not big.select(axis, 2).any()
    assert kv.alloc() == 0 and kv.bytes_in_use() == kv.capacity_bytes() // 3
    kv.free(0)


def test_unported_families_and_speculation_raise():
    _, tcfg = _cfgs("mamba2-2.7b")
    with pytest.raises(ValueError, match="paged data plane"):
        ServingEngine(tcfg, device="cpu", draft_cfg=tcfg)
    with pytest.raises(ValueError, match="kv_dtype"):
        ServingEngine(tcfg, device="cpu", kv_dtype="int8")
    with pytest.raises(ValueError, match="paged"):
        Model(tcfg, device="cpu").init_paged_caches(4, 16)


def test_golden_stateful_streams_replay_on_the_cpu():
    """The fixture's JAX streams for mamba2 and zamba2 (regenerated and
    compared in ``test_torch_engine.py``), served by the port from the
    file alone."""
    with np.load(golden.PATH) as f:
        g = {k: f[k] for k in f.files}
    for fam in golden.STATEFUL:
        cfg = ModelConfig.from_dict(json.loads(str(g[f"{fam}_config"])))
        prefix = f"{fam}_params/"
        params = from_numpy_tree(unflatten(
            {k[len(prefix):]: v for k, v in g.items()
             if k.startswith(prefix)}), cfg, "cpu")
        eng = ServingEngine(cfg, params=params, device="cpu",
                            **json.loads(str(g["stateful_engine"])))
        prompts = [p[:n] for p, n in zip(g["prompts"], g["prompt_lens"])]
        assert _streams(eng, prompts, int(g["max_new"])) == \
            g[f"{fam}_streams"].tolist()


def test_serve_launcher_takes_the_ssm_archs(capsys):
    from repro_torch.launch import serve

    for arch in ("mamba2-2.7b", "zamba2-1.2b"):
        serve.main(["--arch", arch, "--reduced", "--requests", "3",
                    "--max-new", "3", "--device", "cpu"])
        out = capsys.readouterr().out
        assert "dense slots" in out and "served 3 requests, 9 tokens" in out
