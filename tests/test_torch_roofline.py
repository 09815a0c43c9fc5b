"""The port's roofline (``repro_torch.roofline.analysis``) against the JAX
package's (``repro.roofline.analysis``), and the kernels' counted cost.

- ``model_flops_estimate`` equals JAX's for every registered arch and
  every shape, exactly;
- a collective recorded by the counting mode (a process group of the
  fake backend, in a subprocess: this process keeps no process group)
  gives the operand and wire bytes JAX's ``parse_collectives`` reads from
  an HLO line of the same op, size and group;
- ``analyze`` gives JAX's terms when both are handed the same counts,
  each scaled by its own constants;
- each kernel's call counts its closed form (FLOPs from the pairs its
  masks keep, bytes its inputs read and outputs written once) and
  nothing of the plain version that runs inside it on the CPU; with
  ``attn_impl="ref"`` the plain ops are counted instead;
- the memory tracker's argument, temporary and in-place bytes.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.shapes import SHAPES as JSHAPES
from repro.roofline import analysis as janalysis
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.shapes import SHAPES
from repro_torch.roofline import analysis

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("tinyllama-1.1b", "gemma-2b", "zamba2-1.2b", "mamba2-2.7b",
         "hubert-xlarge", "mixtral-8x7b", "chameleon-34b", "command-r-35b",
         "deepseek-v2-236b", "nemotron-4-340b", "edge-cv-heavy",
         "edge-stream-light")


def test_model_flops_estimate_equals_jax_for_every_arch_and_shape():
    from repro import configs as jconfigs

    assert set(ARCHS) == set(jconfigs._MODULES)
    n = 0
    for arch in ARCHS:
        for name, shape in SHAPES.items():
            want = janalysis.model_flops_estimate(jget_config(arch),
                                                  JSHAPES[name])
            got = analysis.model_flops_estimate(get_config(arch), shape)
            assert got == want, (arch, name, got, want)
            n += 1
    assert n == len(ARCHS) * 4


# each collective on a group of 4 of 8 fake ranks, its output shape, and
# the JAX HLO line of the same op
_COLLECTIVES = {
    "all-reduce": ("dist.all_reduce(x, group=g)", (4, 8),
                   "all-reduce(f32[4,8]{1,0} %x), to_apply=%add"),
    "all-gather": ("dist.all_gather_into_tensor("
                   "torch.empty(16, 8, device='meta'), x, group=g)",
                   (16, 8), "all-gather(f32[4,8]{1,0} %x), dimensions={0}"),
    "reduce-scatter": ("dist.reduce_scatter_tensor("
                       "torch.empty(1, 8, device='meta'), x, group=g)",
                       (1, 8), "reduce-scatter(f32[4,8]{1,0} %x), "
                       "dimensions={0}, to_apply=%add"),
    "all-to-all": ("dist.all_to_all_single(torch.empty_like(x), x, group=g)",
                   (4, 8), "all-to-all(f32[4,8]{1,0} %x), dimensions={0}"),
    "collective-permute": ("dist.broadcast(x, 0, group=g)", (4, 8),
                           "collective-permute(f32[4,8]{1,0} %x), "
                           "source_target_pairs={{0,1},{1,2},{2,3},{3,0}}"),
}


@pytest.fixture(scope="module")
def recorded():
    """Each collective of ``_COLLECTIVES`` counted alone by the counting
    mode, in a subprocess over 8 fake ranks: kind -> (operand, wire,
    count)."""
    calls = {k: c for k, (c, _, _) in _COLLECTIVES.items()}
    code = textwrap.dedent(f"""
        import json, torch, torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.roofline import analysis
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=8)
        g = dist.new_group([0, 1, 2, 3])
        x = torch.empty(4, 8, device="meta")
        out = {{}}
        for kind, call in {calls!r}.items():
            c = analysis.count(lambda x: exec(call), (x,)).cost()
            c = c["collectives"]
            out[kind] = [c.operand_bytes, c.wire_bytes, c.count]
        print(json.dumps(out))
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ,
                                PYTHONPATH=os.path.join(ROOT, "src")))
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", sorted(_COLLECTIVES))
def test_collective_wire_bytes_equal_jax_parse(recorded, kind):
    _, shape, op = _COLLECTIVES[kind]
    dims = ",".join(map(str, shape))
    line = (f"  %c = f32[{dims}]{{1,0}} {op}, "
            f"replica_groups={{{{0,1,2,3}}}}")
    want = janalysis.parse_collectives(line, 8)
    operands, wire, counts = recorded[kind]
    assert counts == want.count == {kind: 1}
    assert operands == want.operand_bytes
    operand = operands[kind]
    assert wire == pytest.approx(want.wire_bytes, rel=1e-12)
    assert analysis.collective_bytes(kind, int(np.prod(shape)) * 4, 4) == \
        (operand, pytest.approx(wire, rel=1e-12))


def test_analyze_gives_jax_terms_from_the_same_counts():
    hlo = ("  %a = f32[64,1024]{1,0} all-reduce(f32[64,1024]{1,0} %x), "
           "replica_groups={{0,1,2,3}}, to_apply=%add\n"
           "  %b = bf16[256,512]{1,0} all-gather(bf16[64,512]{1,0} %y), "
           "replica_groups=[4,4]<=[16], dimensions={0}\n")
    coll = janalysis.parse_collectives(hlo, 16)
    kw = dict(flops_per_device=3.5e12, bytes_per_device=7.25e10,
              num_devices=16, model_flops=4.1e13,
              bytes_fused_per_device=2.5e10, attn_io_bytes=3.0e9)
    want = janalysis.analyze(hlo_text=hlo, **kw)
    got = analysis.analyze(collective=analysis.CollectiveStats(
        dict(coll.operand_bytes), coll.wire_bytes, dict(coll.count)), **kw)
    for term, jc, tc in (
            ("compute_s", janalysis.PEAK_FLOPS, analysis.PEAK_FLOPS),
            ("memory_s", janalysis.HBM_BW, analysis.HBM_BW),
            ("memory_fused_s", janalysis.HBM_BW, analysis.HBM_BW),
            ("memory_projected_s", janalysis.HBM_BW, analysis.HBM_BW),
            ("collective_s", janalysis.LINK_BW, analysis.LINK_BW)):
        assert getattr(got, term) * tc == pytest.approx(
            getattr(want, term) * jc, rel=1e-12), term
    assert got.useful_flops_ratio == want.useful_flops_ratio
    assert got.model_flops == want.model_flops
    assert got.collective.wire_bytes == want.collective.wire_bytes
    assert got.floor_s() == max(got.compute_s, got.memory_fused_s)
    # the H100 SXM's published rates, not the TPU's
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.LINK_BW) == \
        (989e12, 3.35e12, 450e9)


def _pairs(Tq, Tk, causal, window):
    qp = np.arange(Tk - Tq, Tk)[:, None]
    kp = np.arange(Tk)[None, :]
    keep = np.ones((Tq, Tk), bool)
    if causal:
        keep &= kp <= qp
    if window:
        keep &= qp - kp < window
    return int(keep.sum())


def _nb(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


@pytest.mark.parametrize("Tq, Tk, Hq, Hkv, D, Dv, causal, window", [
    (24, 24, 4, 2, 16, 16, True, 0),
    (8, 40, 4, 1, 16, 16, True, 0),
    (32, 32, 2, 2, 32, 16, True, 9),
    (16, 24, 4, 4, 16, 16, False, 0),
])
def test_flash_counts_its_closed_form_forward_and_backward(
        Tq, Tk, Hq, Hkv, D, Dv, causal, window):
    g = torch.Generator().manual_seed(Tq + Tk)
    B = 2
    q = torch.randn(B, Tq, Hq, D, generator=g, requires_grad=True)
    k = torch.randn(B, Tk, Hkv, D, generator=g, requires_grad=True)
    v = torch.randn(B, Tk, Hkv, Dv, generator=g, requires_grad=True)
    kw = dict(causal=causal, window=window)
    pairs = _pairs(Tq, Tk, causal, window) * B * Hq
    out_b = B * Tq * Hq * Dv * 4
    with torch.no_grad():
        seen = analysis.count(lambda q, k, v: ops.flash_attention(
            q, k, v, **kw), (q, k, v)).cost()
    assert seen["flops"] == 2 * pairs * (D + Dv)
    assert seen["bytes"] == seen["bytes_fused"] == _nb(q, k, v) + out_b
    assert seen["kernels"] == {"flash_attention": {
        "calls": 1, "flops": seen["flops"], "bytes": seen["bytes"]}}

    def grads(q, k, v):
        o = ops.flash_attention(q, k, v, **kw)
        return torch.autograd.grad(o, (q, k, v), torch.ones_like(o))

    seen = analysis.count(grads, (q, k, v)).cost()
    fwd, bwd = (seen["kernels"][n] for n in ("flash_attention",
                                             "flash_attention_bwd"))
    assert fwd["flops"] == 2 * pairs * (D + Dv)
    assert fwd["bytes"] == _nb(q, k, v) + out_b + B * Tq * Hq * 4
    assert bwd["flops"] == pairs * (8 * D + 6 * Dv)
    # q, k, v, out, lse and do read; dq, dk, dv written
    assert bwd["bytes"] == 2 * _nb(q, k, v) + 2 * out_b + B * Tq * Hq * 4
    # around the kernels only ones_like (a fill) runs: no matmul
    assert seen["flops"] == fwd["flops"] + bwd["flops"]


def test_decode_kernels_count_their_closed_form():
    g = torch.Generator().manual_seed(0)
    B, S, Hq, Hkv, D = 3, 40, 8, 2, 16
    q = torch.randn(B, Hq, D, generator=g)
    k = torch.randn(B, S, Hkv, D, generator=g)
    v = torch.randn(B, S, Hkv, D, generator=g)
    clen = torch.tensor([5, 40, 0], dtype=torch.int32)
    for fn, name, lse in ((ops.decode_attention, "decode_attention", 0),
                          (ops.decode_attention_lse,
                           "decode_attention_lse", B * Hq * 4)):
        c = analysis.count(fn, (q, k, v, clen)).cost()
        assert c["kernels"] == {name: {
            "calls": 1, "flops": 2.0 * B * Hq * S * 2 * D,
            "bytes": _nb(q, k, v, clen) + B * Hq * D * 4 + lse}}
        assert (c["flops"], c["bytes"]) == (2.0 * B * Hq * S * 2 * D,
                                            c["kernels"][name]["bytes"])
    # paged decode over a table of 3 pages of 8 a row, and verify at K1 2
    pages = torch.randn(10, 8, Hkv, D, generator=g)
    table = torch.tensor([[1, 2, 3], [4, 5, 6], [7, 8, 9]],
                         dtype=torch.int32)
    c = analysis.count(ops.paged_decode_attention,
                       (q, pages, pages, table, clen)).cost()
    keys = 3 * 8
    assert c["flops"] == 2.0 * B * Hq * keys * 2 * D
    assert c["bytes"] == _nb(q, table, clen) + B * keys * Hkv * 2 * D * 4 \
        + B * Hq * D * 4
    qv = torch.randn(B, 2, Hq, D, generator=g)
    c = analysis.count(ops.paged_verify_attention,
                       (qv, pages, pages, table, clen + 2)).cost()
    assert c["flops"] == 2.0 * B * 2 * Hq * keys * 2 * D


def test_ssd_scan_and_rmsnorm_count_their_closed_form():
    g = torch.Generator().manual_seed(1)
    B, T, H, P, G, N, Q = 2, 40, 4, 8, 1, 16, 16
    x = torch.randn(B, T, H, P, generator=g)
    dt = torch.rand(B, T, H, generator=g)
    A = -torch.rand(H, generator=g)
    Bm = torch.randn(B, T, G, N, generator=g)
    C = torch.randn(B, T, G, N, generator=g)
    c = analysis.count(lambda *a: ops.ssd_scan(*a, chunk=Q,
                                               return_final_state=True),
                       (x, dt, A, Bm, C)).cost()
    chunks = 3
    assert c["flops"] == B * chunks * H * (2 * Q * Q * (N + P)
                                          + 4 * Q * N * P)
    assert c["bytes"] == _nb(x, dt, A, Bm, C) + _nb(x) + B * H * P * N * 4
    rows = torch.randn(6, 40, generator=g)
    scale = torch.randn(40, generator=g)
    c = analysis.count(ops.rmsnorm, (rows, scale)).cost()
    assert c["flops"] == 0.0 and c["bytes"] == 2 * _nb(rows) + _nb(scale)


def test_ref_counts_the_plain_ops_and_their_logits():
    """``attn_impl="ref"``: the plain version's ops are counted (its
    products by flop_counter, its [B, Hkv, G, T, T] f32 scores as
    attention traffic), no kernel call; ``"kernel"`` counts none of
    them."""
    g = torch.Generator().manual_seed(2)
    q = torch.randn(1, 512, 2, 8, generator=g)
    k = torch.randn(1, 512, 1, 8, generator=g)
    run = (lambda q, k: ops.flash_attention(q, k, k))
    plain = analysis.count(run, (q, k), attn_impl="ref").cost()
    kern = analysis.count(run, (q, k), attn_impl="kernel").cost()
    assert plain["kernels"] == {} and plain["attn_io"] > 0
    # the two score products: q·kᵀ and p·v over every pair, masked or not
    assert plain["flops"] == 2 * 2 * 512 * 512 * 8 * 2
    assert kern["attn_io"] == 0
    assert kern["flops"] == 2 * 2 * (512 * 513 // 2) * 16
    assert kern["bytes"] < plain["bytes_fused"] < plain["bytes"]


def test_memory_counts_arguments_temporaries_and_in_place_updates():
    x = torch.zeros(1000)                    # 4000 B
    y = torch.zeros(250)                     # 1000 B

    def step(x, y):
        t = x * 2                            # 4000 B live
        u = t + 1                            # 8000 B live at the peak
        del t
        x.add_(u)                            # in place
        return x, u.sum()

    m = analysis.count(step, (x, y)).memory()
    assert m["argument_bytes"] == 5000
    assert m["temp_bytes"] == 8000
    assert m["alias_bytes"] == 4000
    assert m["output_bytes"] == 4000 + 4
    assert m["peak_bytes"] == 13000
