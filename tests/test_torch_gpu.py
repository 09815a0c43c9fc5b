"""CUDA kernels against their plain PyTorch versions, on the card.

This file imports no JAX, so it runs on the GPU machine, which has none:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py

Without a GPU every test skips (the kernels cannot run on the CPU; their
plain versions are held against JAX in ``test_torch_kernels.py``).  Cases
are the JAX suite's kernel shapes; tolerances 2e-5 (fp32) and 3.5e-2
(bf16) relative to the largest output."""
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref

# the JAX suite's cases (tests/test_kernels.py:29, tests/test_paged_kv.py:33);
# test_torch_kernels.py runs the same cases against JAX
FLASH_CASES = [
    # B, Tq, Tk, Hq, Hkv, D, causal, window, softcap, valid
    (2, 64, 64, 4, 2, 32, True, 0, 0.0, False),
    (1, 100, 100, 4, 4, 64, True, 0, 0.0, False),
    (2, 64, 64, 8, 1, 32, True, 0, 0.0, False),
    (2, 64, 64, 4, 2, 32, True, 16, 0.0, False),
    (2, 64, 64, 4, 2, 32, True, 0, 20.0, False),
    (2, 64, 64, 4, 2, 32, True, 0, 0.0, True),
    (2, 64, 64, 4, 2, 32, False, 0, 0.0, False),
    (2, 48, 96, 4, 2, 32, True, 0, 0.0, False),
    (1, 32, 32, 2, 2, 128, True, 0, 0.0, False),
]
PAGED_CASES = [
    # B, Hq, Hkv, D, page, MP, num_pages, window, softcap
    (2, 4, 2, 32, 16, 4, 11, 0, 0.0),
    (3, 8, 1, 64, 16, 8, 30, 0, 0.0),
    (1, 4, 4, 32, 32, 4, 9, 48, 0.0),
    (2, 8, 2, 32, 16, 6, 15, 0, 20.0),
    (2, 16, 2, 128, 8, 4, 12, 0, 0.0),
]
# tests/test_spec_decode.py:35 (window 0), then a deepest-K1 windowed case;
# test_torch_spec.py runs the same cases against JAX
VERIFY_CASES = [
    # B, K1, Hq, Hkv, D, page, MP, num_pages, softcap, window
    (2, 3, 4, 2, 32, 16, 4, 11, 0.0, 0),
    (1, 5, 8, 1, 64, 16, 8, 30, 0.0, 0),
    (2, 1, 4, 4, 32, 32, 4, 9, 0.0, 0),
    (2, 4, 8, 2, 32, 16, 6, 15, 20.0, 0),
    (3, 8, 16, 2, 128, 8, 6, 20, 0.0, 24),
]
DECODE_CASES = [
    # B, Hq, Hkv, D, S, window, softcap (S 100 and 70: not a multiple of
    # the Pallas block_k of 32 nor of the CUDA kernel's 32-key tile)
    (2, 4, 2, 32, 64, 0, 0.0),
    (3, 8, 1, 64, 100, 0, 0.0),
    (2, 8, 2, 32, 96, 40, 0.0),
    (2, 4, 4, 32, 64, 0, 20.0),
    (1, 16, 2, 128, 70, 16, 30.0),
]
TOL = {torch.float32: 2e-5, torch.bfloat16: 3.5e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(want, got):
    w, g = want.float().cpu(), got.float().cpu()
    return float((w - g).abs().max() / w.abs().max().clamp_min(1e-6))


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(case, dtype, cuda):
    B, Tq, Tk, Hq, Hkv, D, causal, window, softcap, valid = case
    g = torch.Generator(device=cuda).manual_seed(Tq)
    q = torch.randn(B, Tq, Hq, D, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, Tk, Hkv, D, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, Tk, Hkv, D, generator=g, device=cuda).to(dtype)
    vl = torch.randint(1, Tk + 1, (B,), generator=g, device=cuda) \
        if valid else None
    kw = dict(causal=causal, window=window, softcap=softcap,
              kv_valid_len=vl)
    got = ops.flash_attention(q, k, v, **kw)
    want = ref.mha(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and _rel(want, got) < TOL[dtype]


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_matches_plain(case, dtype, cuda):
    B, Hq, Hkv, D, page, MP, P, window, softcap = case
    g = torch.Generator(device=cuda).manual_seed(MP)
    q = torch.randn(B, Hq, D, generator=g, device=cuda).to(dtype)
    kp = torch.randn(P, page, Hkv, D, generator=g, device=cuda).to(dtype)
    vp = torch.randn(P, page, Hkv, D, generator=g, device=cuda).to(dtype)
    table = torch.randint(0, P, (B, MP), generator=g, device=cuda,
                          dtype=torch.int32)
    clen = torch.randint(1, MP * page + 1, (B,), generator=g, device=cuda,
                         dtype=torch.int32)
    kw = dict(window=window, softcap=softcap)
    got = ops.paged_decode_attention(q, kp, vp, table, clen, **kw)
    want = ref.paged_decode_attention(q, kp, vp, table, clen, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and _rel(want, got) < TOL[dtype]


def _pools(g, P, page, Hkv, D, dtype, int8, cuda):
    from repro_torch.models.attention import _quantize

    kf = torch.randn(P, page, Hkv, D, generator=g, device=cuda)
    vf = torch.randn(P, page, Hkv, D, generator=g, device=cuda)
    if not int8:
        return kf.to(dtype), vf.to(dtype), {}
    (kq, ks), (vq, vs) = _quantize(kf), _quantize(vf)
    return kq, vq, dict(k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("case", VERIFY_CASES)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_kernel_matches_plain(case, int8, dtype, cuda):
    B, K1, Hq, Hkv, D, page, MP, P, softcap, window = case
    g = torch.Generator(device=cuda).manual_seed(K1 * 7 + MP)
    q = torch.randn(B, K1, Hq, D, generator=g, device=cuda).to(dtype)
    kp, vp, scales = _pools(g, P, page, Hkv, D, dtype, int8, cuda)
    table = torch.randint(0, P, (B, MP), generator=g, device=cuda,
                          dtype=torch.int32)
    clen = torch.randint(K1, MP * page + 1, (B,), generator=g, device=cuda,
                         dtype=torch.int32)
    kw = dict(window=window, softcap=softcap, **scales)
    got = ops.paged_verify_attention(q, kp, vp, table, clen, **kw)
    want = ref.paged_verify_attention(q, kp, vp, table, clen, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and _rel(want, got) < TOL[dtype]
    if K1 == 1:                  # one verify token is one decode step
        dec = ops.paged_decode_attention(q[:, 0], kp, vp, table, clen, **kw)
        assert _rel(dec, got[:, 0]) < TOL[dtype]


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain(case, dtype, cuda):
    B, Hq, Hkv, D, S, window, softcap = case
    g = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn(B, Hq, D, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=g, device=cuda).to(dtype)
    clen = torch.randint(1, S + 1, (B,), generator=g, device=cuda,
                         dtype=torch.int32)
    kw = dict(window=window, softcap=softcap)
    got = ops.decode_attention(q, k, v, clen, **kw)
    want = ref.decode_attention(q, k, v, clen, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and _rel(want, got) < TOL[dtype]


def test_verify_and_decode_ignore_stale_keys(cuda):
    """Keys at or past ``cache_len`` hold huge values (a rejected
    speculative suffix, a stale dense row): neither kernel loads them,
    and ``cache_len = 0`` gives 0."""
    q = torch.randn(2, 3, 8, 64, device=cuda)
    kp = torch.randn(5, 16, 2, 64, device=cuda)
    kp[2, 4:] = 1e30                       # row 1: positions 20..31
    table = torch.tensor([[1, 2], [1, 2]], dtype=torch.int32, device=cuda)
    clen = torch.tensor([3, 20], dtype=torch.int32, device=cuda)
    got = ops.paged_verify_attention(q, kp, kp, table, clen)
    want = ref.paged_verify_attention(q, kp, kp, table, clen)
    k = torch.randn(2, 40, 2, 64, device=cuda)
    k[:, 20:] = 1e30
    dec = ops.decode_attention(q[:, 0], k, k, torch.tensor(
        [0, 20], dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and _rel(want, got) < 2e-5
    assert bool((dec[0] == 0).all()) and bool(torch.isfinite(dec).all())


def test_empty_rows_give_zero(cuda):
    q = torch.randn(1, 16, 4, 64, device=cuda)
    k = torch.randn(1, 64, 2, 64, device=cuda)
    zero = torch.zeros(1, dtype=torch.int32, device=cuda)
    out = ops.flash_attention(q, k, k, kv_valid_len=zero)
    kp = torch.randn(3, 16, 2, 64, device=cuda)
    dec = ops.paged_decode_attention(q[:, 0], kp, kp,
                                     torch.ones(1, 2, dtype=torch.int32,
                                                device=cuda), zero)
    torch.cuda.synchronize()
    assert bool((out == 0).all()) and bool((dec == 0).all())


def test_unsupported_head_dim_raises(cuda):
    q = torch.randn(1, 4, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_lse(dtype, cuda):
    """The optional log-sum-exp output: logsumexp of the scaled, masked
    logits per (position, head), f32."""
    from repro_torch.kernels.flash_attention import flash_attention

    B, T, Hq, Hkv, D = 2, 40, 8, 2, 64
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(B, T, Hq, D, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, T, Hkv, D, generator=g, device=cuda).to(dtype)
    out, lse = flash_attention(q, k, k, return_lse=True)
    kf = k.float().repeat_interleave(Hq // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * D ** -0.5, kf)
    causal = torch.ones(T, T, dtype=torch.bool, device=cuda).tril()
    want = torch.logsumexp(s.masked_fill(~causal, float("-inf")), dim=-1)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == (B, T, Hq)
    assert torch.allclose(lse, want.transpose(1, 2), atol=1e-4, rtol=1e-5)
    assert _rel(ref.mha(q, k, k), out) < TOL[dtype]


def test_draft_kernel_launch_failure_fails_the_batch(cuda, monkeypatch):
    """A ``decode_attention`` launch that returns a CUDA error raises
    ``KernelError`` from the wrapper, and the speculative engine fails
    the batch rather than turning speculation off around it."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.serving.engine import ServingEngine

    cfg = dataclasses.replace(get_reduced_config("tinyllama-1.1b"),
                              compute_dtype="float32")
    eng = ServingEngine(cfg, draft_cfg=dataclasses.replace(cfg, num_layers=1),
                        max_slots=2, max_seq=64, seed=1, device=cuda)
    monkeypatch.setattr(da, "_fn", lambda *a: 1)    # cudaErrorInvalidValue
    for p in (np.arange(7), np.arange(3, 15)):
        eng.submit(p, max_new_tokens=6)
    assert eng.run_until_drained() == []
    st = eng.stats()
    assert st["failed"] == 2 and st["speculative"]
    assert "spec_disabled_reason" not in st
    assert all("decode_attention kernel launch failed" in r.error
               for r in eng.failed.values())


# ---------------------------------------------------------------------------
# flash attention backward (the training path)
# ---------------------------------------------------------------------------

# B, Tq, Tk, Hq, Hkv, D, causal, window, softcap, valid: causal, non-causal,
# window, softcap, a kv_valid_len of 0 for one row, G 1/2/8 (8 with Hkv 1
# is MQA), ragged Tq != Tk, D 32/64/128; test_torch_train_kernels.py runs
# the plain version of the same cases against JAX
BWD_CASES = [
    (2, 64, 64, 4, 2, 32, True, 0, 0.0, False),
    (2, 64, 64, 4, 2, 32, False, 0, 0.0, False),
    (2, 64, 64, 4, 2, 32, True, 16, 0.0, False),
    (2, 64, 64, 4, 2, 32, True, 0, 12.0, False),
    (2, 64, 64, 4, 2, 64, True, 0, 0.0, True),
    (2, 64, 64, 8, 1, 64, True, 0, 0.0, False),
    (1, 100, 100, 4, 4, 64, True, 0, 0.0, False),
    (2, 48, 96, 4, 2, 32, True, 0, 0.0, False),
    (2, 96, 40, 16, 2, 128, False, 0, 0.0, True),
    (1, 70, 70, 32, 4, 64, True, 0, 30.0, False),
]


def _bwd_inputs(case, dtype, cuda, explicit=False):
    B, Tq, Tk, Hq, Hkv, D, causal, window, softcap, valid = case
    g = torch.Generator(device=cuda).manual_seed(Tq * 3 + Hq + D)
    q = torch.randn(B, Tq, Hq, D, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, Tk, Hkv, D, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, Tk, Hkv, D, generator=g, device=cuda).to(dtype)
    do = torch.randn(B, Tq, Hq, D, generator=g, device=cuda).to(dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    if valid:                      # row 0 sees no key at all
        kw["kv_valid_len"] = torch.tensor([0] + [Tk // 2] * (B - 1),
                                          device=cuda, dtype=torch.int32)
    if explicit:                   # a chunk at an offset over explicit keys
        qpos = (Tk - Tq + torch.arange(Tq, device=cuda, dtype=torch.int32)
                )[None].repeat(B, 1)
        qpos[-1, :3] = -1          # the last row's first 3 queries see none
        kw["q_positions"] = qpos
        kw["kv_positions"] = torch.arange(
            Tk, device=cuda, dtype=torch.int32)[None].expand(B, Tk)
    return q, k, v, do, kw


@pytest.mark.parametrize("explicit", [False, True])
@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_match_plain(case, dtype, explicit, cuda):
    """The dq and dk/dv kernels against ``ref.flash_attention_bwd`` on the
    forward kernel's own ``out`` and ``lse``."""
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels.flash_attention import flash_attention

    if explicit and case[1] > case[2]:
        pytest.skip("the explicit-position variant needs Tq <= Tk")
    q, k, v, do, kw = _bwd_inputs(case, dtype, cuda, explicit)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    n_dq, n_dkv = (fab.flash_attention_bwd_dq.launches,
                   fab.flash_attention_bwd_dkv.launches)
    got = fab.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    want = ref.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert fab.flash_attention_bwd_dq.launches == n_dq + 1
    assert fab.flash_attention_bwd_dkv.launches == n_dkv + 1
    for name, w, x in zip(("dq", "dk", "dv"), want, got):
        assert x.dtype == dtype and x.shape == w.shape, name
        assert bool(torch.isfinite(x).all()), name
        assert float(w.abs().max()) > 0, name
        assert _rel(w, x) < TOL[dtype], (name, _rel(w, x))
    if "kv_valid_len" in kw:       # the empty row has no gradient at all
        assert bool((got[0][0] == 0).all())
    if explicit and case[6]:       # nor have causal queries that see none
        assert bool((got[0][-1, :3] == 0).all())
        assert bool((got[0][-1, 3:] != 0).any())


@pytest.mark.parametrize("case", BWD_CASES[:6])
def test_flash_mha_grads_match_autograd_of_plain(case, cuda):
    """The autograd function on the card (forward kernel with lse, then
    the two backward kernels) against autograd through ``ref.mha``."""
    from repro_torch.kernels.flash_attention_bwd import flash_mha

    q, k, v, _, kw = _bwd_inputs(case, torch.float32, cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_mha(*leaves, **kw).cos().sum(), leaves)
    leaves2 = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.mha(*leaves2, **kw).cos().sum(), leaves2)
    torch.cuda.synchronize()
    for w, x in zip(want, got):
        assert _rel(w, x) < 2e-4


def _small_train_model(cuda):
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(
        get_reduced_config("tinyllama-1.1b", num_layers=2, d_model=128,
                           num_heads=8, num_kv_heads=2, head_dim=32),
        compute_dtype="float32")
    model = Model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=g, device=cuda)
    labels = torch.randint(0, cfg.vocab_size, (2, 40), generator=g,
                           device=cuda)
    labels[:, :3] = -1
    return model, params, {"tokens": toks, "labels": labels}


def _attn_grads(model, params, batch):
    attn = params["stack"]["blocks"]["attn"]
    leaves = [attn[n].requires_grad_() for n in ("w_q", "w_k", "w_v")]
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return grads


def test_model_loss_grads_reach_attention_weights(cuda, monkeypatch):
    """The train-mode forward used to cut the graph at the CUDA flash
    kernel: w_q, w_k and w_v got no gradient.  Through the kernels they
    now get the plain path's gradients (fp32, within 2e-4)."""
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ops

    model, params, batch = _small_train_model(cuda)
    n_dq = fab.flash_attention_bwd_dq.launches
    got = _attn_grads(model, params, batch)
    torch.cuda.synchronize()
    assert fab.flash_attention_bwd_dq.launches == n_dq + 2     # 2 layers
    monkeypatch.setattr(ops, "flash_mha", ref.mha)             # plain path
    want = _attn_grads(model, params, batch)
    for w, x in zip(want, got):
        assert float(x.abs().max()) > 0
        assert _rel(w, x) < 2e-4


def test_backward_kernel_launch_failure_raises(cuda, monkeypatch):
    """A dq launch that returns a CUDA error raises ``KernelError`` out
    of ``backward``; nothing falls back to the plain version."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention_bwd as fab

    model, params, batch = _small_train_model(cuda)
    fab._entry("flash_attention_bwd_dq")
    monkeypatch.setitem(fab._fns, "flash_attention_bwd_dq", lambda *a: 1)
    params["embed"]["embedding"].requires_grad_()
    loss, _ = model.loss(params, batch)
    with pytest.raises(build.KernelError, match="flash_attention_bwd_dq"):
        loss.backward()


def test_forward_only_kernels_refuse_grad_inputs(cuda):
    q = torch.randn(2, 4, 32, device=cuda, requires_grad=True)
    kp = torch.randn(3, 16, 2, 32, device=cuda)
    table = torch.ones(2, 2, dtype=torch.int32, device=cuda)
    clen = torch.full((2,), 5, dtype=torch.int32, device=cuda)
    for call in (
            lambda: ops.paged_decode_attention(q, kp, kp, table, clen),
            lambda: ops.paged_verify_attention(q[:, None], kp, kp, table,
                                               clen),
            lambda: ops.decode_attention(q, kp[:2], kp[:2], clen)):
        with pytest.raises(ValueError, match="forward-only"):
            call()
        with torch.no_grad():
            assert bool(torch.isfinite(call()).all())
