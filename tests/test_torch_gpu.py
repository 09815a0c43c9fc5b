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
