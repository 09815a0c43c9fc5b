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
