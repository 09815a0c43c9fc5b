"""CUDA kernels against their plain PyTorch versions, on the card.

This file imports no JAX, so it runs on the GPU machine, which has none:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py

Without a GPU every kernel test skips (the kernels cannot run on the
CPU; their plain versions are held against JAX in
``test_torch_kernels.py``).  Cases are the JAX suite's kernel shapes;
tolerances 2e-5 (fp32) and 3.5e-2 (bf16) relative to the largest
output."""
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.tree import leaves

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
    # G 12 (60-row bf16 blocks), G 96 at D 64 and D 128 (a partial second
    # head group), G 1 at T 129 (ragged around the 64-row tile), softcap 30
    (1, 70, 70, 24, 2, 64, True, 0, 0.0, True),
    (1, 40, 40, 96, 1, 64, True, 0, 0.0, False),
    (1, 40, 40, 96, 1, 128, False, 0, 0.0, False),
    (1, 129, 129, 2, 2, 128, True, 0, 0.0, True),
    (2, 129, 129, 8, 2, 32, True, 0, 30.0, False),
    # the encoders' widths (fig 3's apps at D 48, hubert-xlarge at D 80):
    # non-causal (as the encoders run it) and causal, G 1 and G 4
    (1, 37, 37, 4, 4, 48, False, 0, 0.0, False),
    (2, 70, 70, 8, 2, 48, False, 0, 0.0, False),
    (1, 37, 37, 4, 4, 48, True, 0, 0.0, True),
    (2, 70, 70, 8, 2, 48, True, 0, 20.0, False),
    (1, 37, 37, 4, 4, 80, False, 0, 0.0, False),
    (2, 70, 70, 8, 2, 80, False, 0, 0.0, True),
    (1, 37, 37, 4, 4, 80, True, 0, 0.0, False),
    (2, 70, 70, 8, 2, 80, True, 16, 0.0, False),
]
PAGED_CASES = [
    # B, Hq, Hkv, D, page, MP, num_pages, window, softcap
    (2, 4, 2, 32, 16, 4, 11, 0, 0.0),
    (3, 8, 1, 64, 16, 8, 30, 0, 0.0),
    (1, 4, 4, 32, 32, 4, 9, 48, 0.0),
    (2, 8, 2, 32, 16, 6, 15, 0, 20.0),
    (2, 16, 2, 128, 8, 4, 12, 0, 0.0),
    # the serving heads over MP·page 1024 with a window that crosses the
    # blocks' shares of the keys; G 1 at B 1 over MP·page 4096; G 16 at D
    # 128 over 4096; G 8 at D 32
    (8, 32, 4, 64, 16, 64, 520, 100, 0.0),
    (1, 8, 8, 64, 16, 256, 300, 0, 0.0),
    (2, 32, 2, 128, 16, 256, 520, 0, 30.0),
    (8, 8, 1, 32, 16, 64, 520, 0, 0.0),
    # the fleet's decode ticks: the serving heads at 4 slots and at one,
    # over MP·page 128 (max_seq 128), where most blocks of a cluster hold
    # none of a short row's keys
    (4, 32, 4, 64, 16, 8, 40, 0, 0.0),
    (1, 32, 4, 64, 16, 8, 9, 0, 0.0),
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
    # G 16 with K1 8 and G 32 with K1 4 (R = 128: two groups of 64 rows);
    # the serving shape (K1 5, G 8) with a window across the blocks'
    # shares; G 1 over MP·page 4096 at B 1
    (2, 8, 32, 2, 64, 16, 64, 130, 0.0, 0),
    (2, 4, 64, 2, 32, 16, 16, 40, 30.0, 0),
    (8, 5, 32, 4, 64, 16, 64, 520, 0.0, 100),
    (1, 8, 8, 8, 64, 16, 256, 260, 0.0, 0),
]
DECODE_CASES = [
    # B, Hq, Hkv, D, S, window, softcap (S 100 and 70: not a multiple of
    # the Pallas block_k of 32 nor of the CUDA kernel's 32-key tile)
    (2, 4, 2, 32, 64, 0, 0.0),
    (3, 8, 1, 64, 100, 0, 0.0),
    (2, 8, 2, 32, 96, 40, 0.0),
    (2, 4, 4, 32, 64, 0, 20.0),
    (1, 16, 2, 128, 70, 16, 30.0),
    # G 1 (zamba2's shared attention), G 1 with a window, and B 1 with one
    # 122-token row (on the CPU: neither a multiple of 16 nor of 64)
    (2, 8, 8, 64, 100, 0, 0.0),
    (2, 4, 4, 32, 96, 40, 0.0),
    (1, 8, 1, 64, 123, 0, 0.0),
]
# the card only: the serving shapes (the draft's G 8 and zamba2's G 1 over
# S 1024) with lengths that cross the blocks' shares of the key range,
# lengths of S, past S (clamped to S) and 0 (exactly 0), and windows
# across the shares
DECODE_GPU_CASES = [
    # B, Hq, Hkv, D, S, window, softcap, lengths (None: random 36-543)
    (8, 32, 32, 64, 1024, 0, 0.0, None),
    (8, 32, 4, 64, 1024, 0, 0.0, None),
    (8, 32, 32, 64, 1024, 100, 0.0, None),
    (8, 32, 4, 64, 1024, 300, 30.0, None),
    (6, 32, 4, 64, 1024, 0, 0.0, [1024, 1100, 5000, 0, 1, 65]),
    (6, 32, 32, 64, 1024, 300, 0.0, [1024, 1100, 1400, 0, 301, 700]),
    (3, 8, 8, 64, 512, 0, 0.0, [0, 200, 512]),
    (1, 32, 32, 64, 1000, 0, 0.0, [1000]),
    (1, 8, 1, 128, 4096, 1000, 0.0, [4001]),
    # the unikernel decode image of edge-stream-light: G 2, B 1, S 128
    (1, 4, 2, 64, 128, 0, 0.0, [1]),
    (1, 4, 2, 64, 128, 0, 0.0, [77]),
    (1, 4, 2, 64, 128, 0, 0.0, [128]),
    # mixtral-8x7b's decode tick over its ring of 4096 slots (G 4, D 128,
    # 8 slots): every ring full, every ring wrapped (lengths past S read
    # all S slots, as decode_step clamps them), and rings filling
    (8, 32, 8, 128, 4096, 0, 0.0, [4096] * 8),
    (8, 32, 8, 128, 4096, 0, 0.0, [4097, 4600, 5000, 8191, 4096, 4200,
                                   6000, 8000]),
    (8, 32, 8, 128, 4096, 0, 0.0, [1, 100, 2000, 4095, 4096, 0, 3000,
                                   4500]),
]
# mixtral-8x7b's monolithic prefill (the card only: the plain version's
# scores take 2.7 GB): G 4 at D 128 under its 4096-key window, a prompt
# of 4608 tokens, a ragged 4600, and a valid length past the window
MIXTRAL_FLASH_CASES = [
    # B, Tq, Tk, Hq, Hkv, D, causal, window, softcap, valid
    (1, 4608, 4608, 32, 8, 128, True, 4096, 0.0, False),
    (1, 4600, 4600, 32, 8, 128, True, 4096, 0.0, False),
    (1, 4200, 4200, 32, 8, 128, True, 4096, 0.0, True),
]
# head dims 192 (nemotron-4-340b) and 256 (gemma-2b), which the flash
# forward and the three paged-template kernels take since the dense
# variants; test_torch_dense_variants.py runs the same cases' plain
# versions against JAX.  Flash: gemma's G 8 over one KV head, nemotron's
# G 12, G 1 non-causal, a window, a softcap, ragged valid lengths and
# Tq < Tk.
WIDE_FLASH_CASES = [
    # B, Tq, Tk, Hq, Hkv, D, causal, window, softcap, valid
    (1, 64, 64, 8, 1, 256, True, 0, 0.0, False),
    (2, 70, 70, 8, 1, 256, True, 0, 0.0, True),
    (1, 40, 40, 4, 4, 256, False, 0, 0.0, False),
    (2, 64, 64, 8, 1, 256, True, 16, 30.0, False),
    (1, 48, 96, 8, 1, 256, True, 0, 0.0, False),
    (1, 64, 64, 12, 1, 192, True, 0, 0.0, False),
    (2, 70, 70, 12, 1, 192, True, 0, 0.0, True),
    (1, 40, 40, 4, 4, 192, False, 0, 0.0, False),
    (2, 64, 64, 24, 2, 192, True, 16, 30.0, False),
]
# paged decode: gemma's serving shape (B 8, G 8 over MP 64), nemotron's
# (G 12 on 8 KV heads), B 2-3 (clusters of 16 blocks), a window, softcap
WIDE_PAGED_CASES = [
    # B, Hq, Hkv, D, page, MP, num_pages, window, softcap
    (8, 8, 1, 256, 16, 64, 520, 0, 0.0),
    (8, 96, 8, 192, 16, 64, 520, 0, 0.0),
    (2, 8, 1, 256, 16, 4, 11, 0, 20.0),
    (3, 12, 1, 192, 16, 8, 30, 40, 0.0),
    (1, 4, 4, 256, 32, 4, 9, 48, 0.0),
]
# verify: K1 1, 2 and 5 at gemma's G 8 (8, 16 and 40 rows: one row
# group of 8, one of 16, two of 32), K1 8 (64 rows), nemotron's G 12 at
# K1 3 with a window
WIDE_VERIFY_CASES = [
    # B, K1, Hq, Hkv, D, page, MP, num_pages, softcap, window
    (2, 1, 8, 1, 256, 16, 8, 30, 0.0, 0),
    (2, 2, 8, 1, 256, 16, 4, 11, 20.0, 0),
    (8, 5, 8, 1, 256, 16, 64, 520, 0.0, 0),
    (2, 8, 8, 1, 256, 16, 6, 15, 0.0, 0),
    (2, 3, 12, 1, 192, 16, 6, 15, 0.0, 24),
]
# dense decode: the gemma draft's G 8, nemotron's G 12, G 1 with a window
WIDE_DECODE_CASES = [
    # B, Hq, Hkv, D, S, window, softcap
    (8, 8, 1, 256, 1024, 0, 0.0),
    (3, 12, 1, 192, 100, 0, 0.0),
    (2, 8, 1, 256, 96, 40, 20.0),
    (1, 4, 4, 192, 70, 16, 0.0),
]
# MLA (deepseek-v2-236b): the prefill's flash at q/k 192 and v 128 (Hq =
# Hkv, the broadcast k_rope; the smoke's 512-token bucket at 128 heads),
# G 2, a softcap, ragged valid lengths, non-causal; the absorbed decode's
# keys 576 and values 512 under one KV head at G 128 (the serving shape,
# B 8 over max_seq 1024 and full caches of 4096), G 4 (the golden
# replay's) and G 16, with empty rows, lengths of S and a softcap
MLA_FLASH_CASES = [
    # B, Tq, Tk, Hq, Hkv, causal, softcap, valid
    (1, 64, 64, 4, 4, True, 0.0, False),
    (2, 70, 70, 8, 8, True, 0.0, True),
    (1, 512, 512, 128, 128, True, 0.0, False),
    (2, 130, 130, 4, 2, True, 30.0, False),
    (1, 40, 40, 4, 4, False, 0.0, False),
]
MLA_DECODE_CASES = [
    # B, Hq, S, lengths (None: 36-543), softcap
    (8, 128, 1024, None, 0.0),
    (8, 128, 4096, [4096] * 8, 0.0),
    (2, 4, 128, [77, 128], 0.0),
    (3, 16, 200, [0, 5, 199], 0.0),
    (4, 128, 300, [0, 1, 299, 300], 30.0),
    (1, 128, 64, [64], 0.0),
]
# Every shape the JAX package's paths hand its Pallas kernels (the card
# only; test_torch_shapes.py runs the same cases against JAX).  Head dim
# 16: the JAX kernel tests' cases (tests/test_kernels.py:206-211,
# :246-251: B 2, T 32, Hq 4 over 2 and 8 over 1, window 8, softcap 15,
# cross lengths 24/40, non-causal), the JAX quickstart's train step (B 8
# x T 32, four heads of 16), T 70 and 129 around the 64-row tile with
# empty rows.  B, Tq, Tk, Hq, Hkv, D, causal, window, softcap, valid
D16_FLASH_CASES = [
    (2, 32, 32, 4, 2, 16, True, 0, 0.0, False),
    (2, 32, 32, 8, 1, 16, True, 0, 0.0, False),
    (2, 32, 32, 4, 2, 16, True, 8, 0.0, False),
    (2, 32, 32, 4, 2, 16, True, 0, 15.0, False),
    (2, 24, 40, 4, 2, 16, True, 0, 0.0, False),
    (2, 32, 32, 4, 2, 16, False, 0, 0.0, False),
    (8, 32, 32, 4, 4, 16, True, 0, 0.0, False),
    (2, 70, 70, 4, 4, 16, True, 0, 0.0, True),
    (2, 129, 129, 8, 2, 16, True, 0, 12.0, True),
]
# paged decode at D 16: the quickstart's tick (B 2, MP 4, four heads of
# 16 at G 1), G 2 and G 8, a window and a softcap, the serving heads'
# count over MP·page 1024.  B, Hq, Hkv, D, page, MP, num_pages, window,
# softcap
D16_PAGED_CASES = [
    (2, 4, 4, 16, 16, 4, 11, 0, 0.0),
    (2, 4, 2, 16, 16, 4, 11, 0, 0.0),
    (3, 8, 1, 16, 16, 8, 30, 0, 0.0),
    (2, 8, 2, 16, 16, 6, 15, 24, 20.0),
    (8, 32, 4, 16, 16, 64, 520, 100, 0.0),
]
# verify at any K1: D 16, then K1 9, 13 and 16 (spec_k_max 8, 12 and 15)
# at G 8 over one KV head at D 64 and 256, past a block's 64 rows (32 at
# D 256: 72-128 rows in 2-4 row groups), with a window and a softcap; G
# 12 at K1 16 (192 rows), and the reduced tinyllama's G 1 at K1 13.
# B, K1, Hq, Hkv, D, page, MP, num_pages, softcap, window
VERIFY_ANY_K1_CASES = [
    (2, 3, 4, 4, 16, 16, 4, 11, 0.0, 0),
    (2, 13, 8, 1, 16, 16, 8, 30, 20.0, 0),
    (2, 9, 8, 1, 64, 16, 8, 30, 0.0, 0),
    (2, 13, 8, 1, 64, 16, 8, 30, 0.0, 24),
    (2, 16, 8, 1, 64, 16, 8, 30, 30.0, 0),
    (2, 16, 24, 2, 64, 16, 8, 30, 0.0, 0),
    (2, 9, 8, 1, 256, 16, 8, 30, 0.0, 0),
    (2, 16, 8, 1, 256, 16, 8, 30, 0.0, 40),
    (2, 13, 4, 4, 32, 16, 4, 11, 0.0, 0),
]
# dense decode at D 16.  B, Hq, Hkv, D, S, window, softcap
D16_DECODE_CASES = [
    (2, 4, 4, 16, 64, 0, 0.0),
    (3, 8, 1, 16, 100, 0, 0.0),
    (2, 8, 2, 16, 96, 40, 20.0),
]
# MLA's absorbed decode at the reduced config's widths: keys of 48 (the
# 32 latent and 16 rope columns) over values of 32 (the latent ones),
# one KV head at G 4 as get_reduced_config("deepseek-v2-236b") runs it,
# and at G 16.  B, Hq, S, lengths (None: random 36-543), softcap
MLA_REDUCED_DECODE_CASES = [
    (8, 4, 1024, None, 0.0),
    (2, 4, 128, [77, 128], 0.0),
    (3, 4, 200, [0, 5, 199], 30.0),
    (2, 16, 64, [64, 1], 0.0),
]
# the SSD scan: T 1, 63, 64, 100, 257 and 511 around the chunk and the
# kernel's 64-row tiles (its bounds mask stands in for the JAX padding),
# chunk 100 (a partial second tile), P 16/32/64, N 16/32/64/128, groups 1
# and 2, batch 2 with a carried state, with and without an initial state;
# test_torch_ssm.py runs the same cases against JAX
SSD_CASES = [
    # B, T, H, P, G, N, chunk, initial state
    (1, 1, 4, 16, 1, 16, 16, True),
    (2, 63, 4, 16, 2, 16, 16, False),
    (1, 64, 4, 32, 1, 32, 64, True),
    (1, 257, 4, 16, 2, 64, 64, True),
    (1, 511, 2, 64, 1, 128, 256, True),
    (2, 100, 8, 16, 2, 16, 16, False),
    (2, 100, 4, 32, 2, 32, 100, True),
    (1, 257, 4, 64, 2, 128, 100, True),
]
# RMSNorm rows x width: the models' widths (2048, 2560, 4096, 5120) and
# the reduced ones; mamba2's decode rows (8 x 2560, 8 x 5120) and one row;
# d 100 (200 bytes in bf16, 400 in f32) and 1000 are not whole 16-byte
# vectors in bf16
RMSNORM_CASES = [(3, 128), (5, 256), (8, 2048), (7, 2560), (2, 4096),
                 (64, 5120), (8, 2560), (8, 5120), (1, 5120), (3, 100),
                 (2, 1000)]
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


@pytest.mark.parametrize("case", MIXTRAL_FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_flash_kernel_at_mixtral_prefill(case, dtype, cuda):
    """The window crosses 4096 keys on both sides of the tile skip."""
    test_flash_kernel_matches_plain(case, dtype, cuda)


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


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_int8_matches_plain(case, dtype, cuda):
    """The paged decode kernel over int8 pools with their scales."""
    B, Hq, Hkv, D, page, MP, P, window, softcap = case
    g = torch.Generator(device=cuda).manual_seed(MP + 1)
    q = torch.randn(B, Hq, D, generator=g, device=cuda).to(dtype)
    kp, vp, scales = _pools(g, P, page, Hkv, D, dtype, True, cuda)
    table = torch.randint(0, P, (B, MP), generator=g, device=cuda,
                          dtype=torch.int32)
    clen = torch.randint(1, MP * page + 1, (B,), generator=g, device=cuda,
                         dtype=torch.int32)
    kw = dict(window=window, softcap=softcap, **scales)
    got = ops.paged_decode_attention(q, kp, vp, table, clen, **kw)
    want = ref.paged_decode_attention(q, kp, vp, table, clen, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and _rel(want, got) < TOL[dtype]


# Lengths at the edges of the paged kernels' splits: a tile is 64 keys and
# a cluster of blocks (`cluster_size`: 4 or 8 here, 16 at B 1) shares a
# (sequence, KV head)'s keys in multiples of 16, so 512 keys are one tile
# a block at 8 and two at 4; then MP·page itself, and a length of 0
# beside the long rows
EDGE_LENGTHS = [1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 511, 512, 513]


def _edge_case(g, lengths, mp_page, K1, dtype, int8, cuda, Hq=16, Hkv=2,
               D=64, page=16):
    B, MP = len(lengths), mp_page // page
    P = B * MP + 1
    shape = (B, K1, Hq, D) if K1 else (B, Hq, D)
    q = torch.randn(*shape, generator=g, device=cuda).to(dtype)
    kp, vp, scales = _pools(g, P, page, Hkv, D, dtype, int8, cuda)
    table = (torch.randperm(P - 1, generator=g, device=cuda) + 1)[
        :B * MP].reshape(B, MP).to(torch.int32)
    clen = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    return q, kp, vp, table, clen, scales


@pytest.mark.parametrize("mp_page", [1024, 4096])
@pytest.mark.parametrize("K1", [0, 5])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernels_at_split_edges(mp_page, K1, int8, dtype, cuda):
    """Decode (K1 0) and verify (K1 5) at B 16: lengths around the tile
    and the blocks' shares, mp_page - 1 and mp_page, and one row of 0
    (which gives 0 in decode, and in verify for every query token)."""
    g = torch.Generator(device=cuda).manual_seed(mp_page + K1)
    lengths = EDGE_LENGTHS + [mp_page - 1, mp_page, 0]
    q, kp, vp, table, clen, kw = _edge_case(g, lengths, mp_page, K1, dtype,
                                            int8, cuda)
    if K1:
        got = ops.paged_verify_attention(q, kp, vp, table, clen, **kw)
        want = ref.paged_verify_attention(q, kp, vp, table, clen, **kw)
    else:
        got = ops.paged_decode_attention(q, kp, vp, table, clen, **kw)
        want = ref.paged_decode_attention(q, kp, vp, table, clen, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _rel(want, got) < TOL[dtype]
    assert bool((got[-1] == 0).all())


@pytest.mark.parametrize("length", [1, 64, 65, 543, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernels_one_sequence(length, dtype, cuda):
    """B 1 (clusters of 16 blocks): decode, and verify at K1 8, over
    MP·page 4096."""
    g = torch.Generator(device=cuda).manual_seed(length)
    for K1, kern, plain in ((0, ops.paged_decode_attention,
                             ref.paged_decode_attention),
                            (8, ops.paged_verify_attention,
                             ref.paged_verify_attention)):
        q, kp, vp, table, clen, kw = _edge_case(g, [length], 4096, K1, dtype,
                                                False, cuda, Hq=8, Hkv=1)
        got = kern(q, kp, vp, table, clen, **kw)
        want = plain(q, kp, vp, table, clen, **kw)
        torch.cuda.synchronize()
        assert _rel(want, got) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernels_ignore_stale_keys_at_a_share_end(dtype, cuda):
    """Every key at or past ``cache_len`` holds 1e30, in the page that
    also holds a block's last valid keys (lengths 200 and 75 end inside a
    16-key page and inside a block's share of 32 or 16 keys): decode and
    verify stay finite and equal to the plain versions, which mask them."""
    g = torch.Generator(device=cuda).manual_seed(3)
    lengths, page, mp_page = [200, 75], 16, 512
    for K1 in (0, 3):
        q, kp, vp, table, clen, kw = _edge_case(g, lengths, mp_page, K1,
                                                dtype, False, cuda)
        for b, n in enumerate(lengths):
            for pos in range(n, mp_page):
                kp[table[b, pos // page], pos % page] = 1e30
                vp[table[b, pos // page], pos % page] = 1e30
        if K1:
            got = ops.paged_verify_attention(q, kp, vp, table, clen)
            want = ref.paged_verify_attention(q, kp, vp, table, clen)
        else:
            got = ops.paged_decode_attention(q, kp, vp, table, clen)
            want = ref.paged_decode_attention(q, kp, vp, table, clen)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        assert _rel(want, got) < TOL[dtype]


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


def _dense_inputs(g, B, Hq, Hkv, D, S, lengths, dtype, cuda):
    q = torch.randn(B, Hq, D, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=g, device=cuda).to(dtype)
    clen = torch.randint(36, 544, (B,), generator=g, device=cuda,
                         dtype=torch.int32) if lengths is None else \
        torch.tensor(lengths, dtype=torch.int32, device=cuda)
    return q, k, v, clen


@pytest.mark.parametrize("case", DECODE_GPU_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_serving_shapes(case, dtype, cuda):
    """Rows whose keys (after the window) are none give exactly 0."""
    B, Hq, Hkv, D, S, window, softcap, lengths = case
    g = torch.Generator(device=cuda).manual_seed(S + Hkv + window)
    q, k, v, clen = _dense_inputs(g, B, Hq, Hkv, D, S, lengths, dtype, cuda)
    kw = dict(window=window, softcap=softcap)
    got = ops.decode_attention(q, k, v, clen, **kw)
    want = ref.decode_attention(q, k, v, clen, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert got.dtype == dtype and _rel(want, got) < TOL[dtype]
    c = clen.long()
    empty = (torch.clamp(c, max=S) <= (c - window if window else 0)) \
        | (c == 0)
    assert bool((got[empty] == 0).all())


@pytest.mark.parametrize("D", [16, 32, 64, 128, 192, 256])
@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_every_head_dim(D, G, dtype, cuda):
    g = torch.Generator(device=cuda).manual_seed(D + G)
    q, k, v, clen = _dense_inputs(g, 4, 4 * G, 4, D, 1024, None, dtype,
                                  cuda)
    got = ops.decode_attention(q, k, v, clen)
    want = ref.decode_attention(q, k, v, clen)
    torch.cuda.synchronize()
    assert _rel(want, got) < TOL[dtype]


@pytest.mark.parametrize("B", [4, 8])
@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_equals_paged_over_one_page(B, G, dtype, cuda):
    """A dense cache [B, S, Hkv, D] is a page pool of B pages of S keys
    with the identity table: the dense kernel agrees with the paged decode
    kernel on it within the tolerance, and bit for bit, since both size
    their clusters by one rule from the same grid and key range."""
    g = torch.Generator(device=cuda).manual_seed(G + B)
    S = 1024
    q, k, v, clen = _dense_inputs(g, B, 4 * G, 4, 64, S, None, dtype, cuda)
    table = torch.arange(B, dtype=torch.int32, device=cuda)[:, None]
    for window in (0, 300):
        dense = ops.decode_attention(q, k, v, clen, window=window)
        paged = ops.paged_decode_attention(q, k, v, table, clen,
                                           window=window)
        torch.cuda.synchronize()
        assert _rel(paged, dense) < TOL[dtype]
        assert torch.equal(dense, paged)


@pytest.mark.parametrize("case", WIDE_FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_flash_kernel_matches_plain(case, dtype, cuda):
    """D 192 and 256: three and two warpgroups a block in bf16, each
    with its own output columns."""
    test_flash_kernel_matches_plain(case, dtype, cuda)


@pytest.mark.parametrize("case", WIDE_PAGED_CASES)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_paged_kernel_matches_plain(case, int8, dtype, cuda):
    """D 192 and 256: two ring stages (32-key tiles in fp32), one row
    tile a warp; B 2-3 over one KV head takes clusters of 16 blocks."""
    if int8:
        test_paged_kernel_int8_matches_plain(case, dtype, cuda)
    else:
        test_paged_kernel_matches_plain(case, dtype, cuda)


@pytest.mark.parametrize("case", WIDE_VERIFY_CASES)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_verify_kernel_matches_plain(case, int8, dtype, cuda):
    """More than 32 rows (K1 5 and 8 at G 8, K1 3 at G 12) take row
    groups of 32 at D 192 and 256."""
    test_verify_kernel_matches_plain(case, int8, dtype, cuda)


@pytest.mark.parametrize("case", WIDE_DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_decode_kernel_matches_plain(case, dtype, cuda):
    test_decode_kernel_matches_plain(case, dtype, cuda)


@pytest.mark.parametrize("D", [192, 256])
def test_backward_takes_wide_head_dims(D, cuda):
    """The dq and dk/dv kernels take D 192 and 256 (nemotron-4-340b and
    gemma-2b train): a grad-mode ``flash_mha`` launches the forward and
    both backward kernels once each, its gradients those of autograd
    through ``ref.mha``; an unlisted width still raises in both wrappers
    and, before its forward, in a grad-mode ``flash_mha``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab

    g = torch.Generator(device=cuda).manual_seed(D)
    q, k, v = (torch.randn(1, 64, h, D, generator=g, device=cuda)
               .to(torch.bfloat16) for h in (8, 1, 1))
    counts = [f.launches for f in (fa.flash_attention,
                                   fab.flash_attention_bwd_dq,
                                   fab.flash_attention_bwd_dkv)]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(fab.flash_mha(*leaves).float().square().sum(),
                              leaves)
    ref_leaves = [t.clone().float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.mha(*ref_leaves).square().sum(),
                               ref_leaves)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(
        (fa.flash_attention, fab.flash_attention_bwd_dq,
         fab.flash_attention_bwd_dkv), counts)] == [1, 1, 1]
    for w, x in zip(want, got):
        assert _rel(w, x) < TOL[torch.bfloat16]
    bad = torch.randn(1, 64, 8, 96, generator=g, device=cuda) \
        .to(torch.bfloat16)
    lse = torch.zeros(1, 64, 8, device=cuda)
    for kernel in (fab.flash_attention_bwd_dq, fab.flash_attention_bwd_dkv):
        with pytest.raises(ValueError, match="head dims"):
            kernel(bad, bad[:, :, :1], bad[:, :, :1], lse, bad, lse)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="head dims"):
        fab.flash_mha(bad.clone().requires_grad_(), bad[:, :, :1],
                      bad[:, :, :1])
    assert fa.flash_attention.launches == before


@pytest.mark.parametrize("case", MLA_FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_mla_widths(case, dtype, cuda):
    """Keys 192 wide, values 128: the output is 128 wide, and so is the
    log-sum-exp the same as the plain version's."""
    B, Tq, Tk, Hq, Hkv, causal, softcap, valid = case
    g = torch.Generator(device=cuda).manual_seed(Tq + Hq)
    q = torch.randn(B, Tq, Hq, 192, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, Tk, Hkv, 192, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, Tk, Hkv, 128, generator=g, device=cuda).to(dtype)
    vl = torch.randint(1, Tk + 1, (B,), generator=g, device=cuda) \
        if valid else None
    kw = dict(causal=causal, softcap=softcap, kv_valid_len=vl,
              sm_scale=192 ** -0.5)
    from repro_torch.kernels.flash_attention import flash_attention

    got, lse = flash_attention(q, k, v, return_lse=True, **kw)
    want, want_lse = ref.mha(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert got.shape == (B, Tq, Hq, 128) and got.dtype == dtype
    assert _rel(want, got) < TOL[dtype]
    live = want_lse > ref.NEG_INF
    assert torch.allclose(lse[live], want_lse[live], atol=1e-4, rtol=1e-5)
    assert _rel(want, ops.flash_attention(q, k, v, **kw)) < TOL[dtype]


@pytest.mark.parametrize("case", MLA_DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_at_mla_widths(case, dtype, cuda):
    """Keys 576 wide (the latent c_kv and k_rope), values their first 512
    columns as the absorbed decode passes them, and independent values;
    a row with no valid key gives exactly 0."""
    B, Hq, S, lengths, softcap = case
    g = torch.Generator(device=cuda).manual_seed(S + Hq)
    q, k, _, clen = _dense_inputs(g, B, Hq, 1, 576, S, lengths, dtype, cuda)
    for v in (k[..., :512].contiguous(),
              torch.randn(B, S, 1, 512, generator=g,
                          device=cuda).to(dtype)):
        kw = dict(softcap=softcap, sm_scale=192 ** -0.5)
        got = ops.decode_attention(q, k, v, clen, **kw)
        want = ref.decode_attention(q, k, v, clen, **kw)
        torch.cuda.synchronize()
        assert got.shape == (B, Hq, 512) and got.dtype == dtype
        assert bool(torch.isfinite(got).all())
        assert _rel(want, got) < TOL[dtype]
        assert bool((got[clen == 0] == 0).all())


def test_unlisted_key_and_value_widths_raise(cuda):
    """Each wrapper takes its listed (key, value) widths only: the
    backward takes MLA's (192, 128) now, and at an unlisted pair such as
    (128, 64) its wrappers raise, and so does a grad-mode ``flash_mha``
    before its forward launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels.decode_attention import decode_attention

    def t(*shape):
        return torch.randn(*shape, device=cuda).to(torch.bfloat16)

    for dk, dv in ((192, 64), (128, 64), (256, 128), (576, 512)):
        with pytest.raises(ValueError, match="head dims"):
            fa.flash_attention(t(1, 8, 2, dk), t(1, 8, 2, dk), t(1, 8, 2, dv))
    clen = torch.tensor([5], device=cuda, dtype=torch.int32)
    for dk, dv in ((576, 256), (512, 512), (192, 128), (576, 576)):
        with pytest.raises(ValueError, match="head dims"):
            decode_attention(t(1, 4, dk), t(1, 16, 1, dk), t(1, 16, 1, dv),
                             clen)
    q, k, v = t(1, 64, 4, 128), t(1, 64, 4, 128), t(1, 64, 4, 64)
    lse = torch.zeros(1, 64, 4, device=cuda)
    for kernel in (fab.flash_attention_bwd_dq, fab.flash_attention_bwd_dkv):
        with pytest.raises(ValueError, match="head dims"):
            kernel(q, k, v, lse, t(1, 64, 4, 64), lse)
        with pytest.raises(ValueError, match="bad shapes"):
            kernel(q, k, v, lse, t(1, 64, 4, 128), lse)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="head dims"):
        fab.flash_mha(q.clone().requires_grad_(), k, v)
    assert fa.flash_attention.launches == before


def test_decode_kernel_takes_cuda_tensors_only():
    """The kernel's wrapper launches on CUDA tensors and raises on any
    other; the CPU path goes through ``ops``."""
    from repro_torch.kernels.decode_attention import decode_attention

    q = torch.zeros(1, 4, 32)
    k = torch.zeros(1, 16, 2, 32)
    clen = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        decode_attention(q, k, k, clen)


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
    q = torch.randn(1, 4, 2, 96, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q, q)


@pytest.mark.parametrize("D", [48, 80])
def test_forward_only_head_dims_stay_out_of_the_other_kernels(D, cuda):
    """The flash forward and backward take D 48 and 80; the dense decode
    kernel instantiates neither, so its wrapper refuses both."""
    from repro_torch.kernels.decode_attention import decode_attention

    q = torch.randn(1, 4, 2, D, device=cuda)
    k = torch.randn(1, 16, 2, D, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        decode_attention(q[:, 0], k, k, torch.tensor([5], device=cuda,
                                                     dtype=torch.int32))


@pytest.mark.parametrize("shape", [(2, 40, 8, 2, 64), (1, 129, 24, 2, 128),
                                   (2, 70, 8, 2, 48), (1, 77, 4, 4, 80),
                                   (2, 100, 4, 4, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_lse(dtype, shape, cuda):
    """The optional log-sum-exp output: logsumexp of the scaled, masked
    logits per (position, head), f32; the same as the plain version's."""
    from repro_torch.kernels.flash_attention import flash_attention

    B, T, Hq, Hkv, D = shape
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
    plain, plain_lse = ref.mha(q, k, k, return_lse=True)
    assert _rel(plain, out) < TOL[dtype]
    assert torch.allclose(lse, plain_lse, atol=1e-4, rtol=1e-5)


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
# the plain version of the first ten against JAX.  Then T 63, 65 and 129
# around the bf16 kernels' 64-row tile, D 32 and D 128 at G 8 and G 1,
# G 128, more heads a KV head than a dq block's 64 rows hold, G 12,
# whose dq blocks hold 60 rows and whose row map divides by a number
# that is no power of two, and G 96, whose second head group is partial;
# last the encoders' head dims 48 and 80.
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
    (2, 63, 63, 16, 2, 64, True, 0, 0.0, False),
    (2, 65, 65, 16, 2, 64, True, 24, 0.0, True),
    (1, 129, 129, 8, 1, 64, True, 0, 0.0, False),
    (2, 96, 96, 16, 2, 32, True, 0, 0.0, False),
    (2, 80, 80, 2, 2, 32, True, 0, 20.0, False),
    (1, 130, 130, 16, 2, 128, True, 0, 0.0, False),
    (2, 65, 65, 2, 2, 128, True, 0, 0.0, True),
    (1, 40, 40, 128, 1, 32, True, 0, 0.0, False),
    (2, 70, 70, 24, 2, 64, True, 0, 0.0, True),
    (1, 70, 70, 96, 1, 64, True, 0, 0.0, False),
    (1, 70, 70, 96, 1, 128, False, 0, 0.0, False),
    # the encoders' widths: D 48 and 80, non-causal (as the encoders
    # train) and causal, G 1 and GQA, ragged T, an empty row, softcap
    (2, 70, 70, 4, 4, 48, False, 0, 0.0, False),
    (2, 129, 129, 8, 2, 48, True, 0, 0.0, True),
    (2, 129, 129, 16, 16, 80, False, 0, 0.0, True),
    (2, 70, 70, 8, 2, 80, True, 16, 20.0, False),
]


def _bwd_inputs(case, dtype, cuda, positions=None):
    """Inputs of the backward kernels.  ``positions``: None leaves them
    implicit; "index" makes them explicit and equal to the indices, the
    queries at the last Tq of Tk keys; "offset" does the same with the
    last row's first 3 queries padding (-1); "packed"
    makes them two documents, 0..99 then 0..Tk-101; "reversed" runs them
    backwards.  The last two keep each tile's least and largest position
    away from the indices."""
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
    if positions in ("index", "offset"):   # a chunk over explicit keys
        qpos = (Tk - Tq + torch.arange(Tq, device=cuda, dtype=torch.int32)
                )[None].repeat(B, 1)
        if positions == "offset":  # the last row's first 3 queries see none
            qpos[-1, :3] = -1
        kw["q_positions"] = qpos
        kw["kv_positions"] = torch.arange(
            Tk, device=cuda, dtype=torch.int32)[None].expand(B, Tk)
    elif positions is not None:
        if positions == "packed":
            pos = torch.cat([torch.arange(100), torch.arange(Tk - 100)])
        else:
            pos = torch.arange(Tk - 1, -1, -1)
        pos = pos.to(device=cuda, dtype=torch.int32)[None].expand(B, Tk)
        kw["q_positions"] = kw["kv_positions"] = pos
    return q, k, v, do, kw


# each case with implicit and with offset positions (Tq <= Tk), then
# packed and reversed positions over one row of 256 (causal; Hq, Hkv, D,
# window and softcap vary)
BWD_RUNS = [(c, p) for c in BWD_CASES for p in (None, "offset")
            if p is None or c[1] <= c[2]] + [
    ((2, 256, 256, 32, 4, 64, True, 0, 0.0, False), "packed"),
    ((2, 256, 256, 16, 2, 128, True, 48, 0.0, False), "packed"),
    ((2, 256, 256, 32, 4, 64, True, 0, 0.0, False), "reversed"),
    ((2, 256, 256, 8, 8, 32, True, 40, 12.0, False), "reversed"),
]


@pytest.mark.parametrize("case, positions", BWD_RUNS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_match_plain(case, dtype, positions, cuda):
    """The dq and dk/dv kernels against ``ref.flash_attention_bwd`` on the
    forward kernel's own ``out`` and ``lse``."""
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v, do, kw = _bwd_inputs(case, dtype, cuda, positions)
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
        assert _rel(w, x) < TOL[dtype], (name, positions, _rel(w, x))
    if "kv_valid_len" in kw:       # the empty row has no gradient at all
        assert bool((got[0][0] == 0).all())
    if positions == "offset" and case[6]:   # nor have causal queries that
        assert bool((got[0][-1, :3] == 0).all())        # see none
        assert bool((got[0][-1, 3:] != 0).any())


# the wide (key, value) pairs: B, Tq, Tk, Hq, Hkv, Dk, Dv, causal, window,
# softcap, valid.  Each pair causal with an empty row and a ragged
# length, non-causal, with a window and a softcap, at G 1, gemma's G 8
# over one KV head, nemotron's G 12 and deepseek's Hq = Hkv, over T
# around the 64-row tile and Tq < Tk
WIDE_BWD_CASES = [
    (2, 65, 65, 8, 1, 256, 256, True, 0, 0.0, True),
    (1, 70, 70, 8, 1, 256, 256, False, 0, 0.0, False),
    (2, 129, 129, 4, 4, 256, 256, True, 40, 30.0, False),
    (2, 48, 96, 8, 1, 256, 256, True, 0, 0.0, False),
    (2, 65, 65, 24, 2, 192, 192, True, 0, 0.0, True),
    (1, 70, 70, 4, 4, 192, 192, False, 0, 20.0, False),
    (2, 129, 129, 12, 1, 192, 192, True, 32, 0.0, False),
    (2, 96, 130, 12, 1, 192, 192, True, 0, 0.0, True),
    (2, 65, 65, 8, 8, 192, 128, True, 0, 0.0, True),
    (1, 129, 129, 16, 16, 192, 128, False, 0, 30.0, False),
    (2, 70, 70, 8, 2, 192, 128, True, 24, 0.0, False),
    (2, 48, 96, 16, 16, 192, 128, True, 0, 0.0, True),
    (2, 65, 65, 4, 4, 48, 32, True, 0, 0.0, True),
    (1, 129, 129, 8, 2, 48, 32, False, 0, 30.0, False),
    (2, 70, 70, 4, 4, 48, 32, True, 24, 0.0, False),
]


def _wide_bwd_inputs(case, dtype, cuda, positions=None):
    """``_bwd_inputs`` at a (key, value) pair: v and do Dv wide."""
    B, Tq, Tk, Hq, Hkv, Dk, Dv, causal, window, softcap, valid = case
    q, k, _, _, kw = _bwd_inputs((B, Tq, Tk, Hq, Hkv, Dk, causal, window,
                                  softcap, valid), dtype, cuda, positions)
    g = torch.Generator(device=cuda).manual_seed(Tq + Dv)
    v = torch.randn(B, Tk, Hkv, Dv, generator=g, device=cuda).to(dtype)
    do = torch.randn(B, Tq, Hq, Dv, generator=g, device=cuda).to(dtype)
    return q, k, v, do, kw


# each case with implicit positions, offset ones where Tq <= Tk, packed
# ones (two documents) where Tq = Tk > 100
WIDE_BWD_RUNS = [(c, p) for c in WIDE_BWD_CASES
                 for p in (None, "offset", "packed")
                 if p is None or (p == "offset" and c[1] <= c[2])
                 or c[1] == c[2] > 100]


@pytest.mark.parametrize("case, positions", WIDE_BWD_RUNS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_flash_bwd_kernels_match_plain(case, positions, dtype, cuda):
    """The dq and dk/dv kernels at (192, 192), (256, 256), (192, 128) and
    (48, 32) against ``ref.flash_attention_bwd`` on the forward kernel's own
    ``out`` and ``lse``, whose ``lse`` is held against ``ref.mha``'s:
    dq and dk Dk wide, dv Dv wide."""
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v, do, kw = _wide_bwd_inputs(case, dtype, cuda, positions)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    want_out, want_lse = ref.mha(q, k, v, return_lse=True, **kw)
    got = fab.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    want = ref.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert _rel(want_out, out) < TOL[dtype]
    assert torch.allclose(lse, want_lse, atol=1e-4, rtol=1e-5)
    for name, w, x in zip(("dq", "dk", "dv"), want, got):
        assert x.dtype == dtype and x.shape == w.shape, name
        assert bool(torch.isfinite(x).all()), name
        assert float(w.abs().max()) > 0, name
        assert _rel(w, x) < TOL[dtype], (name, positions, _rel(w, x))
    assert got[2].shape[-1] == case[6] and got[1].shape[-1] == case[5]
    if "kv_valid_len" in kw:       # the empty row has no gradient at all
        assert bool((got[0][0] == 0).all())


@pytest.mark.parametrize("case", [BWD_CASES[4], BWD_CASES[12],
                                  BWD_CASES[15]] + [WIDE_BWD_CASES[i]
                                                    for i in (0, 4, 8)])
def test_flash_bwd_kernels_bf16_repeat_bit_equal(case, cuda):
    """No atomics: two bf16 runs give the same dq, dk and dv, bit for
    bit."""
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels.flash_attention import flash_attention

    inputs = _wide_bwd_inputs if len(case) == 11 else _bwd_inputs
    q, k, v, do, kw = inputs(case, torch.bfloat16, cuda, "offset")
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    first = fab.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    again = fab.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), first, again):
        assert torch.equal(x, y), name


# The forward kernel with positions: every backward run above, then
# explicit index positions, packed positions alone and with window 64,
# G 12, G 96 at D 64 and D 128, G 1, T 129, D 32 and D 128, a row that
# sees no key, a B 2 x T 1024 causal case and softcap 30.
FWD_RUNS = BWD_RUNS + [
    ((2, 256, 256, 32, 4, 64, True, 0, 0.0, False), "index"),
    ((2, 256, 256, 32, 4, 64, True, 64, 0.0, False), "packed"),
    ((2, 70, 70, 24, 2, 64, True, 0, 0.0, True), "offset"),
    ((1, 70, 70, 96, 1, 64, True, 0, 0.0, False), "index"),
    ((1, 70, 70, 96, 1, 128, False, 0, 0.0, False), "index"),
    ((2, 129, 129, 4, 4, 128, True, 0, 0.0, True), "index"),
    ((2, 129, 129, 32, 4, 64, True, 0, 0.0, True), "offset"),
    ((2, 200, 200, 16, 4, 32, True, 0, 0.0, False), "index"),
    ((2, 96, 256, 32, 4, 64, True, 0, 0.0, True), "index"),
    ((2, 1024, 1024, 32, 4, 64, True, 0, 0.0, False), "index"),
    ((2, 1024, 1024, 32, 4, 64, True, 0, 0.0, False), None),
    ((2, 256, 256, 32, 4, 64, True, 0, 30.0, False), "index"),
]


@pytest.mark.parametrize("case, positions", FWD_RUNS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_positions_match_plain(case, dtype, positions, cuda):
    """The forward kernel's ``out`` and ``lse`` against ``ref.mha``: a row
    that sees no key gives an output of exactly 0 and ``lse = NEG_INF``."""
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v, _, kw = _bwd_inputs(case, dtype, cuda, positions)
    n = flash_attention.launches
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    want, want_lse = ref.mha(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    assert out.dtype == dtype and out.shape == want.shape
    assert bool(torch.isfinite(out).all())
    assert _rel(want, out) < TOL[dtype], (positions, _rel(want, out))
    assert lse.dtype == torch.float32 and lse.shape == want_lse.shape
    assert torch.allclose(lse, want_lse, atol=1e-4, rtol=1e-5)
    empty = want_lse == ref.NEG_INF                # rows with no kept key
    assert bool((lse[empty] == ref.NEG_INF).all())
    assert bool((out[empty] == 0).all())
    if "kv_valid_len" in kw:                       # batch row 0 sees none
        assert bool(empty[0].all())


@pytest.mark.parametrize("case, positions", [FWD_RUNS[-1], FWD_RUNS[-6],
                                             BWD_RUNS[-1]])
def test_flash_kernel_bf16_repeat_bit_equal(case, positions, cuda):
    """Two bf16 forward runs give the same output and ``lse``, bit for
    bit."""
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v, _, kw = _bwd_inputs(case, torch.bfloat16, cuda, positions)
    first = flash_attention(q, k, v, return_lse=True, **kw)
    again = flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    for x, y in zip(first, again):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_no_key_past_the_valid_length(dtype, cuda):
    """With index positions the kernel loads no key at or past
    ``kv_valid_len`` (a serving chunk's gathered span ends in stale
    pages): NaN written there leaves the output as the plain version
    gives it on the keys as they were."""
    B, Tq, Tk, Hq, Hkv, D = 2, 64, 320, 32, 4, 64
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn(B, Tq, Hq, D, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, Tk, Hkv, D, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, Tk, Hkv, D, generator=g, device=cuda).to(dtype)
    valid = torch.tensor([200, 131], device=cuda, dtype=torch.int32)
    kw = dict(q_positions=(136 + torch.arange(Tq, device=cuda))[None]
              .expand(B, Tq), kv_valid_len=valid)
    want = ref.mha(q, k, v, **kw)
    for b, n in enumerate(valid.tolist()):
        k[b, n:] = float("nan")
        v[b, n:] = float("nan")
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _rel(want, got) < TOL[dtype]


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_mha_at_head_dim_80_trains_through_the_kernels(dtype, cuda):
    """A grad-mode ``flash_mha`` at hubert-xlarge's width (16 heads of 80,
    non-causal, explicit positions) launches the forward once and the dq
    and dk/dv kernels once each; its gradients match autograd through
    ``ref.mha`` (2e-4 in fp32, the bf16 tolerance in bf16)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab

    g = torch.Generator(device=cuda).manual_seed(80)
    q, k, v = (torch.randn(2, 100, 16, 80, generator=g, device=cuda)
               .to(dtype) for _ in range(3))
    pos = torch.arange(100, device=cuda, dtype=torch.int32)[None].expand(
        2, 100)
    kw = dict(causal=False, q_positions=pos, kv_positions=pos)
    counts = [fa.flash_attention.launches, fab.flash_attention_bwd_dq.launches,
              fab.flash_attention_bwd_dkv.launches]
    leaves_ = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(
        fab.flash_mha(*leaves_, **kw).float().cos().sum(), leaves_)
    assert [fa.flash_attention.launches - counts[0],
            fab.flash_attention_bwd_dq.launches - counts[1],
            fab.flash_attention_bwd_dkv.launches - counts[2]] == [1, 1, 1]
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.mha(*plain, **kw).float().cos().sum(),
                               plain)
    torch.cuda.synchronize()
    for w, x in zip(want, got):
        assert x.dtype == dtype
        assert _rel(w, x) < (2e-4 if dtype == torch.float32
                             else TOL[dtype])


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


# ---------------------------------------------------------------------------
# every shape of the JAX package's paths: head dim 16, verify at any K1,
# MLA's absorbed decode at keys of 48 over values of 32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", D16_FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_d16_flash_kernel_matches_plain(case, dtype, cuda):
    """One k16 step for q·kᵀ, an m64n16 p·v, one 16-byte chunk a thread."""
    test_flash_kernel_matches_plain(case, dtype, cuda)


@pytest.mark.parametrize("case", D16_FLASH_CASES)
@pytest.mark.parametrize("positions", [None, "offset"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_d16_flash_bwd_kernels_match_plain(case, positions, dtype, cuda):
    """dq and dk/dv at D 16 (m64n16 accumulators) on the forward
    kernel's own ``out`` and ``lse``."""
    test_flash_bwd_kernels_match_plain(case, dtype, positions, cuda)


@pytest.mark.parametrize("case", D16_PAGED_CASES)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_d16_paged_kernel_matches_plain(case, int8, dtype, cuda):
    """One m16n8k16 step covers q·kᵀ; an int8 row is one 16-byte chunk."""
    if int8:
        test_paged_kernel_int8_matches_plain(case, dtype, cuda)
    else:
        test_paged_kernel_matches_plain(case, dtype, cuda)


@pytest.mark.parametrize("case", VERIFY_ANY_K1_CASES)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_kernel_at_any_k1(case, int8, dtype, cuda):
    """Rows past a block's 64 (32 at D 256) go to more row groups; each
    group's rows keep their own query token and causal limit."""
    test_verify_kernel_matches_plain(case, int8, dtype, cuda)


def test_verify_kernel_refuses_a_k1_past_the_grid(cuda):
    """K1 4097 at 1024 KV heads of G 1 is 65 row groups a head, 66 560
    blocks on the grid's y: the wrapper raises before any launch."""
    from repro_torch.kernels import paged_verify_attention as pva

    q = torch.zeros(1, 4097, 1024, 16, device=cuda, dtype=torch.bfloat16)
    pools = torch.zeros(2, 16, 1024, 16, device=cuda, dtype=torch.bfloat16)
    table = torch.ones(1, 1, dtype=torch.int32, device=cuda)
    clen = torch.full((1,), 4097, dtype=torch.int32, device=cuda)
    before = pva.paged_verify_attention.launches
    with pytest.raises(ValueError, match="65535"):
        pva.paged_verify_attention(q, pools, pools, table, clen)
    assert pva.paged_verify_attention.launches == before


@pytest.mark.parametrize("case", D16_DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_d16_decode_kernel_matches_plain(case, dtype, cuda):
    test_decode_kernel_matches_plain(case, dtype, cuda)


@pytest.mark.parametrize("case", MLA_REDUCED_DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_at_reduced_mla_widths(case, dtype, cuda):
    """Keys of 48, values their first 32 columns as the absorbed decode
    passes them, and independent values; the log-sum-exp variant's output
    equals ``decode_attention``'s bit for bit and its lse the plain one's;
    a row with no valid key gives exactly 0 (and NEG_INF)."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_lse)

    B, Hq, S, lengths, softcap = case
    g = torch.Generator(device=cuda).manual_seed(S + Hq + 48)
    q, k, _, clen = _dense_inputs(g, B, Hq, 1, 48, S, lengths, dtype, cuda)
    for v in (k[..., :32].contiguous(),
              torch.randn(B, S, 1, 32, generator=g, device=cuda).to(dtype)):
        kw = dict(softcap=softcap, sm_scale=48 ** -0.5)
        got = decode_attention(q, k, v, clen, **kw)
        out, lse = decode_attention_lse(q, k, v, clen, **kw)
        want, want_lse = ref.decode_attention(q, k, v, clen,
                                              return_lse=True, **kw)
        torch.cuda.synchronize()
        assert got.shape == (B, Hq, 32) and got.dtype == dtype
        assert bool(torch.isfinite(got).all())
        assert _rel(want, got) < TOL[dtype]
        assert torch.equal(out, got)
        live = clen > 0
        assert torch.allclose(lse[live], want_lse[live], atol=1e-4,
                              rtol=1e-5)
        assert bool((got[~live] == 0).all())
        assert bool((lse[~live] == ref.NEG_INF).all())


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


# ---------------------------------------------------------------------------
# the SSD scan and RMSNorm (the SSM serving path)
# ---------------------------------------------------------------------------

def _ssd_inputs(case, dtype, device, seed=0):
    B, T, H, P, G, N, chunk, init = case
    g = torch.Generator(device=device).manual_seed(seed + T)
    x = torch.randn(B, T, H, P, generator=g, device=device).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(B, T, H, generator=g, device=device)) * 0.5
    A = -torch.exp(torch.randn(H, generator=g, device=device))
    Bm = torch.randn(B, T, G, N, generator=g, device=device).to(dtype)
    Cm = torch.randn(B, T, G, N, generator=g, device=device).to(dtype)
    s0 = torch.randn(B, H, P, N, generator=g, device=device) if init \
        else None
    return (x, dt, A, Bm, Cm), dict(chunk=chunk, initial_state=s0,
                                    return_final_state=True)


@pytest.mark.parametrize("case", SSD_CASES + [
    (1, 64, 80, 64, 1, 128, 256, True),     # mamba2-2.7b serving chunk
    (1, 64, 64, 64, 1, 64, 256, True),      # zamba2-1.2b serving chunk
    # a rank's heads on a model axis: mamba2's 40 of 80 and zamba2's 32 of
    # 64 on two ranks, 5 of 80 on sixteen (an odd count: no head pairs in
    # a cluster), two heads reading a group each
    (4, 130, 40, 64, 1, 128, 256, True),
    (4, 130, 32, 64, 1, 64, 256, True),
    (1, 257, 5, 64, 1, 128, 256, True),
    (2, 64, 2, 64, 2, 128, 64, True),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain(case, dtype, cuda):
    args, kw = _ssd_inputs(case, dtype, cuda)
    y, s = ops.ssd_scan(*args, **kw)
    wy, ws = ref.ssd_scan(*args, **kw)
    torch.cuda.synchronize()
    assert y.dtype == dtype and s.dtype == torch.float32
    assert _rel(wy, y) < TOL[dtype] and _rel(ws, s) < TOL[dtype]


# every P the kernel takes: 1, 2 or 4 P-slices of 16 a head (a cluster
# of 1-8 blocks over two heads), rows 100 (a partial tile), chunk 64
@pytest.mark.parametrize("P", [16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_every_slice_width(P, dtype, cuda):
    args, kw = _ssd_inputs((2, 100, 4, P, 2, 64, 64, True), dtype, cuda)
    y, s = ops.ssd_scan(*args, **kw)
    wy, ws = ref.ssd_scan(*args, **kw)
    torch.cuda.synchronize()
    assert _rel(wy, y) < TOL[dtype] and _rel(ws, s) < TOL[dtype]


def test_ssd_scan_slice_width_fills_the_card():
    """A batch-1 serving chunk of mamba2 (80 heads) or zamba2 (64) runs
    one block per P-slice of 16 of each head: more blocks than the
    card's 132 SMs."""
    from repro_torch.kernels.ssd_scan import HEAD_DIMS, P_SLICE

    assert P_SLICE == 16 and all(P % P_SLICE == 0 for P in HEAD_DIMS)
    for H in (80, 64):
        assert 1 * H * 64 // P_SLICE > 132


@pytest.mark.parametrize("T,a_scale", [(511, 1.0), (4096, 1.0),
                                       (4096, 0.01)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_carries_the_state_over_calls(T, a_scale, dtype,
                                                      cuda):
    """A prompt of 511 or 4096 tokens fed as calls of at most 64 tokens
    (8 or 64 calls), each passing on the state (as serving does), against
    one plain call; also with A / 100, a state that remembers thousands
    of tokens."""
    args, kw = _ssd_inputs((1, T, 8, 64, 1, 128, 256, True), dtype, cuda)
    x, dt, A, Bm, Cm = args
    A = A * a_scale
    args = (x, dt, A, Bm, Cm)
    wy, ws = ref.ssd_scan(*args, **kw)
    s, ys = kw["initial_state"], []
    for c0 in range(0, T, 64):
        c1 = min(c0 + 64, T)
        y, s = ops.ssd_scan(x[:, c0:c1], dt[:, c0:c1], A, Bm[:, c0:c1],
                            Cm[:, c0:c1], chunk=256, initial_state=s,
                            return_final_state=True)
        ys.append(y)
    torch.cuda.synchronize()
    assert _rel(wy, torch.cat(ys, dim=1)) < TOL[dtype]
    assert _rel(ws, s) < TOL[dtype]


@pytest.mark.parametrize("case", RMSNORM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(case, dtype, cuda):
    rows, d = case
    g = torch.Generator(device=cuda).manual_seed(d)
    x = (torch.randn(rows, d, generator=g, device=cuda) * 3).to(dtype)
    scale = 1 + 0.1 * torch.randn(d, generator=g, device=cuda)
    got = ops.rmsnorm(x, scale, eps=1e-5)
    want = ref.rmsnorm(x, scale, 1e-5)
    torch.cuda.synchronize()
    assert got.dtype == dtype and _rel(want, got) < TOL[dtype]


@pytest.mark.parametrize("case", RMSNORM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_takes_the_mean_square_from_outside(case, dtype,
                                                           cuda):
    """The ``ms`` form (a rank's channels of a row split over a model
    axis): each row normalized by a given f32 mean of squares, here the
    whole row's of which x is half, against the plain version with the
    same ``ms``; a misaligned view of the rows too."""
    rows, d = case
    g = torch.Generator(device=cuda).manual_seed(d + 1)
    flat = (torch.randn(rows * d + 1, generator=g, device=cuda) * 3).to(dtype)
    other = (torch.randn(rows, d, generator=g, device=cuda) * 3).to(dtype)
    scale = 1 + 0.1 * torch.randn(d, generator=g, device=cuda)
    for x in (flat[:-1].view(rows, d), flat[1:].view(rows, d)):
        ms = (x.float().square().sum(-1) + other.float().square().sum(-1)) \
            / (2 * d)
        got = ops.rmsnorm(x, scale, eps=1e-5, ms=ms)
        want = ref.rmsnorm(x, scale, 1e-5, ms)
        torch.cuda.synchronize()
        assert got.dtype == dtype and _rel(want, got) < TOL[dtype]


@pytest.mark.parametrize("rows,d", [(8, 2560), (3, 5120), (64, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_misaligned_rows(rows, d, dtype, cuda):
    """Rows of a contiguous view that starts one element past a 16-byte
    boundary: read by element, the same result."""
    g = torch.Generator(device=cuda).manual_seed(rows)
    flat = (torch.randn(rows * d + 1, generator=g, device=cuda) * 3).to(dtype)
    x = flat[1:].view(rows, d)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    scale = 1 + 0.1 * torch.randn(d, generator=g, device=cuda)
    got = ops.rmsnorm(x, scale, eps=1e-5)
    want = ref.rmsnorm(x, scale, 1e-5)
    torch.cuda.synchronize()
    assert _rel(want, got) < TOL[dtype]


def test_ssm_kernels_refuse_grad_and_raise_on_a_failed_launch(
        cuda, monkeypatch):
    """Both kernels are forward-only, and a launch that returns a CUDA
    error raises ``KernelError``: nothing falls back to the plain
    version, and the engine fails the request with it."""
    import numpy as np

    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels import build
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.serving.engine import ServingEngine

    x = torch.randn(4, 64, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="forward-only"):
        ops.rmsnorm(x, torch.ones(64, device=cuda))
    args, kw = _ssd_inputs(SSD_CASES[0], torch.float32, cuda)
    args[0].requires_grad_()
    with pytest.raises(ValueError, match="forward-only"):
        ops.ssd_scan(*args, **kw)
    with torch.no_grad():
        assert bool(torch.isfinite(ops.ssd_scan(*args, **kw)[0]).all())

    ss._entry()
    monkeypatch.setattr(ss, "_fn", lambda *a: 1)    # cudaErrorInvalidValue
    with torch.no_grad(), pytest.raises(build.KernelError, match="ssd_scan"):
        ops.ssd_scan(*args, **kw)
    rn._entry()
    monkeypatch.setattr(rn, "_fn", lambda *a: 1)
    with pytest.raises(build.KernelError, match="rmsnorm"):
        ops.rmsnorm(x.detach(), torch.ones(64, device=cuda))
    eng = ServingEngine(get_reduced_config("mamba2-2.7b"), max_slots=2,
                        max_seq=64, device=cuda)
    eng.submit(np.arange(7), max_new_tokens=3)
    assert eng.run_until_drained() == [] and len(eng.failed) == 1
    assert "kernel launch failed" in next(iter(eng.failed.values())).error


def test_ssm_engine_launches_the_kernels(cuda):
    """Served reduced mamba2 and zamba2 go through the kernels: one SSD
    scan per Mamba2 layer per chunk, one RMSNorm per norm per chunk and
    decode step."""
    import numpy as np

    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.serving.engine import ServingEngine

    for arch, norms in (("mamba2-2.7b", 2 * 2 + 1),
                        ("zamba2-1.2b", 2 * 4 + 2 * 2 + 1)):
        cfg = get_reduced_config(arch)
        eng = ServingEngine(cfg, max_slots=2, max_seq=64, prefill_chunk=16,
                            device=cuda)
        ss.ssd_scan.launches = rn.rmsnorm.launches = 0
        for n in (40, 5, 23):
            eng.submit(np.arange(n) % 200, max_new_tokens=4)
        eng.run_until_drained()
        st = eng.stats()
        assert st["failed"] == 0 and not st["paged"]
        assert ss.ssd_scan.launches == cfg.num_layers * st["prefill_chunks"]
        assert rn.rmsnorm.launches == norms * (st["prefill_chunks"]
                                               + st["decode_steps"])


# ---------------------------------------------------------------------------
# the unikernel image: one captured CUDA graph
# ---------------------------------------------------------------------------

def _light_image(cuda, max_seq=32):
    from repro_torch.configs import get_reduced_config
    from repro_torch.core import ImageRegistry, Workload, WorkloadKind
    from repro_torch.serving import router

    cfg = get_reduced_config("edge-stream-light")
    reg = ImageRegistry()
    ex, _ = router.make_unikernel_decode_builder(
        cfg, reg, max_seq=max_seq, device=cuda)(
        Workload("d", WorkloadKind.DECODE, cfg, batch=1), None)
    return cfg, ex, Workload("d", WorkloadKind.DECODE, cfg, batch=1)


def test_image_replays_equal_eager_calls(cuda):
    """Eight replays give the tokens and caches of eight eager decode
    steps over the same params; the decode kernel was captured once per
    layer and ran at every replay."""
    from repro_torch.models.model import build_model

    cfg, ex, w = _light_image(cuda)
    img = ex.image
    assert img.captured and img.build_time_s > 0
    assert img.captured_launches.get("decode_attention") == cfg.num_layers
    params = img.static_args[0]
    model = build_model(cfg, cuda)
    caches = model.init_caches(1, 32, cfg.cdtype)
    tok = torch.tensor([3], dtype=torch.int32, device=cuda)
    clen = torch.zeros((1,), dtype=torch.int32, device=cuda)
    itok, icaches, ilen = tok, model.init_caches(1, 32, cfg.cdtype), clen
    for _ in range(8):
        with torch.no_grad():
            logits = model.decode(params, tok, caches, clen)
        tok = torch.argmax(logits, -1).to(torch.int32)
        clen = clen + 1
        itok, icaches, ilen = ex.dispatch(w, (params, itok, icaches, ilen))
        assert torch.equal(itok, tok) and torch.equal(ilen, clen)
    for a, b in zip(leaves(icaches), leaves(caches)):
        assert torch.equal(a, b)
    assert img.replays == 8


def test_image_rejects_a_mismatched_spec(cuda):
    from repro_torch.core import IncompatibleWorkload

    cfg, ex, w = _light_image(cuda)
    p, tok, caches, clen = ex.image.static_args
    with pytest.raises(IncompatibleWorkload):
        ex.dispatch(w, (p, tok.long(), caches, clen))
    with pytest.raises(IncompatibleWorkload):
        ex.dispatch(w, (p, tok.cpu(), caches, clen))
    with pytest.raises(IncompatibleWorkload):
        ex.dispatch(w, (p, torch.zeros((2,), dtype=torch.int32,
                                       device=cuda), caches, clen))
    assert ex.image.replays == 0


def test_donated_cache_is_not_copied_back_in(cuda):
    """The caches come back in the caller's own tensors, never the
    image's static buffers; handed back, only the token and the length
    are copied in."""
    cfg, ex, w = _light_image(cuda)
    img = ex.image
    p, tok, caches, clen = (torch.zeros_like(t) if i == 1 else t
                            for i, t in enumerate(img.static_args))
    from repro_torch.models.model import build_model
    fresh = build_model(cfg, cuda).init_caches(1, 32, cfg.cdtype)
    tok, caches, clen = ex.dispatch(w, (p, tok, fresh, clen))
    first = img.copied_bytes
    assert all(a is b for a, b in zip(leaves(caches), leaves(fresh)))
    assert not any(a is b for a, b in zip(leaves(caches),
                                          leaves(img.static_args[2])))
    tok, caches, clen = ex.dispatch(w, (p, tok, caches, clen))
    assert img.copied_bytes - first == 2 * 4        # int32 token + length


def test_two_decode_streams_through_one_image(cuda):
    """Two decode streams interleaved through one captured image, as two
    executors share it after a failover: each stream's tokens and caches
    equal its own eager run, bit for bit."""
    from repro_torch.models.model import build_model

    cfg, ex, w = _light_image(cuda)
    model = build_model(cfg, cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(5))

    def start(t):
        return (torch.tensor([t], dtype=torch.int32, device=cuda),
                model.init_caches(1, 32, cfg.cdtype),
                torch.zeros((1,), dtype=torch.int32, device=cuda))

    streams, eager = {"a": start(3), "b": start(9)}, {"a": start(3),
                                                      "b": start(9)}
    for name in "aababbab":
        streams[name] = ex.dispatch(w, (params,) + tuple(streams[name]))
        etok, ecaches, eclen = eager[name]
        with torch.no_grad():
            logits = model.decode(params, etok, ecaches, eclen)
        eager[name] = (torch.argmax(logits, -1).to(torch.int32), ecaches,
                       eclen + 1)
        for a, b in zip(leaves(streams[name]), leaves(eager[name])):
            assert torch.equal(a, b)
    assert not torch.equal(leaves(streams["a"][1])[0],
                           leaves(streams["b"][1])[0])
    assert ex.image.replays == 8


def test_capture_with_a_host_sync_raises(cuda):
    """A host sync inside the captured function fails the capture, and
    the build raises: it never falls back to running eagerly."""
    from repro_torch.core import ExecutableImage

    def bad(x):
        return x * float(x.sum().item())

    with pytest.raises(RuntimeError, match="capture"):
        ExecutableImage.build("bad", bad, (torch.ones(4, device=cuda),))
    torch.cuda.synchronize()
    ok = ExecutableImage.build("ok", lambda x: x * 2,
                               (torch.ones(4, device=cuda),))
    assert ok.captured and torch.equal(ok(torch.ones(4, device=cuda)),
                                       torch.full((4,), 2.0, device=cuda))



# ---------------------------------------------------------------------------
# two engine loops on one card (the fleet's replicas)
# ---------------------------------------------------------------------------

def test_two_engine_loops_on_one_card_count_launches_exactly(cuda):
    """Two engines, each with its own loop thread, serve 4 requests each at
    once on one card: flash attention runs once a layer per prefill chunk
    and paged decode once a layer per decode step, summed over both
    engines, with no count lost between the threads."""
    import numpy as np

    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.serving.engine import ServingEngine

    cfg = get_reduced_config("tinyllama-1.1b")
    engines = [ServingEngine(cfg, max_slots=4, max_seq=128, seed=i,
                             device=cuda, replica_id=f"fleet/{i}")
               for i in range(2)]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(rng.integers(8, 100)))
               for _ in range(8)]
    fa.flash_attention.launches = pda.paged_decode_attention.launches = 0
    for eng in engines:
        eng.start()
    try:
        hs = [engines[i % 2].submit(p, max_new_tokens=12)
              for i, p in enumerate(prompts)]
        done = [h.result(timeout=120) for h in hs]
    finally:
        for eng in engines:
            eng.stop(timeout=60)
    torch.cuda.synchronize()
    sts = [e.stats() for e in engines]
    assert all(len(r.generated) == 12 for r in done)
    assert all(s["failed"] == 0 for s in sts)
    assert [len(e.completed) for e in engines] == [4, 4]
    L = cfg.num_layers
    assert fa.flash_attention.launches == \
        L * sum(s["prefill_chunks"] for s in sts)
    assert pda.paged_decode_attention.launches == \
        L * sum(s["decode_steps"] for s in sts)
    assert [r.replica for e in engines
            for r in e.dispatch_stats.samples] == ["fleet/0"] * 4 + \
        ["fleet/1"] * 4
