"""The port's flash attention backward on the CPU against the JAX
package: the plain ``ref.flash_attention_bwd`` against the Pallas dq and
dk/dv kernels in interpret mode and against ``_blocked_bwd`` (through
``jax.grad`` of ``mha_blocked``), the forward's ``lse`` against the
Pallas forward's, and the autograd function ``flash_mha`` against
``jax.grad`` of ``ref.mha``.  The CUDA kernels themselves are held
against the plain version on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).

Tolerances: 2e-5 (fp32) and 3.5e-2 (bf16) relative to the largest value
for the kernels, as ``tests/test_kernels.py:15``; 2e-4 for gradients
through a loss, as ``tests/test_kernels.py:238``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.blocked_attention import mha_blocked
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.flash_attention_bwd import \
    flash_attention_bwd as pallas_bwd
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention_bwd import flash_mha

torch.set_num_threads(1)

# the cases of tests/test_kernels.py:245 (causal, MQA, window, softcap,
# ragged Tq != Tk, non-causal), then a chunk at explicit positions over
# explicit keys with an empty kv_valid_len row and three queries whose
# positions see no key, then the encoders' head dims 48 and 80
CASES = [
    # B, Tq, Tk, Hq, Hkv, D, causal, window, softcap, explicit
    (2, 32, 32, 4, 2, 16, True, 0, 0.0, False),
    (2, 32, 32, 8, 1, 16, True, 0, 0.0, False),
    (2, 32, 32, 4, 2, 16, True, 8, 0.0, False),
    (2, 32, 32, 4, 2, 16, True, 0, 12.0, False),
    (2, 24, 40, 4, 2, 16, True, 0, 0.0, False),
    (2, 32, 32, 4, 2, 16, False, 0, 0.0, False),
    (2, 16, 48, 8, 2, 32, True, 0, 0.0, True),
    # the encoders' widths, non-causal as they train: fig 3's D 48 at G 2
    # and hubert-xlarge's D 80 at G 1 (T a multiple of the Pallas blocks:
    # its interpret mode reads a ragged non-causal tail as NaN)
    (1, 32, 32, 4, 2, 48, False, 0, 0.0, False),
    (1, 32, 32, 2, 2, 80, False, 0, 0.0, False),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3.5e-2)}


def _rel(want, got):
    w, g = np.asarray(want, np.float32), np.asarray(got, np.float32)
    return np.max(np.abs(w - g)) / max(np.max(np.abs(w)), 1e-6)


def _np(t):
    return t.detach().float().numpy()


def _inputs(case, seed):
    B, Tq, Tk, Hq, Hkv, D, causal, window, softcap, explicit = case
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, np.float32) for s in
            ((B, Tq, Hq, D), (B, Tk, Hkv, D), (B, Tk, Hkv, D),
             (B, Tq, Hq, D))]
    kw = dict(causal=causal, window=window, softcap=softcap)
    pos = {}
    if explicit:       # batch row 0 sees no key, row 1's first 3 queries
        qpos = (Tk - Tq + np.arange(Tq, dtype=np.int32))[None].repeat(B, 0)
        qpos[1, :3] = -1               # see none either (causal)
        pos = dict(q_positions=qpos,
                   kv_positions=np.arange(Tk, dtype=np.int32)[None]
                   .repeat(B, 0),
                   kv_valid_len=np.array([0] + [Tk - 5] * (B - 1),
                                         np.int32))
    return arrs, kw, pos


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bwd_matches_pallas_kernels(case, dtype):
    """``ref.flash_attention_bwd`` against the Pallas dq and dk/dv kernels
    (interpret mode) on the same q, k, v, out, lse and do."""
    jdt, tdt, tol = DTYPES[dtype]
    (q, k, v, do), kw, pos = _inputs(case, seed=case[1] * 7 + case[3])
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))
    jpos = {n: jnp.asarray(x) for n, x in pos.items()}
    out, lse = pallas_flash(jq, jk, jv, return_lse=True, interpret=True,
                            block_q=16, block_k=16, **kw, **jpos)
    want = pallas_bwd(jq, jk, jv, out, lse, jdo, interpret=True,
                      block_q=16, block_k=16, **kw, **jpos)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    tout = torch.from_numpy(np.array(out, np.float32)).to(tdt)
    got = tref.flash_attention_bwd(
        tq, tk, tv, tout, torch.from_numpy(np.array(lse)), tdo, **kw,
        **{n: torch.from_numpy(x) for n, x in pos.items()})
    for name, w, g in zip(("dq", "dk", "dv"), want, got):
        assert g.dtype == tdt and tuple(g.shape) == w.shape, name
        assert np.isfinite(_np(g)).all(), name
        assert _rel(w, _np(g)) < tol, (name, _rel(w, _np(g)))
    if pos:                          # rows that see no key: no gradient
        assert not _np(got[0])[0].any() and not _np(got[0])[1, :3].any()
        assert _np(got[0])[1, 3:].any()


@pytest.mark.parametrize("case", CASES)
def test_forward_lse_matches_pallas(case):
    """The forward's ``lse`` (what ``flash_mha`` saves on the CPU) against
    the Pallas forward's: ``m + log l``, NEG_INF for an empty row."""
    (q, k, v, _), kw, pos = _inputs(case, seed=case[2])
    want_out, want_lse = pallas_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), return_lse=True,
        interpret=True, block_q=16, block_k=16, **kw,
        **{n: jnp.asarray(x) for n, x in pos.items()})
    out, lse = tref.mha(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), return_lse=True, **kw,
                        **{n: torch.from_numpy(x) for n, x in pos.items()})
    assert lse.dtype == torch.float32 and tuple(lse.shape) == want_lse.shape
    assert _rel(want_lse, lse.numpy()) < 2e-5
    assert _rel(want_out, out.numpy()) < 2e-5
    if pos:
        assert (lse[0].numpy() == np.float32(tref.NEG_INF)).all()
        assert (lse[1, :3].numpy() == np.float32(tref.NEG_INF)).all()


def _loss_grads_torch(fn, q, k, v, pos):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    loss = torch.cos(fn(*leaves, **{n: torch.from_numpy(x)
                                    for n, x in pos.items()})).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


@pytest.mark.parametrize("case", CASES)
def test_flash_mha_grads_match_jax(case):
    """Gradients of ``sum(cos(flash_mha(q, k, v)))`` on the CPU (the plain
    forward and backward behind the autograd function) against
    ``jax.grad`` of the same through ``ref.mha`` and through the blocked
    flash-semantics path (``_blocked_bwd``)."""
    (q, k, v, _), kw, pos = _inputs(case, seed=case[1] + case[4])
    jpos = {n: jnp.asarray(x) for n, x in pos.items()}

    def jloss(attn):
        return lambda q, k, v: jnp.sum(jnp.cos(attn(q, k, v, **kw, **jpos)))

    got = _loss_grads_torch(lambda *a, **p: flash_mha(*a, **kw, **p),
                            q, k, v, pos)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_ref = jax.grad(jloss(jref.mha), argnums=(0, 1, 2))(*args)
    want_blk = jax.grad(jloss(lambda *a, **p: mha_blocked(
        *a, block_k=32, **p)), argnums=(0, 1, 2))(*args)
    for wr, wb, g in zip(want_ref, want_blk, got):
        assert _rel(wr, g) < 2e-4
        assert _rel(wb, g) < 2e-4


def test_flash_mha_saves_only_under_grad():
    """Under ``torch.no_grad()`` (serving) the function computes the plain
    forward alone and returns a tensor with no graph; with grad it
    returns one whose backward is the plain backward."""
    (q, k, v, _), kw, _ = _inputs(CASES[0], seed=0)
    tq = torch.from_numpy(q).requires_grad_()
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    with torch.no_grad():
        out = flash_mha(tq, tk, tv, **kw)
    assert out.grad_fn is None
    out = flash_mha(tq, tk, tv, **kw)
    assert out.grad_fn is not None
    np.testing.assert_array_equal(
        out.detach().numpy(), tref.mha(tq.detach(), tk, tv, **kw).numpy())


def test_forward_only_kernels_refuse_grad():
    """The CUDA wrappers of the three decode-style kernels refuse an input
    that needs a gradient under grad mode (they would cut the graph), and
    say so before anything else; no tensor that needs a gradient reaches
    them on the served paths."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention
    from repro_torch.kernels.paged_verify_attention import \
        paged_verify_attention

    q = torch.zeros(2, 4, 32, requires_grad=True)
    kp = torch.zeros(3, 16, 2, 32)
    table = torch.ones(2, 2, dtype=torch.int32)
    clen = torch.full((2,), 5, dtype=torch.int32)
    for call in (lambda: paged_decode_attention(q, kp, kp, table, clen),
                 lambda: paged_verify_attention(q[:, None], kp, kp, table,
                                                clen),
                 lambda: decode_attention(q, kp[:2], kp[:2], clen)):
        with pytest.raises(ValueError, match="forward-only"):
            call()
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
            call()
