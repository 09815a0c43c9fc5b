"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase catches and
continues:

1. device and build: the card's name and power limit, the CUDA kernels
   built with nvcc from ``src/repro_torch/csrc`` (one process per source,
   all at once), TF32 off for matmuls and cuDNN;
2. kernels: each kernel against its plain PyTorch version on the card at
   the serving path's shapes (bf16 and fp32, window and softcap variants,
   int8 pools for the paged kernels, K1 of 1, 2 and 5 for the verify
   kernel, which at K1 = 1 is also held against the paged decode kernel)
   and the backward kernels at the train step's (causal, non-causal,
   window, softcap, an empty row, G 1 and 8, Tq < Tk, D 32/64/128),
   with CUDA-event times for the kernel, its plain version and a library
   yardstick (``F.scaled_dot_product_attention`` with an explicit mask
   over the same dense or gathered KV, and its backward for the backward
   kernels; timed here only, never called by the port), and the bound:
   bytes over 3.35 TB/s or operations over the peak rate;
3. serve: full-width tinyllama-1.1b (22 layers, bf16 compute, random
   weights from a seed) in ``ServingEngine``, 8 requests plus a 256-token
   shared-prefix pair, through the background loop; every request must
   complete, and each kernel's launch count must equal 22 x the chunks or
   decode steps the engine ran;
3b. speculative serve: the same model over int8 pages with a draft made of
   its first 2 layers, residual write-backs zeroed so that every draft
   token is accepted; 8 requests of 32 tokens; acceptance >= 0.95, the
   verify kernel launched 22 x the verify rounds, the dense decode kernel
   by every draft step, the streams equal to the same traffic served
   without the draft, whose decode tokens/s is printed beside;
4. consistency: fp32 at full width, 2 layers: every decode step's logits
   against ``Model.forward`` over the same prefix, within 2e-4 relative;
4b. speculative exactness: fp32 at full width, 2 random layers, the first
   as the draft: speculative streams equal plain ones with pages in fp32
   and in int8 (a token may differ only at a top-2 margin <= 1e-3);
5. golden: the JAX reference's token streams (``tests/data``), plain and
   speculative, reproduced by the port on the card in fp32;
6. train: ``Trainer`` at full tinyllama-1.1b width (fp32 parameters and
   AdamW moments, bf16 compute) on the bigram stream at B 8 x T 1024, 6
   steps: every loss and grad norm finite, the parameters still after
   step 1 (lr 0) and moved after step 2, the forward flash, dq and dk/dv
   kernels each launched 22 x 6 times; median step time, tokens/s, peak
   memory and a profiled step's device busy share and top kernels; an
   async checkpoint restored into a fresh ``Trainer`` gives the same next
   loss;
7. train consistency: fp32 at full width, 2 layers, every gradient leaf of
   ``Model.loss`` through the kernels against the plain path within 2e-4
   relative; a reduced fp32 model trained 30 steps through the kernels
   lowers its loss by more than 0.3;
8. golden train: the JAX trainer's 5 fp32 steps from the fixture,
   replayed through the kernels from its step-0 state: losses and grad
   norms within 1e-4 relative, final parameters within 1e-4;
9. the kernels line (each kernel's launches from the path that runs it:
   per request for serving, per step for training), then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12              # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12,      # dense tensor-core bf16
              "float32": 67e12}        # f32 outside the tensor cores
TOL = {"float32": 2e-5, "bfloat16": 3.5e-2}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

class Timer:
    """Device time of one call from CUDA events, averaged over ``iters``
    calls.  A GPU-side sleep queued first lets the host enqueue every
    call before the device reaches them, so the events bracket device
    work only (no Python or launch latency); the L2 cache is flushed
    before each call (the serving path meets its KV cold)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 20) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        torch.cuda._sleep(200_000_000)          # ~0.1 s of GPU cycles
        for s, e in zip(starts, ends):
            self.flush.zero_()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def rel_err(want, got) -> float:
    w, g = want.float(), got.float()
    return float((w - g).abs().max() / w.abs().max().clamp_min(1e-6))


# ---------------------------------------------------------------------------
# phase 1: device and build
# ---------------------------------------------------------------------------

def phase_device_and_build(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build

    t0 = time.monotonic()
    logs = build.build_all()
    secs = time.monotonic() - t0
    print(f"[build] {sorted(logs)} for sm_90a in {secs:.1f}s "
          f"(into {os.path.relpath(build.BUILD_DIR, ROOT)})")
    for name, log in sorted(logs.items()):
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill", log))
        print(f"[build] {name}: {len(regs)} instantiations, registers "
              f"<= {max(regs, default=0)}, spill bytes {spills}")
    return card


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _flash_case(torch, gen, dtype, Tq, Tk, start, valid, window=0,
                softcap=0.0, explicit_kv_pos=False):
    """A prefill chunk of tinyllama (Hq 32, Hkv 4, D 64) over a gathered
    KV span: queries at start..start+Tq-1, keys valid below ``valid``."""
    dt = getattr(torch, dtype)
    B, Hq, Hkv, D = 1, 32, 4, 64
    q = torch.randn(B, Tq, Hq, D, generator=gen, device="cuda").to(dt)
    k = torch.randn(B, Tk, Hkv, D, generator=gen, device="cuda").to(dt)
    v = torch.randn(B, Tk, Hkv, D, generator=gen, device="cuda").to(dt)
    qpos = (start + torch.arange(Tq, device="cuda", dtype=torch.int32))[None]
    kw = dict(causal=True, window=window, softcap=softcap, q_positions=qpos,
              kv_valid_len=torch.tensor([valid], device="cuda",
                                        dtype=torch.int32))
    if explicit_kv_pos:
        kw["kv_positions"] = torch.arange(Tk, device="cuda",
                                          dtype=torch.int32)[None]
    # what the data needs: the (query, key) pairs the masks keep, and
    # the keys up to the last one any query sees
    qp = np.arange(start, start + Tq)[:, None]
    kp = np.arange(Tk)[None, :]
    keep = (kp <= qp) & (kp < valid)
    if window:
        keep &= qp - kp < window
    pairs = int(keep.sum()) * Hq
    keys = int(keep.any(axis=0).nonzero()[0].max() + 1) if keep.any() else 0
    e = q.element_size()
    nbytes = (2 * B * Tq * Hq * D + 2 * B * keys * Hkv * D) * e + 4 * Tq
    flops = 4 * D * pairs
    return (q, k, v), kw, nbytes, flops


def _sdpa_flash(torch, F, q, k, v, kw):
    """Library yardstick: SDPA over the same dense KV (expanded to the
    query heads beforehand, untimed), explicit mask."""
    Tq, Tk = q.shape[1], k.shape[1]
    qp = kw["q_positions"][0][:, None].long()
    kp = torch.arange(Tk, device="cuda")[None, :]
    mask = (kp <= qp) & (kp < kw["kv_valid_len"][0])
    if kw["window"]:
        mask &= qp - kp < kw["window"]
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt, vt = (x.transpose(1, 2).repeat_interleave(G, dim=1) for x in (k, v))
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[None, None])


def _paged_case(torch, gen, dtype, int8=False, window=0, softcap=0.0,
                K1=0):
    """A decode tick of the serving path: B 8, Hq 32, Hkv 4, D 64, page
    16, 64 table entries (max_seq 1024), pages scattered over the pool,
    lengths 36-543.  ``K1 > 0`` makes it a verify pass: K1 query tokens
    per sequence, the last K1 of its length."""
    from repro_torch.models.attention import _quantize

    dt = getattr(torch, dtype)
    B, Hq, Hkv, D, page, MP = 8, 32, 4, 64, 16, 64
    P = B * MP + 1
    qshape = (B, K1, Hq, D) if K1 else (B, Hq, D)
    q = torch.randn(*qshape, generator=gen, device="cuda").to(dt)
    kf = torch.randn(P, page, Hkv, D, generator=gen, device="cuda")
    vf = torch.randn(P, page, Hkv, D, generator=gen, device="cuda")
    perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    table = perm[:B * MP].reshape(B, MP).to(torch.int32)
    clen = torch.randint(36, 544, (B,), generator=gen, device="cuda",
                         dtype=torch.int32)
    kw = dict(window=window, softcap=softcap)
    if int8:
        kp, ks = _quantize(kf)
        vp, vs = _quantize(vf)
        kw.update(k_scale=ks, v_scale=vs)
        e = 1
    else:
        kp, vp = kf.to(dt), vf.to(dt)
        e = q.element_size()
    # what the data needs: the keys some query sees (read once) and the
    # (query, key) pairs the masks keep
    n = clen.long().cpu().numpy()
    rows = [n] if not K1 else [n - K1 + i + 1 for i in range(K1)]
    seen = [np.minimum(r, window) if window else r for r in rows]
    toks = int(np.minimum(n, window + max(K1, 1) - 1).sum() if window
               else n.sum())
    pairs = int(sum(s.sum() for s in seen)) * Hq
    nbytes = (2 * q.numel() * q.element_size() + 2 * toks * Hkv * D * e
              + (2 * toks * Hkv * 4 if int8 else 0)
              + 4 * (B * MP + B))
    flops = 4 * D * pairs
    return (q, kp, vp, table, clen), kw, nbytes, flops


def _sdpa_paged(torch, F, args, kw):
    """Library yardstick: SDPA over the KV gathered dense and expanded to
    the query heads beforehand (untimed), explicit mask: length (decode)
    or causal from ``cache_len - K1`` (verify), and the window."""
    from repro_torch.kernels.ref import dequantize_pages, gather_pages

    q, kp, vp, table, clen = args
    k, v = gather_pages(kp, table), gather_pages(vp, table)
    if kw.get("k_scale") is not None:
        k = dequantize_pages(k, gather_pages(kw["k_scale"], table)).to(q.dtype)
        v = dequantize_pages(v, gather_pages(kw["v_scale"], table)).to(q.dtype)
    K1 = q.shape[1] if q.dim() == 4 else 1
    pos = torch.arange(k.shape[1], device="cuda")[None, None]
    qpos = (clen[:, None] - K1 + torch.arange(K1, device="cuda")[None])
    mask = pos <= qpos[:, :, None]                 # [B, K1, S]
    if kw["window"]:
        mask &= pos > qpos[:, :, None] - kw["window"]
    G = q.shape[-2] // k.shape[2]
    qt = q.transpose(1, 2) if q.dim() == 4 else q[:, :, None]  # [B,Hq,K1,D]
    kt, vt = (x.transpose(1, 2).repeat_interleave(G, dim=1)
              for x in (k, v))                      # [B, Hq, S, D]
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[:, None])


def _dense_case(torch, gen, dtype, S, D=64, window=0, softcap=0.0,
                full=False):
    """A draft decode step of the serving path: B 8, Hq 32, Hkv 4 over a
    dense [B, S, Hkv, D] cache, valid lengths 36-543 (one row at S with
    ``full``)."""
    dt = getattr(torch, dtype)
    B, Hq, Hkv = 8, 32, 4
    q = torch.randn(B, Hq, D, generator=gen, device="cuda").to(dt)
    k = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dt)
    v = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dt)
    clen = torch.randint(36, 544, (B,), generator=gen, device="cuda",
                         dtype=torch.int32)
    if full:
        clen[0] = S
    kw = dict(window=window, softcap=softcap)
    n = np.minimum(clen.long().cpu().numpy(), S)
    toks = int(np.minimum(n, window).sum() if window else n.sum())
    e = q.element_size()
    nbytes = 2 * q.numel() * e + 2 * toks * Hkv * D * e + 4 * B
    flops = 4 * D * toks * Hq
    return (q, k, v, clen), kw, nbytes, flops


def _sdpa_dense(torch, F, args, kw):
    """Library yardstick: SDPA over the dense cache expanded to the query
    heads beforehand (untimed), explicit length and window mask."""
    q, k, v, clen = args
    pos = torch.arange(k.shape[1], device="cuda")[None]
    mask = pos < clen[:, None]
    if kw["window"]:
        mask &= pos >= clen[:, None] - kw["window"]
    G = q.shape[1] // k.shape[2]
    kt, vt = (x.transpose(1, 2).repeat_interleave(G, dim=1) for x in (k, v))
    return lambda: F.scaled_dot_product_attention(
        q[:, :, None], kt, vt, attn_mask=mask[:, None, None])


def _bwd_case(torch, gen, dtype, dims, causal=True, window=0, softcap=0.0,
              valid=False, index_kv=False):
    """Inputs of the backward kernels as the train step gives them:
    q/k/v/do random, ``out`` and ``lse`` from the forward kernel, the
    query positions the last Tq of Tk, the key positions explicit (the
    train-mode forward passes them; ``index_kv`` leaves them None), with
    ``valid`` batch row 0 sees no key and the others the first 3/4."""
    from repro_torch.kernels.flash_attention import flash_attention

    dt = getattr(torch, dtype)
    B, Tq, Tk, Hq, Hkv, D = dims
    q = torch.randn(B, Tq, Hq, D, generator=gen, device="cuda").to(dt)
    k = torch.randn(B, Tk, Hkv, D, generator=gen, device="cuda").to(dt)
    v = torch.randn(B, Tk, Hkv, D, generator=gen, device="cuda").to(dt)
    do = torch.randn(B, Tq, Hq, D, generator=gen, device="cuda").to(dt)
    qp = np.arange(Tk - Tq, Tk)
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_positions=torch.tensor(qp, device="cuda",
                                       dtype=torch.int32)[None].expand(B, Tq))
    if not index_kv:
        kw["kv_positions"] = torch.arange(
            Tk, device="cuda", dtype=torch.int32)[None].expand(B, Tk)
    vl = np.array([0] + [3 * Tk // 4] * (B - 1)) if valid else np.full(B, Tk)
    if valid:
        kw["kv_valid_len"] = torch.tensor(vl, device="cuda",
                                          dtype=torch.int32)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    dsum = (do.float() * out.float()).sum(-1)
    # what the data needs: the (query, key) pairs the masks keep
    kp = np.arange(Tk)[None, :]
    keep = np.ones((Tq, Tk), bool)
    if causal:
        keep &= kp <= qp[:, None]
    if window:
        keep &= qp[:, None] - kp < window
    pairs = sum(int((keep & (kp < n)).sum()) for n in vl) * Hq
    e = q.element_size()
    qbytes, kbytes = B * Tq * Hq * D * e, B * Tk * Hkv * D * e
    common = 2 * qbytes + 2 * kbytes + 8 * B * Tq * Hq + 4 * B * (Tq + Tk)
    nbytes = {"dq": common + qbytes, "dkv": common + 2 * kbytes}
    flops = {"dq": 3 * 2 * D * pairs, "dkv": 4 * 2 * D * pairs}
    return (q, k, v, lse, do, dsum), kw, out, nbytes, flops


def _sdpa_bwd(torch, F, q, k, v, do):
    """Library yardstick: the backward of one causal
    ``F.scaled_dot_product_attention`` over the same q, k and v, the KV
    heads expanded to the query heads beforehand (untimed), by
    ``torch.autograd.grad``.  It computes dq, dk and dv in one call."""
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (x.transpose(1, 2).repeat_interleave(G, dim=1).detach()
              .requires_grad_() for x in (k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)


def phase_kernels(torch, timer, card):
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention
    from repro_torch.kernels.paged_verify_attention import \
        paged_verify_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    # the worst error of each kernel over all its checks, per dtype
    worst = {}

    def run(name, label, dtype, kernel, plain, args, kw, nbytes, flops,
            library, timed):
        """Check ``kernel`` against ``plain`` (each returns a tensor or a
        tuple of them, each held to the tolerance relative to its own
        largest value) and, if ``timed``, time both and the library."""
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        check(all(bool(torch.isfinite(x).all()) for x in got),
              f"{name} {label}: non-finite")
        err = max(rel_err(w, x) for w, x in zip(want, got))
        abs_err = max(float((w.float() - x.float()).abs().max())
                      for w, x in zip(want, got))
        print(f"[kernel] {name} {label} {dtype}: max_abs_err={abs_err:.3e} "
              f"rel_err={err:.3e} tol={TOL[dtype]:.1e}")
        check(err < TOL[dtype], f"{name} {label}: {err} >= {TOL[dtype]}")
        w = worst.setdefault(name, {}).setdefault(dtype, dict(
            max_abs_err=0.0, rel_err=0.0, tolerance=TOL[dtype], checks=0))
        w["max_abs_err"] = max(w["max_abs_err"], abs_err)
        w["rel_err"] = max(w["rel_err"], err)
        w["checks"] += 1
        if not timed:
            return
        ms = timer.ms(lambda: kernel(*args, **kw))
        plain_ms = timer.ms(lambda: plain(*args, **kw))
        lib_ms = timer.ms(library)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        bound = max(t_bytes, t_ops)
        print(f"[kernel] {name} {label} {dtype}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
              f"{bound:.5f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}"
              f": {nbytes} B, {flops} FLOP) on {card}")
        results[name] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            shape=label, dtype=dtype)

    flash_cases = [
        # label, Tq, Tk, start, valid, extra, timed
        ("Tq64/Tk512 chunk@448", 64, 512, 448, 512, {}, True),
        ("Tq64/Tk1024 chunk@960", 64, 1024, 960, 1024, {}, False),
        ("Tq16/Tk512 tail@400", 16, 512, 400, 416, {}, False),
        ("Tq64/Tk64 forward", 64, 64, 0, 64, {"explicit_kv_pos": True},
         False),
        ("Tq64/Tk512 window128", 64, 512, 448, 512, {"window": 128}, False),
        ("Tq64/Tk512 softcap30", 64, 512, 448, 512, {"softcap": 30.0},
         False),
        ("Tq16/Tk64 warmup(valid=0)", 16, 64, 0, 0, {}, False),
    ]
    for dtype in ("bfloat16", "float32"):
        for label, Tq, Tk, start, valid, extra, timed in flash_cases:
            args, kw, nb, fl = _flash_case(torch, gen, dtype, Tq, Tk, start,
                                           valid, **extra)
            run("flash_attention", label, dtype, flash_attention, ref.mha,
                args, kw, nb, fl, _sdpa_flash(torch, F, *args, kw),
                timed and dtype == "bfloat16")
            if valid == 0:
                out = flash_attention(*args, **kw)
                check(bool((out == 0).all()),
                      "flash_attention: a fully masked chunk must give 0")

    paged_cases = [
        ("B8/MP64 decode", {}, True),
        ("B8/MP64 window256", {"window": 256}, False),
        ("B8/MP64 softcap30", {"softcap": 30.0}, False),
        ("B8/MP64 int8", {"int8": True}, False),
        ("B8/MP64 int8+softcap30", {"int8": True, "softcap": 30.0}, False),
    ]
    for dtype in ("bfloat16", "float32"):
        for label, extra, timed in paged_cases:
            args, kw, nb, fl = _paged_case(torch, gen, dtype, **extra)
            run("paged_decode_attention", label, dtype,
                paged_decode_attention, ref.paged_decode_attention, args,
                kw, nb, fl, _sdpa_paged(torch, F, args, kw),
                timed and dtype == "bfloat16")

    # the target's verify pass; K1 = 5 is spec_k_max 4, the serving shape
    verify_cases = [("B8/MP64 K1=5 verify", {"K1": 5}, True)] + [
        (f"B8/MP64 K1={k1} {name}", dict(extra, K1=k1), False)
        for k1 in (1, 2, 5)
        for name, extra in (("window256", {"window": 256}),
                            ("softcap30", {"softcap": 30.0}),
                            ("int8", {"int8": True}),
                            ("int8+softcap30",
                             {"int8": True, "softcap": 30.0}))]
    for dtype in ("bfloat16", "float32"):
        for label, extra, timed in verify_cases:
            args, kw, nb, fl = _paged_case(torch, gen, dtype, **extra)
            run("paged_verify_attention", label, dtype,
                paged_verify_attention, ref.paged_verify_attention, args,
                kw, nb, fl, _sdpa_paged(torch, F, args, kw),
                timed and dtype == "bfloat16")
            if extra["K1"] == 1:        # one verify token is one decode step
                q, *rest = args
                got = paged_verify_attention(*args, **kw)[:, 0]
                dec = paged_decode_attention(q[:, 0], *rest, **kw)
                torch.cuda.synchronize()
                err = rel_err(dec, got)
                print(f"[kernel] paged_verify_attention {label} {dtype}: "
                      f"vs the paged decode kernel rel_err={err:.3e}")
                check(err < TOL[dtype], f"verify K1=1 vs paged decode {err}")

    # the draft's dense decode steps: S 1024 is max_seq; 1000 is not a
    # multiple of the 32-key tile
    dense_cases = [
        ("B8/S1024 decode", 1024, {}, True),
        ("B8/S1024 window256", 1024, {"window": 256}, False),
        ("B8/S1024 softcap30", 1024, {"softcap": 30.0}, False),
        ("B8/S1000 full row", 1000, {"full": True}, False),
        ("B8/S1000 D32 window100+softcap30", 1000,
         {"D": 32, "window": 100, "softcap": 30.0, "full": True}, False),
        ("B8/S1024 D32", 1024, {"D": 32}, False),
    ]
    for dtype in ("bfloat16", "float32"):
        for label, S, extra, timed in dense_cases:
            args, kw, nb, fl = _dense_case(torch, gen, dtype, S, **extra)
            run("decode_attention", label, dtype, decode_attention,
                ref.decode_attention, args, kw, nb, fl,
                _sdpa_dense(torch, F, args, kw),
                timed and dtype == "bfloat16")
    # the training path's backward kernels: timed at the train step's
    # shape, checked in every variant the path and the JAX tests take
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq)

    bwd_cases = [
        # label, (B, Tq, Tk, Hq, Hkv, D), extra, timed
        ("B8/T1024 train", (8, 1024, 1024, 32, 4, 64), {}, True),
        ("B2/T256 causal", (2, 256, 256, 32, 4, 64), {}, False),
        ("B2/T256 non-causal", (2, 256, 256, 32, 4, 64),
         {"causal": False}, False),
        ("B2/T256 window128", (2, 256, 256, 32, 4, 64), {"window": 128},
         False),
        ("B2/T256 softcap30", (2, 256, 256, 32, 4, 64), {"softcap": 30.0},
         False),
        ("B2/T256 valid(row 0 empty)", (2, 256, 256, 32, 4, 64),
         {"valid": True}, False),
        ("B2/T256 G1", (2, 256, 256, 4, 4, 64), {}, False),
        ("B2/T256 G8 MQA", (2, 256, 256, 8, 1, 64), {}, False),
        ("B2/Tq96/Tk256 chunk", (2, 96, 256, 32, 4, 64), {}, False),
        ("B2/T200 D32", (2, 200, 200, 16, 4, 32), {}, False),
        ("B2/T200 D128 softcap30", (2, 200, 200, 16, 2, 128),
         {"softcap": 30.0}, False),
        ("B2/T256 index positions", (2, 256, 256, 32, 4, 64),
         {"index_kv": True, "valid": True}, False),
    ]
    for dtype in ("bfloat16", "float32"):
        for label, dims, extra, timed in bwd_cases:
            if timed and dtype == "float32":
                continue               # the train step's backward is bf16
            args, kw, out, nb, fl = _bwd_case(torch, gen, dtype, dims,
                                              **extra)
            library = _sdpa_bwd(torch, F, *args[:3], args[4]) \
                if timed else None

            def plain_dq(q, k, v, lse, do, dsum, out=out, **kw):
                return ref.flash_attention_bwd(q, k, v, out, lse, do, **kw)[0]

            def plain_dkv(q, k, v, lse, do, dsum, out=out, **kw):
                return ref.flash_attention_bwd(q, k, v, out, lse, do,
                                               **kw)[1:]

            run("flash_attention_bwd_dq", label, dtype,
                flash_attention_bwd_dq, plain_dq, args, kw, nb["dq"],
                fl["dq"], library, timed)
            run("flash_attention_bwd_dkv", label, dtype,
                flash_attention_bwd_dkv, plain_dkv, args, kw, nb["dkv"],
                fl["dkv"], library, timed)
            dq = flash_attention_bwd_dq(*args, **kw)
            dk, dv = flash_attention_bwd_dkv(*args, **kw)
            check(all(float(x.abs().max()) > 0 for x in (dq, dk, dv)),
                  f"flash_attention_bwd {label}: a gradient is all zero")
            if extra.get("valid"):     # batch row 0 sees no key
                check(all(bool((x[0] == 0).all()) for x in (dq, dk, dv)),
                      f"flash_attention_bwd {label}: an empty row must "
                      f"give zero gradients")
            del args, out

    for name, res in results.items():
        by_dtype = worst[name]
        res["max_abs_err"] = max(w["max_abs_err"] for w in by_dtype.values())
        res["rel_err"] = max(w["rel_err"] for w in by_dtype.values())
        res["err_by_dtype"] = by_dtype
    return results


# ---------------------------------------------------------------------------
# phase 3: serve full-width tinyllama
# ---------------------------------------------------------------------------

def phase_serve(torch):
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("tinyllama-1.1b")
    check(cfg.num_layers == 22 and cfg.d_model == 2048, "config")
    t0 = time.monotonic()
    eng = ServingEngine(cfg, max_slots=8, max_seq=1024, page_size=16,
                        prefill_chunk=64, seed=0, device="cuda")
    eng.warmup()
    print(f"[serve] tinyllama-1.1b 22L d2048 bf16 on cuda: init "
          f"{time.monotonic() - t0 - eng.warmup_s:.1f}s, warmup "
          f"{eng.warmup_s:.2f}s")
    rng = np.random.default_rng(0)
    lens = [int(rng.integers(4, 512)) for _ in range(8)]
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lens]
    shared = rng.integers(0, cfg.vocab_size, size=256)
    first_turn = np.concatenate([shared,
                                 rng.integers(0, cfg.vocab_size, size=10)])

    fa.flash_attention.launches = 0
    pda.paged_decode_attention.launches = 0
    t0 = time.monotonic()
    with eng:
        handles = [eng.submit(p, max_new_tokens=32) for p in prompts]
        h1 = eng.submit(first_turn, max_new_tokens=32)
        r1 = h1.result(timeout=600)
        # the follow-up turn extends the first one past a page boundary:
        # its admission attaches the shared pages and copy-seeds the tail
        follow = np.concatenate([first_turn, np.asarray(r1.generated),
                                 rng.integers(0, cfg.vocab_size, size=8)])
        h2 = eng.submit(follow, max_new_tokens=32)
        done = [h.result(timeout=600) for h in handles + [h2]] + [r1]
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"flash_attention": fa.flash_attention.launches,
                "paged_decode_attention":
                    pda.paged_decode_attention.launches}
    st = eng.stats()
    check(not eng.failed and st["failed"] == 0,
          f"failed requests: {[r.error for r in eng.failed.values()]}")
    check(len(done) == 10 and all(len(r.generated) == 32 for r in done),
          "every request must complete with 32 tokens")
    check(st["kv_prefix_hits"] >= 1 and st["cow_copies"] >= 1,
          f"the shared-prefix pair must hit the radix and COW: {st}")
    L = cfg.num_layers
    check(launches["flash_attention"] == L * st["prefill_chunks"],
          f"flash launches {launches['flash_attention']} != {L} x "
          f"{st['prefill_chunks']} chunks")
    check(launches["paged_decode_attention"] == L * st["decode_steps"],
          f"paged launches {launches['paged_decode_attention']} != {L} x "
          f"{st['decode_steps']} decode steps")
    check(min(launches.values()) > 0, "a kernel never ran on the main path")
    toks = sum(len(r.generated) for r in done)
    print(f"[serve] {len(done)} requests, {toks} tokens in {wall:.2f}s "
          f"({toks / wall:.1f} tok/s); prompts {lens} + shared pair "
          f"{len(first_turn)}/{len(follow)}")
    print(f"[serve] ttft p50 {st['p50_ttft_s'] * 1e3:.1f} ms p95 "
          f"{st['p95_ttft_s'] * 1e3:.1f} ms; decode tick p50 "
          f"{st['p50_decode_tick_s'] * 1e3:.2f} ms p95 "
          f"{st['p95_decode_tick_s'] * 1e3:.2f} ms; prefill tick p50 "
          f"{st['p50_prefill_tick_s'] * 1e3:.2f} ms")
    print(f"[serve] {st['prefill_chunks']} chunks, {st['decode_steps']} "
          f"decode steps, launches {launches}, radix hits "
          f"{st['kv_prefix_hits']}, cow copies {st['cow_copies']}, "
          f"preemptions {st['preemptions']}")
    profile_decode(torch, eng, rng)
    del eng
    torch.cuda.empty_cache()
    return launches, len(done)


def profile_decode(torch, eng, rng, steps: int = 10, label: str = "decode",
                   per_tick: int = 1):
    """Where a steady decode tick's time goes: 8 rows decoding, ``steps``
    ticks to settle (a speculative depth grows with its acceptance), the
    host wall of ``steps`` ticks without the profiler, then the device
    time of the same number of ticks by kernel from ``torch.profiler``.
    A tick commits up to ``per_tick`` tokens per row (k+1 when
    speculative)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(8):
        eng.submit(rng.integers(0, eng.cfg.vocab_size, size=64),
                   max_new_tokens=(4 + 3 * steps + 4) * per_tick)
    while eng.queue or any(r.phase != "decode" for r in eng.active.values()):
        eng.step()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3 / steps
    toks = sum(t[4] for t in list(eng._tick_log)[-steps:]) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    by_kernel = {}
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue                    # operator rows repeat their kernels
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            by_kernel[ev.key] = us / 1e3 / steps
    eng.run_until_drained()
    busy = sum(by_kernel.values())
    print(f"[profile] {label} tick, 8 rows: host wall {wall_ms:.2f} ms for "
          f"{toks:.1f} tokens ({wall_ms / toks:.2f} ms/token), device busy "
          f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}% of the wall; "
          f"{'measured' if by_kernel else 'no device time seen'})")
    for name, ms in sorted(by_kernel.items(), key=lambda x: -x[1])[:8]:
        print(f"[profile]   {ms:.4f} ms/tick  {name[:90]}")


# ---------------------------------------------------------------------------
# phase 3b: speculative serving over int8 pages, full-width tinyllama
# ---------------------------------------------------------------------------

def _zero_residual(tree):
    """Residual write-backs (attention ``w_o``, MLP ``w_down``) zeroed, as
    in ``benchmarks/bench_paged_serving.py:299``: the residual stream is
    the embedding alone, so any two models sharing embedding, final norm
    and head give the same logits, and every draft token is accepted."""
    if isinstance(tree, dict):
        return {k: (v.zero_() if k in ("w_o", "w_down") else
                    _zero_residual(v)) for k, v in tree.items()}
    return tree


def _truncated(params, n_layers: int):
    """A draft of the target's first ``n_layers`` layers: the target's
    embedding, head and final norm (views; the target is unchanged)."""
    def first(tree):
        if isinstance(tree, dict):
            return {k: first(v) for k, v in tree.items()}
        return tree[:n_layers]

    return {**params, "stack": {"blocks": first(params["stack"]["blocks"]),
                                "final_norm": params["stack"]["final_norm"]}}


def _decode_rate(eng):
    """Decode tokens/s over the tick log's decode ticks only, as the JAX
    canary counts them.  The prefill ticks are left out, and they are not
    the same work with and without speculation: each finished prompt also
    runs the draft's whole-prompt prefill there, so the end-to-end rate
    is printed beside this one."""
    log = list(eng._tick_log)
    secs = sum(d for _p, d, _t, n, _tk in log if n)
    toks = sum(tk for _p, _d, _t, n, tk in log if n)
    return toks / secs if secs else float("nan"), toks, secs


def phase_spec_serve(torch):
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_verify_attention as pva
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("tinyllama-1.1b")
    dcfg = dataclasses.replace(cfg, num_layers=2)
    params = _zero_residual(Model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0)))
    dparams = _truncated(params, 2)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n))
               for n in rng.integers(4, 512, size=8)]
    kw = dict(max_slots=8, max_seq=1024, page_size=16, prefill_chunk=64,
              params=params, kv_dtype="int8", device="cuda")

    counters = ((fa, "flash_attention"), (pda, "paged_decode_attention"),
                (pva, "paged_verify_attention"), (da, "decode_attention"))

    def serve(eng):
        eng.warmup()
        eng._tick_log.clear()
        for mod, fn in counters:          # count the traffic's launches only
            getattr(mod, fn).launches = 0
        t0 = time.monotonic()
        for p in prompts:
            eng.submit(p, max_new_tokens=32)
        done = sorted(eng.run_until_drained(), key=lambda r: r.rid)
        torch.cuda.synchronize()
        check(not eng.failed and len(done) == len(prompts)
              and all(len(r.generated) == 32 for r in done),
              "every request must complete with 32 tokens")
        return [r.generated for r in done], time.monotonic() - t0

    t0 = time.monotonic()
    spec = ServingEngine(cfg, draft_cfg=dcfg, draft_params=dparams,
                         spec_k_max=4, **kw)
    print(f"[spec] tinyllama-1.1b 22L d2048 bf16, int8 pages, draft = its "
          f"first 2 layers, zero-residual weights: init "
          f"{time.monotonic() - t0:.1f}s")
    got, wall = serve(spec)
    launches = {fn: getattr(mod, fn).launches for mod, fn in counters}
    st = spec.stats()
    spec_rate, spec_toks, spec_s = _decode_rate(spec)
    L = cfg.num_layers
    check(st["acceptance_rate"] >= 0.95,
          f"acceptance {st['acceptance_rate']} < 0.95")
    check("spec_disabled_reason" not in st and st["speculative"],
          f"speculation turned itself off: {st.get('spec_disabled_reason')}")
    check(st["draft_ticks"] > 0 and st["spec_rounds"] > 0,
          f"no speculative tick ran: {st}")
    check(launches["paged_verify_attention"] == L * st["spec_rounds"],
          f"verify launches {launches['paged_verify_attention']} != {L} x "
          f"{st['spec_rounds']} rounds")
    check(launches["decode_attention"] > 0
          and launches["decode_attention"] % dcfg.num_layers == 0,
          f"draft decode launches {launches['decode_attention']}")
    check(launches["flash_attention"] ==
          L * st["prefill_chunks"] + dcfg.num_layers * len(prompts),
          f"flash launches {launches['flash_attention']} != {L} x "
          f"{st['prefill_chunks']} chunks + {dcfg.num_layers} x "
          f"{len(prompts)} draft prefills")
    check(launches["paged_decode_attention"] == L * st["decode_steps"],
          "paged decode launches differ from the normal ticks run")
    print(f"[spec] {len(got)} requests x 32 tokens in {wall:.2f}s; "
          f"acceptance {st['acceptance_rate']:.3f}, {st['spec_rounds']} "
          f"verify rounds, {st['draft_ticks']} draft ticks, launches "
          f"{launches}")
    profile_decode(torch, spec, rng, steps=4, label="speculative",
                   per_tick=spec.spec_k_max + 1)
    del spec

    base = ServingEngine(cfg, **kw)
    want, base_wall = serve(base)
    base_rate, base_toks, base_s = _decode_rate(base)
    del base
    torch.cuda.empty_cache()
    check(got == want, "speculative streams differ from non-speculative "
          "ones on the same weights")
    print(f"[spec] decode tokens/s (decode ticks only, same traffic and "
          f"weights, int8 pages): speculative {spec_rate:.1f} ({spec_toks} "
          f"tokens in {spec_s:.3f}s) vs plain {base_rate:.1f} ({base_toks} "
          f"in {base_s:.3f}s): {spec_rate / base_rate:.2f}x; streams equal")
    n_tok = sum(len(g) for g in got)
    print(f"[spec] end-to-end tokens/s (all {n_tok} generated tokens over "
          f"the wall from first submit to drained, prefill and draft "
          f"prefill included): speculative {n_tok / wall:.1f} ({wall:.3f}s)"
          f" vs plain {n_tok / base_wall:.1f} ({base_wall:.3f}s): "
          f"{base_wall / wall:.2f}x")
    return launches, len(got)


# ---------------------------------------------------------------------------
# phase 4b: speculative streams equal plain ones, fp32 full width
# ---------------------------------------------------------------------------

def phase_spec_exactness(torch):
    """A random-weight 2-layer target and its first layer as the draft
    (acceptance well below 1): with pages in fp32 and in int8, the
    speculative token streams equal the non-speculative ones.  A token
    may differ only where the two best logits of the full forward are
    within 1e-3 (``phase_consistency``'s rule); the streams are compared
    up to that token."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServingEngine

    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), num_layers=2,
                              compute_dtype="float32")
    dcfg = dataclasses.replace(cfg, num_layers=1)
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(3))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (40, 100, 7, 300)]
    kw = dict(max_slots=4, max_seq=512, page_size=16, params=params,
              device="cuda")
    for kv in ("auto", "int8"):
        outs = []
        for spec in (True, False):
            extra = dict(draft_cfg=dcfg, draft_params=_truncated(params, 1),
                         spec_k_max=4) if spec else {}
            eng = ServingEngine(cfg, kv_dtype=kv, **kw, **extra)
            for p in prompts:
                eng.submit(p, max_new_tokens=24)
            done = sorted(eng.run_until_drained(), key=lambda r: r.rid)
            check(not eng.failed and len(done) == len(prompts),
                  "a request failed")
            outs.append([r.generated for r in done])
            if spec:
                st = eng.stats()
                check(st["spec_rounds"] > 0 and st["speculative"],
                      f"no speculative tick ran: {st}")
        flips = 0
        for p, s, b in zip(prompts, *outs):
            j = next((i for i, (x, y) in enumerate(zip(s, b)) if x != y),
                     None)
            if j is None:
                continue
            with torch.no_grad():
                full = model.forward(params, {"tokens": torch.tensor(
                    [list(p) + b[:j]], device="cuda")})[0, -1]
            top2 = torch.topk(full, 2).values
            check(float(top2[0] - top2[1]) <= 1e-3,
                  f"speculative token differs at a clear margin ({kv})")
            flips += 1
        print(f"[spec-exact] fp32 full width, 2-layer target, 1-layer "
              f"draft, pages {kv}: acceptance {st['acceptance_rate']:.3f} "
              f"over {st['spec_rounds']} rounds; {len(prompts)} streams "
              f"of 24 equal the plain ones (near-tie flips {flips})")


# ---------------------------------------------------------------------------
# phase 4: decode against the full forward, fp32 full width, 2 layers
# ---------------------------------------------------------------------------

def phase_consistency(torch):
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), num_layers=2,
                              compute_dtype="float32")
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(1))
    page, MP = 16, 16
    pools = model.init_paged_caches(2 * MP + 1, page, dtype=torch.float32)
    table = (torch.randperm(2 * MP, device="cuda") + 1).reshape(2, MP)
    table = table.to(torch.int32)
    rng = np.random.default_rng(1)
    lens = [40, 100]
    seqs = [list(rng.integers(0, cfg.vocab_size, size=n)) for n in lens]
    worst, flips, steps = 0.0, 0, 12
    with torch.no_grad():
        last = []
        for b, s in enumerate(seqs):
            for c0 in range(0, len(s), 64):
                chunk = s[c0:c0 + 64]
                pad = np.zeros((1, 64), np.int64)
                pad[0, :len(chunk)] = chunk
                lg = model.prefill_chunk(
                    params, {"tokens": torch.tensor(pad, device="cuda")},
                    pools, torch.tensor([c0], device="cuda"),
                    torch.tensor([c0 + len(chunk)], device="cuda"),
                    page_table=table[b:b + 1, :-(-(c0 + 64) // page)])
            last.append(lg[0])
        clen = torch.tensor(lens, device="cuda", dtype=torch.int32)
        nxt = torch.stack([torch.argmax(x) for x in last])
        for _ in range(steps):
            for b in range(2):
                seqs[b].append(int(nxt[b]))
            dec = model.decode_paged(params, nxt.to(torch.int32), pools,
                                     table, clen)
            clen = clen + 1
            for b in range(2):
                full = model.forward(params, {"tokens": torch.tensor(
                    [seqs[b]], device="cuda")})[0, -1]
                err = float((dec[b] - full).abs().max()
                            / full.abs().max())
                worst = max(worst, err)
                top2 = torch.topk(full, 2).values
                if int(torch.argmax(dec[b])) != int(torch.argmax(full)):
                    check(float(top2[0] - top2[1]) <= 1e-3,
                          "greedy token differs at a clear margin")
                    flips += 1
            nxt = torch.argmax(dec, dim=-1)
    print(f"[consistency] fp32 full width, 2 layers, {steps} decode steps "
          f"x 2 requests: max rel err {worst:.3e} (bound 2e-4), "
          f"near-tie flips {flips}")
    check(worst < 2e-4, f"decode vs forward {worst} >= 2e-4")


# ---------------------------------------------------------------------------
# phase 5: the JAX reference's golden streams, on the card
# ---------------------------------------------------------------------------

def phase_golden(torch):
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.weights import from_numpy_tree, unflatten
    from repro_torch.serving.engine import ServingEngine

    with np.load(os.path.join(ROOT, "tests", "data",
                              "torch_port_golden.npz")) as f:
        g = {k: f[k] for k in f.files}
    cfg = ModelConfig.from_dict(json.loads(str(g["config"])))
    dcfg = ModelConfig.from_dict(json.loads(str(g["draft_config"])))

    def tree(prefix, c):
        return from_numpy_tree(unflatten(
            {k[len(prefix):]: v for k, v in g.items()
             if k.startswith(prefix)}), c, "cuda")

    def replay(want, **kw):
        eng = ServingEngine(cfg, params=params, device="cuda",
                            **json.loads(str(g["engine"])), **kw)
        for w in (0, 1):
            for p, n, pw in zip(g["prompts"], g["prompt_lens"], g["waves"]):
                if pw == w:
                    eng.submit(p[:n], max_new_tokens=int(g["max_new"]))
            eng.run_until_drained()
        got = [r.generated for r in sorted(eng.completed.values(),
                                           key=lambda r: r.rid)]
        check(not eng.failed, "golden replay: a request failed")
        check(got == want.tolist(),
              f"golden streams differ ({kw.get('kv_dtype', 'plain')}):\n"
              f"{got}\n{want.tolist()}")
        return eng

    params = tree("params/", cfg)
    eng = replay(g["streams"])
    for kv in ("auto", "int8"):
        spec = replay(g[f"spec_streams_{kv}"], kv_dtype=kv, draft_cfg=dcfg,
                      draft_params=tree("draft_params/", dcfg),
                      spec_k_max=int(g["spec_k_max"]))
        check(spec.stats()["spec_rounds"] > 0, "golden: no speculative tick")
    got = g["streams"].tolist()
    worst = 0.0
    with torch.no_grad():
        for p, n, want in zip(g["prompts"], g["prompt_lens"],
                              g["first_logits"]):
            lg = eng.model.forward(eng.params, {"tokens": torch.tensor(
                p[None, :n].astype(np.int64), device="cuda")})[0, -1]
            w = torch.tensor(want, device="cuda")
            worst = max(worst, float((lg - w).abs().max() / w.abs().max()))
    print(f"[golden] {len(got)} JAX token streams reproduced on the card "
          f"(fp32, cow copies {eng.kv.cow_copies}), and the JAX "
          f"speculative streams with pages in fp32 and int8; first-token "
          f"logits max rel err {worst:.3e} (bound 2e-4)")
    check(worst < 2e-4, f"golden logits {worst} >= 2e-4")


def phase_golden_train(torch):
    """The JAX training run of the fixture (fp32, 5 steps of
    ``build_train_step``) replayed on the card through the kernels from
    its step-0 parameters and AdamW state, restored by ``Trainer`` from a
    checkpoint: each step's loss and grad norm within 1e-4 relative, the
    final parameters within 1e-4."""
    from repro_torch.checkpointing import checkpoint as ck
    from repro_torch.data.tokens import make_lm_iterator
    from repro_torch.launch import programs
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.weights import from_numpy_tree, unflatten
    from repro_torch.optim import adamw, schedule
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import flatten_with_path

    with np.load(os.path.join(ROOT, "tests", "data",
                              "torch_port_golden.npz")) as f:
        g = {k: f[k] for k in f.files if k.startswith("train_")}
    cfg = ModelConfig.from_dict(json.loads(str(g["train_config"])))
    setup = json.loads(str(g["train_setup"]))

    def tree(prefix):
        return from_numpy_tree(unflatten(
            {k[len(prefix):]: v for k, v in g.items()
             if k.startswith(prefix)}), cfg, "cuda")

    ckpt = os.path.join(ROOT, "build", "chip_smoke_golden_train")
    shutil.rmtree(ckpt, ignore_errors=True)
    ck.save(ckpt, 0, {"params": tree("train_params0/"), "opt": {
        "step": torch.zeros((), dtype=torch.int32, device="cuda"),
        "m": tree("train_opt0/m/"), "v": tree("train_opt0/v/")}},
        {"step": 0})
    tcfg = programs.TrainConfig(
        adamw=adamw.AdamWConfig(**setup["adamw"]),
        sched=schedule.ScheduleConfig(**setup["sched"]))
    tr = Trainer(cfg, "cuda", tcfg, TrainerConfig(ckpt_dir=ckpt,
                                                  ckpt_every=0))
    tr.initialize(restore=True)
    data = make_lm_iterator(cfg, setup["batch"], setup["seq"],
                            seed=setup["seed"])
    before = [fn.launches for fn, _ in _train_counters()]
    ms = [tr.train_step(next(data)) for _ in range(setup["steps"])]
    moved = [fn.launches - b for (fn, _), b in zip(_train_counters(), before)]
    shutil.rmtree(ckpt, ignore_errors=True)
    check(moved == [cfg.num_layers * setup["steps"]] * 3,
          f"golden training did not run through the kernels: {moved}")
    loss_err = max(abs(m["loss"] - w) / abs(w)
                   for m, w in zip(ms, g["train_losses"]))
    norm_err = max(abs(m["grad_norm"] - w) / abs(w)
                   for m, w in zip(ms, g["train_grad_norms"]))
    want = dict(flatten_with_path(tree("train_final/")))
    param_err = max(float((p.detach() - want[path]).abs().max())
                    for path, p in flatten_with_path(tr.params))
    print(f"[golden-train] the JAX trainer's {setup['steps']} fp32 steps "
          f"replayed on the card through the kernels: loss max rel err "
          f"{loss_err:.3e}, grad norm {norm_err:.3e} (bound 1e-4), final "
          f"params max abs err {param_err:.3e} (bound 1e-4)")
    check(loss_err < 1e-4 and norm_err < 1e-4 and param_err < 1e-4,
          "the golden training run does not replay")


# ---------------------------------------------------------------------------
# phase 6: train full-width tinyllama
# ---------------------------------------------------------------------------

def _train_counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab

    return ((fa.flash_attention, "flash_attention"),
            (fab.flash_attention_bwd_dq, "flash_attention_bwd_dq"),
            (fab.flash_attention_bwd_dkv, "flash_attention_bwd_dkv"))


def phase_train(torch):
    """``Trainer`` at full tinyllama width on the card: fp32 parameters,
    bf16 compute, fp32 AdamW moments, the bigram stream at B 8 x T 1024.
    Six counted steps (the first at lr 0), one profiled step, then an
    async checkpoint restored into a fresh ``Trainer``: one more step
    from both gives the same loss."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import make_lm_iterator
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config("tinyllama-1.1b")
    B, T, steps = 8, 1024, 6
    ckpt = os.path.join(ROOT, "build", "chip_smoke_train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    run_cfg = TrainerConfig(ckpt_dir=ckpt, ckpt_every=0, keep_ckpts=1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    tr = Trainer(cfg, "cuda", run_cfg=run_cfg).initialize(restore=False)
    check(tr.tcfg.adamw.state_dtype == "float32"
          and tr.cfg.compute_dtype == "bfloat16", "train config")
    data = make_lm_iterator(cfg, B, T, seed=0)
    batches = [next(data) for _ in range(steps + 2)]
    print(f"[train] tinyllama-1.1b {cfg.num_layers}L d{cfg.d_model}, fp32 "
          f"params + AdamW, bf16 compute, B {B} x T {T}: init "
          f"{time.monotonic() - t0:.1f}s, "
          f"{cfg.num_params() / 1e9:.3f}B params")

    w0 = tr.params["stack"]["blocks"]["attn"]["w_q"][0].detach().clone()
    counters = _train_counters()
    for fn, _ in counters:
        fn.launches = 0
    hist = []
    for i in range(steps):
        m = tr.train_step(batches[i])
        hist.append(m)
        check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
              f"step {i + 1}: loss {m['loss']} grad norm {m['grad_norm']}")
        w = tr.params["stack"]["blocks"]["attn"]["w_q"][0]
        if i == 0:
            check(m["lr"] == 0.0 and bool(torch.equal(w, w0)),
                  "step 1 trains at lr 0: the parameters must not move")
        if i == 1:
            check(not bool(torch.equal(w, w0)),
                  "the parameters must move after step 2")
    launches = {name: fn.launches for fn, name in counters}
    L = cfg.num_layers
    for name, n in launches.items():
        check(n == L * steps, f"{name} launched {n} times, not {L} x "
              f"{steps} steps")
    secs = sorted(m["step_time_s"] for m in hist)
    med = secs[len(secs) // 2]
    peak = torch.cuda.max_memory_allocated()
    print(f"[train] {steps} steps: losses "
          f"{[round(m['loss'], 4) for m in hist]}, grad norms "
          f"{[round(m['grad_norm'], 3) for m in hist]}, lr "
          f"{[m['lr'] for m in hist]}")
    print(f"[train] step time median {med * 1e3:.1f} ms (all "
          f"{[round(x * 1e3, 1) for x in (m['step_time_s'] for m in hist)]}"
          f" ms), {B * T / med:.0f} tokens/s; peak memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated); launches "
          f"{launches}")

    torch.cuda.synchronize()
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.train_step(batches[steps])
        torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3
    by_kernel = {}
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            by_kernel[ev.key] = (us / 1e3, ev.count)
    busy = sum(ms for ms, _ in by_kernel.values())
    print(f"[profile] train step (profiled): wall {wall_ms:.1f} ms, device "
          f"busy {busy:.1f} ms ({100 * busy / wall_ms:.1f}% of the profiled "
          f"wall, {100 * busy / (med * 1e3):.1f}% of the unprofiled median "
          f"step; {'measured' if by_kernel else 'no device time seen'})")
    groups = {}
    for name, (ms, n) in by_kernel.items():
        group = ("attention kernels" if "flash_" in name else
                 "GEMMs" if re.search(r"nvjet|gemm|cutlass|sm90_", name)
                 else "other")
        groups[group] = groups.get(group, 0.0) + ms
    print(f"[profile]   by group: " + ", ".join(
        f"{g} {ms:.1f} ms ({100 * ms / busy:.1f}%)"
        for g, ms in sorted(groups.items(), key=lambda x: -x[1])))
    for name, (ms, n) in sorted(by_kernel.items(), key=lambda x: -x[1][0])[:12]:
        print(f"[profile]   {ms:9.3f} ms {n:5d}x  {name[:90]}")

    t0 = time.monotonic()
    tr.maybe_checkpoint(force=True)        # host snapshot now, write behind
    snap_s = time.monotonic() - t0
    after = tr.train_step(batches[steps + 1])
    t0 = time.monotonic()
    tr.checkpointer.wait()
    wait_s = time.monotonic() - t0
    saved_step = tr.step - 1
    del tr
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    tr2 = Trainer(cfg, "cuda", run_cfg=run_cfg).initialize(restore=True)
    restore_s = time.monotonic() - t0
    check(tr2.step == saved_step, f"restored step {tr2.step} != {saved_step}")
    again = tr2.train_step(batches[steps + 1])
    print(f"[train] async checkpoint at step {saved_step}: snapshot "
          f"{snap_s:.1f}s, write finished {wait_s:.1f}s after the next "
          f"step, restore {restore_s:.1f}s; the next step's loss "
          f"{after['loss']:.6f} (kept trainer) vs {again['loss']:.6f} "
          f"(restored)")
    check(abs(after["loss"] - again["loss"]) <= 1e-6 * abs(after["loss"]),
          "the restored trainer's next loss differs")
    del tr2
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches, steps


# ---------------------------------------------------------------------------
# phase 7: training consistency, fp32
# ---------------------------------------------------------------------------

def _integration_cfg():
    """tests/test_train_integration.py:17's model and optimizer in fp32,
    with head_dim 32 in place of 16 (the kernels take 32, 64 and 128)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import programs
    from repro_torch.optim import adamw, schedule

    cfg = dataclasses.replace(
        get_reduced_config("tinyllama-1.1b", num_layers=2, d_model=64,
                           head_dim=32, d_ff=128, vocab_size=128),
        compute_dtype="float32")
    return cfg, programs.TrainConfig(
        adamw=adamw.AdamWConfig(lr=3e-3, grad_clip_norm=1.0),
        sched=schedule.ScheduleConfig(warmup_steps=5, decay_steps=200))


def phase_train_consistency(torch):
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import make_lm_iterator
    from repro_torch.kernels import ops, ref
    from repro_torch.models.model import Model
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import flatten_with_path

    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), num_layers=2,
                              compute_dtype="float32")
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(4))
    flat = flatten_with_path(params)
    for _, p in flat:
        p.requires_grad_(True)
    rng = np.random.default_rng(4)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size, size=(2, 256)),
                             device="cuda") for k in ("tokens", "labels")}
    batch["labels"][:, :5] = -1

    def grads():
        loss, _ = model.loss(params, batch)
        return float(loss.detach()), torch.autograd.grad(
            loss, [p for _, p in flat])

    counters = _train_counters()
    before = [fn.launches for fn, _ in counters]
    loss_k, g_k = grads()
    moved = [fn.launches - b for (fn, _), b in zip(counters, before)]
    check(moved == [2, 2, 2], f"2 layers must launch each kernel twice: "
          f"{moved}")
    plain = ops.flash_mha
    ops.flash_mha = ref.mha                   # autograd through the plain
    try:
        loss_p, g_p = grads()
    finally:
        ops.flash_mha = plain
    worst, where = 0.0, ""
    for (path, _), a, b in zip(flat, g_k, g_p):
        err = rel_err(b, a)
        if err > worst:
            worst, where = err, path
        check(bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0,
              f"gradient of {path} is zero or non-finite")
    print(f"[train-consistency] fp32 full width, 2 layers, B 2 x T 256: "
          f"loss {loss_k:.6f} (kernels) vs {loss_p:.6f} (plain); every "
          f"gradient leaf within {worst:.3e} relative (worst {where}; "
          f"bound 2e-4)")
    check(worst < 2e-4, f"gradients through the kernels differ: {worst}")
    del model, params, flat, g_k, g_p
    torch.cuda.empty_cache()

    cfg, tcfg = _integration_cfg()
    ckpt = os.path.join(ROOT, "build", "chip_smoke_train_small")
    shutil.rmtree(ckpt, ignore_errors=True)
    tr = Trainer(cfg, "cuda", tcfg, TrainerConfig(ckpt_dir=ckpt,
                                                  ckpt_every=0))
    tr.initialize(restore=False)
    hist = tr.fit(make_lm_iterator(cfg, 8, 32, seed=3), num_steps=30)
    shutil.rmtree(ckpt, ignore_errors=True)
    first, last = np.mean(hist["loss"][:5]), np.mean(hist["loss"][-5:])
    print(f"[train-consistency] reduced fp32 (2L d64 hd32 V128), 30 steps "
          f"through the kernels: mean loss of the first 5 {first:.4f}, of "
          f"the last 5 {last:.4f} (must drop by > 0.3)")
    check(last < first - 0.3, f"loss did not decrease: {first} -> {last}")


# ---------------------------------------------------------------------------

KERNELS = {
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:142"),
    "paged_decode_attention": dict(
        route="cuda", source="src/repro_torch/csrc/paged_decode_attention.cu",
        replaces="src/repro/kernels/paged_decode_attention.py:144"),
    "paged_verify_attention": dict(
        route="cuda", source="src/repro_torch/csrc/paged_verify_attention.cu",
        replaces="src/repro/kernels/paged_verify_attention.py:154"),
    "decode_attention": dict(
        route="cuda", source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:99"),
    "flash_attention_bwd_dq": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention_bwd.py:198"),
    "flash_attention_bwd_dkv": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention_bwd.py:228"),
}
# the path each kernel's launch count comes from, and that path's unit
PATH_OF = {"flash_attention": "serve", "paged_decode_attention": "serve",
           "paged_verify_attention": "spec", "decode_attention": "spec",
           "flash_attention_bwd_dq": "train",
           "flash_attention_bwd_dkv": "train"}
UNIT_OF = {"serve": "request", "spec": "request", "train": "step"}


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401 — fails here, before any output,
    # when the script stands alone without the package
    t_start = time.monotonic()
    card = phase_device_and_build(torch)
    timer = Timer(torch)
    kernels = phase_kernels(torch, timer, card)
    paths = {"serve": phase_serve(torch), "spec": phase_spec_serve(torch)}
    phase_consistency(torch)
    phase_spec_exactness(torch)
    phase_golden(torch)
    paths["train"] = phase_train(torch)
    phase_train_consistency(torch)
    phase_golden_train(torch)
    line = []
    for name, meta in KERNELS.items():
        k = kernels[name]
        path = PATH_OF[name]
        launches, n_units = paths[path]
        line.append({"name": name, **meta, "launches": launches[name],
                     f"launches_per_{UNIT_OF[path]}":
                         launches[name] / n_units,
                     "path": path,
                     **{key: k[key] for key in (
                         "max_abs_err", "rel_err", "err_by_dtype", "ms",
                         "plain_ms", "bound_ms", "bound_by", "library_ms")},
                     "timed_shape": k["shape"], "timed_dtype": k["dtype"]})
    print(f"[done] all phases passed in {time.monotonic() - t_start:.1f}s "
          f"on {card}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
