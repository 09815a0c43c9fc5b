"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase catches and
continues:

1. device and build: the card's name and power limit, the CUDA kernels
   built with nvcc from ``src/repro_torch/csrc`` (one process per source,
   all at once; registers and spills of each kernel, and no tensor-core
   kernel may spill), the tensor-core instructions of every kernel counted
   in its SASS (the bf16 SSD scan's must have some, the fp32 scan's none;
   so must every bf16 instance of the paged and dense decode attention
   kernels, and no fp32 one),
   TF32 off for matmuls and cuDNN;
2. kernels: each kernel against its plain PyTorch version on the card at
   the serving path's shapes (bf16 and fp32, window and softcap variants,
   int8 pools for the paged kernels, K1 of 1, 2 and 5 for the verify
   kernel, which at K1 = 1 is also held against the paged decode kernel;
   both paged kernels timed at B 8 over 64 table entries, at B 1 with one
   543-token sequence and at B 8 over 256 entries with lengths 1024-4095;
   the dense decode kernel timed at the draft's G 8, at zamba2's G 1 and
   at the edge decode image's G 2 (B 1, S 128),
   and checked with lengths of 0, of S and past S),
   the forward (with lse, as the train step runs it) and the backward
   kernels at the train step's (causal, non-causal, window, softcap, an
   empty row, G 1, 8, 12 and 96, Tq < Tk, D 32/64/128, packed positions
   that restart mid-row, T 129; at the train shape the share of 64 x 64
   tiles computed, the useful TFLOP/s of each, the forward against one
   causal SDPA forward and the two backward kernels against SDPA's one
   backward), the SSD scan
   at the SSM prefill's (mamba2's 64-token chunk with the carried state
   and zamba2's H 64 N 64, both timed, a 511-token prompt whole, 511 and
   4096 tokens as 64-token calls that carry the state, groups 2, one
   token; final state included) and
   RMSNorm at its rows and widths (a 64 x 5120 chunk and the 8-row
   decode shapes timed, one row, widths that are not whole 16-byte
   vectors, a misaligned row view), with
   CUDA-event times for the kernel, its plain version and a library
   yardstick (``F.scaled_dot_product_attention`` with an explicit mask
   over the same dense or gathered KV, causal at the train shape, its
   backward for the backward kernels, ``F.rms_norm`` for RMSNorm, none
   for the SSD scan; timed here
   only, never called by the port), the bound: bytes over 3.35 TB/s
   or operations over the peak rate, and the floor that event timing puts
   under any launch (an empty kernel timed the same way);
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
3c. SSM serve: full-width mamba2-2.7b (64 layers) and zamba2-1.2b (38
   Mamba2 layers, 6 shared-attention applications), bf16, random weights
   from a seed, on the dense-slot plane with phase 3's traffic; every
   request completes, and the launches are exact: the SSD scan layers x
   chunks, RMSNorm norms x (chunks + decode steps), for zamba2 flash 6 x
   chunks and the dense decode kernel 6 x decode steps; tokens/s, TTFT,
   tick walls, a profiled decode tick and a profiled prefill tick (a lone
   512-token prompt), each with the SSD scan's and RMSNorm's device time;
3d. the edge system: ``EdgeSystem`` with two logical nodes on cuda:0
   (half of the card's memory each, ``LeastLoadedPolicy``), the standard
   builders over full-width tinyllama-1.1b (heavy) and edge-stream-light
   (light), random bf16 weights from a seed, the ``cv-infer``,
   ``stream-analytics`` and a light decode spec; 16 rounds of mixed
   ``submit_many`` traffic (cv frames through the container's flash
   forward, record batches through the stream image, decode steps
   through the decode image, a captured CUDA graph): every dispatch
   completes and routes as ``classify`` says, each service deployed
   once, the analytics within 1e-5 of ``reference_analytics``, the
   image's tokens equal to eager ``Model.decode``'s, flash launched 22 x
   the frames and the dense decode kernel 4 x the replays (the capture's
   launches, cross-checked in a ``torch.profiler`` trace of 3 replays);
   per-class dispatch p50/p95, footprints, the stream task's footprint
   on the image and on a container, the capture time, replay against
   eager ms per step; a node loss redeploys the stream instance from the
   registry; then ``launch/serve.py`` at full width (8 requests,
   ``--save-state``), flash and paged decode launches exact, and a fresh
   ``EdgeSystem`` restores the saved spec set;
4. consistency: fp32 at full width, 2 layers: every decode step's logits
   against ``Model.forward`` over the same prefix, within 2e-4 relative;
4c. SSM consistency: mamba2 (2 layers) and zamba2 (3) in fp32 at full
   width: chunked against monolithic prefill (logits and SSM state) and
   each decode step against ``Model.forward``, within 2e-4 relative;
4b. speculative exactness: fp32 at full width, 2 random layers, the first
   as the draft: speculative streams equal plain ones with pages in fp32
   and in int8 (a token may differ only at a top-2 margin <= 1e-3);
5. golden: the JAX reference's token streams (``tests/data``), plain,
   speculative and dense-slot (reduced mamba2 and zamba2), reproduced by
   the port on the card in fp32;
6. train: ``Trainer`` at full tinyllama-1.1b width (fp32 parameters and
   AdamW moments, bf16 compute) on the bigram stream at B 8 x T 1024, 6
   steps: every loss and grad norm finite, the parameters still after
   step 1 (lr 0) and moved after step 2, the forward flash, dq and dk/dv
   kernels each launched 22 x 6 times; median step time, tokens/s, peak
   memory and a profiled step's device busy share and top kernels (the
   bf16 forward's and backward's tensor-core kernels 22 times each); an
   async checkpoint restored into a fresh ``Trainer`` gives the same next
   loss;
7. train consistency: fp32 at full width, 2 layers, every gradient leaf of
   ``Model.loss`` through the kernels against the plain path within 2e-4
   relative; a reduced fp32 model trained 30 steps through the kernels
   lowers its loss by more than 0.3;
8. golden train: the JAX trainer's 5 fp32 steps from the fixture,
   replayed through the kernels from its step-0 state: losses and grad
   norms within 1e-4 relative, final parameters within 1e-4;
9. the kernels line (each kernel's launches from the paths that run it:
   per request for serving, per step for training, per dispatch on the
   edge path; the SSD scan and RMSNorm from mamba2's serve, the dense
   decode kernel from the speculative and zamba2's serves and the edge
   path; flash attention's times at the serving
   chunk, and as ``train_*`` at the train shape; other timed shapes under
   ``also_timed``, the launch floor, the stitched scans' final-state
   errors), then the last line
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

def _demangle(sym: str) -> str:
    """``name<int and bool template args>`` of a mangled kernel symbol."""
    for m in re.finditer(r"[0-9]+(?=[A-Za-z_])", sym):
        for i in range(len(m.group())):      # a hash's digits may lead
            name = sym[m.end():m.end() + int(m.group()[i:])]
            if name.endswith("_kernel"):
                rest = sym[m.end() + len(name):]
                args = re.findall(r"L[ib](\d+)E", rest.split("EEv")[0])
                return f"{name}<{','.join(args)}>"
    return sym


def _kernel_resources(log: str) -> list:
    """`-Xptxas -v` per entry function: ("name<template args>", registers,
    spilled bytes)."""
    out = []
    for block in log.split("Compiling entry function")[1:]:
        regs = re.search(r"Used (\d+) registers", block)
        if not regs:
            continue
        name = _demangle(block.split()[0].strip("'"))
        spill = sum(int(x) for x in re.findall(r"(\d+) bytes spill", block))
        out.append((name, int(regs.group(1)), spill))
    return out


def _tensor_core_ops(build, name: str, full: bool = False) -> dict:
    """The `HMMA`/`HGMMA` instructions of each kernel of a built library,
    from `cuobjdump -sass` (instances that print alike are summed; with
    ``full``, by each instance's whole demangled name, types included)."""
    bindir = os.path.dirname(build._nvcc())
    sass = subprocess.run([os.path.join(bindir, "cuobjdump"), "-sass",
                           str(build._target(name))],
                          capture_output=True, text=True, timeout=120)
    check(sass.returncode == 0, f"cuobjdump: {sass.stderr.strip()[-300:]}")
    counts, cur = {}, None
    for line in sass.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if full else _demangle(m.group(1))
            counts.setdefault(cur, 0)
        elif cur and re.search(r"\bH(G)?MMA\b", line):
            counts[cur] += 1
    if full:
        filt = os.path.join(bindir, "cu++filt")
        out = subprocess.run([filt if os.path.exists(filt) else "c++filt",
                              *counts], capture_output=True, text=True,
                             timeout=60)
        names = out.stdout.splitlines()
        check(out.returncode == 0 and len(names) == len(counts),
              f"demangling {name}'s kernels: {out.stderr.strip()[-300:]}")
        counts = dict(zip(names, counts.values()))
    return counts


def _template_args(kernel: str) -> list:
    """``a, b, c`` of a demangled ``name<a, b, c>(...)``."""
    return kernel.split("<", 1)[1].rsplit(">(", 1)[0].split(", ")


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
    # a tensor-core kernel (one with HMMA/HGMMA in its SASS, or a wgmma
    # kernel) keeps its accumulators in registers: no spill
    tc_ops = {}
    for name, log in sorted(logs.items()):
        kernels = _kernel_resources(log)
        print(f"[build] {name}: " + ", ".join(
            f"{k} {r} regs" + (f", {b} B spilled" if b else "")
            for k, r, b in kernels))
        ops = tc_ops[name] = _tensor_core_ops(build, name)
        print(f"[build] {name} tensor-core instructions (HMMA/HGMMA, "
              f"cuobjdump -sass): " + ", ".join(
                  f"{k} {v}" for k, v in sorted(ops.items())))
        spilled = [k for k, _, b in kernels
                   if b and ("wgmma" in k or ops.get(k, 0) > 0)]
        check(not spilled, f"tensor-core kernels spill registers: {spilled}")
    # the bf16 SSD scan's products run on the tensor cores, the fp32
    # scan's on the CUDA cores (no TF32)
    ops = tc_ops["ssd_scan"]
    tc = [v for k, v in ops.items() if k.startswith("ssd_scan_tc_kernel")]
    f32 = [v for k, v in ops.items() if k.startswith("ssd_scan_f32_kernel")]
    check(tc and all(tc) and f32 and not any(f32),
          f"ssd_scan: bf16 kernels without or fp32 kernels with tensor-core "
          f"instructions: {ops}")
    # the instances of the paged kernels and of the dense decode kernel
    # (the q dtype is their second template argument): HMMA in every bf16
    # one, none in an fp32 one
    for name in ("paged_decode_attention", "paged_verify_attention",
                 "decode_attention"):
        inst = {k: v for k, v in _tensor_core_ops(build, name, True).items()
                if "paged_attention_kernel<" in k}
        bf = [v for k, v in inst.items()
              if _template_args(k)[1] == "__nv_bfloat16"]
        f32 = [v for k, v in inst.items() if _template_args(k)[1] == "float"]
        print(f"[build] {name}: HMMA in {len(bf)} bf16 instances "
              f"({min(bf) if bf else 0}-{max(bf) if bf else 0} each), in "
              f"{sum(1 for v in f32 if v)} of {len(f32)} fp32 instances")
        check(bf and all(bf) and f32 and not any(f32),
              f"{name}: bf16 instances without or fp32 instances with "
              f"tensor-core instructions: {inst}")
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
                K1=0, B=8, MP=64, lens=(36, 544)):
    """A decode tick of the serving path: B 8, Hq 32, Hkv 4, D 64, page
    16, 64 table entries (max_seq 1024), pages scattered over the pool,
    lengths 36-543 (``B``, ``MP`` and the lengths' range ``lens`` change
    them).  ``K1 > 0`` makes it a verify pass: K1 query tokens per
    sequence, the last K1 of its length."""
    from repro_torch.models.attention import _quantize

    dt = getattr(torch, dtype)
    Hq, Hkv, D, page = 32, 4, 64, 16
    P = B * MP + 1
    qshape = (B, K1, Hq, D) if K1 else (B, Hq, D)
    q = torch.randn(*qshape, generator=gen, device="cuda").to(dt)
    kf = torch.randn(P, page, Hkv, D, generator=gen, device="cuda")
    vf = torch.randn(P, page, Hkv, D, generator=gen, device="cuda")
    perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    table = perm[:B * MP].reshape(B, MP).to(torch.int32)
    clen = torch.randint(*lens, (B,), generator=gen, device="cuda",
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


def _dense_case(torch, gen, dtype, S, D=64, window=0, softcap=0.0, B=8,
                Hq=32, Hkv=4, fix=None):
    """A decode step of a dense [B, S, Hkv, D] cache: the draft's (B 8, Hq
    32, Hkv 4) by default, zamba2's shared attention at Hq = Hkv = 32;
    valid lengths 36-543, with ``fix`` setting some rows' lengths (S: a
    full row; past S: clamped to S; 0: an empty row)."""
    dt = getattr(torch, dtype)
    q = torch.randn(B, Hq, D, generator=gen, device="cuda").to(dt)
    k = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dt)
    v = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dt)
    clen = torch.randint(36, 544, (B,), generator=gen, device="cuda",
                         dtype=torch.int32)
    for row, n in (fix or {}).items():
        clen[row] = n
    kw = dict(window=window, softcap=softcap)
    # what the data needs: the keys in [cache_len - window, min(cache_len,
    # S)) of each row, read once
    c = clen.long().cpu().numpy()
    lo = np.maximum(c - window, 0) if window else 0
    toks = int(np.maximum(np.minimum(c, S) - lo, 0).sum())
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
              valid=False, index_kv=False, packed=False):
    """Inputs of the backward kernels as the train step gives them:
    q/k/v/do random, ``out`` and ``lse`` from the forward kernel, the
    query positions the last Tq of Tk, the key positions explicit (the
    train-mode forward passes them; ``index_kv`` leaves them None), with
    ``valid`` batch row 0 sees no key and the others the first 3/4;
    ``packed`` makes the positions two documents, 0..99 then 0..Tk-101."""
    from repro_torch.kernels.flash_attention import flash_attention

    dt = getattr(torch, dtype)
    B, Tq, Tk, Hq, Hkv, D = dims
    q = torch.randn(B, Tq, Hq, D, generator=gen, device="cuda").to(dt)
    k = torch.randn(B, Tk, Hkv, D, generator=gen, device="cuda").to(dt)
    v = torch.randn(B, Tk, Hkv, D, generator=gen, device="cuda").to(dt)
    do = torch.randn(B, Tq, Hq, D, generator=gen, device="cuda").to(dt)
    kp = np.arange(Tk)
    if packed:
        kp = np.concatenate([np.arange(100), np.arange(Tk - 100)])
    qp = kp[Tk - Tq:]

    def positions(p, n):
        return torch.tensor(p, device="cuda",
                            dtype=torch.int32)[None].expand(B, n)

    kw = dict(causal=causal, window=window, softcap=softcap,
              q_positions=positions(qp, Tq))
    if not index_kv:
        kw["kv_positions"] = positions(kp, Tk)
    vl = np.array([0] + [3 * Tk // 4] * (B - 1)) if valid else np.full(B, Tk)
    if valid:
        kw["kv_valid_len"] = torch.tensor(vl, device="cuda",
                                          dtype=torch.int32)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    dsum = (do.float() * out.float()).sum(-1)
    # what the data needs: the (query, key) pairs the masks keep
    keep = np.ones((Tq, Tk), bool)
    if causal:
        keep &= kp[None, :] <= qp[:, None]
    if window:
        keep &= qp[:, None] - kp[None, :] < window
    pairs = sum(int((keep & (kp[None, :] < n)).sum()) for n in vl) * Hq
    e = q.element_size()
    qbytes, kbytes = B * Tq * Hq * D * e, B * Tk * Hkv * D * e
    common = 2 * qbytes + 2 * kbytes + 8 * B * Tq * Hq + 4 * B * (Tq + Tk)
    nbytes = {"dq": common + qbytes, "dkv": common + 2 * kbytes,
              "fwd": 2 * qbytes + 2 * kbytes + 4 * B * Tq * Hq
              + 4 * B * (Tq + Tk)}
    flops = {"dq": 3 * 2 * D * pairs, "dkv": 4 * 2 * D * pairs,
             "fwd": 2 * 2 * D * pairs}
    return (q, k, v, lse, do, dsum), kw, out, nbytes, flops


def _tile_share(qp, kp, G, causal, window):
    """The share of (64-row, 64-key) tile pairs that hold a kept pair, for
    one batch row, with the bf16 dq kernel's rows (64/G positions times
    the G heads of a KV head): what tile skipping leaves to compute."""
    per = max(64 // G, 1)
    tiles = kept = 0
    for t0 in range(0, len(qp), per):
        q = qp[t0:t0 + per, None]
        for k0 in range(0, len(kp), 64):
            k = kp[None, k0:k0 + 64]
            keep = np.ones((q.shape[0], k.shape[1]), bool)
            if causal:
                keep &= k <= q
            if window:
                keep &= q - k < window
            tiles += 1
            kept += bool(keep.any())
    return kept / tiles


def _sdpa_causal(torch, F, q, k, v):
    """Library yardstick of the forward at the train shape: one causal
    ``F.scaled_dot_product_attention`` over the same q, k and v, the KV
    heads expanded to the query heads beforehand (untimed)."""
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt, vt = (x.transpose(1, 2).repeat_interleave(G, dim=1) for x in (k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)


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


def _ssd_case(torch, gen, dtype, T, H, P, N, G=1, chunk=256, init=True):
    """A Mamba2 scan of one sequence (a serving prefill is batch 1): x, B,
    C in ``dtype``, dt softplus'd and A negative in f32, an f32 initial
    state when ``init`` (every serving chunk passes one)."""
    dt = getattr(torch, dtype)
    x = torch.randn(1, T, H, P, generator=gen, device="cuda").to(dt)
    dtv = torch.nn.functional.softplus(
        torch.randn(1, T, H, generator=gen, device="cuda") - 2)
    A = -torch.exp(torch.randn(H, generator=gen, device="cuda"))
    Bm = torch.randn(1, T, G, N, generator=gen, device="cuda").to(dt)
    Cm = torch.randn(1, T, G, N, generator=gen, device="cuda").to(dt)
    s0 = torch.randn(1, H, P, N, generator=gen, device="cuda") \
        if init else None
    kw = dict(chunk=chunk, initial_state=s0, return_final_state=True)
    es = x.element_size()
    nbytes = (2 * T * H * P * es + 4 * T * H + 4 * H + 2 * T * G * N * es
              + (2 if init else 1) * H * P * N * 4)
    # what the data needs, per head and chunk of r rows: the r(r+1)/2
    # causal pairs (C·B over N, the decay, times dt·x over P), the state's
    # read (C·S) and update (B·dt·x) over N·P per row
    flops = 0
    for c0 in range(0, T, chunk):
        r = min(chunk, T - c0)
        flops += H * (r * (r + 1) // 2 * (2 * N + 2 * P + 1)
                      + r * 4 * N * P + 2 * N * P)
    return (x, dtv, A, Bm, Cm), kw, nbytes, flops


def _ssd_stitched(scan, args, kw, step: int = 64):
    """The scan of all of ``args``' tokens as calls of at most ``step``
    tokens, each passing its final state on to the next (a serving
    prefill's chunks): y of all tokens and the last state."""
    import torch

    x, dt, A, Bm, Cm = args
    s, ys = kw["initial_state"], []
    for c0 in range(0, x.shape[1], step):
        c1 = min(c0 + step, x.shape[1])
        y, s = scan(x[:, c0:c1], dt[:, c0:c1], A, Bm[:, c0:c1],
                    Cm[:, c0:c1], chunk=kw["chunk"], initial_state=s,
                    return_final_state=True)
        ys.append(y)
    return torch.cat(ys, dim=1), s


def _rms_case(torch, gen, dtype, rows, d, misaligned=False):
    """x [rows, d] and scale; with ``misaligned`` x is a contiguous view
    that starts one element past a 16-byte boundary."""
    dt = getattr(torch, dtype)
    x = (torch.randn(rows * d + 1, generator=gen, device="cuda") * 3).to(dt)
    x = x[1:].view(rows, d) if misaligned else x[:-1].view(rows, d)
    scale = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dt)
    es = x.element_size()
    return (x, scale), dict(eps=1e-5), (2 * rows + 1) * d * es, 4 * rows * d


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
    state_err = {}

    # the forward's f32 lse, held as tests/test_torch_gpu.py holds it:
    # absolute, since an empty row's NEG_INF would swamp a relative error
    lse_atol, lse_rtol = 1e-4, 1e-5
    worst_lse = {}

    def check_lse(label, dtype, got, want):
        """Rows with a kept key within lse_atol + lse_rtol·|want| of the
        plain version's ``lse``, rows with none exactly NEG_INF."""
        torch.cuda.synchronize()
        empty = want == ref.NEG_INF
        diff = (got - want)[~empty].abs()
        err = float(diff.max()) if diff.numel() else 0.0
        print(f"[kernel] flash_attention {label} lse {dtype}: "
              f"max_abs_err={err:.3e} (limit {lse_atol:.0e} + "
              f"{lse_rtol:.0e}·|lse|), {int(empty.sum())} empty rows")
        check(bool((got[empty] == ref.NEG_INF).all()),
              f"flash_attention {label}: an empty row's lse is not NEG_INF")
        check(bool((diff <= lse_atol + lse_rtol * want[~empty].abs()).all()),
              f"flash_attention {label}: lse off by {err}")
        worst_lse[dtype] = max(worst_lse.get(dtype, 0.0), err)

    def run(name, label, dtype, kernel, plain, args, kw, nbytes, flops,
            library, timed, key=None):
        """Check ``kernel`` against ``plain`` (each returns a tensor or a
        tuple of them, each held to the tolerance relative to its own
        largest value) and, if ``timed``, time both and the library (the
        times go under ``key``, by default the kernel's name)."""
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
        lib_ms = timer.ms(library) if library is not None else None
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        bound = max(t_bytes, t_ops)
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"[kernel] {name} {label} {dtype}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {lib}, bound "
              f"{bound:.5f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}"
              f": {nbytes} B, {flops} FLOP) on {card}")
        results[key or name] = dict(
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
        # the cv-infer container's forward in phase 3d: B 1, T 32
        ("Tq32/Tk32 forward", 32, 32, 0, 32, {"explicit_kv_pos": True},
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

    # the paged kernels: timed at the serving shape, at B 1 with one
    # 543-token sequence and at B 8 over MP 256 (max_seq 4096) with lengths
    # 1024-4095 (the third field: the key the times go under)
    long = {"MP": 256, "lens": (1024, 4096)}
    one = {"B": 1, "lens": (543, 544)}
    paged_cases = [
        ("B8/MP64 decode", {}, "paged_decode_attention"),
        ("B1/MP64 one 543-token sequence", one, "paged_decode_attention@B1"),
        ("B8/MP256 lengths 1024-4095", long, "paged_decode_attention@MP256"),
        ("B8/MP64 window256", {"window": 256}, None),
        ("B8/MP64 softcap30", {"softcap": 30.0}, None),
        ("B8/MP64 int8", {"int8": True}, None),
        ("B8/MP64 int8+softcap30", {"int8": True, "softcap": 30.0}, None),
    ]
    for dtype in ("bfloat16", "float32"):
        for label, extra, key in paged_cases:
            args, kw, nb, fl = _paged_case(torch, gen, dtype, **extra)
            run("paged_decode_attention", label, dtype,
                paged_decode_attention, ref.paged_decode_attention, args,
                kw, nb, fl, _sdpa_paged(torch, F, args, kw),
                key is not None and dtype == "bfloat16", key)

    # the target's verify pass; K1 = 5 is spec_k_max 4, the serving shape
    verify_cases = [
        ("B8/MP64 K1=5 verify", {"K1": 5}, "paged_verify_attention"),
        ("B1/MP64 K1=5 one 543-token sequence", dict(one, K1=5),
         "paged_verify_attention@B1"),
        ("B8/MP256 K1=5 lengths 1024-4095", dict(long, K1=5),
         "paged_verify_attention@MP256")] + [
        (f"B8/MP64 K1={k1} {name}", dict(extra, K1=k1), None)
        for k1 in (1, 2, 5)
        for name, extra in (("window256", {"window": 256}),
                            ("softcap30", {"softcap": 30.0}),
                            ("int8", {"int8": True}),
                            ("int8+softcap30",
                             {"int8": True, "softcap": 30.0}))]
    for dtype in ("bfloat16", "float32"):
        for label, extra, key in verify_cases:
            args, kw, nb, fl = _paged_case(torch, gen, dtype, **extra)
            run("paged_verify_attention", label, dtype,
                paged_verify_attention, ref.paged_verify_attention, args,
                kw, nb, fl, _sdpa_paged(torch, F, args, kw),
                key is not None and dtype == "bfloat16", key)
            if extra["K1"] == 1:        # one verify token is one decode step
                q, *rest = args
                got = paged_verify_attention(*args, **kw)[:, 0]
                dec = paged_decode_attention(q[:, 0], *rest, **kw)
                torch.cuda.synchronize()
                err = rel_err(dec, got)
                print(f"[kernel] paged_verify_attention {label} {dtype}: "
                      f"vs the paged decode kernel rel_err={err:.3e}")
                check(err < TOL[dtype], f"verify K1=1 vs paged decode {err}")

    # the dense decode kernel at the two shapes the serving paths run it
    # at, both timed: the draft's decode steps (G 8) and zamba2's shared
    # attention (Hq = Hkv = 32, G 1); S 1024 is max_seq, 1000 is not a
    # multiple of a key tile; then lengths that cross the blocks' shares
    # of the key range (the third field: the key the times go under; the
    # fourth: rows that must give exactly 0)
    g1 = {"Hq": 32, "Hkv": 32}
    dense_cases = [
        ("B8/S1024 decode", 1024, {}, "decode_attention", ()),
        ("B8/Hkv32 G1 zamba2", 1024, g1, "decode_attention@zamba2", ()),
        ("B8/S1024 window256", 1024, {"window": 256}, None, ()),
        ("B8/S1024 softcap30", 1024, {"softcap": 30.0}, None, ()),
        ("B8/S1000 full row", 1000, {"fix": {0: 1000}}, None, ()),
        ("B8/S1000 D32 window100+softcap30", 1000,
         {"D": 32, "window": 100, "softcap": 30.0, "fix": {0: 1000}}, None,
         ()),
        ("B8/S1024 D32", 1024, {"D": 32}, None, ()),
        ("B1/S1000 one full row", 1000, {"B": 1, "fix": {0: 1000}}, None,
         ()),
        ("B8/Hkv32 G1 window100", 1024, dict(g1, window=100), None, ()),
        ("B8/S1024 cache_len past S (clamped), window300", 1024,
         {"window": 300, "fix": {0: 1100, 1: 1500}}, None, (1,)),
        ("B8/S1024 a cache_len 0 row", 1024, {"fix": {2: 0}}, None, (2,)),
        ("B8/Hkv32 G1 cache_len 0 and past S", 1024,
         dict(g1, fix={3: 0, 4: 2000}), None, (3,)),
        # the unikernel decode image of edge-stream-light (phase 3d): B 1,
        # Hq 4, Hkv 2 (G 2), S 128 (its max_seq), timed
        ("B1/S128 G2 edge-stream-light", 128,
         {"B": 1, "Hq": 4, "Hkv": 2, "fix": {0: 77}},
         "decode_attention@edge", ()),
        ("B1/S128 G2 one key", 128, {"B": 1, "Hq": 4, "Hkv": 2,
                                     "fix": {0: 1}}, None, ()),
        ("B1/S128 G2 full row", 128, {"B": 1, "Hq": 4, "Hkv": 2,
                                      "fix": {0: 128}}, None, ()),
    ]
    for dtype in ("bfloat16", "float32"):
        for label, S, extra, key, empty in dense_cases:
            args, kw, nb, fl = _dense_case(torch, gen, dtype, S, **extra)
            run("decode_attention", label, dtype, decode_attention,
                ref.decode_attention, args, kw, nb, fl,
                _sdpa_dense(torch, F, args, kw),
                key is not None and dtype == "bfloat16", key)
            if empty:
                out = decode_attention(*args, **kw)
                check(bool((out[list(empty)] == 0).all()),
                      f"decode_attention {label}: a row with no valid key "
                      f"must give exactly 0")
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
        ("B2/T256 packed positions", (2, 256, 256, 32, 4, 64),
         {"packed": True}, False),
        ("B2/T256 packed window64", (2, 256, 256, 32, 4, 64),
         {"packed": True, "window": 64}, False),
        ("B2/T129 ragged", (2, 129, 129, 32, 4, 64), {"valid": True},
         False),
        ("B1/T129 D128 G1", (1, 129, 129, 4, 4, 128), {}, False),
        ("B2/T256 G12", (2, 256, 256, 24, 2, 64), {"valid": True}, False),
        ("B1/T200 G96 D128", (1, 200, 200, 96, 1, 128), {}, False),
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

            def fwd(q, k, v, lse, do, dsum, **kw):
                return flash_attention(q, k, v, return_lse=True, **kw)[0]

            def plain_fwd(q, k, v, lse, do, dsum, **kw):
                return ref.mha(q, k, v, return_lse=True, **kw)[0]

            # the forward as the train step runs it (both compute lse),
            # timed at the train shape beside one causal SDPA forward;
            # `out` is compared here, the lse (args[3], from _bwd_case)
            # on its own
            run("flash_attention", f"{label} (train forward)", dtype, fwd,
                plain_fwd, args, kw, nb["fwd"], fl["fwd"],
                _sdpa_causal(torch, F, *args[:3]) if timed else None,
                timed, key="flash_attention@train")
            check_lse(f"{label} (train forward)", dtype, args[3],
                      ref.mha(*args[:3], return_lse=True, **kw)[1])

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
                check(bool((out[0] == 0).all())
                      and bool((args[3][0] == ref.NEG_INF).all()),
                      f"flash_attention {label}: a row with no key must "
                      f"give 0 and lse NEG_INF")
            if timed:
                dq_r = results["flash_attention_bwd_dq"]
                dkv_r = results["flash_attention_bwd_dkv"]
                fwd_r = results["flash_attention@train"]
                both = dq_r["ms"] + dkv_r["ms"]
                qp = kw["q_positions"][0].cpu().numpy()
                kp = kw["kv_positions"][0].cpu().numpy()
                share = _tile_share(qp, kp, dims[3] // dims[4],
                                    kw["causal"], kw["window"])
                fwd_r["tile_share"] = share
                print(f"[kernel] flash_attention {label} {dtype}: useful "
                      f"work {fl['fwd'] / fwd_r['ms'] / 1e9:.1f} TFLOP/s "
                      f"({100 * share:.1f}% of the 64 x 64 tiles hold a "
                      f"kept pair); {fwd_r['ms']:.4f} ms against one "
                      f"causal SDPA forward {fwd_r['library_ms']:.4f} ms "
                      f"({fwd_r['ms'] / fwd_r['library_ms']:.2f}x) on "
                      f"{card}")
                print(f"[kernel] flash_attention_bwd {label} {dtype}: "
                      f"useful work dq {fl['dq'] / dq_r['ms'] / 1e9:.1f} "
                      f"TFLOP/s, dk/dv "
                      f"{fl['dkv'] / dkv_r['ms'] / 1e9:.1f} TFLOP/s "
                      f"({100 * share:.1f}% of the 64 x 64 tiles hold a "
                      f"kept pair); dq + dk/dv {both:.4f} ms against "
                      f"SDPA's backward {dq_r['library_ms']:.4f} ms "
                      f"({both / dq_r['library_ms']:.2f}x) on {card}")
            del args, out

    # the SSM serving path: the SSD scan of a prefill chunk (mamba2-2.7b:
    # 80 heads, P 64, N 128, chunk 256, timed; zamba2-1.2b: 64 heads, N 64,
    # timed) with the carried state, a whole 511-token prompt, groups 2,
    # one token, long prompts as 64-token calls; no single PyTorch call
    # computes it (library: none)
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_scan

    ssd_cases = [
        # label, T, H, P, N, G, init, timed under
        ("mamba2 T64 chunk+state", 64, 80, 64, 128, 1, True, "ssd_scan"),
        ("mamba2 T511", 511, 80, 64, 128, 1, False, None),
        ("mamba2 T511+state", 511, 80, 64, 128, 1, True, None),
        ("zamba2 T64 H64 N64", 64, 64, 64, 64, 1, True, "ssd_scan@zamba2"),
        ("T257 G2", 257, 80, 64, 128, 2, True, None),
        ("T1", 1, 80, 64, 128, 1, True, None),
    ]
    for dtype in ("bfloat16", "float32"):
        for label, T, H, P, N, G, init, key in ssd_cases:
            args, kw, nb, fl = _ssd_case(torch, gen, dtype, T, H, P, N, G,
                                         init=init)
            run("ssd_scan", label, dtype, ssd_scan, ref.ssd_scan, args, kw,
                nb, fl, None, key is not None and dtype == "bfloat16", key)
        # prompts of 511 and 4096 tokens fed as calls of at most 64 tokens
        # (8 and 64 calls), each passing on the state (as serving does),
        # against one plain call: does the state's error grow with length?
        # The 4096-token prompt's state is also read after 512, 1024 and
        # 2048 tokens, and once more with A / 100 (a state that remembers
        # thousands of tokens)
        for T, slow in ((511, False), (4096, False), (4096, True)):
            args, kw, _, _ = _ssd_case(torch, gen, dtype, T, 80, 64, 128)
            if slow:
                args = args[:2] + (args[2] / 100,) + args[3:]
            tag = f"mamba2 T{T}" + (" A/100" if slow else "")
            run("ssd_scan", f"{tag} as {-(-T // 64)} calls of 64", dtype,
                lambda *a, **k: _ssd_stitched(ssd_scan, a, k), ref.ssd_scan,
                args, kw, 0, 0, None, False)
            errs = state_err.setdefault(dtype, {}).setdefault(tag, {})
            for n in (T,) if T < 4096 else (512, 1024, 2048, 4096):
                pre = tuple(a if a.dim() == 1 else a[:, :n] for a in args)
                got = _ssd_stitched(ssd_scan, pre, kw)[1]
                errs[n] = rel_err(ref.ssd_scan(*pre, **kw)[1], got)
            del args, kw, pre, got
    results["ssd_scan"]["stitched_state_rel_err"] = state_err
    print(f"[kernel] ssd_scan final state over 64-token calls, rel_err by "
          f"tokens: {state_err}")

    # RMSNorm at the serving path's rows and widths: a 64-token chunk's
    # gated out-norm over d_inner and the decode rows (each timed), block
    # norms, one row, widths that are not whole 16-byte vectors, a row view
    # that starts off a 16-byte boundary
    rms_cases = [
        # label, rows, d, timed under, misaligned view
        ("64x5120 out-norm", 64, 5120, "rmsnorm", False),
        ("64x2560 block", 64, 2560, None, False),
        ("8x2560 decode", 8, 2560, "rmsnorm@8x2560", False),
        ("8x5120 decode out-norm", 8, 5120, "rmsnorm@8x5120", False),
        ("1x5120 row", 1, 5120, None, False),
        ("64x2048 zamba2", 64, 2048, None, False),
        ("64x4096 zamba2 out-norm", 64, 4096, None, False),
        ("3x100 elements", 3, 100, None, False),
        ("8x2560 misaligned view", 8, 2560, None, True),
    ]
    for dtype in ("bfloat16", "float32"):
        for label, rows, d, key, off in rms_cases:
            args, kw, nb, fl = _rms_case(torch, gen, dtype, rows, d, off)
            run("rmsnorm", label, dtype, rmsnorm, ref.rmsnorm, args, kw, nb,
                fl, lambda a=args: F.rms_norm(a[0], (a[0].shape[-1],),
                                              weight=a[1], eps=1e-5),
                key is not None and dtype == "bfloat16", key)

    # the floor that event timing puts under a launch: an empty kernel
    # (one thread that returns at once) timed the same way
    floor_ms = timer.ms(lambda: torch.cuda._sleep(0))
    print(f"[kernel] launch floor (empty kernel, events, L2 flushed): "
          f"{floor_ms:.4f} ms on {card}")
    results["launch_floor_ms"] = floor_ms

    for name, res in results.items():
        if name == "launch_floor_ms":
            continue
        by_dtype = worst[name.split("@")[0]]
        res["max_abs_err"] = max(w["max_abs_err"] for w in by_dtype.values())
        res["rel_err"] = max(w["rel_err"] for w in by_dtype.values())
        res["err_by_dtype"] = by_dtype
        if name.split("@")[0] == "flash_attention":
            res["lse_max_abs_err"] = worst_lse
    print(f"[kernel] flash_attention lse worst max_abs_err {worst_lse}")
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
    counts = {}
    by_kernel = _device_ms(prof, steps, counts)
    eng.run_until_drained()
    busy = sum(by_kernel.values())
    print(f"[profile] {label} tick, 8 rows: host wall {wall_ms:.2f} ms for "
          f"{toks:.1f} tokens ({wall_ms / toks:.2f} ms/token), device busy "
          f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}% of the wall; "
          f"{'measured' if by_kernel else 'no device time seen'})")
    _print_kernels(by_kernel, busy, counts)


def _device_ms(prof, ticks: int = 1, counts: dict = None) -> dict:
    """Device time per tick of each kernel in a ``torch.profiler`` run
    (and, into ``counts``, its launches per tick)."""
    by_kernel = {}
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue                    # operator rows repeat their kernels
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            by_kernel[ev.key] = us / 1e3 / ticks
            if counts is not None:
                counts[ev.key] = ev.count / ticks
    return by_kernel


# the hand-written kernels' share of a profiled tick, by a part of their
# names: the SSM kernels, the paged kernels' instances and the dense
# decode kernel
SHARES = ("ssd_scan", "rmsnorm", "paged_decode", "paged_verify",
          "dense_decode")


def _print_kernels(by_kernel: dict, busy: float, counts: dict,
                   top: int = 8) -> None:
    """The top kernels of a tick, then the hand-written SSM and attention
    kernels' time and launches per tick by name and their share of the
    device busy time."""
    for name, ms in sorted(by_kernel.items(), key=lambda x: -x[1])[:top]:
        print(f"[profile]   {ms:.4f} ms/tick  {name[:90]}")
    for part in SHARES:
        ms = sum(v for k, v in by_kernel.items() if part in k)
        n = sum(v for k, v in counts.items() if part in k)
        if ms:
            print(f"[profile]   {part} kernels {ms:.4f} ms/tick, {n:.1f} "
                  f"launches/tick ({ms / n:.4f} ms each; {100 * ms / busy:.1f}"
                  f"% of the device busy time)")


def profile_prefill(torch, eng, rng, label: str):
    """Where a prefill tick's time goes: one 512-token prompt alone (no
    decoding row), so each tick runs the prefill budget's chunks of it.
    The first tick settles; the host wall of the second, then the device
    time of the third by kernel from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    eng.submit(rng.integers(0, eng.cfg.vocab_size, size=512),
               max_new_tokens=1)
    eng.step()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    tick = eng._tick_log[-1]              # (prefill s, decode s, prefill
    check(tick[2] > 0 and tick[3] == 0,   # tokens, decode rows, tokens)
          f"{label}: the profiled tick is not a prefill tick: {tick}")
    eng.run_until_drained()
    counts = {}
    by_kernel = _device_ms(prof, 1, counts)
    busy = sum(by_kernel.values())
    print(f"[profile] {label} prefill tick, {tick[2]} tokens in chunks of "
          f"{eng.chunk_tokens}: host wall {wall_ms:.2f} ms, device busy "
          f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}% of the wall; "
          f"{'measured' if by_kernel else 'no device time seen'})")
    _print_kernels(by_kernel, busy, counts)


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
# phase 3c: serve full-width mamba2-2.7b and zamba2-1.2b on dense slots
# ---------------------------------------------------------------------------

def phase_ssm_serve(torch, arch: str):
    """Phase 3's traffic (8 random prompts of 4-511 tokens, seed 0, and a
    two-turn pair whose second turn extends the first, 32 new tokens each)
    on the dense-slot plane: 8 slots, exact-length chunks of at most 64
    tokens resuming each request's staging cache, random bf16 weights
    from a seed.  Every kernel of the path launched exactly: the SSD scan
    once per Mamba2 layer per chunk, RMSNorm once per norm per chunk and
    decode step, and for the hybrid flash attention once per shared-block
    application per chunk and the dense decode kernel once per
    application per decode step.  Then a profiled decode tick."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config(arch)
    n_attn = (cfg.num_layers // cfg.hybrid_attn_every
              if cfg.family == "hybrid" else 0)
    norms = 2 * cfg.num_layers + 2 * n_attn + 1
    t0 = time.monotonic()
    eng = ServingEngine(cfg, max_slots=8, max_seq=1024, prefill_chunk=64,
                        seed=0, device="cuda")
    eng.warmup()
    check(not eng.paged, f"{arch} must serve on dense slots")
    print(f"[{arch}] {cfg.num_layers}L d{cfg.d_model} ({cfg.family}, "
          f"{n_attn} attention applications) bf16 on cuda, dense slots: "
          f"init {time.monotonic() - t0 - eng.warmup_s:.1f}s, warmup "
          f"{eng.warmup_s:.2f}s, params {cfg.num_params() / 1e9:.3f} B, "
          f"slot tree {eng.kv.capacity_bytes() / 2**30:.2f} GiB")
    rng = np.random.default_rng(0)
    lens = [int(rng.integers(4, 512)) for _ in range(8)]
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lens]
    shared = rng.integers(0, cfg.vocab_size, size=256)
    first_turn = np.concatenate([shared,
                                 rng.integers(0, cfg.vocab_size, size=10)])
    counters = ((ss, "ssd_scan"), (rn, "rmsnorm"), (fa, "flash_attention"),
                (da, "decode_attention"))
    for mod, fn in counters:              # count the traffic's launches only
        getattr(mod, fn).launches = 0
    t0 = time.monotonic()
    with eng:
        handles = [eng.submit(p, max_new_tokens=32) for p in prompts]
        r1 = eng.submit(first_turn, max_new_tokens=32).result(timeout=600)
        follow = np.concatenate([first_turn, np.asarray(r1.generated),
                                 rng.integers(0, cfg.vocab_size, size=8)])
        h2 = eng.submit(follow, max_new_tokens=32)
        done = [h.result(timeout=600) for h in handles + [h2]] + [r1]
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {fn: getattr(mod, fn).launches for mod, fn in counters}
    st = eng.stats()
    check(not eng.failed and st["failed"] == 0,
          f"failed requests: {[r.error for r in eng.failed.values()]}")
    check(len(done) == 10 and all(len(r.generated) == 32 for r in done),
          "every request must complete with 32 tokens")
    chunks, steps = st["prefill_chunks"], st["decode_steps"]
    check(chunks == sum(-(-len(r.prompt) // 64) for r in done),
          f"{chunks} chunks: stateful chunks must be exact and <= 64")
    want = {"ssd_scan": cfg.num_layers * chunks,
            "rmsnorm": norms * (chunks + steps),
            "flash_attention": n_attn * chunks,
            "decode_attention": n_attn * steps}
    check(launches == want, f"launches {launches} != {want} ({chunks} "
          f"chunks, {steps} decode steps)")
    check(launches["ssd_scan"] > 0 and launches["rmsnorm"] > 0,
          "a kernel never ran on the main path")
    toks = sum(len(r.generated) for r in done)
    print(f"[{arch}] {len(done)} requests, {toks} tokens in {wall:.2f}s "
          f"({toks / wall:.1f} tok/s); prompts {lens} + pair "
          f"{len(first_turn)}/{len(follow)}")
    print(f"[{arch}] ttft p50 {st['p50_ttft_s'] * 1e3:.1f} ms p95 "
          f"{st['p95_ttft_s'] * 1e3:.1f} ms; decode tick p50 "
          f"{st['p50_decode_tick_s'] * 1e3:.2f} ms p95 "
          f"{st['p95_decode_tick_s'] * 1e3:.2f} ms; prefill tick p50 "
          f"{st['p50_prefill_tick_s'] * 1e3:.2f} ms")
    print(f"[{arch}] {chunks} chunks, {steps} decode steps, launches "
          f"{launches} (exact)")
    profile_decode(torch, eng, rng, label=f"{arch} decode")
    profile_prefill(torch, eng, rng, arch)
    del eng
    torch.cuda.empty_cache()
    return launches, len(done)


# ---------------------------------------------------------------------------
# phase 3d: the edge system
# ---------------------------------------------------------------------------

EDGE_STATE = os.path.join(ROOT, "build", "edge_state.json")


def _edge_traffic(torch, system, heavy, light, scfg, params_light):
    """The paper's fig 1 mix through ``submit_many``, 16 rounds: every
    round one single-stream decode step of edge-stream-light (the decode
    image), every other round a stream record batch (the stream image),
    every fourth a ``cv-infer`` frame (32 tokens in, argmax out, through
    the heavy container).  The decode steps and the stream state chain
    from round to round."""
    from repro_torch.core import Workload, WorkloadKind
    from repro_torch.data import stream as stream_lib
    from repro_torch.models.model import build_model

    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    records = stream_lib.make_record_stream(scfg)
    state = stream_lib.init_state(scfg, dev)
    tok = torch.tensor([1], dtype=torch.int32, device=dev)
    caches = build_model(light, dev).init_caches(1, 128, light.cdtype)
    clen = torch.zeros((1,), dtype=torch.int32, device=dev)
    fed, tokens, results = [], [], []
    for r in range(16):
        # after the first step the image holds the params and this
        # stream's caches: only the token and length are copied in
        items = [(Workload(f"step{r}", WorkloadKind.DECODE, light, batch=1),
                  (params_light, tok, caches, clen))]
        if r % 2 == 0:
            rec = next(records)
            fed.append(rec)
            items.append((Workload(f"records{r}", WorkloadKind.STREAM),
                          (state, stream_lib.to_device(rec, dev))))
        if r % 4 == 0:
            frame = torch.as_tensor(
                rng.integers(0, heavy.vocab_size, size=(1, 32)), device=dev)
            items.append((Workload(f"frame{r}", WorkloadKind.GENERIC, heavy,
                                   batch=1, seq_len=32,
                                   est_flops=2.0 * heavy.num_params() * 32
                                   * 300), (frame,)))
        out = system.submit_many(items)
        results += list(zip((w for w, _ in items), out))
        tok, caches, clen = out[0].output
        tokens.append(int(tok[0]))
        if r % 2 == 0:
            state, analytics = out[1].output
        if r % 4 == 0:
            pred = out[2].output
            check(tuple(pred.shape) == (1, 32) and pred.dtype == torch.int32
                  and 0 <= int(pred.min()) and
                  int(pred.max()) < heavy.vocab_size,
                  f"cv-infer frame {r}: bad predictions")
    return results, tokens, fed, state, analytics


def phase_edge(torch):
    """The paper's hybrid system on the card: an ``EdgeSystem`` of two
    logical nodes sharing cuda:0, each given half of the card's memory,
    ``LeastLoadedPolicy``; the standard builder set over full-width
    tinyllama-1.1b (the heavy ``cv-infer`` container) and edge-stream-light
    (the light decode image), random weights from a seed, bf16 compute;
    the ``cv-infer`` and ``stream-analytics`` specs and a light decode
    spec; the mixed traffic of ``_edge_traffic``; a node loss; and the
    engine service, deployed by ``launch/serve.py`` at full width and
    restored from its saved state."""
    from repro_torch.configs import get_config
    from repro_torch.core import (EdgeSystem, LeastLoadedPolicy,
                                  NodeCapacity, ServiceSpec, Workload,
                                  WorkloadClass, WorkloadKind, classify)
    from repro_torch.core.spec import EXECUTOR_FOR_CLASS
    from repro_torch.data import stream as stream_lib
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model
    from repro_torch.serving import router
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.monotonic()
    dev = torch.device("cuda", torch.cuda.current_device())
    total = torch.cuda.get_device_properties(dev).total_memory
    system = EdgeSystem(policy=LeastLoadedPolicy())
    for i in range(2):
        system.add_node(f"edge{i}", NodeCapacity(hbm_bytes=total // 2),
                        mesh=dev)
    print(f"[edge] nodes edge0, edge1 on {dev}, {total // 2} B each (half "
          f"of the card's {total} B)")
    heavy, light = get_config("tinyllama-1.1b"), get_config(
        "edge-stream-light")
    check(heavy.cdtype == light.cdtype == torch.bfloat16, "bf16 compute")
    params_heavy = build_model(heavy, dev).init(
        torch.Generator(device=dev).manual_seed(0))
    params_light = build_model(light, dev).init(
        torch.Generator(device=dev).manual_seed(1))
    scfg = stream_lib.StreamConfig()
    router.assemble_edge_system(system, heavy, light, scfg,
                                params_heavy=params_heavy,
                                params_light=params_light, device=dev)
    specs = router.standard_specs(heavy) + (ServiceSpec(
        name="light-decode",
        workload=Workload("light-decode", WorkloadKind.DECODE, light,
                          batch=1, seq_len=1)),)
    t0 = time.monotonic()
    for spec in specs:
        system.apply(spec)
    deps = system.orchestrator.deployments.values()
    print(f"[edge] applied {[s.name for s in specs]} in "
          f"{time.monotonic() - t0:.2f}s: "
          f"{[(d.name, d.node_id) for d in deps]}")
    for spec in specs:
        check(sum(e.startswith(f"deploy {spec.name}/")
                  for e in system.events) == 1,
              f"{spec.name} must be deployed exactly once: {system.events}")
    check(system.registry.stats()["builds"] == 2,
          f"two images (stream, decode): {system.registry.stats()}")
    dex = system.instances("light-decode")[0].executor
    img = dex.image
    simg = system.instances("stream-analytics")[0].executor.image
    check(img.captured and simg.captured,
          "the unikernel images must be captured CUDA graphs")
    check(img.captured_launches == {"decode_attention": light.num_layers},
          f"the decode image captured {img.captured_launches}, not one "
          f"decode kernel per layer")
    check(simg.captured_launches == {}, "the stream image runs no kernel")
    print(f"[edge] decode image: captured in {img.build_time_s:.3f}s, "
          f"args {img.arg_bytes} B, graph {img.temp_bytes} B allocated "
          f"({img.pool_bytes} B pool reserved), outputs "
          f"{img.output_bytes} B; launches per replay "
          f"{img.captured_launches}")

    # the traffic, with every kernel count at 0 just before it, in a
    # profiler trace: the graph's kernels are counted there (a wrapper
    # counts its launch at the capture only)
    fa.flash_attention.launches = da.decode_attention.launches = 0
    pda.paged_decode_attention.launches = 0
    replays0 = img.replays
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        results, tokens, fed, state, analytics = _edge_traffic(
            torch, system, heavy, light, scfg, params_light)
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    replays = img.replays - replays0
    frames = sum(w.kind is WorkloadKind.GENERIC for w, _ in results)
    launches = {"flash_attention": fa.flash_attention.launches,
                "paged_decode_attention":
                    pda.paged_decode_attention.launches,
                "decode_attention": da.decode_attention.launches}
    check(all(not isinstance(r, Exception) for _, r in results),
          "every dispatch must complete")
    service = {WorkloadKind.GENERIC: "cv-infer",
               WorkloadKind.STREAM: "stream-analytics",
               WorkloadKind.DECODE: "light-decode"}
    for w, r in results:
        want = classify(w)
        ex = system.instances(r.service)[0].executor
        check(r.workload_class is want and r.service == service[w.kind]
              and ex.executor_class is EXECUTOR_FOR_CLASS[want]
              and not r.deployed_fresh,
              f"{w.name} routed to {r.service} ({r.workload_class}), "
              f"classify says {want}")
    check(replays == 16, f"{replays} decode replays for 16 steps")
    check(launches["decode_attention"] == 0,
          "the decode kernel ran outside the graph")
    check(launches["flash_attention"] == heavy.num_layers * frames,
          f"flash launches {launches['flash_attention']} != "
          f"{heavy.num_layers} x {frames} frames")
    # the graph's launches, read from the trace: the capture's, once per
    # layer, at each replay
    counts = {}
    _device_ms(prof, 1, counts)
    seen = int(sum(v for k, v in counts.items() if "dense_decode" in k))
    want = img.captured_launches["decode_attention"] * replays
    check(seen == want, f"the trace holds {seen} dense decode kernels in "
          f"{replays} replays, not {want}")
    launches["decode_attention"] = seen
    print(f"[edge] trace of the traffic: {seen} dense decode kernels in "
          f"{replays} replays (= {img.captured_launches['decode_attention']}"
          f" captured x {replays})")
    allrec = {k: np.concatenate([r[k] for r in fed]) for k in fed[0]}
    avg, mx, arg = stream_lib.reference_analytics(allrec, scfg.num_users)
    err = rel_err(torch.as_tensor(avg),
                  analytics["avg_steps_per_user"].cpu())
    check(err < 1e-5 and abs(float(analytics["max_avg_steps"]) - mx)
          <= 1e-5 * mx and int(analytics["argmax_user"]) == arg,
          f"stream analytics off the reference: rel_err {err}")
    print(f"[edge] {len(results)} dispatches ({frames} cv frames, "
          f"{len(fed)} record batches, 16 decode steps) in {wall:.2f}s "
          f"under the profiler; "
          f"analytics over {len(allrec['user_id'])} records rel_err "
          f"{err:.3e}, max avg steps {mx:.1f} (user {arg})")

    # the image's tokens against eager Model.decode: the same kernels
    model = build_model(light, dev)
    etok = torch.tensor([1], dtype=torch.int32, device=dev)
    ecaches = model.init_caches(1, 128, light.cdtype)
    eclen = torch.zeros((1,), dtype=torch.int32, device=dev)
    eager = []
    with torch.no_grad():
        for _ in range(16):
            logits = model.decode(params_light, etok, ecaches, eclen)
            etok = torch.argmax(logits, dim=-1).to(torch.int32)
            eclen = eclen + 1
            eager.append(int(etok[0]))
    check(eager == tokens, f"image tokens {tokens} != eager {eager}")
    print(f"[edge] decode image tokens equal eager Model.decode's over 16 "
          f"steps: {tokens}")

    summ = system.stats.summary()
    for wc in ("heavy", "light"):
        s = summ[wc]
        print(f"[edge] {wc} dispatches: {s['count']}, p50 "
              f"{s['p50_wall_s'] * 1e3:.3f} ms, p95 "
              f"{s['p95_wall_s'] * 1e3:.3f} ms")
    for d in system.orchestrator.deployments.values():
        print(f"[edge] {d.name} on {d.node_id} "
              f"({d.executor.executor_class.value}): static "
              f"{d.executor.footprint_bytes()} B, dynamic "
              f"{d.executor.dynamic_footprint_bytes()} B")
    # the stream task on a container, for the paper's fig 5 comparison:
    # its state and batch plus the peak an eager step allocates
    cex, _ = router.make_stream_container_builder(scfg, device=dev)(
        Workload("fitbit", WorkloadKind.STREAM), dev)
    cargs = (stream_lib.init_state(scfg, dev),
             stream_lib.to_device(next(stream_lib.make_record_stream(scfg)),
                                  dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    cex.dispatch(Workload("fitbit", WorkloadKind.STREAM), cargs)
    peak = torch.cuda.max_memory_allocated(dev) - base
    cbytes = sum(t.numel() * t.element_size() for part in cargs
                 for t in part.values()) + peak
    print(f"[edge] stream task footprint: unikernel image "
          f"{simg.footprint_bytes} B (args {simg.arg_bytes} B + graph "
          f"{simg.temp_bytes} B; pool {simg.pool_bytes} B reserved) vs "
          f"container {cbytes} B (args + an eager step's peak {peak} B; "
          f"the container's static footprint is "
          f"{cex.footprint_bytes()} B)")

    # per step: a replay against an eager Model.decode step, 64 steps
    # each from a fresh cache, one sync at the end
    for name in ("replay", "eager"):
        tok = torch.tensor([1], dtype=torch.int32, device=dev)
        caches = model.init_caches(1, 128, light.cdtype)
        clen = torch.zeros((1,), dtype=torch.int32, device=dev)
        times = []
        for _ in range(2):                  # the second pass is timed
            torch.cuda.synchronize()
            t0 = time.monotonic()
            with torch.no_grad():
                for _ in range(64):
                    if name == "replay":
                        tok, caches, clen = img(params_light, tok,
                                                caches, clen)
                    else:
                        logits = model.decode(params_light, tok, caches,
                                              clen)
                        tok = torch.argmax(logits, -1).to(torch.int32)
                        clen = clen + 1
            torch.cuda.synchronize()
            times.append((time.monotonic() - t0) * 1e3 / 64)
            clen = torch.zeros_like(clen)
        print(f"[edge] decode step, {name}: {times[1]:.4f} ms/step")
    # a node loss: the stream instance redeploys on the other node, from
    # the registry
    lost = system.instances("stream-analytics")[0].node_id
    builds, hits = system.registry.builds, system.registry.hits
    moved = system.on_node_loss(lost)
    check("stream-analytics/0" in moved, f"failover moved {moved}")
    rec = next(stream_lib.make_record_stream(scfg))
    r = system.submit(Workload("after-loss", WorkloadKind.STREAM),
                      (state, stream_lib.to_device(rec, dev)))
    check(r.node_id != lost and r.service == "stream-analytics",
          f"record batch after the loss ran on {r.node_id}")
    check(system.registry.builds == builds and system.registry.hits > hits,
          f"failover must hit the registry: {system.registry.stats()}")
    print(f"[edge] lost {lost}: moved {moved}, next batch on {r.node_id}, "
          f"registry {system.registry.stats()}")
    units = len(results)
    del system, dex, img, simg, cex, params_heavy
    torch.cuda.empty_cache()

    # the engine service, deployed by launch/serve.py at full width
    os.makedirs(os.path.dirname(EDGE_STATE), exist_ok=True)
    fa.flash_attention.launches = pda.paged_decode_attention.launches = 0
    esys = serve.main(["--arch", "tinyllama-1.1b", "--requests", "8",
                       "--slo-ms", "60000", "--save-state", EDGE_STATE,
                       "--device", "cuda"])
    torch.cuda.synchronize()
    served = {"flash_attention": fa.flash_attention.launches,
              "paged_decode_attention": pda.paged_decode_attention.launches}
    (dep,) = esys.instances("llm-serving")
    eng = dep.executor.engine
    st = eng.stats()
    L = heavy.num_layers
    check(st["failed"] == 0 and len(eng.completed) == 8,
          "launch/serve.py's 8 requests must complete")
    # serve.py's warmup runs every chunk bucket and one decode step
    check(served["flash_attention"] ==
          L * (st["prefill_chunks"] + len(eng.chunk_buckets)),
          f"serve flash launches {served} vs {st['prefill_chunks']} chunks "
          f"+ {len(eng.chunk_buckets)} warmup buckets")
    check(served["paged_decode_attention"] == L * (st["decode_steps"] + 1),
          f"serve paged launches {served} vs {st['decode_steps']} steps + 1")
    print(f"[edge] serve: {st['prefill_chunks']} chunks + "
          f"{len(eng.chunk_buckets)} warmup, {st['decode_steps']} decode "
          f"steps + 1 warmup, launches {served} (exact); footprint static "
          f"{dep.executor.footprint_bytes()} B, dynamic "
          f"{dep.executor.dynamic_footprint_bytes()} B")
    with open(EDGE_STATE) as f:
        saved = json.load(f)
    del esys, dep, eng
    torch.cuda.empty_cache()
    fresh = EdgeSystem()
    fresh.add_node("edge0")
    fresh.register_builder("decode", WorkloadClass.HEAVY,
                           router.make_engine_builder(
                               heavy, max_slots=4, max_seq=128, device=dev))
    applied = fresh.restore(EDGE_STATE)
    check(applied == [s["name"] for s in saved["specs"]] and
          [s.to_dict() for s in fresh.manager.specs.values()]
          == saved["specs"] and len(fresh.instances("llm-serving")) == 1,
          f"restore applied {applied}, not the saved spec set")
    print(f"[edge] restored {applied} from {EDGE_STATE} on a fresh "
          f"EdgeSystem; phase {time.monotonic() - t_phase:.1f}s")
    del fresh
    torch.cuda.empty_cache()
    for k, v in served.items():
        launches[k] += v
    return launches, units + 8


# ---------------------------------------------------------------------------
# phase 4c: the SSM families in fp32 at full width
# ---------------------------------------------------------------------------

def phase_ssm_consistency(torch):
    """mamba2-2.7b (2 layers) and zamba2-1.2b (3 layers: one super-block
    of 2 Mamba2 layers and the shared attention block, then 1 trailing
    layer) at full width in fp32, random weights: the prompt's logits and
    final SSM states from exact chunks of 64 against one monolithic
    prefill, and every decode step's logits against ``Model.forward``
    over the same prefix (the decode path runs the kernels' norms, the
    forward the plain ones), within 2e-4 relative."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    for arch, over in (("mamba2-2.7b", dict(num_layers=2)),
                       ("zamba2-1.2b", dict(num_layers=3,
                                            hybrid_attn_every=2))):
        cfg = dataclasses.replace(get_config(arch), compute_dtype="float32",
                                  **over)
        model = Model(cfg, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(1))
        rng = np.random.default_rng(1)
        worst = {"chunked": 0.0, "state": 0.0, "decode": 0.0}
        flips, steps = 0, 8
        with torch.no_grad():
            for n in (40, 150):
                seq = list(rng.integers(0, cfg.vocab_size, size=n))
                toks = torch.tensor([seq], device="cuda")
                mono = model.init_caches(1, 512, torch.float32)
                want, _ = model.prefill(params, {"tokens": toks}, mono)
                staging = model.init_caches(1, 512, torch.float32)
                for c0 in range(0, n, 64):
                    c1 = min(c0 + 64, n)
                    lg = model.prefill_chunk(
                        params, {"tokens": toks[:, c0:c1]}, staging,
                        torch.tensor([c0], device="cuda"),
                        torch.tensor([c1], device="cuda"))
                worst["chunked"] = max(worst["chunked"], rel_err(want, lg))
                key = "mamba" if cfg.family == "ssm" else "mamba_tail"
                worst["state"] = max(worst["state"], rel_err(
                    mono[key]["ssm"], staging[key]["ssm"]))
                clen = torch.tensor([n], device="cuda", dtype=torch.int32)
                nxt = torch.argmax(lg, dim=-1).to(torch.int32)
                for _ in range(steps):
                    seq.append(int(nxt[0]))
                    dec = model.decode(params, nxt, staging, clen)
                    clen = clen + 1
                    full = model.forward(params, {"tokens": torch.tensor(
                        [seq], device="cuda")})[0, -1]
                    worst["decode"] = max(worst["decode"],
                                          rel_err(full, dec[0]))
                    if int(torch.argmax(dec[0])) != int(torch.argmax(full)):
                        top2 = torch.topk(full, 2).values
                        check(float(top2[0] - top2[1]) <= 1e-3,
                              "greedy token differs at a clear margin")
                        flips += 1
                    nxt = torch.argmax(dec, dim=-1).to(torch.int32)
        print(f"[ssm-consistency] {arch} fp32 full width, "
              f"{cfg.num_layers} layers, prompts 40/150 in chunks of 64, "
              f"{steps} decode steps each: chunked vs monolithic logits "
              f"{worst['chunked']:.3e}, SSM state {worst['state']:.3e}, "
              f"decode vs forward {worst['decode']:.3e} (bound 2e-4), "
              f"near-tie flips {flips}")
        check(max(worst.values()) < 2e-4, f"{arch}: {worst} >= 2e-4")
        del model, params
        torch.cuda.empty_cache()


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

    # the dense-slot plane: reduced mamba2 and zamba2 served by the JAX
    # engine, all four prompts at once on two slots in exact chunks
    skw = json.loads(str(g["stateful_engine"]))
    for fam in ("ssm", "hybrid"):
        scfg = ModelConfig.from_dict(json.loads(str(g[f"{fam}_config"])))
        sparams = tree(f"{fam}_params/", scfg)
        seng = ServingEngine(scfg, params=sparams, device="cuda", **skw)
        for p, n in zip(g["prompts"], g["prompt_lens"]):
            seng.submit(p[:n], max_new_tokens=int(g["max_new"]))
        done = sorted(seng.run_until_drained(), key=lambda r: r.rid)
        check(not seng.failed and not seng.paged,
              f"golden {fam}: a request failed")
        check([r.generated for r in done] == g[f"{fam}_streams"].tolist(),
              f"golden {fam} streams differ:\n"
              f"{[r.generated for r in done]}\n"
              f"{g[f'{fam}_streams'].tolist()}")
        worst = 0.0
        with torch.no_grad():
            for p, n, want in zip(g["prompts"], g["prompt_lens"],
                                  g[f"{fam}_first_logits"]):
                lg = seng.model.forward(seng.params, {"tokens": torch.tensor(
                    p[None, :n].astype(np.int64), device="cuda")})[0, -1]
                w = torch.tensor(want, device="cuda")
                worst = max(worst, float((lg - w).abs().max()
                                         / w.abs().max()))
        print(f"[golden] {scfg.name} ({fam}, {scfg.num_layers}L "
              f"d{scfg.d_model}): the JAX engine's {len(done)} dense-slot "
              f"streams reproduced on the card (fp32); last-position "
              f"logits max rel err {worst:.3e} (bound 2e-4)")
        check(worst < 2e-4, f"golden {fam} logits {worst} >= 2e-4")


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
    # bf16 attention runs on the tensor-core kernels, once a layer each
    for kname in ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                  "flash_bwd_dkv_wgmma_kernel"):
        ms = sum(t for name, (t, _) in by_kernel.items() if kname in name)
        n = sum(c for name, (_, c) in by_kernel.items() if kname in name)
        print(f"[profile]   {kname}: {ms:.3f} ms over {n} launches")
        check(n == cfg.num_layers, f"the profiled step ran {kname} {n} "
              f"times, not {cfg.num_layers}")

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
        route="cuda", source="src/repro_torch/csrc/paged_attention.cuh",
        entry="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:99"),
    "flash_attention_bwd_dq": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention_bwd.py:198"),
    "flash_attention_bwd_dkv": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention_bwd.py:228"),
    "ssd_scan": dict(
        route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:119"),
    "rmsnorm": dict(
        route="cuda", source="src/repro_torch/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:41"),
}
# the paths each kernel's launch count comes from, and each path's unit
PATH_OF = {"flash_attention": ("serve", "edge"),
           "paged_decode_attention": ("serve", "edge"),
           "paged_verify_attention": ("spec",),
           "decode_attention": ("spec", "zamba2", "edge"),
           "flash_attention_bwd_dq": ("train",),
           "flash_attention_bwd_dkv": ("train",),
           "ssd_scan": ("mamba2",), "rmsnorm": ("mamba2",)}
UNIT_OF = {"serve": "request", "spec": "request", "train": "step",
           "mamba2": "request", "zamba2": "request", "edge": "dispatch"}


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
    paths = {"serve": phase_serve(torch), "spec": phase_spec_serve(torch),
             "mamba2": phase_ssm_serve(torch, "mamba2-2.7b"),
             "zamba2": phase_ssm_serve(torch, "zamba2-1.2b"),
             "edge": phase_edge(torch)}
    phase_consistency(torch)
    phase_ssm_consistency(torch)
    phase_spec_exactness(torch)
    phase_golden(torch)
    paths["train"] = phase_train(torch)
    phase_train_consistency(torch)
    phase_golden_train(torch)
    line = []
    for name, meta in KERNELS.items():
        k = kernels[name]
        by_path = {}
        for path in PATH_OF[name]:
            launches, n_units = paths[path]
            by_path[path] = {"launches": launches[name],
                             f"per_{UNIT_OF[path]}": launches[name] / n_units}
        line.append({"name": name, **meta,
                     "launches": sum(v["launches"] for v in by_path.values()),
                     "launches_by_path": by_path,
                     **{key: k[key] for key in (
                         "max_abs_err", "rel_err", "err_by_dtype", "ms",
                         "plain_ms", "bound_ms", "bound_by", "library_ms")},
                     "timed_shape": k["shape"], "timed_dtype": k["dtype"],
                     **({"lse_max_abs_err": k["lse_max_abs_err"]}
                        if "lse_max_abs_err" in k else {}),
                     **({f"train_{key}": kernels[f"{name}@train"][key]
                         for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms", "shape", "tile_share")}
                        if f"{name}@train" in kernels else {}),
                     "also_timed": [
                         {key: kernels[k][key] for key in (
                             "shape", "ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms")}
                         for k in sorted(kernels)
                         if k.startswith(f"{name}@") and k != f"{name}@train"],
                     **({"stitched_state_rel_err":
                         k["stitched_state_rel_err"]}
                        if "stitched_state_rel_err" in k else {}),
                     "launch_floor_ms": kernels["launch_floor_ms"]})
    print(f"[done] all phases passed in {time.monotonic() - t_start:.1f}s "
          f"on {card}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
