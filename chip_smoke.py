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
   kernels and every wgmma instance of the flash forward and of the
   flash backward's dq and dk/dv kernels, one for each head dim they
   take (the forward's and the backward's 32, 48, 64, 80, 128, 192 and
   256, and keys of 192 over values of 128; registers and spills
   printed), and MLA's absorbed-decode wgmma kernel (keys 576, values
   512), and no fp32 one; the paged,
   verify and dense decode kinds at D 192 and 256 in bf16 and fp32, over
   int8 pools too for the paged kinds, registers and spills printed),
   TF32 off for matmuls and cuDNN;
2. kernels: each kernel against its plain PyTorch version on the card at
   the serving path's shapes (bf16 and fp32, window and softcap variants,
   int8 pools for the paged kernels, K1 of 1, 2 and 5 for the verify
   kernel, which at K1 = 1 is also held against the paged decode kernel;
   both paged kernels timed at B 8 over 64 table entries, at B 1 with one
   543-token sequence and at B 8 over 256 entries with lengths 1024-4095,
   paged decode also at the fleet's 4 slots over 8 entries (phase 3e,
   with B 1 and rows of 1-16 and 128 keys checked there), and flash
   attention at the fleet's prefill chunks (64 queries after a shared
   prefix of 16 or 48 tokens over 128 keys timed; first chunks and
   tails over 64 or 128 keys);
   the dense decode kernel timed at the draft's G 8, at zamba2's G 1 and
   at the edge decode image's G 2 (B 1, S 128), and at the dense
   variants' head dims (phase 3g): flash at gemma-2b's 64-token chunk
   after 448 keys (Hq 8, Hkv 1, D 256) and nemotron-4-340b's (Hq 96, Hkv
   8, D 192), each with a first chunk, a window, a softcap and a ragged
   tail; paged decode at B 8 over MP 64 for both, on bf16 and int8 pools;
   verify at K1 1, 2 and 5 at D 256; the gemma draft's dense decode (G 8,
   D 256) with lengths of 0, S and past S, each timed shape against SDPA,
   and checked with lengths of 0, of S and past S), and at mixtral-8x7b's
   (phase 3h): flash over a 4608-token prompt under the 4096-key window
   (B 1, Hq 32, Hkv 8, D 128; also 4600 tokens, and 4200 with 4100
   valid) and the dense decode kernel over 8 rings of 4096 at G 4, full
   or wrapped (lengths past S), both timed against SDPA with the explicit
   windowed or length mask, and rings filling; at deepseek-v2-236b's
   (phase 3i): flash at q/k 192 and v 128 over its 512-token bucket (B 1,
   128 heads, causal; also 64, a ragged 256, a softcap, GQA, non-causal)
   and the dense decode kernel at keys 576 and values 512 under one KV
   head at G 128 (B 8 over 1024 slots with lengths 36-543, and over 8
   full caches of 4096; lengths 0, S and past S, a softcap, G 4 and 16,
   values of their own), each timed shape against SDPA on the first of
   its cuDNN, memory-efficient and math backends that takes it (named);
   flash attention
   non-causal at G 1 at the encoders' shapes, each timed against one
   non-causal SDPA: the cv frame (B 1, T 32, 12 heads of 64), a hubert
   batch (B 8, T 500, 16 heads of 80) and fig 3's widest app (B 1, T 64,
   8 heads of 48), with causal and ragged cases at D 48 and 80,
   the forward (with lse, as the train step runs it) and the backward
   kernels at the train step's (causal, non-causal, window, softcap, an
   empty row, G 1, 8, 12 and 96, Tq < Tk, D 32/64/128, packed positions
   that restart mid-row, T 129; at the train shape the share of 64 x 64
   tiles computed, the useful TFLOP/s of each, the forward against one
   causal SDPA forward and the two backward kernels against SDPA's one
   backward), the backward at the encoders' widths (D 48 and 80:
   non-causal and causal, G 1 and GQA, ragged T, an empty row, softcap,
   explicit, packed and index positions; the forward's lse with them),
   timed at hubert-xlarge's train shape (B 8, T 500, 16 heads of 80,
   non-causal, G 1: the forward with lse, dq and dk/dv, against one
   maskless SDPA forward and backward), the backward (and the forward's
   lse) at (key, value) head dims (256, 256), (192, 192) and (192, 128):
   causal and non-causal, a window, a softcap, an empty row and ragged
   lengths, Tq < Tk, packed and index positions, G 1, gemma-2b's G 8
   over one KV head, nemotron-4-340b's G 12 and deepseek's Hq = Hkv =
   128, timed at gemma-2b's train shape (B 2, T 1024, 8 heads over 1, D
   256), nemotron's heads (B 1, T 1024, 96 over 8, D 192) and deepseek's
   (B 2, T 512, 128 heads, 192/128) against SDPA's forward and backward
   on the first of its cuDNN, flash, memory-efficient and math backends
   that takes the shape (named), the SSD scan
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
3g. the dense variants (after 3f): full-width gemma-2b (18 layers, fp32
   parameters, bf16 compute, random weights from a seed) with phase 3's
   traffic, flash launched 18 x the chunks at D 256 and paged decode 18
   x the decode steps, a radix hit and a COW copy, a profiled decode
   tick; then speculatively over int8 pages (``spec_k_max`` 4, a draft of
   its first 2 layers, residual writes zeroed): verify 18 x the rounds,
   the draft's dense decode at D 256, acceptance printed; then
   ``launch/serve.py --arch gemma-2b`` (4 requests, launches exact);
   command-r-35b (8 of 40 layers), chameleon-34b (8 of 48) and
   nemotron-4-340b (2 of 96) at full width with bf16 parameters, 4
   requests of 4-511 tokens and 16 new tokens each, launches exact, peak
   memory printed;
3h. mixtral-8x7b (after 3g): 8 of its 32 layers at full width (d 4096,
   32 heads of 128 over 8 KV heads, 8 experts of 14336, top 2, window
   4096), bf16 parameters, random weights from a seed, on the dense-slot
   plane (8 slots, max_seq 8192, rings of 4096): 10 prompts of 4-511
   tokens and one of 4600, 32 new tokens each, each prompt prefilled once
   at its exact length; every request completes, flash launched 8 x the
   prefills and the dense decode kernel 8 x the decode steps; tokens/s,
   TTFT, tick walls, peak memory and a profiled decode tick with the MoE
   dispatch's, expert FFN's and combine's device time; then a 2-layer
   fp32 mixtral at full width (capacity factor 8, no drops) serves a
   4600-token prompt plus 16 tokens through the ring wrap, each token the
   argmax of one ``Model.forward`` over the whole sequence;
3i. deepseek-v2-236b (after 3h, whose memory is freed first): 4 of its 60
   layers at full width (the dense one and 3 MoE: d 5120, 128 heads of
   MLA with kv_lora 512, 160 experts of 1536, top 6, 2 shared), bf16
   parameters, random weights from a seed, on the dense-slot plane (8
   slots, max_seq 1024): phase 3's 10 prompts of 4-511 tokens, 32 new
   tokens each, each prompt prefilled once, whole, in its pow2 bucket;
   every request completes, flash launched 4 x the prefills and the
   dense decode kernel 4 x the decode steps (no paged kernel); tokens/s,
   TTFT, tick walls, peak memory at init and under traffic, and a
   profiled decode tick with the expert GEMMs', the latent-key copies'
   (``mla.kv_cat``) and the dense decode kernel's device time;
3d. the edge system: ``EdgeSystem`` with two logical nodes on cuda:0
   (half of the card's memory each, ``LeastLoadedPolicy``), the standard
   builders over full-width edge-cv-heavy (heavy, the paper's CV
   container workload) and edge-stream-light (light), random bf16
   weights from a seed, the ``cv-infer``, ``stream-analytics`` and a
   light decode spec; 16 rounds of mixed ``submit_many`` traffic (cv
   frames of [1, 32, 256] features through the container's non-causal
   flash forward, predictions in [0, 1000), record batches through the
   stream image, decode steps through the decode image, a captured CUDA
   graph): every dispatch
   completes and routes as ``classify`` says, each service deployed
   once, the analytics within 1e-5 of ``reference_analytics``, the
   image's tokens equal to eager ``Model.decode``'s, flash launched 12 x
   the frames and the dense decode kernel 4 x the replays (the capture's
   launches, cross-checked in a ``torch.profiler`` trace of 3 replays);
   per-class dispatch p50/p95, footprints, the stream task's footprint
   on the image and on a container, the capture time, replay against
   eager ms per step; a node loss redeploys the stream instance from the
   registry; then ``launch/serve.py`` with full-width tinyllama-1.1b (8
   requests, ``--save-state``), flash and paged decode launches exact,
   and a fresh ``EdgeSystem`` restores the saved spec set;
3e. the fleet: ``EdgeSystem`` with two logical nodes on cuda:0 (half of
   the card's memory each), two full-width tinyllama-1.1b replicas (one
   parameter tree from a seed, bf16) deployed by ``deploy_fleet``; the
   JAX package's ``fleet_trace()`` (its fingerprint checked) replayed
   through ``run_fleet_replay`` under affinity, round-robin, and affinity
   with a stall of replica 0 and the loss of node edge1 (failover builds
   a third engine; edge1 rejoins at the end): every request completes or
   is requeued, no GUARANTEED request is dropped, affinity's hit rate is
   above round-robin's, flash launched 22 x the chunks and paged decode
   22 x the decode steps over every engine built (warmups included);
   SLO attainment, latency percentiles, goodput, the router's counters,
   the failover's redeploy time and peak memory; after the chaos replay
   replica 0 is stalled once more and a request of a session it holds
   must be served by replica 1 while the stall lasts, counted as one
   stall evasion; then two engine loop threads on one card (decode tick
   alone and paired, and the device busy share of a traced paired run
   of the same traffic) and a 2-layer fp32 fleet whose streams equal a
   solo engine's;
3f. hubert-xlarge at full width (48 layers, about 946 M parameters,
   random weights from a seed, bf16 compute) as an ``EdgeSystem``
   container service, batches of [8, 500, 512] features through its
   ``generic`` entry point: forward ms a batch (median of 6 after a
   warm-up), frames/s, peak memory, the device busy share of one traced
   batch, flash launched 48 x the batches, predictions in [0, 504); a
   grad-mode ``flash_mha`` at D 80 launches the forward, dq and dk/dv
   once each;
4. consistency: fp32 at full width, 2 layers: every decode step's logits
   against ``Model.forward`` over the same prefix, within 2e-4 relative;
4c. SSM consistency: mamba2 (2 layers) and zamba2 (3) in fp32 at full
   width: chunked against monolithic prefill (logits and SSM state) and
   each decode step against ``Model.forward``, within 2e-4 relative;
4b. speculative exactness: fp32 at full width, 2 random layers, the first
   as the draft: speculative streams equal plain ones with pages in fp32
   and in int8 (a token may differ only at a top-2 margin <= 1e-3);
5. golden: the JAX reference's token streams (``tests/data``), plain,
   speculative and dense-slot (reduced mamba2 and zamba2), and the dense
   variants' (reduced gemma-2b at head dim 256, command-r-35b,
   chameleon-34b, nemotron-4-340b at head dim 192, with their last-token
   logits within 2e-4) and reduced mixtral-8x7b's (prompts past its
   window of 32 on dense slots, the default capacity factor, through the
   windowed flash and the dense decode kernels) and reduced
   deepseek-v2-236b's at the published MLA widths (through flash at
   192/128 and the dense decode kernel at 576/512), reproduced by the
   port on the card in fp32, and
   the JAX encoder logits of reduced
   edge-cv-heavy at head dims 48 and 80 through the fp32 flash kernel
   (within 2e-4 relative, argmax equal, the masked loss within 2e-4);
6. train: ``Trainer`` at full tinyllama-1.1b width (fp32 parameters and
   AdamW moments, bf16 compute) on the bigram stream at B 8 x T 1024, 6
   steps: every loss and grad norm finite, the parameters still after
   step 1 (lr 0) and moved after step 2, the forward flash, dq and dk/dv
   kernels each launched 22 x 6 times; median step time, tokens/s, peak
   memory and a profiled step's device busy share and top kernels (the
   bf16 forward's and backward's tensor-core kernels 22 times each); an
   async checkpoint restored into a fresh ``Trainer`` gives the same next
   loss;
6b. encoder training through ``launch/train.py``'s ``main``: full-width
   hubert-xlarge (fp32 parameters and AdamW, bf16 compute) on
   masked-prediction batches of [8, 500, 512] frames, 6 steps: losses and
   grad norms finite, the parameters still after step 1 and moved after
   step 2, the flash forward, dq and dk/dv each launched 48 x 6 times;
   median step, frames/s, the phase's peak memory, a profiled step; then
   edge-cv-heavy (B 8 x T 64) restarted from its checkpoint gives the
   loss of a run that did not stop;
6c. mixtral-8x7b training: first an fp32 MoE layer at full width
   (capacity factor 0.25, pairs drop) whose backward, run twice, repeats
   bit for bit; then ``Trainer`` on 2 of 32 layers at full width (fp32
   parameters and moments, the cut config's ``default_train_config``),
   B 4 x T 1024, 4 steps: losses and grad norms finite, ``aux`` > 0,
   w_o still after step 1 and moved after step 2, the flash forward, dq
   and dk/dv launched 2 x 4 times, a router gradient in every MoE layer
   and an expert gradient exactly where a pair was kept; median step,
   tokens/s, peak memory, a profiled step (the tensor-core kernels once
   a layer) split into flash forward and backward, expert GEMMs,
   dispatch and combine, the optimizer and the rest; then
   ``launch/train.py --arch mixtral-8x7b --reduced`` restarted from its
   checkpoint gives the loss of a run that did not stop;
6d. deepseek-v2-236b training the same way: its MoE layer's backward
   repeats (160 experts, top 6, 2 shared, fp32), then the dense layer
   and one MoE layer at full width (bf16 parameters, the full arch's
   int8 moments), B 2 x T 512, flash and the backward at q/k 192 over v
   128; the reduced launcher's restart (flash and its backward at q/k
   48 over v 32);
6e. gemma-2b training at full width and depth (18 layers, fp32
   parameters and moments), B 2 x T 1024, the backward at D 256 over one
   KV head, as 6c without the MoE checks; the reduced launcher's
   restart;
6f. training on a device mesh at world size 1: an NCCL group of one
   over a ``FileStore`` and the 1 x 1 ``make_test_mesh`` on cuda; gemma-2b
   at full width and depth through the mesh ``Trainer``, 3 steps at each
   ``remat_policy`` (none, minimal, full): losses within 1e-6 of each
   other and of phase 6e's, the forward's activation bytes full <
   minimal < none; deepseek-v2-236b as phase 6d (int8 moments placed by
   ``opt_state_shardings``, remat full), 2 steps against 6d's losses; a
   sharded decode image captured and replayed equal to the eager step;
   ``hierarchical_psum`` on a (1, 1, 1) pod mesh equal to one int8
   round trip; two spawned gloo ranks sharing the card train reduced
   mixtral on a (1, 2) mesh as one rank does; ``launch/train.py
   --distributed`` under ``torch.distributed.run`` restarts to the
   unbroken loss and ``--mesh single`` exits naming world size 256.
   Every train phase runs its config's remat (the flash forward twice a
   layer and step under "minimal" and "full");
7. train consistency: fp32 at full width, 2 layers, every gradient leaf of
   ``Model.loss`` through the kernels against the plain path within 2e-4
   relative; a reduced fp32 model trained 30 steps through the kernels
   lowers its loss by more than 0.3; one full-width fp32 hubert-xlarge
   layer's every gradient leaf the same way;
8. golden train: the JAX trainer's 5 fp32 steps from the fixture,
   replayed through the kernels from its step-0 state: losses and grad
   norms within 1e-4 relative, final parameters within 1e-4; the same
   for the fixture's encoder runs (reduced edge-cv-heavy at head dims 48
   and 80, masked prediction); and its MoE and wide-head runs (reduced
   mixtral past its window of 32, deepseek at the published MLA widths
   and capacity factor 0.25, gemma-2b at head dim 256): losses and grad
   norms within 2e-5 relative, parameters within 2e-4;
9. the kernels line (each kernel's launches from the paths that run it:
   per request for serving, per step for training (tinyllama's,
   hubert-xlarge's, mixtral's, deepseek's, gemma-2b's and the mesh
   phase's), per dispatch
   on the
   edge path, per request on the fleet, per batch for hubert, per request
   of each dense variant's path and of mixtral's and deepseek's; the SSD
   scan and RMSNorm from mamba2's serve, the dense
   decode kernel from the speculative, zamba2's, mixtral's and
   deepseek's serves and the edge path; a timed shape named after a serving path (``@mixtral``)
   with that path's launches per 10 requests; flash attention's times at
   the serving
   chunk, and as ``train_*`` at the train shape, the encoders' shapes
   under ``also_timed``; other timed shapes under
   ``also_timed``, the launch floor, the stitched scans' final-state
   errors), then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
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
# sha256 of the JAX package's ``fleet_trace()`` JSONL (seed 0, its default
# knobs): phase 3e's trace must be that one, byte for byte
FLEET_TRACE_FINGERPRINT = (
    "b0b2baffc2a54c14ca80828fceb4903a57b0b20fa5505a258d2cf7672bbe53fc")


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
    # flash forward: one wgmma instance for each (key, value) head dims
    # the wrapper takes (D 48 and 80 for the encoders, MLA's 192 and 128),
    # tensor-core instructions in every one (its spills are checked
    # above), none in the fp32 kernel
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels.flash_attention import DIM_PAIRS

    ops = tc_ops["flash_attention"]
    regs = {k: r for k, r, _ in _kernel_resources(logs["flash_attention"])}
    for D, Dv in DIM_PAIRS:
        wk = f"flash_fwd_wgmma_kernel<{D},{Dv}>"
        fk = f"flash_fwd_kernel<{D},{Dv}>"
        check(ops.get(wk, 0) > 0 and ops.get(fk, -1) == 0,
              f"flash_attention D {D}/{Dv}: {wk} without or {fk} with "
              f"tensor-core instructions: {ops}")
        print(f"[build] flash_attention D {D}/{Dv}: {wk} {ops[wk]} HGMMA, "
              f"{regs.get(wk, 'n/a')} regs; {fk} {regs.get(fk, 'n/a')} "
              f"regs, no HMMA")
    # MLA's absorbed decode (keys 576, values 512): its wgmma kernel with
    # tensor-core instructions (and, as above, no spill), its fp32 kernel
    # and the partials' merge without
    ops = tc_ops["decode_attention"]
    res = {k: (r, b) for k, r, b in _kernel_resources(logs[
        "decode_attention"]) if k.startswith("mla_")}
    mla = {k: v for k, v in ops.items() if k.startswith("mla_")}
    wk = [k for k in mla if k.startswith("mla_dense_decode_wgmma_kernel")]
    rest = [k for k in mla if k not in wk]
    check(len(wk) == 1 and mla[wk[0]] > 0 and len(rest) >= 2
          and not any(mla[k] for k in rest),
          f"decode_attention MLA: the wgmma kernel without or the fp32 "
          f"kernels with tensor-core instructions: {mla}")
    print(f"[build] decode_attention MLA (576/512): " + ", ".join(
        f"{k} {mla.get(k, 0)} HMMA/HGMMA, {r} regs, {b} B spilled"
        for k, (r, b) in sorted(res.items())))
    # flash backward: the dq and dk/dv kernels at every (key, value) head
    # dims the wrapper takes (D 48 and 80 for encoder training, 192 and
    # 256, and MLA's 192 over 128), the wgmma instances with tensor-core
    # instructions (and, as above, no spill), the fp32 instances without
    ops = tc_ops["flash_attention_bwd"]
    res = {k: (r, b) for k, r, b in
           _kernel_resources(logs["flash_attention_bwd"])}
    for D, Dv in fab.HEAD_DIMS:
        for part in ("dq", "dkv"):
            wk = f"flash_bwd_{part}_wgmma_kernel<{D},{Dv}>"
            fk = f"flash_bwd_{part}_kernel<{D},{Dv}>"
            check(ops.get(wk, 0) > 0 and ops.get(fk, -1) == 0,
                  f"flash_attention_bwd D {D}/{Dv}: {wk} without or {fk} "
                  f"with tensor-core instructions: {ops}")
            (wr, wb), (fr, fb) = res.get(wk, ("n/a", 0)), res.get(fk,
                                                                  ("n/a", 0))
            print(f"[build] flash_attention_bwd D {D}/{Dv} {part}: {wk} "
                  f"{ops[wk]} HGMMA, {wr} regs, {wb} B spilled; {fk} {fr} "
                  f"regs, {fb} B spilled, no HMMA")
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
        # the dense variants' widths: bf16 and fp32 instances at D 192 and
        # 256, and over int8 pools for the paged kinds (the check above
        # holds their tensor-core instructions; the spill check, spills)
        have = {(a[1], a[2], a[3].replace("(int)", ""))
                for a in map(_template_args, inst)}
        pools = ("", "signed char") if name != "decode_attention" else ("",)
        for D in ("192", "256"):
            for tc in ("__nv_bfloat16", "float"):
                for kv in pools:
                    check((tc, kv or tc, D) in have,
                          f"{name}: no {tc} instance over {kv or tc} "
                          f"pools at D {D}: {sorted(have)}")
        wide = [f"{k} {r} regs" + (f", {b} B spilled" if b else "")
                for k, r, b in _kernel_resources(logs[name])
                if re.search(r"<(192|256),", k)]
        print(f"[build] {name} at D 192 and 256 (bf16 and fp32, "
              f"{'bf16, fp32 and int8 pools' if len(pools) > 1 else 'dense'}"
              f"): {', '.join(wide)}")
    return card


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _flash_case(torch, gen, dtype, Tq, Tk, start, valid, window=0,
                softcap=0.0, explicit_kv_pos=False, heads=(32, 4, 64)):
    """A prefill chunk of tinyllama (``heads``: Hq 32, Hkv 4, D 64) over a
    gathered KV span: queries at start..start+Tq-1, keys valid below
    ``valid``."""
    dt = getattr(torch, dtype)
    B, (Hq, Hkv, D) = 1, heads
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


def _encoder_flash_case(torch, gen, dtype, B, T, H, D, causal=False):
    """An encoder's attention: q, k, v [B, T, H, D] (G 1), every position
    explicit as ``Model.forward`` passes them, non-causal as the encoders
    run it (``causal`` for the mask's check at the new widths)."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(B, T, H, D, generator=gen, device="cuda").to(dt)
               for _ in range(3))
    pos = torch.arange(T, device="cuda", dtype=torch.int32)[None].expand(B, T)
    kw = dict(causal=causal, q_positions=pos, kv_positions=pos)
    # what the data needs: q, k, v and o once, both position rows, and two
    # products over the pairs the mask keeps
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    nbytes = 4 * B * T * H * D * q.element_size() + 2 * 4 * B * T
    return (q, k, v), kw, nbytes, 4 * D * pairs


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
                K1=0, B=8, MP=64, lens=(36, 544), heads=(32, 4, 64)):
    """A decode tick of the serving path: B 8, Hq 32, Hkv 4, D 64, page
    16, 64 table entries (max_seq 1024), pages scattered over the pool,
    lengths 36-543 (``B``, ``MP``, the lengths' range ``lens`` and
    ``heads``, (Hq, Hkv, D), change them).  ``K1 > 0`` makes it a verify
    pass: K1 query tokens per sequence, the last K1 of its length."""
    from repro_torch.models.attention import _quantize

    dt = getattr(torch, dtype)
    (Hq, Hkv, D), page = heads, 16
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


def _mla_flash_case(torch, gen, dtype, B, T, H, valid=None, softcap=0.0,
                    Hkv=None, causal=True):
    """MLA's prefill (deepseek-v2-236b): q and k 192 wide (nope 128 + rope
    64), v 128, Hq = Hkv (the broadcast k_rope) unless ``Hkv``, scale
    192^-0.5, explicit positions as ``attend`` passes them, keys valid
    below ``valid`` (a ragged bucket)."""
    dt = getattr(torch, dtype)
    Hkv = Hkv or H
    q = torch.randn(B, T, H, 192, generator=gen, device="cuda").to(dt)
    k = torch.randn(B, T, Hkv, 192, generator=gen, device="cuda").to(dt)
    v = torch.randn(B, T, Hkv, 128, generator=gen, device="cuda").to(dt)
    pos = torch.arange(T, device="cuda", dtype=torch.int32)[None].expand(B, T)
    kw = dict(causal=causal, softcap=softcap, q_positions=pos,
              kv_positions=pos, sm_scale=192 ** -0.5)
    if valid is not None:
        kw["kv_valid_len"] = torch.full((B,), valid, device="cuda",
                                        dtype=torch.int32)
    # what the data needs: q, k, v and o once, the positions, and the
    # products over the pairs the masks keep
    n = valid if valid is not None else T
    qp, kp = np.arange(T)[:, None], np.arange(T)[None, :]
    keep = (kp < n) & ((kp <= qp) if causal else True)
    pairs = int(keep.sum()) * B * H
    e = q.element_size()
    nbytes = (B * T * H * (192 + 128) + B * T * Hkv * (192 + 128)) * e \
        + 2 * 4 * B * T
    return (q, k, v), kw, nbytes, 2 * (192 + 128) * pairs


def _sdpa_library(torch, F, call):
    """The first of SDPA's backends that takes ``call`` (values narrower
    than keys; one KV head under many query heads): cuDNN, the
    memory-efficient kernel, then the math one.  Returns (its name, a
    timed closure).  Only the library yardstick picks a backend: the
    port's kernels are not involved."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        def run(backend=backend):
            with sdpa_kernel(backend):
                return call()
        try:
            run()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return backend.name, run
    fail("no SDPA backend takes the MLA shape")


def _sdpa_mla_flash(torch, F, args, kw):
    """Library yardstick of MLA's prefill: one causal SDPA over the same
    q, k and v (192/192/128 wide), no mask tensor."""
    q, k, v = (x.transpose(1, 2) for x in args)
    return _sdpa_library(torch, F, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=kw["causal"], scale=kw["sm_scale"],
        enable_gqa=k.shape[1] != q.shape[1]))


def _mla_decode_case(torch, gen, dtype, B, S, Hq=128, fix=None,
                     softcap=0.0, own_v=False):
    """MLA's absorbed decode (deepseek-v2-236b): q [B, Hq, 576] (q_lat and
    q_rope), one KV head of keys [c_kv, k_rope] 576 wide and values c_kv
    (their first 512 columns, a copy, as ``_decode_step_mla`` passes
    ``cache["c_kv"]``; ``own_v`` draws values of their own), lengths
    36-543 unless ``fix``."""
    dt = getattr(torch, dtype)
    q = torch.randn(B, Hq, 576, generator=gen, device="cuda").to(dt)
    k = torch.randn(B, S, 1, 576, generator=gen, device="cuda").to(dt)
    v = torch.randn(B, S, 1, 512, generator=gen, device="cuda").to(dt) \
        if own_v else k[..., :512].contiguous()
    clen = torch.randint(36, 544, (B,), generator=gen, device="cuda",
                         dtype=torch.int32)
    for row, n in (fix or {}).items():
        clen[row] = n
    kw = dict(softcap=softcap, sm_scale=192 ** -0.5)
    # what the data needs: each row's valid keys (576 + 512 columns) once,
    # q and o; 2·(576 + 512) FLOP a key and query head
    toks = int(np.minimum(clen.long().cpu().numpy(), S).sum())
    e = q.element_size()
    nbytes = toks * (576 + 512) * e + B * Hq * (576 + 512) * e + 4 * B
    return (q, k, v, clen), kw, nbytes, 2 * (576 + 512) * toks * Hq


def _sdpa_mla_decode(torch, F, args, kw):
    """Library yardstick of MLA's decode: SDPA with the single KV head
    shared by ``enable_gqa``, an explicit length mask."""
    q, k, v, clen = args
    mask = torch.arange(k.shape[1], device="cuda")[None] < clen[:, None]
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    return _sdpa_library(torch, F, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[:, None, None], scale=kw["sm_scale"],
        enable_gqa=True))


def _bwd_case(torch, gen, dtype, dims, causal=True, window=0, softcap=0.0,
              valid=False, index_kv=False, packed=False, Dv=None,
              sm_scale=None):
    """Inputs of the backward kernels as the train step gives them:
    q/k/v/do random, ``out`` and ``lse`` from the forward kernel, the
    query positions the last Tq of Tk, the key positions explicit (the
    train-mode forward passes them; ``index_kv`` leaves them None), with
    ``valid`` batch row 0 sees no key and the others the first 3/4;
    ``packed`` makes the positions two documents, 0..99 then 0..Tk-101;
    values (and do) ``Dv`` wide, by default as wide as the keys."""
    from repro_torch.kernels.flash_attention import flash_attention

    dt = getattr(torch, dtype)
    B, Tq, Tk, Hq, Hkv, D = dims
    Dv = Dv or D
    q = torch.randn(B, Tq, Hq, D, generator=gen, device="cuda").to(dt)
    k = torch.randn(B, Tk, Hkv, D, generator=gen, device="cuda").to(dt)
    v = torch.randn(B, Tk, Hkv, Dv, generator=gen, device="cuda").to(dt)
    do = torch.randn(B, Tq, Hq, Dv, generator=gen, device="cuda").to(dt)
    kp = np.arange(Tk)
    if packed:
        kp = np.concatenate([np.arange(100), np.arange(Tk - 100)])
    qp = kp[Tk - Tq:]

    def positions(p, n):
        return torch.tensor(p, device="cuda",
                            dtype=torch.int32)[None].expand(B, n)

    kw = dict(causal=causal, window=window, softcap=softcap,
              q_positions=positions(qp, Tq))
    if sm_scale is not None:
        kw["sm_scale"] = sm_scale
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
    # q and dq, k and dk D wide; do and out, v and dv Dv wide.  The dq
    # kernel's products: s (D), do·vᵀ (Dv), ds·k (D); the dk/dv kernel's
    # also pᵀ·do (Dv) and dsᵀ·q (D)
    e = q.element_size()
    qb, ob = B * Tq * Hq * D * e, B * Tq * Hq * Dv * e
    kb, vb = B * Tk * Hkv * D * e, B * Tk * Hkv * Dv * e
    common = qb + ob + kb + vb + 8 * B * Tq * Hq + 4 * B * (Tq + Tk)
    nbytes = {"dq": common + qb, "dkv": common + kb + vb,
              "fwd": qb + kb + vb + ob + 4 * B * Tq * Hq
              + 4 * B * (Tq + Tk)}
    flops = {"dq": 2 * (2 * D + Dv) * pairs,
             "dkv": 2 * (2 * D + 2 * Dv) * pairs,
             "fwd": 2 * (D + Dv) * pairs}
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


def _sdpa_causal(torch, F, q, k, v, causal=True):
    """Library yardstick of the forward at a train shape: one causal (or,
    for the encoders, maskless) ``F.scaled_dot_product_attention`` over
    the same q, k and v, the KV heads expanded to the query heads
    beforehand (untimed)."""
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt, vt = (x.transpose(1, 2).repeat_interleave(G, dim=1) for x in (k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)


def _sdpa_bwd(torch, F, q, k, v, do, causal=True):
    """Library yardstick: the backward of one causal (or maskless)
    ``F.scaled_dot_product_attention`` over the same q, k and v, the KV
    heads expanded to the query heads beforehand (untimed), by
    ``torch.autograd.grad``.  It computes dq, dk and dv in one call."""
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (x.transpose(1, 2).repeat_interleave(G, dim=1).detach()
              .requires_grad_() for x in (k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)


def _sdpa_train_named(torch, F, q, k, v, do, causal, scale):
    """Library yardsticks at a wide train shape: SDPA's forward and its
    backward (``torch.autograd.grad``, dq, dk and dv in one call) on the
    first of its cuDNN, flash, memory-efficient and math backends that
    takes the shape (values narrower than keys rule out flash), the KV
    heads expanded to the query heads beforehand (untimed).  Returns
    (the backend's name, the forward closure, the backward closure)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (x.transpose(1, 2).repeat_interleave(G, dim=1).detach()
              .requires_grad_() for x in (k, v))
    dot = do.transpose(1, 2)
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        def fwd(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, scale=scale)
        try:
            out = fwd()
            torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        def fwd_only(fwd=fwd):
            with torch.no_grad():
                return fwd()
        return (backend.name, fwd_only,
                lambda out=out: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                    retain_graph=True))
    fail("no SDPA backend takes the wide train shape")


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
        # label, Tq, Tk, start, valid, extra, the key the times go under
        ("Tq64/Tk512 chunk@448", 64, 512, 448, 512, {}, "flash_attention"),
        ("Tq64/Tk1024 chunk@960", 64, 1024, 960, 1024, {}, None),
        ("Tq16/Tk512 tail@400", 16, 512, 400, 416, {}, None),
        ("Tq64/Tk64 forward", 64, 64, 0, 64, {"explicit_kv_pos": True},
         None),
        # a 32-token tinyllama forward (phase 3d's heavy container ran it
        # until edge-cv-heavy was ported; the encoders' cases follow)
        ("Tq32/Tk32 forward", 32, 32, 0, 32, {"explicit_kv_pos": True},
         None),
        ("Tq64/Tk512 window128", 64, 512, 448, 512, {"window": 128}, None),
        ("Tq64/Tk512 softcap30", 64, 512, 448, 512, {"softcap": 30.0},
         None),
        ("Tq16/Tk64 warmup(valid=0)", 16, 64, 0, 0, {}, None),
        # the fleet's chunks (phase 3e, max_seq 128, chunks of 64): a
        # chunk after a radix-shared prefix of 1 or 3 pages, a prompt's
        # first chunk (whole, or 40 real tokens of a 64 bucket), and the
        # tails of 96- and 93-token prompts, over spans of 64 or 128 keys
        ("Tq64/Tk128 chunk@16 prefix-shared", 64, 128, 16, 80, {},
         "flash_attention@fleet"),
        ("Tq64/Tk128 chunk@48 prefix-shared", 64, 128, 48, 112, {}, None),
        ("Tq64/Tk64 first chunk", 64, 64, 0, 64, {}, None),
        ("Tq64/Tk64 first chunk, 40 real", 64, 64, 0, 40, {}, None),
        ("Tq32/Tk128 tail@64", 32, 128, 64, 96, {}, None),
        ("Tq16/Tk128 tail@80, 13 real", 16, 128, 80, 93, {}, None),
    ]
    # the dense variants' heads (phase 3g), each timed at its chunk after
    # 448 keys: gemma-2b's Hq 8 over one KV head at D 256, nemotron-4-340b's
    # G 12 at D 192; a first chunk, a window, a softcap, a ragged tail
    gemma, nemo = (8, 1, 256), (96, 8, 192)
    for heads, tag in ((gemma, "gemma"), (nemo, "nemotron")):
        D, hd = heads[2], {"heads": heads}
        flash_cases += [
            (f"D{D} Tq64/Tk512 chunk@448", 64, 512, 448, 512, hd,
             f"flash_attention@{tag}"),
            (f"D{D} Tq64/Tk64 first chunk", 64, 64, 0, 64, hd, None),
            (f"D{D} Tq64/Tk512 window128", 64, 512, 448, 512,
             dict(hd, window=128), None),
            (f"D{D} Tq64/Tk512 softcap30", 64, 512, 448, 512,
             dict(hd, softcap=30.0), None),
            (f"D{D} Tq16/Tk512 tail@400, 13 real", 16, 512, 400, 413, hd,
             None),
            (f"D{D} Tq64/Tk64 forward", 64, 64, 0, 64,
             dict(hd, explicit_kv_pos=True), None)]
    # mixtral-8x7b's monolithic prefill (phase 3h): a prompt of 4608
    # tokens under the 4096-key window (G 4, D 128), the key positions
    # explicit as ``attend`` passes them, timed against SDPA with the
    # windowed mask; a ragged 4600 and a 4200-token prompt's first keys
    mix = {"heads": (32, 8, 128), "window": 4096, "explicit_kv_pos": True}
    flash_cases += [
        ("mixtral B1/T4608 window4096", 4608, 4608, 0, 4608, mix,
         "flash_attention@mixtral"),
        ("mixtral B1/T4600 window4096", 4600, 4600, 0, 4600, mix, None),
        ("mixtral B1/T4200 window4096, 4100 valid", 4200, 4200, 0, 4100,
         mix, None)]
    for dtype in ("bfloat16", "float32"):
        for label, Tq, Tk, start, valid, extra, key in flash_cases:
            args, kw, nb, fl = _flash_case(torch, gen, dtype, Tq, Tk, start,
                                           valid, **extra)
            run("flash_attention", label, dtype, flash_attention, ref.mha,
                args, kw, nb, fl, _sdpa_flash(torch, F, *args, kw),
                key is not None and dtype == "bfloat16", key)
            if valid == 0:
                out = flash_attention(*args, **kw)
                check(bool((out == 0).all()),
                      "flash_attention: a fully masked chunk must give 0")

    # the encoders, non-causal at G 1, each timed against one non-causal
    # SDPA over the same q, k and v: the cv-infer container's frame
    # (edge-cv-heavy, 12 heads of 64, phase 3d), a hubert-xlarge batch
    # (10 s of 20 ms frames, 16 heads of 80, phase 3f) and fig 3's widest
    # app (8 heads of 48); then the causal mask at the new widths, and
    # ragged lengths around the 64-row tile
    encoder_cases = [
        # label, (B, T, H, D), causal, the key the times go under
        ("cv frame B1/T32 H12 D64", (1, 32, 12, 64), False,
         "flash_attention@cv"),
        ("hubert B8/T500 H16 D80", (8, 500, 16, 80), False,
         "flash_attention@hubert"),
        ("fig3 B1/T64 H8 D48", (1, 64, 8, 48), False, "flash_attention@fig3"),
        ("B2/T77 H4 D48 causal", (2, 77, 4, 48), True, None),
        ("B2/T130 H4 D80 causal", (2, 130, 4, 80), True, None),
        ("B1/T129 H8 D48", (1, 129, 8, 48), False, None),
        ("B2/T65 H16 D80", (2, 65, 16, 80), False, None),
    ]
    for dtype in ("bfloat16", "float32"):
        for label, dims, causal, key in encoder_cases:
            args, kw, nb, fl = _encoder_flash_case(torch, gen, dtype, *dims,
                                                   causal=causal)
            qt, kt, vt = (x.transpose(1, 2) for x in args)
            run("flash_attention", label, dtype, flash_attention, ref.mha,
                args, kw, nb, fl,
                None if causal else (lambda qt=qt, kt=kt, vt=vt:
                                     F.scaled_dot_product_attention(
                                         qt, kt, vt)),
                key is not None and dtype == "bfloat16", key)

    # the paged kernels: timed at the serving shape, at B 1 with one
    # 543-token sequence and at B 8 over MP 256 (max_seq 4096) with lengths
    # 1024-4095 (the third field: the key the times go under)
    long = {"MP": 256, "lens": (1024, 4096)}
    one = {"B": 1, "lens": (543, 544)}
    paged_cases = [
        ("B8/MP64 decode", {}, "paged_decode_attention"),
        ("B1/MP64 one 543-token sequence", one, "paged_decode_attention@B1"),
        ("B8/MP256 lengths 1024-4095", long, "paged_decode_attention@MP256"),
        # the fleet's decode ticks (phase 3e): 4 slots over MP 8 (max_seq
        # 128), where a cluster's blocks take shares of 16 keys and most
        # hold none of a short row's
        ("B4/MP8 fleet lengths 33-103", {"B": 4, "MP": 8, "lens": (33, 104)},
         "paged_decode_attention@fleet"),
        ("B1/MP8 one 70-token sequence", {"B": 1, "MP": 8, "lens": (70, 71)},
         None),
        ("B4/MP8 lengths 1-16", {"B": 4, "MP": 8, "lens": (1, 17)}, None),
        ("B4/MP8 full rows of 128", {"B": 4, "MP": 8, "lens": (128, 129)},
         None),
        ("B8/MP64 window256", {"window": 256}, None),
        ("B8/MP64 softcap30", {"softcap": 30.0}, None),
        ("B8/MP64 int8", {"int8": True}, None),
        ("B8/MP64 int8+softcap30", {"int8": True, "softcap": 30.0}, None),
    ]
    # the dense variants' decode ticks at B 8 over MP 64 (phase 3g), on
    # bf16 and int8 pools, timed
    for heads, tag in ((gemma, "gemma"), (nemo, "nemotron")):
        D, hd = heads[2], {"heads": heads}
        paged_cases += [
            (f"D{D} B8/MP64 decode", hd, f"paged_decode_attention@{tag}"),
            (f"D{D} B8/MP64 int8", dict(hd, int8=True),
             f"paged_decode_attention@{tag}_int8"),
            (f"D{D} B8/MP64 window256+softcap30",
             dict(hd, window=256, softcap=30.0), None),
            (f"D{D} B1/MP64 one 543-token sequence", dict(hd, **one), None)]
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
    # gemma-2b's verify (phase 3g): K1 5 timed over bf16 and int8 pools,
    # K1 1 and 2 checked, a window with a softcap
    hd = {"heads": gemma}
    verify_cases += [
        ("D256 B8/MP64 K1=5 verify", dict(hd, K1=5),
         "paged_verify_attention@gemma"),
        ("D256 B8/MP64 K1=5 int8", dict(hd, K1=5, int8=True),
         "paged_verify_attention@gemma_int8"),
        ("D256 B8/MP64 K1=5 window256+softcap30",
         dict(hd, K1=5, window=256, softcap=30.0), None)] + [
        (f"D256 B8/MP64 K1={k1}{name}", dict(hd, K1=k1, **extra), None)
        for k1 in (1, 2) for name, extra in (("", {}),
                                             (" int8", {"int8": True}))]
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
    mixd = {"D": 128, "Hq": 32, "Hkv": 8}
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
        # the gemma-2b draft's steps (phase 3g): G 8 over one KV head at D
        # 256, timed, with lengths of 0, S and past S and a window; G 12
        # at D 192
        ("D256 B8/S1024 gemma draft", 1024, {"D": 256, "Hq": 8, "Hkv": 1},
         "decode_attention@gemma", ()),
        ("D256 B8/S1024 a cache_len 0 row, one of S, one past S", 1024,
         {"D": 256, "Hq": 8, "Hkv": 1, "fix": {0: 0, 1: 1024, 2: 1500}},
         None, (0,)),
        ("D256 B8/S1000 window100+softcap30", 1000,
         {"D": 256, "Hq": 8, "Hkv": 1, "window": 100, "softcap": 30.0,
          "fix": {0: 1000}}, None, ()),
        ("D192 B8/S1024 G12", 1024, {"D": 192, "Hq": 96, "Hkv": 8}, None,
         ()),
        # mixtral-8x7b's decode tick (phase 3h): 8 slots at G 4, D 128
        # over rings of 4096, every ring full or wrapped (lengths past S
        # read all S slots), timed; then rings filling, and an empty one
        ("mixtral B8/S4096 G4 full rings, lengths past S", 4096,
         dict(mixd, fix={0: 4096, 1: 4097, 2: 4600, 3: 5000, 4: 8191,
                         5: 4200, 6: 6000, 7: 8000}),
         "decode_attention@mixtral", ()),
        ("mixtral B8/S4096 G4 rings filling", 4096,
         dict(mixd, fix={0: 1, 1: 100, 2: 2000, 3: 4095, 4: 4096, 5: 0,
                         6: 3000, 7: 4500}), None, (5,)),
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

    # deepseek-v2-236b's MLA (phase 3i): the prefill's flash at q/k 192 and
    # v 128 over its pow2 bucket (B 1, 128 heads, causal; timed at 512),
    # ragged, with a softcap, GQA, non-causal; the absorbed decode at keys
    # 576 and values 512 under one KV head at G 128 (timed at phase 3i's
    # tick, B 8 over max_seq 1024 with lengths up to 543, and over 8 full
    # caches of 4096), rows of 0, S and past S, a softcap, G 4 (the golden
    # replay's), independent values; each timed shape against SDPA on the
    # first backend that takes it
    mla_flash = [
        # label, (B, T, H), extra, the key the times go under
        ("MLA B1/T512 H128 192/128", (1, 512, 128), {},
         "flash_attention@deepseek"),
        ("MLA B1/T64 H128 192/128", (1, 64, 128), {}, None),
        ("MLA B1/T256 H128 192/128, 200 valid", (1, 256, 128),
         {"valid": 200}, None),
        ("MLA B2/T130 H8 192/128 softcap30", (2, 130, 8), {"softcap": 30.0},
         None),
        ("MLA B2/T70 H8 over 2 KV heads 192/128", (2, 70, 8), {"Hkv": 2},
         None),
        ("MLA B1/T40 H4 192/128 non-causal", (1, 40, 4), {"causal": False},
         None),
    ]
    for dtype in ("bfloat16", "float32"):
        for label, dims, extra, key in mla_flash:
            args, kw, nb, fl = _mla_flash_case(torch, gen, dtype, *dims,
                                               **extra)
            timed = key is not None and dtype == "bfloat16"
            lib = _sdpa_mla_flash(torch, F, args, kw) if timed else None
            run("flash_attention", label, dtype, flash_attention, ref.mha,
                args, kw, nb, fl, lib and lib[1], timed, key)
            if timed:
                results[key]["library"] = f"SDPA {lib[0]}"
                print(f"[kernel] flash_attention {label}: library SDPA "
                      f"backend {lib[0]}")
    mla_decode = [
        # label, B, S, extra, the key the times go under, empty rows
        ("MLA B8/S1024 G128 576/512, lengths 36-543", 8, 1024, {},
         "decode_attention@deepseek", ()),
        ("MLA B8/S4096 G128 576/512 full caches", 8, 4096,
         {"fix": {i: 4096 for i in range(8)}},
         "decode_attention@deepseek_S4096", ()),
        ("MLA B8/S1024 G128 lengths 0, 1, S and past S", 8, 1024,
         {"fix": {0: 0, 1: 1, 2: 1024, 3: 1500, 4: 64, 5: 65}}, None,
         (0,)),
        ("MLA B4/S300 G128 softcap30", 4, 300,
         {"softcap": 30.0, "fix": {0: 0, 1: 299, 2: 300, 3: 17}}, None,
         (0,)),
        ("MLA B2/S128 G4 golden shape", 2, 128,
         {"Hq": 4, "fix": {0: 77, 1: 128}}, None, ()),
        ("MLA B3/S200 G16 own values", 3, 200,
         {"Hq": 16, "own_v": True, "fix": {0: 0, 1: 5, 2: 199}}, None,
         (0,)),
    ]
    for dtype in ("bfloat16", "float32"):
        for label, B, S, extra, key, empty in mla_decode:
            args, kw, nb, fl = _mla_decode_case(torch, gen, dtype, B, S,
                                                **extra)
            timed = key is not None and dtype == "bfloat16"
            lib = _sdpa_mla_decode(torch, F, args, kw) if timed else None
            run("decode_attention", label, dtype, decode_attention,
                ref.decode_attention, args, kw, nb, fl, lib and lib[1],
                timed, key)
            if timed:
                results[key]["library"] = f"SDPA {lib[0]}"
                print(f"[kernel] decode_attention {label}: library SDPA "
                      f"backend {lib[0]}")
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
        # label, (B, Tq, Tk, Hq, Hkv, D), extra, timed as: the train step's
        # shape under the kernels' names, hubert-xlarge's under
        # "@hubert_train", False untimed
        ("B8/T1024 train", (8, 1024, 1024, 32, 4, 64), {}, "train"),
        ("B8/T500 H16 D80 hubert train", (8, 500, 500, 16, 16, 80),
         {"causal": False}, "hubert_train"),
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
        # the encoders' widths: D 48 and 80, non-causal and causal, G 1
        # and GQA, ragged T, an empty row, softcap, explicit and index
        # positions
        ("B2/T129 D48 G1 non-causal", (2, 129, 129, 8, 8, 48),
         {"causal": False, "valid": True}, False),
        ("B2/T200 D48 G4", (2, 200, 200, 16, 4, 48), {}, False),
        ("B2/T129 D48 softcap30", (2, 129, 129, 8, 2, 48),
         {"softcap": 30.0}, False),
        ("B2/T500 D80 G1 non-causal", (2, 500, 500, 16, 16, 80),
         {"causal": False}, False),
        ("B2/T129 D80 G2", (2, 129, 129, 8, 4, 80), {"valid": True},
         False),
        ("B2/T256 D80 G1 non-causal packed", (2, 256, 256, 4, 4, 80),
         {"causal": False, "packed": True}, False),
        ("B2/T200 D80 index positions", (2, 200, 200, 8, 2, 80),
         {"index_kv": True, "valid": True}, False),
        # the wide pairs: timed at gemma-2b's train shape (D 256, G 8 over
        # one KV head), nemotron-4-340b's heads (D 192, G 12) and
        # deepseek-v2-236b's (q/k 192 over v 128, Hq = Hkv = 128), then
        # causal and non-causal, a window, a softcap, an empty row and
        # ragged lengths, Tq < Tk, packed and index positions, G 1
        ("gemma B2/T1024 H8/1 D256 train", (2, 1024, 1024, 8, 1, 256), {},
         "gemma_train"),
        ("nemotron B1/T1024 H96/8 D192", (1, 1024, 1024, 96, 8, 192), {},
         "nemotron_train"),
        ("deepseek B2/T512 H128 D192/128", (2, 512, 512, 128, 128, 192),
         {"Dv": 128, "sm_scale": 192 ** -0.5}, "deepseek_train"),
        ("B2/T129 D256 G8 non-causal", (2, 129, 129, 8, 1, 256),
         {"causal": False}, False),
        ("B2/T256 D256 window128 softcap30", (2, 256, 256, 8, 1, 256),
         {"window": 128, "softcap": 30.0}, False),
        ("B2/T200 D256 valid(row 0 empty)", (2, 200, 200, 8, 1, 256),
         {"valid": True}, False),
        ("B2/Tq96/Tk256 D256 chunk", (2, 96, 256, 8, 1, 256), {}, False),
        ("B2/T256 D256 packed", (2, 256, 256, 8, 1, 256), {"packed": True},
         False),
        ("B2/T129 D256 G1", (2, 129, 129, 4, 4, 256), {}, False),
        ("B2/T200 D192 G12 valid", (2, 200, 200, 24, 2, 192),
         {"valid": True}, False),
        ("B2/T129 D192 G1 non-causal softcap30", (2, 129, 129, 8, 8, 192),
         {"causal": False, "softcap": 30.0}, False),
        ("B2/T256 D192 G12 packed window64", (2, 256, 256, 12, 1, 192),
         {"packed": True, "window": 64}, False),
        ("B2/Tq96/Tk256 D192 index positions", (2, 96, 256, 12, 1, 192),
         {"index_kv": True, "valid": True}, False),
        ("B2/T129 D192/128 H128 valid", (2, 129, 129, 128, 128, 192),
         {"Dv": 128, "valid": True, "sm_scale": 192 ** -0.5}, False),
        ("B2/T200 D192/128 non-causal softcap30", (2, 200, 200, 16, 16, 192),
         {"Dv": 128, "causal": False, "softcap": 30.0}, False),
        ("B2/T256 D192/128 G4 window100", (2, 256, 256, 16, 4, 192),
         {"Dv": 128, "window": 100}, False),
        ("B2/Tq96/Tk256 D192/128 packed", (2, 96, 256, 16, 16, 192),
         {"Dv": 128, "packed": True}, False),
        # the reduced deepseek config's MLA widths (q/k 32 + 16, v 32),
        # which launch/train.py --reduced trains on the card: its shape
        # timed, then the masks
        ("B4/T64 D48/32 H4 (reduced deepseek train)", (4, 64, 64, 4, 4, 48),
         {"Dv": 32, "sm_scale": 48 ** -0.5}, "deepseek_reduced_train"),
        ("B4/T64 D48/32 G2 valid", (4, 64, 64, 4, 2, 48),
         {"Dv": 32, "valid": True}, False),
        ("B2/T129 D48/32 G4 valid", (2, 129, 129, 8, 2, 48),
         {"Dv": 32, "valid": True}, False),
        ("B2/T200 D48/32 non-causal softcap30", (2, 200, 200, 4, 4, 48),
         {"Dv": 32, "causal": False, "softcap": 30.0}, False),
        ("B2/Tq96/Tk256 D48/32 packed window40", (2, 96, 256, 4, 4, 48),
         {"Dv": 32, "packed": True, "window": 40}, False),
    ]
    # the wide train shapes and the reduced deepseek launcher's, timed
    # beside SDPA's backward on its first backend that takes them
    # (nemotron's is not trained on one card: ROADMAP item 13)
    wide_train = ("gemma_train", "nemotron_train", "deepseek_train",
                  "deepseek_reduced_train")
    for dtype in ("bfloat16", "float32"):
        for label, dims, extra, timed in bwd_cases:
            if timed and dtype == "float32":
                continue               # the train steps' backward is bf16
            args, kw, out, nb, fl = _bwd_case(torch, gen, dtype, dims,
                                              **extra)
            causal = kw["causal"]
            lib_name = lib_fwd = None
            if timed in wide_train:
                lib_name, lib_fwd, library = _sdpa_train_named(
                    torch, F, *args[:3], args[4], causal,
                    kw.get("sm_scale"))
            else:
                library = _sdpa_bwd(torch, F, *args[:3], args[4], causal) \
                    if timed else None
            # where the times go: the train step's under the kernels'
            # own names, another shape's under "<name>@<tag>"
            at = "" if timed in (False, "train") else f"@{timed}"

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
                lib_fwd or (_sdpa_causal(torch, F, *args[:3], causal)
                            if timed else None), bool(timed),
                key=f"flash_attention@{timed or 'train'}")
            check_lse(f"{label} (train forward)", dtype, args[3],
                      ref.mha(*args[:3], return_lse=True, **kw)[1])

            run("flash_attention_bwd_dq", label, dtype,
                flash_attention_bwd_dq, plain_dq, args, kw, nb["dq"],
                fl["dq"], library, bool(timed),
                key=f"flash_attention_bwd_dq{at}")
            run("flash_attention_bwd_dkv", label, dtype,
                flash_attention_bwd_dkv, plain_dkv, args, kw, nb["dkv"],
                fl["dkv"], library, bool(timed),
                key=f"flash_attention_bwd_dkv{at}")
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
                dq_r = results[f"flash_attention_bwd_dq{at}"]
                dkv_r = results[f"flash_attention_bwd_dkv{at}"]
                fwd_r = results[f"flash_attention@{timed}"]
                both = dq_r["ms"] + dkv_r["ms"]
                if lib_name:
                    for r in (dq_r, dkv_r, fwd_r):
                        r["library"] = f"SDPA {lib_name}"
                    print(f"[kernel] {label}: library SDPA backend "
                          f"{lib_name}")
                qp = kw["q_positions"][0].cpu().numpy()
                kp = kw["kv_positions"][0].cpu().numpy()
                share = _tile_share(qp, kp, dims[3] // dims[4],
                                    kw["causal"], kw["window"])
                fwd_r["tile_share"] = share
                sdpa = "causal SDPA" if causal else "maskless SDPA"
                print(f"[kernel] flash_attention {label} {dtype}: useful "
                      f"work {fl['fwd'] / fwd_r['ms'] / 1e9:.1f} TFLOP/s "
                      f"({100 * share:.1f}% of the 64 x 64 tiles hold a "
                      f"kept pair); {fwd_r['ms']:.4f} ms against one "
                      f"{sdpa} forward {fwd_r['library_ms']:.4f} ms "
                      f"({fwd_r['ms'] / fwd_r['library_ms']:.2f}x) on "
                      f"{card}")
                print(f"[kernel] flash_attention_bwd {label} {dtype}: "
                      f"useful work dq {fl['dq'] / dq_r['ms'] / 1e9:.1f} "
                      f"TFLOP/s, dk/dv "
                      f"{fl['dkv'] / dkv_r['ms'] / 1e9:.1f} TFLOP/s "
                      f"({100 * share:.1f}% of the 64 x 64 tiles hold a "
                      f"kept pair); dq + dk/dv {both:.4f} ms against "
                      f"{sdpa}'s backward {dq_r['library_ms']:.4f} ms "
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

def serve_traffic(torch, eng, rng, n: int, new: int, pair: bool,
                  tag: str):
    """Phase 3's traffic through the background loop: ``n`` random
    prompts of 4-511 tokens and, with ``pair``, a 266-token first turn
    whose follow-up extends it past a page boundary (its admission
    attaches the shared pages and copy-seeds the tail), ``new`` tokens
    each.  Every request completes, the pair hits the radix and copies on
    write, flash launches L x the chunks and paged decode L x the decode
    steps the engine ran.  Returns the launches, the requests and the
    engine's stats."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda

    cfg = eng.cfg
    V = cfg.vocab_size
    lens = [int(rng.integers(4, 512)) for _ in range(n)]
    prompts = [rng.integers(0, V, size=m) for m in lens]
    if pair:
        first_turn = np.concatenate([rng.integers(0, V, size=256),
                                     rng.integers(0, V, size=10)])
    fa.flash_attention.launches = 0
    pda.paged_decode_attention.launches = 0
    t0 = time.monotonic()
    with eng:
        handles = [eng.submit(p, max_new_tokens=new) for p in prompts]
        done, pair_lens = [], ""
        if pair:
            r1 = eng.submit(first_turn, max_new_tokens=new).result(
                timeout=900)
            follow = np.concatenate([first_turn, np.asarray(r1.generated),
                                     rng.integers(0, V, size=8)])
            handles.append(eng.submit(follow, max_new_tokens=new))
            done.append(r1)
            pair_lens = f" + shared pair {len(first_turn)}/{len(follow)}"
        done = [h.result(timeout=900) for h in handles] + done
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"flash_attention": fa.flash_attention.launches,
                "paged_decode_attention":
                    pda.paged_decode_attention.launches}
    st = eng.stats()
    check(not eng.failed and st["failed"] == 0,
          f"{tag}: failed requests {[r.error for r in eng.failed.values()]}")
    check(len(done) == n + 2 * pair
          and all(len(r.generated) == new for r in done),
          f"{tag}: every request must complete with {new} tokens")
    check(not pair or (st["kv_prefix_hits"] >= 1 and st["cow_copies"] >= 1),
          f"{tag}: the shared-prefix pair must hit the radix and COW: {st}")
    L = cfg.num_layers
    check(launches["flash_attention"] == L * st["prefill_chunks"],
          f"{tag}: flash launches {launches['flash_attention']} != {L} x "
          f"{st['prefill_chunks']} chunks")
    check(launches["paged_decode_attention"] == L * st["decode_steps"],
          f"{tag}: paged launches {launches['paged_decode_attention']} != "
          f"{L} x {st['decode_steps']} decode steps")
    check(min(launches.values()) > 0,
          f"{tag}: a kernel never ran on the main path")
    toks = sum(len(r.generated) for r in done)
    print(f"[{tag}] {len(done)} requests, {toks} tokens in {wall:.2f}s "
          f"({toks / wall:.1f} tok/s); prompts {lens}{pair_lens}")
    print(f"[{tag}] ttft p50 {st['p50_ttft_s'] * 1e3:.1f} ms p95 "
          f"{st['p95_ttft_s'] * 1e3:.1f} ms; decode tick p50 "
          f"{st['p50_decode_tick_s'] * 1e3:.2f} ms p95 "
          f"{st['p95_decode_tick_s'] * 1e3:.2f} ms; prefill tick p50 "
          f"{st['p50_prefill_tick_s'] * 1e3:.2f} ms")
    print(f"[{tag}] {st['prefill_chunks']} chunks, {st['decode_steps']} "
          f"decode steps, launches {launches} (exact), radix hits "
          f"{st['kv_prefix_hits']}, cow copies {st['cow_copies']}, "
          f"preemptions {st['preemptions']}")
    return launches, len(done), st


def phase_serve(torch):
    from repro_torch.configs import get_config
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
    launches, n, _ = serve_traffic(torch, eng, rng, 8, 32, True, "serve")
    profile_decode(torch, eng, rng)
    del eng
    torch.cuda.empty_cache()
    return launches, n


def profile_decode(torch, eng, rng, steps: int = 10, label: str = "decode",
                   per_tick: int = 1, ranges: tuple = ()):
    """Where a steady decode tick's time goes: 8 rows decoding, ``steps``
    ticks to settle (a speculative depth grows with its acceptance), the
    host wall of ``steps`` ticks without the profiler, then the device
    time of the same number of ticks by kernel from ``torch.profiler``.
    A tick commits up to ``per_tick`` tokens per row (k+1 when
    speculative).  ``ranges`` names operator rows (``record_function``
    ranges, ``aten::`` ops) whose device time, their kernels' included,
    is printed too."""
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
    # a range's device-side row spans its first kernel's start to its
    # last one's end, idle gaps included: a span, not a kernel
    spans = {k: by_kernel.pop(k) for k in ranges if k in by_kernel}
    for k in ranges:
        counts.pop(k, None)
    eng.run_until_drained()
    busy = sum(by_kernel.values())
    print(f"[profile] {label} tick, 8 rows: host wall {wall_ms:.2f} ms for "
          f"{toks:.1f} tokens ({wall_ms / toks:.2f} ms/token), device busy "
          f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}% of the wall; "
          f"{'measured' if by_kernel else 'no device time seen'})")
    _print_kernels(by_kernel, busy, counts)
    # each range's kernels: the host-side events of that name, whose
    # device time sums the kernels they and their child ops launched
    kern, calls = dict.fromkeys(ranges, 0.0), dict.fromkeys(ranges, 0)
    for ev in prof.events():
        if ev.name in kern and str(ev.device_type).endswith("CPU"):
            kern[ev.name] += getattr(ev, "device_time_total", None) \
                or getattr(ev, "cuda_time_total", 0.0)
            calls[ev.name] += 1
    for name in ranges:
        ms = kern[name] / 1e3 / steps
        if not (ms and busy):
            print(f"[profile]   {name}: no device time seen (not measured)")
            continue
        span = (f"; its device-side span {spans[name]:.4f} ms/tick"
                if name in spans else "")
        print(f"[profile]   {name}: its kernels {ms:.4f} ms/tick over "
              f"{calls[name] / steps:.1f} calls/tick ({100 * ms / busy:.1f}% "
              f"of the device busy time){span}")


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
# phase 3g: the dense variants at full width
# ---------------------------------------------------------------------------

# each cut arch's path name in the kernels line and the layers it keeps
# of its full depth, at full width with bf16 parameters, so that its
# weights fit one card (PERF.md §4)
DENSE_CUT = {"command-r-35b": ("command-r", 8),
             "chameleon-34b": ("chameleon", 8),
             "nemotron-4-340b": ("nemotron", 2)}


def phase_dense_variants(torch):
    """gemma-2b at full width and depth (fp32 parameters, bf16 compute)
    with phase 3's traffic, a profiled decode tick, then speculatively
    over int8 pages with its first 2 layers as the draft (residual writes
    zeroed, as phase 3b), then through ``launch/serve.py``;
    command-r-35b, chameleon-34b and nemotron-4-340b at full width and
    cut depth (``DENSE_CUT``) with bf16 parameters, 4 requests each.
    Returns each path's launches and requests."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_verify_attention as pva
    from repro_torch.serving.engine import ServingEngine

    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[dense] {torch.cuda.memory_allocated()} B allocated before the "
          f"phase")
    paths = {}
    rng = np.random.default_rng(0)
    cfg = get_config("gemma-2b")
    check(cfg.num_layers == 18 and cfg.d_model == 2048
          and cfg.head_dim_ == 256 and cfg.num_kv_heads == 1,
          f"gemma-2b config {cfg}")
    kw = dict(max_slots=8, max_seq=1024, page_size=16, prefill_chunk=64,
              device="cuda")
    t0 = time.monotonic()
    eng = ServingEngine(cfg, seed=0, **kw)
    eng.warmup()
    print(f"[gemma-2b] 18L d2048, 8 heads of 256 over 1 KV head, vocab "
          f"256000 (tied), fp32 parameters "
          f"({cfg.num_params() / 1e9:.3f} B), bf16 compute: init "
          f"{time.monotonic() - t0 - eng.warmup_s:.1f}s, warmup "
          f"{eng.warmup_s:.2f}s, {torch.cuda.memory_allocated()} B "
          f"allocated")
    launches, n, _ = serve_traffic(torch, eng, rng, 8, 32, True, "gemma-2b")
    paths["gemma"] = (launches, n)
    profile_decode(torch, eng, rng, label="gemma-2b decode")

    # speculative over int8 pages: the same fp32 tree, residual writes
    # zeroed in place (the first engine is done with it), its first 2
    # layers the draft
    params = _zero_residual(eng.params)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    dcfg = dataclasses.replace(cfg, num_layers=2)
    spec = ServingEngine(cfg, params=params, kv_dtype="int8", draft_cfg=dcfg,
                         draft_params=_truncated(params, 2), spec_k_max=4,
                         **kw)
    spec.warmup()
    counters = ((fa, "flash_attention"), (pda, "paged_decode_attention"),
                (pva, "paged_verify_attention"), (da, "decode_attention"))
    for mod, fn in counters:
        getattr(mod, fn).launches = 0
    prompts = [rng.integers(0, cfg.vocab_size, size=int(m))
               for m in rng.integers(4, 512, size=4)]
    t0 = time.monotonic()
    for p in prompts:
        spec.submit(p, max_new_tokens=24)
    done = spec.run_until_drained()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {fn: getattr(mod, fn).launches for mod, fn in counters}
    st = spec.stats()
    L = cfg.num_layers
    check(not spec.failed and len(done) == 4
          and all(len(r.generated) == 24 for r in done),
          "gemma-2b speculative: every request must complete")
    check("spec_disabled_reason" not in st and st["spec_rounds"] > 0
          and st["acceptance_rate"] >= 0.95,
          f"gemma-2b speculative: {st}")
    check(launches["paged_verify_attention"] == L * st["spec_rounds"],
          f"gemma-2b verify launches {launches['paged_verify_attention']} "
          f"!= {L} x {st['spec_rounds']} rounds")
    check(launches["decode_attention"] > 0
          and launches["decode_attention"] % dcfg.num_layers == 0,
          f"gemma-2b draft decode launches {launches['decode_attention']}")
    check(launches["flash_attention"] ==
          L * st["prefill_chunks"] + dcfg.num_layers * len(prompts),
          f"gemma-2b speculative flash launches {launches}")
    check(launches["paged_decode_attention"] == L * st["decode_steps"],
          "gemma-2b speculative: paged decode launches differ from the "
          "normal ticks run")
    print(f"[gemma-2b] speculative over int8 pages, spec_k_max 4, draft = "
          f"its first 2 layers (zero-residual weights): 4 requests x 24 "
          f"tokens in {wall:.2f}s; acceptance {st['acceptance_rate']:.3f}, "
          f"{st['spec_rounds']} verify rounds, {st['draft_ticks']} draft "
          f"ticks, launches {launches}")
    paths["gemma_spec"] = (launches, len(done))
    del spec, params
    gc.collect()
    torch.cuda.empty_cache()

    # the serve launcher's entry point: an EdgeSystem container over a fresh
    # full-width engine (its warmup runs every chunk bucket and one decode
    # step, counted here)
    from repro_torch.launch import serve

    for mod, fn in counters:
        getattr(mod, fn).launches = 0
    esys = serve.main(["--arch", "gemma-2b", "--requests", "4",
                       "--max-new", "8", "--device", "cuda"])
    torch.cuda.synchronize()
    (dep,) = esys.instances("llm-serving")
    eng = dep.executor.engine
    st = eng.stats()
    check(st["failed"] == 0 and len(eng.completed) == 4,
          "launch/serve.py --arch gemma-2b: 4 requests must complete")
    check(fa.flash_attention.launches ==
          L * (st["prefill_chunks"] + len(eng.chunk_buckets))
          and pda.paged_decode_attention.launches ==
          L * (st["decode_steps"] + 1),
          f"launch/serve.py --arch gemma-2b launches: flash "
          f"{fa.flash_attention.launches}, paged "
          f"{pda.paged_decode_attention.launches}, {st['prefill_chunks']} "
          f"chunks + {len(eng.chunk_buckets)} warmup, {st['decode_steps']} "
          f"steps + 1")
    print(f"[gemma-2b] launch/serve.py --arch gemma-2b: 4 requests through "
          f"an EdgeSystem container, {st['prefill_chunks']} chunks, "
          f"{st['decode_steps']} decode steps, flash and paged decode "
          f"launches exact")
    del esys, dep, eng
    gc.collect()
    torch.cuda.empty_cache()

    for arch, (path, depth) in DENSE_CUT.items():
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=depth,
                                  param_dtype="bfloat16")
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        eng = ServingEngine(cfg, max_slots=4, max_seq=1024, page_size=16,
                            prefill_chunk=64, seed=0, device="cuda")
        eng.warmup()
        print(f"[{arch}] {depth} of {full.num_layers} layers at full width "
              f"(d{cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim_} "
              f"over {cfg.num_kv_heads} KV heads, d_ff {cfg.d_ff}, "
              f"{cfg.norm}, {cfg.activation}"
              f"{', parallel blocks' if cfg.parallel_block else ''}"
              f"{', qk-norm' if cfg.qk_norm else ''}), bf16 parameters "
              f"({cfg.num_params()} = {cfg.num_params() * 2} B): init "
              f"{time.monotonic() - t0 - eng.warmup_s:.1f}s, warmup "
              f"{eng.warmup_s:.2f}s")
        launches, n, _ = serve_traffic(torch, eng, rng, 4, 16, False, arch)
        torch.cuda.synchronize()
        print(f"[{arch}] peak memory {torch.cuda.max_memory_allocated()} B "
              f"({start} B allocated before it); "
              f"{time.monotonic() - t0:.1f}s")
        paths[path] = (launches, n)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[dense] phase 3g {time.monotonic() - t_phase:.1f}s")
    return paths


# ---------------------------------------------------------------------------
# phase 3h: mixtral-8x7b at full width
# ---------------------------------------------------------------------------

# the layers phase 3h keeps of mixtral-8x7b's 32, at full width with bf16
# parameters: 8 x 1 451 270 144 + 262 148 096 = 11 872 309 248 of them,
# 23.7 GB (PERF.md §4)
MIXTRAL_CUT = 8


def _moe_ranges(torch):
    """The MoE's dispatch, expert FFN and combine wrapped in
    ``record_function`` ranges (module attributes that
    ``_apply_moe_local`` reads), for a profiled tick; returns the undo."""
    from repro_torch.models import moe

    names = {"_dispatch": "moe.dispatch", "_expert_ffn": "moe.expert_ffn",
             "_combine": "moe.combine"}
    saved = {n: getattr(moe, n) for n in names}

    def wrap(fn, label):
        def ranged(*a, **kw):
            with torch.profiler.record_function(label):
                return fn(*a, **kw)
        return ranged

    for n, label in names.items():
        setattr(moe, n, wrap(saved[n], label))
    return lambda: [setattr(moe, n, f) for n, f in saved.items()]


def _mixtral_wrap_exactness(torch):
    """Through the wrap at full width: a 2-layer fp32 mixtral with
    ``capacity_factor`` 8 (no pair drops, as ``tests/conftest.py:31``'s
    ``exact_config`` sets) serves a 4600-token prompt plus 16 new tokens
    over its ring of 4096 (prefill past the window, decode over wrapped
    rings); each generated token must be the argmax of one
    ``Model.forward`` over the whole sequence at its position."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import ServingEngine

    full = get_config("mixtral-8x7b")
    cfg = dataclasses.replace(
        full, num_layers=2, compute_dtype="float32",
        moe=dataclasses.replace(full.moe, capacity_factor=8.0))
    t0 = time.monotonic()
    eng = ServingEngine(cfg, max_slots=2, max_seq=8192, seed=5,
                        device="cuda")
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, size=4600)
    req = eng.submit(prompt, max_new_tokens=16).result(timeout=900)
    check(len(req.generated) == 16 and not eng.failed,
          "mixtral fp32: the 4600-token request must complete")
    seq = torch.tensor(np.concatenate([prompt, req.generated])[None],
                       device="cuda")
    with torch.no_grad():
        logits = eng.model.forward(eng.params, {"tokens": seq})[0]
    ahead = logits[len(prompt) - 1:len(prompt) + 15]         # [16, V]
    want = torch.argmax(ahead, dim=-1).tolist()
    top2 = torch.topk(ahead, 2, dim=-1).values
    margin = float((top2[:, 0] - top2[:, 1]).min())
    print(f"[mixtral] fp32, 2 layers at full width, capacity factor 8: a "
          f"4600-token prompt + 16 tokens over the ring of "
          f"{eng.kv.caches['attn']['k'].shape[2]}: the engine's stream "
          f"{req.generated} against Model.forward's argmax {want} (least "
          f"top-2 margin {margin:.4f}); {time.monotonic() - t0:.1f}s")
    check(req.generated == want,
          "mixtral fp32: the stream through the ring wrap differs from "
          "Model.forward's argmax")
    del eng, logits
    gc.collect()
    torch.cuda.empty_cache()


def phase_mixtral(torch):
    """mixtral-8x7b at full width and cut depth (``MIXTRAL_CUT`` layers,
    bf16 parameters, random weights from a seed) on the dense-slot plane:
    8 slots, ``max_seq`` 8192 (rings of 4096), phase 3's 10 prompts of
    4-511 tokens and one of 4600 tokens, 32 new tokens each; every request
    completes, flash launched layers x prefills and the dense decode
    kernel layers x decode steps (no paged kernel); tokens/s, TTFT, tick
    walls, peak memory and a profiled decode tick with the MoE dispatch's
    and the expert GEMMs' device time; then the fp32 stream through the
    ring wrap (``_mixtral_wrap_exactness``).  Returns the launches and
    the requests."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.serving.engine import ServingEngine

    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config("mixtral-8x7b")
    check(full.d_model == 4096 and full.num_heads == 32
          and full.num_kv_heads == 8 and full.moe.num_experts == 8
          and full.moe.top_k == 2 and full.moe.d_expert == 14336
          and full.sliding_window == 4096
          and full.num_params() == 46_702_792_704,
          f"mixtral-8x7b config {full}")
    cfg = dataclasses.replace(full, num_layers=MIXTRAL_CUT,
                              param_dtype="bfloat16")
    L = cfg.num_layers
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng = ServingEngine(cfg, max_slots=8, max_seq=8192, seed=0,
                        device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    init_peak = torch.cuda.max_memory_allocated()
    eng.warmup()
    check(not eng.paged and eng._stateful, "mixtral must serve on dense "
          "slots with exact-length prefill")
    ring = eng.kv.caches["attn"]["k"].shape[2]
    check(ring == 4096, f"mixtral's ring holds {ring} slots, not 4096")
    print(f"[mixtral] {L} of {full.num_layers} layers at full width (d4096, "
          f"32 heads of 128 over 8 KV heads, 8 experts of 14336, top 2, "
          f"window 4096), bf16 parameters ({cfg.num_params()} = "
          f"{cfg.num_params() * 2} B; {full.active_params()} active of "
          f"{full.num_params()} at full depth): init {init_s:.1f}s (peak "
          f"{init_peak - start} B over the {start} B allocated before), "
          f"warmup {eng.warmup_s:.2f}s, rings of {ring} slots "
          f"({eng.kv.capacity_bytes()} B for 8 slots)")
    rng = np.random.default_rng(0)
    lens = [int(rng.integers(4, 512)) for _ in range(10)] + [4600]
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lens]
    counters = ((fa, "flash_attention"), (da, "decode_attention"),
                (pda, "paged_decode_attention"))
    for mod, fn in counters:
        getattr(mod, fn).launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    with eng:
        handles = [eng.submit(p, max_new_tokens=32) for p in prompts]
        done = [h.result(timeout=900) for h in handles]
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {fn: getattr(mod, fn).launches for mod, fn in counters}
    st = eng.stats()
    check(not eng.failed and st["failed"] == 0,
          f"mixtral: failed requests {[r.error for r in eng.failed.values()]}")
    check(len(done) == 11 and all(len(r.generated) == 32 for r in done),
          "mixtral: every request must complete with 32 tokens")
    chunks, steps = st["prefill_chunks"], st["decode_steps"]
    check(chunks == len(prompts),
          f"mixtral: {chunks} prefills for {len(prompts)} prompts (each "
          "must prefill once, at its exact length)")
    want = {"flash_attention": L * chunks, "decode_attention": L * steps,
            "paged_decode_attention": 0}
    check(launches == want and steps > 0,
          f"mixtral launches {launches} != {want} ({chunks} prefills, "
          f"{steps} decode steps)")
    toks = sum(len(r.generated) for r in done)
    print(f"[mixtral] {len(done)} requests, {toks} tokens in {wall:.2f}s "
          f"({toks / wall:.1f} tok/s); prompts {lens}; peak memory "
          f"{torch.cuda.max_memory_allocated()} B")
    print(f"[mixtral] ttft p50 {st['p50_ttft_s'] * 1e3:.1f} ms p95 "
          f"{st['p95_ttft_s'] * 1e3:.1f} ms; decode tick p50 "
          f"{st['p50_decode_tick_s'] * 1e3:.2f} ms p95 "
          f"{st['p95_decode_tick_s'] * 1e3:.2f} ms; prefill tick p50 "
          f"{st['p50_prefill_tick_s'] * 1e3:.2f} ms")
    print(f"[mixtral] {chunks} prefills, {steps} decode steps, launches "
          f"{launches} (exact)")
    undo = _moe_ranges(torch)
    try:
        profile_decode(torch, eng, rng, label="mixtral decode",
                       ranges=("moe.dispatch", "moe.expert_ffn",
                               "moe.combine", "aten::bmm"))
    finally:
        undo()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    _mixtral_wrap_exactness(torch)
    print(f"[mixtral] phase 3h {time.monotonic() - t_phase:.1f}s")
    return {k: launches[k] for k in ("flash_attention", "decode_attention")}, \
        len(done)


# ---------------------------------------------------------------------------
# phase 3i: deepseek-v2-236b at full width
# ---------------------------------------------------------------------------

# the layers phase 3i keeps of deepseek-v2-236b's 60: the leading dense
# one and 3 MoE layers, at full width with bf16 parameters: 13 302 912 000
# of them, 26.6 GB (PERF.md §4)
DEEPSEEK_CUT = 4


def _latent_keys_range(torch):
    """The absorbed decode's ``[c_kv, k_rope]`` copy wrapped in a
    ``record_function`` range (the module attribute ``_decode_step_mla``
    reads), for a profiled tick; returns the undo."""
    from repro_torch.models import attention

    saved = attention._latent_keys

    def ranged(cache):
        with torch.profiler.record_function("mla.kv_cat"):
            return saved(cache)

    attention._latent_keys = ranged
    return lambda: setattr(attention, "_latent_keys", saved)


def phase_deepseek(torch):
    """deepseek-v2-236b at full width and cut depth (``DEEPSEEK_CUT``
    layers: the dense one and 3 MoE, bf16 parameters, random weights from
    a seed) on the dense-slot plane: 8 slots, ``max_seq`` 1024, phase 3's
    10 prompts of 4-511 tokens, 32 new tokens each, each prompt prefilled
    once, whole, in its pow2 bucket; every request completes, flash (q/k
    192, v 128) launched layers x prefills and the dense decode kernel
    (keys 576, values 512, G 128) layers x decode steps (no paged
    kernel); tokens/s, TTFT, tick walls, peak memory at init and under
    traffic, and a profiled decode tick with the expert GEMMs', the
    latent-key copies' and the rest's device time.  Returns the launches
    and the requests."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.serving.engine import ServingEngine

    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config("deepseek-v2-236b")
    m = full.mla
    check(full.d_model == 5120 and full.num_heads == 128
          and (m.q_lora_rank, m.kv_lora_rank, m.qk_nope_head_dim,
               m.qk_rope_head_dim, m.v_head_dim) == (1536, 512, 128, 64, 128)
          and full.moe.num_experts == 160 and full.moe.top_k == 6
          and full.moe.num_shared_experts == 2
          and full.moe.first_dense_layers == 1
          and full.num_params() == 235_741_434_880,
          f"deepseek-v2-236b config {full}")
    cfg = dataclasses.replace(full, num_layers=DEEPSEEK_CUT,
                              param_dtype="bfloat16")
    L = cfg.num_layers
    check(cfg.num_params() == 13_302_912_000,
          f"deepseek cut to {L} layers: {cfg.num_params()} parameters")
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng = ServingEngine(cfg, max_slots=8, max_seq=1024, seed=0,
                        device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    init_peak = torch.cuda.max_memory_allocated()
    eng.warmup()
    check(not eng.paged and not eng._stateful,
          "deepseek must serve on dense slots with bucketed prefill")
    lat = eng.kv.caches["attn"]["c_kv"].shape
    check(tuple(lat) == (L - 1, 8, 1024, 512)
          and tuple(eng.kv.caches["attn_dense"]["k_rope"].shape)
          == (1, 8, 1024, 64), f"deepseek's latent caches {lat}")
    print(f"[deepseek] {L} of {full.num_layers} layers at full width (d5120,"
          f" 128 heads of MLA: q_lora 1536, kv_lora 512, nope 128, rope 64, "
          f"v 128; 1 dense layer of 12288, then 160 experts of 1536, top 6, "
          f"2 shared), bf16 parameters ({cfg.num_params()} = "
          f"{cfg.num_params() * 2} B; {full.active_params()} active of "
          f"{full.num_params()} at full depth): init {init_s:.1f}s (peak "
          f"{init_peak - start} B over the {start} B allocated before), "
          f"warmup {eng.warmup_s:.2f}s over buckets {eng.buckets}, latent "
          f"caches {eng.kv.capacity_bytes()} B for 8 slots")
    rng = np.random.default_rng(0)
    lens = [int(rng.integers(4, 512)) for _ in range(10)]
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lens]
    counters = ((fa, "flash_attention"), (da, "decode_attention"),
                (pda, "paged_decode_attention"))
    for mod, fn in counters:
        getattr(mod, fn).launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    with eng:
        handles = [eng.submit(p, max_new_tokens=32) for p in prompts]
        done = [h.result(timeout=900) for h in handles]
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {fn: getattr(mod, fn).launches for mod, fn in counters}
    st = eng.stats()
    check(not eng.failed and st["failed"] == 0,
          f"deepseek: failed requests "
          f"{[r.error for r in eng.failed.values()]}")
    check(len(done) == 10 and all(len(r.generated) == 32 for r in done),
          "deepseek: every request must complete with 32 tokens")
    chunks, steps = st["prefill_chunks"], st["decode_steps"]
    check(chunks == len(prompts),
          f"deepseek: {chunks} prefills for {len(prompts)} prompts (each "
          "must prefill once, whole)")
    want = {"flash_attention": L * chunks, "decode_attention": L * steps,
            "paged_decode_attention": 0}
    check(launches == want and steps > 0,
          f"deepseek launches {launches} != {want} ({chunks} prefills, "
          f"{steps} decode steps)")
    vocab = {t for r in done for t in r.generated}
    check(all(0 <= t < cfg.vocab_size for t in vocab),
          "deepseek: a token outside the vocabulary")
    toks = sum(len(r.generated) for r in done)
    print(f"[deepseek] {len(done)} requests, {toks} tokens in {wall:.2f}s "
          f"({toks / wall:.1f} tok/s); prompts {lens}; peak memory under "
          f"traffic {torch.cuda.max_memory_allocated()} B")
    print(f"[deepseek] ttft p50 {st['p50_ttft_s'] * 1e3:.1f} ms p95 "
          f"{st['p95_ttft_s'] * 1e3:.1f} ms; decode tick p50 "
          f"{st['p50_decode_tick_s'] * 1e3:.2f} ms p95 "
          f"{st['p95_decode_tick_s'] * 1e3:.2f} ms; prefill tick p50 "
          f"{st['p50_prefill_tick_s'] * 1e3:.2f} ms")
    print(f"[deepseek] {chunks} prefills, {steps} decode steps, launches "
          f"{launches} (exact)")
    undo = (_moe_ranges(torch), _latent_keys_range(torch))
    try:
        profile_decode(torch, eng, rng, label="deepseek decode",
                       ranges=("moe.dispatch", "moe.expert_ffn",
                               "moe.combine", "mla.kv_cat", "aten::bmm"))
    finally:
        for u in undo:
            u()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[deepseek] phase 3i {time.monotonic() - t_phase:.1f}s")
    return {k: launches[k] for k in ("flash_attention", "decode_attention")}, \
        len(done)


# ---------------------------------------------------------------------------
# phase 3d: the edge system
# ---------------------------------------------------------------------------

EDGE_STATE = os.path.join(ROOT, "build", "edge_state.json")


def _edge_traffic(torch, system, heavy, light, scfg, params_light):
    """The paper's fig 1 mix through ``submit_many``, 16 rounds: every
    round one single-stream decode step of edge-stream-light (the decode
    image), every other round a stream record batch (the stream image),
    every fourth a ``cv-infer`` frame (32 feature frames of
    edge-cv-heavy's 256 in, class argmax out, through the heavy
    container).  The decode steps and the stream state chain from round
    to round."""
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
            frame = torch.as_tensor(rng.normal(
                size=(1, 32, heavy.frontend_dim)).astype(np.float32),
                device=dev)
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
    edge-cv-heavy (the paper's heavy workload, the ``cv-infer`` container)
    and edge-stream-light (the light decode image), random weights from a
    seed, bf16 compute; the ``cv-infer`` and ``stream-analytics`` specs
    and a light decode spec; the mixed traffic of ``_edge_traffic``; a
    node loss; and the engine service, deployed by ``launch/serve.py``
    with full-width tinyllama-1.1b and restored from its saved state."""
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
    heavy, light = get_config("edge-cv-heavy"), get_config(
        "edge-stream-light")
    llm = get_config("tinyllama-1.1b")        # the engine service's model
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
        # beside edge-cv-heavy's, the heavy p50 of the same traced
        # traffic when tinyllama-1.1b on token ids stood in for the
        # container (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 2)
        was = (" (tinyllama-1.1b stand-in: p50 76.206 ms)"
               if wc == "heavy" else "")
        print(f"[edge] {wc} dispatches: {s['count']}, p50 "
              f"{s['p50_wall_s'] * 1e3:.3f} ms, p95 "
              f"{s['p95_wall_s'] * 1e3:.3f} ms{was}")
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
    L = llm.num_layers
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
                               llm, max_slots=4, max_seq=128, device=dev))
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
# phase 3f: hubert-xlarge through a container's generic entry point
# ---------------------------------------------------------------------------

def phase_hubert(torch):
    """Full-width hubert-xlarge (48 layers, d 1280, 16 heads of 80, about
    946 M parameters, random fp32 weights from a seed, bf16 compute) as a
    container service of an ``EdgeSystem`` on cuda:0, fed batches of
    [8, 500, 512] feature frames (10 s of 20 ms frames each) through its
    ``generic`` entry point: a warm-up batch, then 6 timed ones (host
    clock to a synchronize) and one in a ``torch.profiler`` trace; flash
    launched 48 times a batch; predictions in [0, 504); a grad-mode
    ``flash_mha`` at D 80 through the forward and both backward
    kernels."""
    from repro_torch.configs import get_config
    from repro_torch.core import (EdgeSystem, NodeCapacity, ServiceSpec,
                                  Workload, WorkloadClass, WorkloadKind)
    from repro_torch.core.executor import ExecutorClass
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention_bwd import flash_mha
    from repro_torch.models.model import build_model
    from repro_torch.serving import router
    from repro_torch.tree import leaves
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.monotonic()
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config("hubert-xlarge")
    check(cfg.cdtype == torch.bfloat16 and cfg.head_dim_ == 80,
          "hubert-xlarge: bf16 compute, head dim 80")
    B, T = 8, 500
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated(dev)     # earlier phases' leftovers
    system = EdgeSystem()
    system.add_node("edge0", NodeCapacity(
        hbm_bytes=torch.cuda.get_device_properties(dev).total_memory),
        mesh=dev)
    params = build_model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(0))
    n_params = sum(x.numel() for x in leaves(params))
    check(n_params == cfg.num_params(),
          f"hubert-xlarge tree {n_params} != num_params {cfg.num_params()}")
    system.register_builder("generic", WorkloadClass.HEAVY,
                            router.make_container_builder(
                                cfg, params=params, device=dev))

    def work(name):
        return Workload(name, WorkloadKind.GENERIC, cfg, batch=B, seq_len=T,
                        est_flops=2.0 * cfg.num_params() * B * T)

    system.apply(ServiceSpec(name="hubert", workload=work("hubert"),
                             executor_class=ExecutorClass.CONTAINER))
    rng = np.random.default_rng(0)
    batches = [torch.as_tensor(rng.normal(size=(B, T, cfg.frontend_dim))
                               .astype(np.float32), device=dev)
               for _ in range(8)]
    res = system.submit(work("warmup"), (batches[0],))      # warm-up
    check(res.workload_class is WorkloadClass.HEAVY
          and res.service == "hubert", f"hubert routed to {res.service}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.flash_attention.launches = 0
    times, preds = [], []
    for i, x in enumerate(batches[1:7]):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = system.submit(work(f"batch{i}"), (x,)).output
        torch.cuda.synchronize()
        times.append((time.monotonic() - t0) * 1e3)
        preds.append(out)
    launches = {"flash_attention": fa.flash_attention.launches}
    peak = torch.cuda.max_memory_allocated(dev) - start
    check(launches["flash_attention"] == cfg.num_layers * len(times),
          f"hubert flash launches {launches} != {cfg.num_layers} x "
          f"{len(times)} batches")
    for p in preds:
        check(tuple(p.shape) == (B, T) and p.dtype == torch.int32
              and 0 <= int(p.min()) and int(p.max()) < cfg.vocab_size,
              "hubert: bad predictions")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        system.submit(work("traced"), (batches[7],))
        torch.cuda.synchronize()
        traced_ms = (time.monotonic() - t0) * 1e3
    counts = {}
    by_kernel = _device_ms(prof, 1, counts)
    busy = sum(by_kernel.values())
    flash_ms = sum(v for k, v in by_kernel.items()
                   if "flash_fwd_wgmma_kernel" in k)
    flash_n = sum(v for k, v in counts.items()
                  if "flash_fwd_wgmma_kernel" in k)
    check(flash_n == cfg.num_layers,
          f"the traced batch ran {flash_n} flash kernels, not "
          f"{cfg.num_layers}")
    med = float(np.median(times))
    print(f"[hubert] hubert-xlarge full width ({cfg.num_layers}L d"
          f"{cfg.d_model}, {n_params} parameters), bf16, through the "
          f"container's generic entry point on [{B}, {T}, "
          f"{cfg.frontend_dim}] features: forward {med:.3f} ms a batch "
          f"(median of {len(times)}: {[round(t, 3) for t in times]}), "
          f"{B * T / med * 1e3:.1f} frames/s, peak {peak} B allocated "
          f"by the phase (parameters included; {start} B were allocated "
          f"before it); "
          f"flash launches {launches['flash_attention']} "
          f"({cfg.num_layers} a batch)")
    print(f"[hubert] one traced batch: host wall {traced_ms:.3f} ms, "
          f"device busy {busy:.3f} ms ({100 * busy / traced_ms:.1f}% of "
          f"the wall), flash {flash_ms:.4f} ms in {flash_n:.0f} launches "
          f"({100 * flash_ms / max(busy, 1e-9):.1f}% of the busy time)")
    _print_kernels(by_kernel, busy, counts)

    # a grad-mode forward at D 80 trains: the forward once (with lse),
    # then the dq and dk/dv kernels once each
    q = torch.randn(1, 8, 2, 80, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    counters = _train_counters()
    before = [fn.launches for fn, _ in counters]
    dq, = torch.autograd.grad(
        flash_mha(q, q.detach(), q.detach(), causal=False).float().sum(),
        (q,))
    torch.cuda.synchronize()
    moved = [fn.launches - b for (fn, _), b in zip(counters, before)]
    check(moved == [1, 1, 1] and bool(torch.isfinite(dq).all()),
          f"a grad-mode flash_mha at D 80 must launch the forward, dq and "
          f"dk/dv once each: {moved}")
    print(f"[hubert] a grad-mode flash_mha at D 80 launches the forward, "
          f"dq and dk/dv once each; phase "
          f"{time.monotonic() - t_phase:.1f}s")
    del system, params, batches, preds, prof
    torch.cuda.empty_cache()
    return launches, len(times)


# ---------------------------------------------------------------------------
# phase 3e: the fleet
# ---------------------------------------------------------------------------

FLEET_SCORECARDS = os.path.join(ROOT, "build", "fleet_scorecards.json")


def _fleet_chaos():
    """Phase 3e's fault script over the 6 s trace: replica 0 stalls in the
    first third, node edge1 is lost in the middle and rejoins at the
    end."""
    from repro_torch.harness import ChaosAction

    return [ChaosAction(at_s=1.0, kind="engine-stall", target="fleet-chat/0",
                        duration_s=1.0),
            ChaosAction(at_s=3.0, kind="node-loss", target="edge1"),
            ChaosAction(at_s=5.5, kind="node-rejoin", target="edge1")]


def _fleet_run(torch, trace, cfg, params, total, name, policy, chaos):
    """One ``run_fleet_replay`` of ``trace`` over two replicas of ``cfg``,
    with every kernel count at 0 just before it; returns the scorecard,
    the router, the system, the engines the fleet built and the launches
    counted once every engine, orphans included, went idle."""
    from repro_torch.harness import fleet_scorecard, run_fleet_replay
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda

    built = []
    fa.flash_attention.launches = pda.paged_decode_attention.launches = 0
    report, router, system = run_fleet_replay(
        trace, cfg, policy=policy, chaos_actions=chaos, max_slots=4,
        max_seq=128, node_hbm_bytes=total // 2,
        engine_kw={"params": params}, device="cuda", engine_sink=built,
        drain_timeout_s=120.0, result_timeout_s=60.0)
    for eng in built:
        eng.drain(timeout=120)
    torch.cuda.synchronize()
    launches = {"flash_attention": fa.flash_attention.launches,
                "paged_decode_attention":
                    pda.paged_decode_attention.launches}
    card = fleet_scorecard(report, router)
    card["fingerprint"] = trace.fingerprint()
    L = cfg.num_layers
    sts = [e.stats() for e in built]
    warmed = [e for e in built if e._warm]
    chunks = sum(s["prefill_chunks"] for s in sts)
    steps = sum(s["decode_steps"] for s in sts)
    buckets = sum(len(e.chunk_buckets) for e in warmed)
    c = card["requests"]
    check(c["total"] == len(trace) and all(
        o.ok or o.requeues > 0 for o in report.outcomes),
          f"fleet {name}: requests neither completed nor requeued: "
          f"{[(o.eid, o.status, o.error) for o in report.outcomes if not o.ok]}")
    check(card["guaranteed"]["dropped"] == 0,
          f"fleet {name}: GUARANTEED dropped: {card['guaranteed']}")
    check(card["fingerprint"] == FLEET_TRACE_FINGERPRINT and
          [(o.eid, o.offset_s, o.qos) for o in report.outcomes]
          == [(e.eid, e.offset_s, e.qos) for e in trace.events],
          f"fleet {name}: the replayed trace is not the JAX package's")
    check(all(e.device.type == "cuda" for e in built),
          f"fleet {name}: an engine off the card")
    # the warmup runs every chunk bucket and one decode step of each
    # replica warmed before the replay; failover's engines start cold
    check(launches["flash_attention"] == L * (chunks + buckets),
          f"fleet {name}: flash launches {launches['flash_attention']} != "
          f"{L} x ({chunks} chunks + {buckets} warmup buckets)")
    check(launches["paged_decode_attention"] == L * (steps + len(warmed)),
          f"fleet {name}: paged launches "
          f"{launches['paged_decode_attention']} != {L} x ({steps} decode "
          f"steps + {len(warmed)} warmup)")
    shared = sum(r.kv_shared_tokens for e in built
                 for r in e.completed.values())
    prompt = sum(len(r.prompt) for e in built for r in e.completed.values())
    lat = card["latency"]
    print(f"[fleet] {name}: {c['completed']}/{c['total']} completed, "
          f"{c['requeued']} requeued; SLO attainment "
          f"{card['slo']['attainment']}, latency p50 {lat['p50_s'] * 1e3:.1f}"
          f" / p95 {lat['p95_s'] * 1e3:.1f} / p99 {lat['p99_s'] * 1e3:.1f} "
          f"ms, goodput {card['goodput_rps']} rps, wall {card['wall_s']}s; "
          f"{len(built)} engines, {chunks} chunks + {buckets} warmup, "
          f"{steps} decode steps + {len(warmed)} warmup, launches "
          f"{launches} (exact); radix-shared prompt tokens {shared}/{prompt}")
    print(f"[fleet] {name} ticks p50 (prefill / decode ms) per engine: "
          + ", ".join(f"{s.get('p50_prefill_tick_s', float('nan')) * 1e3:.1f}"
                      f" / {s.get('p50_decode_tick_s', float('nan')) * 1e3:.1f}"
                      for s in sts))
    fl = card["fleet"]
    print(f"[fleet] {name} router: " + json.dumps({
        "hit_rate": fl["affinity_hit_rate"], "prefix_hits":
        fl["prefix_hits"], "session_hits": fl["session_hits"],
        "misses": fl["misses"], "steals": fl["steals"],
        "reroutes": fl["reroutes"], "stall_evasions": fl["stall_evasions"],
        "replicas": {k: {f: v[f] for f in ("submitted", "completed",
                                           "stolen_in", "stolen_out")}
                     for k, v in fl["replicas"].items()}}))
    return card, report, router, system, built, launches


def _stall_evasion(cfg, router, system, built):
    """One more ``engine-stall`` of the replica that holds a fresh
    session, fired through the chaos injector after the chaos replay (its
    engine lock held for 3 s): the session's next request must go to the
    other replica, counted as one stall evasion, and finish while the
    stall lasts.  Both replicas are idle before it, so the other one
    answers the router's probe."""
    from repro_torch.harness import ChaosAction, ChaosInjector

    rng = np.random.default_rng(7)

    def submit():
        before = router.stats()
        t0 = time.monotonic()
        h = router.submit(rng.integers(0, cfg.vocab_size, size=48),
                          max_new_tokens=6, session="stall-probe")
        h.result(timeout=60)
        after = router.stats()
        moved = [k for k, v in after["replicas"].items()
                 if v["submitted"] > before["replicas"][k]["submitted"]]
        return moved, after["stall_evasions"] - before["stall_evasions"], \
            time.monotonic() - t0

    (held,), _, _ = submit()
    engine = [e for e in built if e.replica_id == held][-1]
    chaos = ChaosInjector(system, [])
    rec = chaos.fire(ChaosAction(at_s=0.0, kind="engine-stall",
                                 target=held, duration_s=3.0), 0.0)
    deadline = time.monotonic() + 5.0
    while engine.responsive(0.0) and time.monotonic() < deadline:
        time.sleep(0.001)               # until the stall holds the lock
    t_held = time.monotonic()
    moved, evasions, wall = submit()
    in_stall = not engine.responsive(0.0)
    held_s = time.monotonic() - t_held
    chaos.join(timeout=10.0)
    check(rec.details.get("instances") == [held] and moved and
          moved[0] != held and len(moved) == 1 and evasions == 1 and
          in_stall,
          f"stall of {held}: the session's request went to {moved} with "
          f"{evasions} evasions, the stall still held: {in_stall}")
    print(f"[fleet] stall evasion: session on {held}, stalled for 3 s; its "
          f"next request went to {moved[0]} (1 evasion) and finished in "
          f"{wall * 1e3:.1f} ms, {held_s * 1e3:.1f} ms into the stall")


def _pair_cost(torch, built, cfg):
    """What two engine loop threads on one card cost each other: 4
    requests (64-token prompts, 16 new tokens) served by replica 0 alone,
    then 4 on each replica at once; tick p50 of each.  The device busy
    share is measured in a ``torch.profiler`` trace of the same paired
    traffic once more: the kernels' device time over that run's wall
    (the two loop threads launch on one stream, so the kernels do not
    overlap).  The profiler slows the host, so that share is low; the
    same device time over the untraced run's wall is printed beside it
    as an estimate of the untraced share."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(5)

    def serve(engines, n, new):
        marks = [len(e._tick_log) for e in engines]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        hs = [e.submit(rng.integers(0, cfg.vocab_size, size=64),
                       max_new_tokens=new) for e in engines for _ in range(n)]
        for h in hs:
            h.result(timeout=120)
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3
        ticks = [[t for t in list(e._tick_log)[m:]]
                 for e, m in zip(engines, marks)]
        return wall, ticks

    def p50(ticks, col):
        xs = [t[col] for t in ticks if t[col + 2]]
        return float(np.median(xs)) * 1e3 if xs else float("nan")

    a, b = built[0], built[1]
    solo_wall, (solo,) = serve([a], 4, 16)
    pair_wall, pair = serve([a, b], 4, 16)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_wall, traced = serve([a, b], 4, 16)
    busy = sum(_device_ms(prof).values())
    check(busy > 0, "the paired run's trace shows no device time")
    n_pair = sum(len(t) for t in pair)
    print(f"[fleet] two loop threads: decode tick p50 {p50(solo, 1):.2f} ms "
          f"alone ({len(solo)} ticks in {solo_wall:.0f} ms), "
          f"{p50(pair[0], 1):.2f} / {p50(pair[1], 1):.2f} ms paired "
          f"({n_pair} ticks in {pair_wall:.0f} ms); prefill tick p50 "
          f"{p50(solo, 0):.2f} ms alone, {p50(pair[0], 0):.2f} / "
          f"{p50(pair[1], 0):.2f} ms paired; traced paired run: device "
          f"busy {busy:.1f} ms of its {traced_wall:.0f} ms wall "
          f"({100 * busy / traced_wall:.1f}% measured, "
          f"{sum(len(t) for t in traced)} ticks); over the untraced "
          f"run's {pair_wall:.0f} ms: {100 * busy / pair_wall:.1f}% "
          f"(estimate)")


def _fleet_exactness(torch, total):
    """A 2-layer fp32 fleet at full width on the card: a burst of one
    session queues on one replica and ``rebalance()`` steals some of it;
    every request's greedy tokens equal one solo engine's."""
    from repro_torch.configs import get_config
    from repro_torch.core import EdgeSystem, NodeCapacity, WorkloadClass
    from repro_torch.harness import fleet_trace, make_engine_item
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.router import (fleet_service_spec,
                                            make_fleet_builder)

    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), num_layers=2,
                              compute_dtype="float32")
    params = build_model(cfg, "cuda").init(
        torch.Generator(device="cuda").manual_seed(3))
    items = [make_engine_item(ev, vocab=cfg.vocab_size)
             for ev in fleet_trace(seed=1).events[:16]]
    system = EdgeSystem()
    for i in range(2):
        system.add_node(f"edge{i}", NodeCapacity(hbm_bytes=total // 2))
    system.register_builder("generic", WorkloadClass.HEAVY,
                            make_fleet_builder(cfg, max_slots=4, max_seq=128,
                                               params=params, device="cuda"))
    router = system.deploy_fleet(fleet_service_spec(cfg, name="exact"),
                                 policy="affinity", warmup=True)
    try:
        hs = [router.submit(tokens, max_new_tokens=meta["max_new"],
                            session="hot" if i < 12 else meta["session"],
                            guaranteed=meta["guaranteed"])
              for i, (_, (tokens, meta)) in enumerate(items)]
        moved = router.rebalance()["moved"]
        fleet = [list(h.result(timeout=120).generated) for h in hs]
        st = router.stats()
    finally:
        router.shutdown()
    solo = ServingEngine(cfg, max_slots=4, max_seq=128, params=params,
                         device="cuda")
    sh = [solo.submit(tokens, max_new_tokens=meta["max_new"])
          for _, (tokens, meta) in items]
    solo.run_until_drained()
    want = [list(h.result().generated) for h in sh]
    check(fleet == want, f"fleet tokens differ from a solo engine's: "
          f"{[(i, a, b) for i, (a, b) in enumerate(zip(fleet, want)) if a != b]}")
    print(f"[fleet] exactness, 2 layers fp32 full width: {len(fleet)} "
          f"requests (12 of one session), {moved} stolen by rebalance, "
          f"placement {[(k, v['submitted']) for k, v in st['replicas'].items()]}"
          f"; every stream equals a solo engine's")


def phase_fleet(torch):
    """The replicated engine fleet on the card: an ``EdgeSystem`` of two
    logical nodes on cuda:0 (half of the card's memory each), two
    full-width tinyllama-1.1b replicas deployed by ``deploy_fleet`` over
    one parameter tree from a seed (bf16 compute), replaying the JAX
    package's ``fleet_trace()`` through ``run_fleet_replay``: affinity,
    round-robin, and affinity under ``_fleet_chaos``; then the cost of two
    loop threads on one card, and the fleet's fp32 exactness."""
    from repro_torch.configs import get_config
    from repro_torch.harness import fleet_trace, write_scorecards
    from repro_torch.models.model import build_model

    t_phase = time.monotonic()
    dev = torch.device("cuda", torch.cuda.current_device())
    total = torch.cuda.get_device_properties(dev).total_memory
    cfg = get_config("tinyllama-1.1b")
    check(cfg.num_layers == 22 and cfg.cdtype == torch.bfloat16, "config")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    params = build_model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(0))
    trace = fleet_trace()
    check(trace.fingerprint() == FLEET_TRACE_FINGERPRINT,
          "fleet_trace() differs from the JAX package's")
    print(f"[fleet] trace {trace.name}: {len(trace)} requests over "
          f"{trace.duration_s}s, {sum(e.qos == 'guaranteed' for e in trace.events)}"
          f" GUARANTEED, prompts {min(e.prompt_len for e in trace.events)}-"
          f"{max(e.prompt_len for e in trace.events)} tokens; nodes edge0, "
          f"edge1 on {dev}, {total // 2} B each")
    cards, launches = {}, {"flash_attention": 0, "paged_decode_attention": 0}
    for name, policy, chaos in (("affinity", "affinity", None),
                                ("round-robin", "round-robin", None),
                                ("chaos", "affinity", _fleet_chaos())):
        card, report, router, system, built, counted = _fleet_run(
            torch, trace, cfg, params, total, name, policy, chaos)
        cards[name] = card
        for k, v in counted.items():
            launches[k] += v
        if name == "affinity":
            _pair_cost(torch, built, cfg)
        if name == "chaos":
            kinds = [r.kind for r in report.chaos]
            check(kinds == ["engine-stall", "node-loss", "node-rejoin"] and
                  not any(r.details.get("error") for r in report.chaos),
                  f"chaos records {[r.to_dict() for r in report.chaos]}")
            stall, loss = report.chaos[0], report.chaos[1]
            check(stall.details["instances"] == ["fleet-chat/0"] and
                  loss.details == {"moved": 1, "failover_failed": 0} and
                  len(built) == 3 and card["events"]["failover"] == 1,
                  f"the loss of edge1 must rebuild one replica: "
                  f"{loss.details}, {len(built)} engines")
            # recovery in trace time: from the loss to the first finish of
            # a request that arrived after it
            after = [o.offset_s + o.latency_s for o in report.outcomes
                     if o.ok and o.offset_s >= loss.fired_at_s]
            check(bool(after), "no request that arrived after the loss of "
                  "edge1 completed")
            print(f"[fleet] chaos: stall of fleet-chat/0 fired at "
                  f"{stall.fired_at_s:.3f}s; edge1 lost at "
                  f"{loss.fired_at_s:.3f}s, failover redeployed in "
                  f"{loss.wall_s * 1e3:.1f} ms; the rebuilt replica served "
                  f"{len(built[2].completed)} requests; the first request "
                  f"that arrived after the loss finished "
                  f"{(min(after) - loss.fired_at_s) * 1e3:.1f} ms after it; "
                  f"events {card['events']}")
            _stall_evasion(cfg, router, system, built)
        router.shutdown()
        for eng in built:
            eng.stop(drain=False)
        # the engines sit in reference cycles (loop threads, handles,
        # the system and its router): free them before the next replay
        del router, system, built, report
        gc.collect()
        torch.cuda.empty_cache()
    check(cards["affinity"]["fleet"]["affinity_hit_rate"] >
          cards["round-robin"]["fleet"]["affinity_hit_rate"],
          "affinity's prefix hit rate must be above round-robin's")
    write_scorecards({f"fleet-{k}": v for k, v in cards.items()},
                     path=FLEET_SCORECARDS)
    peak = torch.cuda.max_memory_allocated(dev) - base
    del params
    torch.cuda.empty_cache()
    _fleet_exactness(torch, total)
    print(f"[fleet] peak memory {peak} B over the three replays; "
          f"scorecards in {os.path.relpath(FLEET_SCORECARDS, ROOT)}; phase "
          f"{time.monotonic() - t_phase:.1f}s")
    return launches, 3 * len(trace)


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

    # the dense variants: reduced fp32 gemma-2b at head dim 256,
    # command-r-35b, chameleon-34b and nemotron-4-340b at 192, served by
    # the JAX engine; the streams token for token and the logits, through
    # the flash and paged decode kernels at those head dims
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.models.model import Model

    for arch in sorted({k.split("_")[1] for k in g if k.startswith("dense_")}):
        pre = f"dense_{arch}_"
        vcfg = ModelConfig.from_dict(json.loads(str(g[pre + "config"])))
        vparams = tree(pre + "params/", vcfg)
        before = (fa.flash_attention.launches,
                  pda.paged_decode_attention.launches)
        veng = ServingEngine(vcfg, params=vparams, device="cuda",
                             **json.loads(str(g["engine"])))
        for w in (0, 1):
            for p, n, pw in zip(g["prompts"], g["prompt_lens"], g["waves"]):
                if pw == w:
                    veng.submit(p[:n], max_new_tokens=int(g["max_new"]))
            veng.run_until_drained()
        got = [r.generated for r in sorted(veng.completed.values(),
                                           key=lambda r: r.rid)]
        check(not veng.failed and got == g[pre + "streams"].tolist(),
              f"golden {arch} streams differ:\n{got}\n"
              f"{g[pre + 'streams'].tolist()}")
        check(fa.flash_attention.launches > before[0]
              and pda.paged_decode_attention.launches > before[1],
              f"golden {arch}: the kernels did not run")
        worst = 0.0
        with torch.no_grad():
            for p, n, want in zip(g["prompts"], g["prompt_lens"],
                                  g[pre + "first_logits"]):
                lg = veng.model.forward(vparams, {"tokens": torch.tensor(
                    p[None, :n].astype(np.int64), device="cuda")})[0, -1]
                w = torch.tensor(want, device="cuda")
                worst = max(worst, float((lg - w).abs().max()
                                         / w.abs().max()))
        print(f"[golden] {arch} reduced ({vcfg.num_layers}L d{vcfg.d_model},"
              f" head dim {vcfg.head_dim_}, fp32): the JAX engine's "
              f"{len(got)} streams reproduced on the card (cow copies "
              f"{veng.kv.cow_copies}); last-position logits max rel err "
              f"{worst:.3e} (bound 2e-4)")
        check(worst < 2e-4, f"golden {arch} logits {worst} >= 2e-4")

    # mixtral: reduced fp32 (window 32, 4 experts, the default capacity),
    # prompts of 40-90 tokens on two dense slots, served by the JAX
    # engine; the streams token for token and the logits, through the
    # windowed flash and dense decode kernels
    from repro_torch.kernels import decode_attention as da

    pre = "mixtral_"
    mcfg = ModelConfig.from_dict(json.loads(str(g[pre + "config"])))
    mparams = tree(pre + "params/", mcfg)
    before = (fa.flash_attention.launches, da.decode_attention.launches)
    meng = ServingEngine(mcfg, params=mparams, device="cuda",
                         **json.loads(str(g[pre + "engine"])))
    mprompts = [p[:n] for p, n in zip(g[pre + "prompts"],
                                      g[pre + "prompt_lens"])]
    for p in mprompts:
        meng.submit(p, max_new_tokens=int(g[pre + "max_new"]))
    got = [r.generated for r in sorted(meng.run_until_drained(),
                                       key=lambda r: r.rid)]
    check(not meng.failed and got == g[pre + "streams"].tolist(),
          f"golden mixtral streams differ:\n{got}\n"
          f"{g[pre + 'streams'].tolist()}")
    moved = (fa.flash_attention.launches - before[0],
             da.decode_attention.launches - before[1])
    check(moved[0] == mcfg.num_layers * len(mprompts) and moved[1] > 0,
          f"golden mixtral: flash and dense decode launches {moved}")
    worst = 0.0
    with torch.no_grad():
        for p, want in zip(mprompts, g[pre + "last_logits"]):
            lg = meng.model.forward(mparams, {"tokens": torch.tensor(
                p[None].astype(np.int64), device="cuda")})[0, -1]
            w = torch.tensor(want, device="cuda")
            worst = max(worst, float((lg - w).abs().max() / w.abs().max()))
    print(f"[golden] mixtral-8x7b reduced ({mcfg.num_layers}L "
          f"d{mcfg.d_model}, window {mcfg.sliding_window}, "
          f"{mcfg.moe.num_experts} experts, fp32): the JAX engine's "
          f"{len(got)} streams over prompts of "
          f"{[len(p) for p in mprompts]} tokens reproduced on the card "
          f"(launches: flash {moved[0]}, dense decode {moved[1]}); "
          f"last-position logits max rel err {worst:.3e} (bound 2e-4)")
    check(worst < 2e-4, f"golden mixtral logits {worst} >= 2e-4")

    # deepseek: reduced fp32 at the published MLA widths (kv_lora 512,
    # nope 128, rope 64, v 128; a dense block, then a MoE block with the
    # shared expert), prompts of 40-90 tokens on two dense slots, served
    # by the JAX engine; the streams token for token and the logits,
    # through the fp32 flash kernel at (192, 128) and the fp32 dense
    # decode kernel at (576, 512)
    pre = "deepseek_"
    dcfg = ModelConfig.from_dict(json.loads(str(g[pre + "config"])))
    dm = dcfg.mla
    check((dm.kv_lora_rank, dm.qk_nope_head_dim + dm.qk_rope_head_dim,
           dm.v_head_dim) == (512, 192, 128)
          and dcfg.cdtype == torch.float32,
          f"golden deepseek: config {dcfg}")
    dparams = tree(pre + "params/", dcfg)
    before = (fa.flash_attention.launches, da.decode_attention.launches)
    deng = ServingEngine(dcfg, params=dparams, device="cuda",
                         **json.loads(str(g[pre + "engine"])))
    dprompts = [p[:n] for p, n in zip(g[pre + "prompts"],
                                      g[pre + "prompt_lens"])]
    for p in dprompts:
        deng.submit(p, max_new_tokens=int(g[pre + "max_new"]))
    got = [r.generated for r in sorted(deng.run_until_drained(),
                                       key=lambda r: r.rid)]
    check(not deng.failed and got == g[pre + "streams"].tolist(),
          f"golden deepseek streams differ:\n{got}\n"
          f"{g[pre + 'streams'].tolist()}")
    moved = (fa.flash_attention.launches - before[0],
             da.decode_attention.launches - before[1])
    check(moved[0] == dcfg.num_layers * len(dprompts)
          and moved[1] == dcfg.num_layers * deng.decode_steps,
          f"golden deepseek: flash and dense decode launches {moved}")
    worst = 0.0
    with torch.no_grad():
        for p, want in zip(dprompts, g[pre + "last_logits"]):
            lg = deng.model.forward(dparams, {"tokens": torch.tensor(
                p[None].astype(np.int64), device="cuda")})[0, -1]
            w = torch.tensor(want, device="cuda")
            worst = max(worst, float((lg - w).abs().max() / w.abs().max()))
    print(f"[golden] deepseek-v2-236b reduced ({dcfg.num_layers}L "
          f"d{dcfg.d_model}, {dcfg.num_heads} heads of MLA at kv_lora "
          f"{dm.kv_lora_rank}, q/k {dm.qk_nope_head_dim}+"
          f"{dm.qk_rope_head_dim}, v {dm.v_head_dim}, fp32): the JAX "
          f"engine's {len(got)} streams over prompts of "
          f"{[len(p) for p in dprompts]} tokens reproduced on the card "
          f"(launches: flash {moved[0]}, dense decode {moved[1]}); "
          f"last-position logits max rel err {worst:.3e} (bound 2e-4)")
    check(worst < 2e-4, f"golden deepseek logits {worst} >= 2e-4")

    # the encoder: reduced fp32 edge-cv-heavy at head dims 48 and 80, JAX
    # Model.forward's logits and masked loss, through the fp32 kernel

    for hd in (48, 80):
        pre = f"encoder_{hd}_"
        ecfg = ModelConfig.from_dict(json.loads(str(g[pre + "config"])))
        check(ecfg.head_dim_ == hd and ecfg.cdtype == torch.float32,
              f"golden encoder {hd}: config {ecfg}")
        model = Model(ecfg, "cuda")
        eparams = tree(pre + "params/", ecfg)
        batch = {k: torch.as_tensor(g[pre + k], device="cuda")
                 for k in ("features", "targets", "mask")}
        before = fa.flash_attention.launches
        with torch.no_grad():
            logits = model.forward(eparams, {"features": batch["features"]})
            loss, _ = model.loss(eparams, batch)
        torch.cuda.synchronize()
        check(fa.flash_attention.launches - before == 2 * ecfg.num_layers,
              "golden encoder: the forwards must run the flash kernel")
        want = torch.as_tensor(g[pre + "logits"], device="cuda")
        err = rel_err(want, logits)
        same = bool((want.argmax(-1) == logits.argmax(-1)).all())
        lerr = abs(float(loss) - float(g[pre + "loss"])) / abs(
            float(g[pre + "loss"]))
        print(f"[golden] {ecfg.name} reduced ({ecfg.num_layers}L "
              f"d{ecfg.d_model}, head dim {hd}, fp32): JAX logits max rel "
              f"err {err:.3e} (bound 2e-4), argmax equal {same}, masked "
              f"loss rel err {lerr:.3e} (bound 2e-4)")
        check(err < 2e-4 and same and lerr < 2e-4,
              f"golden encoder {hd}: logits {err}, argmax {same}, loss "
              f"{lerr}")


def phase_golden_train(torch, pre: str = "train_", loss_tol: float = 1e-4,
                       param_tol: float = 1e-4):
    """A JAX training run of the fixture (fp32, 5 steps of
    ``build_train_step``; ``pre`` names it: ``train_`` the decoder's on
    the bigram stream, ``encoder_train_48_`` and ``encoder_train_80_``
    the encoder's on masked-prediction batches, ``mixtral_train_``,
    ``deepseek_train_`` and ``dense_gemma-2b_train_`` the MoE and
    wide-head ones, whose step-0 parameters are the fixture's serving
    parameters named by ``params0_from``) replayed on the card through
    the kernels from its step-0 parameters and AdamW state, restored by
    ``Trainer`` from a checkpoint: each step's loss and grad norm within
    ``loss_tol`` relative, the final parameters within ``param_tol``."""
    from repro_torch.checkpointing import checkpoint as ck
    from repro_torch.data.tokens import make_encoder_iterator, make_lm_iterator
    from repro_torch.launch import programs
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.weights import from_numpy_tree, unflatten
    from repro_torch.optim import adamw, schedule
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import flatten_with_path

    with np.load(os.path.join(ROOT, "tests", "data",
                              "torch_port_golden.npz")) as f:
        g = {k[len(pre):]: f[k] for k in f.files if k.startswith(pre)}
        src = str(g["params0_from"]) if "params0_from" in g else None
        if src:
            g.update({"params0/" + k[len(src):]: f[k] for k in f.files
                      if k.startswith(src)})
    cfg = ModelConfig.from_dict(json.loads(str(g["config"])))
    setup = json.loads(str(g["setup"]))

    def tree(prefix):
        return from_numpy_tree(unflatten(
            {k[len(prefix):]: v for k, v in g.items()
             if k.startswith(prefix)}), cfg, "cuda")

    ckpt = os.path.join(ROOT, "build", "chip_smoke_golden_train")
    shutil.rmtree(ckpt, ignore_errors=True)
    ck.save(ckpt, 0, {"params": tree("params0/"), "opt": {
        "step": torch.zeros((), dtype=torch.int32, device="cuda"),
        "m": tree("opt0/m/"), "v": tree("opt0/v/")}},
        {"step": 0})
    tcfg = programs.TrainConfig(
        adamw=adamw.AdamWConfig(**setup["adamw"]),
        sched=schedule.ScheduleConfig(**setup["sched"]))
    tr = Trainer(cfg, "cuda", tcfg, TrainerConfig(ckpt_dir=ckpt,
                                                  ckpt_every=0))
    tr.initialize(restore=True)
    stream = make_encoder_iterator if cfg.encoder_only else make_lm_iterator
    data = stream(cfg, setup["batch"], setup["seq"], seed=setup["seed"])
    before = [fn.launches for fn, _ in _train_counters()]
    ms = [tr.train_step(next(data)) for _ in range(setup["steps"])]
    moved = [fn.launches - b for (fn, _), b in zip(_train_counters(), before)]
    shutil.rmtree(ckpt, ignore_errors=True)
    check(moved == [_train_launches(name, cfg) * setup["steps"]
                    for _, name in _train_counters()],
          f"golden training did not run through the kernels: {moved}")
    loss_err = max(abs(m["loss"] - w) / abs(w)
                   for m, w in zip(ms, g["losses"]))
    norm_err = max(abs(m["grad_norm"] - w) / abs(w)
                   for m, w in zip(ms, g["grad_norms"]))
    want = dict(flatten_with_path(tree("final/")))
    param_err = max(float((p.detach() - want[path]).abs().max())
                    for path, p in flatten_with_path(tr.params))
    print(f"[golden-train] {pre[:-1]} (head dim {cfg.head_dim_}): the JAX "
          f"trainer's {setup['steps']} fp32 steps "
          f"replayed on the card through the kernels: loss max rel err "
          f"{loss_err:.3e}, grad norm {norm_err:.3e} (bound {loss_tol:.0e}), "
          f"final params max abs err {param_err:.3e} (bound "
          f"{param_tol:.0e})")
    check(loss_err < loss_tol and norm_err < loss_tol
          and param_err < param_tol,
          f"the golden training run {pre[:-1]} does not replay")


# ---------------------------------------------------------------------------
# phase 6: train full-width tinyllama
# ---------------------------------------------------------------------------

def _train_counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab

    return ((fa.flash_attention, "flash_attention"),
            (fab.flash_attention_bwd_dq, "flash_attention_bwd_dq"),
            (fab.flash_attention_bwd_dkv, "flash_attention_bwd_dkv"))


def _train_launches(name: str, cfg) -> int:
    """A train step's launches of the kernel ``name``: one a layer, and a
    second flash forward a layer under any ``remat_policy`` but "none"
    (the block's forward runs again in the backward pass; JAX recomputes
    its Pallas flash under remat too)."""
    again = name == "flash_attention" and cfg.remat_policy != "none"
    return cfg.num_layers * (2 if again else 1)


def _profile_train_step(torch, tr, batch, med_s: float, label: str):
    """One ``tr.train_step(batch)`` in a ``torch.profiler`` trace: the
    device busy share of its wall and of the unprofiled median step
    ``med_s``, the time by kernel group and the top kernels; the bf16
    forward's and backward's tensor-core kernels must each run once a
    layer."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.train_step(batch)
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
    print(f"[profile] {label} step (profiled): wall {wall_ms:.1f} ms, "
          f"device busy {busy:.1f} ms ({100 * busy / wall_ms:.1f}% of the "
          f"profiled wall, {100 * busy / (med_s * 1e3):.1f}% of the "
          f"unprofiled median step; "
          f"{'measured' if by_kernel else 'no device time seen'})")
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
    # (the forward twice under remat)
    for kname, wrapper in (("flash_fwd_wgmma_kernel", "flash_attention"),
                           ("flash_bwd_dq_wgmma_kernel", "dq"),
                           ("flash_bwd_dkv_wgmma_kernel", "dkv")):
        ms = sum(t for name, (t, _) in by_kernel.items() if kname in name)
        n = sum(c for name, (_, c) in by_kernel.items() if kname in name)
        want = _train_launches(wrapper, tr.cfg)
        print(f"[profile]   {kname}: {ms:.3f} ms over {n} launches")
        check(n == want, f"the profiled {label} step ran {kname} {n} "
              f"times, not {want}")


def phase_train(torch):
    """``Trainer`` at full tinyllama width on the card: fp32 parameters,
    bf16 compute, fp32 AdamW moments, the bigram stream at B 8 x T 1024.
    Six counted steps (the first at lr 0), one profiled step, then an
    async checkpoint restored into a fresh ``Trainer``: one more step
    from both gives the same loss."""
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
    for name, n in launches.items():
        want = _train_launches(name, cfg) * steps
        check(n == want, f"{name} launched {n} times, not {want} "
              f"({steps} steps, remat {cfg.remat_policy!r})")
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

    _profile_train_step(torch, tr, batches[steps], med, "train")

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
# phase 6b: encoder training through launch/train.py
# ---------------------------------------------------------------------------

def phase_encoder_train(torch):
    """Encoder training through its entry point,
    ``repro_torch.launch.train.main``: full-width hubert-xlarge (48
    layers, d 1280, 16 heads of 80, about 946 M parameters; fp32
    parameters and AdamW moments, bf16 compute) on masked-prediction
    batches of [8, 500, 512] frames, 6 steps: every loss and grad norm
    finite, the parameters still after step 1 (lr 0) and moved after
    step 2, the flash forward, dq and dk/dv each launched 48 x 6 times;
    the median step, frames/s, the phase's peak memory (what earlier
    phases left allocated subtracted) and a profiled step.  Then
    edge-cv-heavy at the launcher's defaults (B 8 x T 64): 3 steps, then
    one more from their checkpoint (the stream replayed) against 4 steps
    that did not stop: the same last loss."""
    from repro_torch.data.tokens import make_encoder_iterator
    from repro_torch.launch import train
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import leaves

    t_phase = time.monotonic()
    dev = torch.device("cuda", torch.cuda.current_device())
    B, T, steps = 8, 500, 6
    ckpt = os.path.join(ROOT, "build", "chip_smoke_encoder_ckpt")
    for d in (ckpt, ckpt + "_a", ckpt + "_b"):
        shutil.rmtree(d, ignore_errors=True)
    # each step's metrics and the first layer's w_q before and after it
    hist, w_q = [], []
    step = Trainer.train_step

    def spy(self, batch):
        first = self.params["stack"]["blocks"]["attn"]["w_q"][0]
        before = first.detach().clone()
        m = step(self, batch)
        hist.append(m)
        w_q.append((before, first.detach().clone()))
        return m

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated(dev)     # earlier phases' leftovers
    torch.cuda.reset_peak_memory_stats(dev)
    counters = _train_counters()
    for fn, _ in counters:
        fn.launches = 0
    Trainer.train_step = spy
    t0 = time.monotonic()
    try:
        tr, _ = train.main(["--arch", "hubert-xlarge", "--batch", str(B),
                            "--seq", str(T), "--steps", str(steps),
                            "--ckpt-dir", ckpt])
    finally:
        Trainer.train_step = step
    run_s = time.monotonic() - t0
    launches = {name: fn.launches for fn, name in counters}
    peak = torch.cuda.max_memory_allocated(dev) - start
    cfg = tr.cfg
    check(cfg.num_params() == sum(p.numel() for p in leaves(tr.params))
          and cfg.head_dim_ == 80
          and tr.tcfg.adamw.state_dtype == "float32"
          and cfg.compute_dtype == "bfloat16",
          "hubert-xlarge: full width, fp32 AdamW, bf16 compute")
    check(len(hist) == steps, f"{len(hist)} steps ran, not {steps}")
    for i, m in enumerate(hist):
        check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
              f"hubert step {i + 1}: loss {m['loss']} grad norm "
              f"{m['grad_norm']}")
    check(hist[0]["lr"] == 0.0 and bool(torch.equal(*w_q[0])),
          "hubert step 1 trains at lr 0: the parameters must not move")
    check(not bool(torch.equal(w_q[0][0], w_q[1][1])),
          "hubert: the parameters must move after step 2")
    for name, n in launches.items():
        want = _train_launches(name, cfg) * steps
        check(n == want, f"hubert training launched {name} {n} times, "
              f"not {want} ({steps} steps, remat {cfg.remat_policy!r})")
    secs = sorted(m["step_time_s"] for m in hist)
    med = secs[len(secs) // 2]
    print(f"[encoder-train] hubert-xlarge through launch/train.py "
          f"({cfg.num_layers}L d{cfg.d_model}, {cfg.num_params()} parameters, fp32 "
          f"params + AdamW, bf16 compute) on [{B}, {T}, "
          f"{cfg.frontend_dim}] masked-prediction batches: losses "
          f"{[round(m['loss'], 4) for m in hist]}, grad norms "
          f"{[round(m['grad_norm'], 3) for m in hist]}, lr "
          f"{[m['lr'] for m in hist]}")
    print(f"[encoder-train] step time median {med * 1e3:.1f} ms (all "
          f"{[round(m['step_time_s'] * 1e3, 1) for m in hist]} ms), "
          f"{B * T / med:.0f} frames/s; peak {peak} B allocated by the "
          f"phase ({start} B were allocated before it); launches "
          f"{launches}; main() {run_s:.1f}s with its final checkpoint")
    shutil.rmtree(ckpt, ignore_errors=True)
    batch = next(make_encoder_iterator(cfg, B, T, seed=99))
    _profile_train_step(torch, tr, batch, med, "hubert-xlarge train")
    del tr, batch, w_q
    gc.collect()
    torch.cuda.empty_cache()

    # edge-cv-heavy: a restart from the checkpoint resumes the same run
    args = ["--arch", "edge-cv-heavy"]
    _, whole = train.main(args + ["--steps", "4", "--ckpt-dir",
                                  ckpt + "_a"])
    train.main(args + ["--steps", "3", "--ckpt-dir", ckpt + "_b"])
    again, rest = train.main(args + ["--steps", "1", "--ckpt-dir",
                                     ckpt + "_b"])
    a, b = whole["loss"][-1], rest["loss"][-1]
    print(f"[encoder-train] edge-cv-heavy (B 8 x T 64): 4 steps losses "
          f"{[round(x, 6) for x in whole['loss']]}; 3 steps, a restart "
          f"from step {again.step - 1}, one more: {b:.6f} against "
          f"{a:.6f}; phase {time.monotonic() - t_phase:.1f}s")
    check(again.step == 4 and np.isfinite(a)
          and abs(a - b) <= 1e-6 * abs(a),
          "the restarted edge-cv-heavy run's loss differs")
    del again
    for d in (ckpt + "_a", ckpt + "_b"):
        shutil.rmtree(d, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, steps


# ---------------------------------------------------------------------------
# phases 6c-6e: MoE and wide-head training at full width
# ---------------------------------------------------------------------------

# the layers phases 6c and 6d keep: mixtral-8x7b's 2 of 32 (3 164 688 384
# parameters; fp32 with fp32 AdamW moments, 16 B each: 51 GB) and
# deepseek-v2-236b's dense layer and one MoE layer of 60 (5 358 679 040;
# bf16 with int8 moments: about 32 GB); gemma-2b trains whole (PERF.md
# §4)
MIXTRAL_TRAIN_CUT = 2
DEEPSEEK_TRAIN_CUT = 2
# each wide training phase's losses, by label, for phase 6f to hold its
# mesh runs against
TRAIN_LOSSES = {}


def _moe_train_spies(torch):
    """For a MoE training phase: the experts each dispatch kept a pair for
    (one entry a MoE layer, in layer order), and per MoE layer, from the
    gradients AdamW is given, whether its router got a gradient and
    which experts' w_gate, w_up and w_down did.  Returns (the records,
    the undo)."""
    from repro_torch.models import moe
    from repro_torch.optim import adamw

    rec = {"kept": [], "grads": []}
    dispatch, apply = moe._dispatch, adamw.apply_updates

    def spy_dispatch(xt, gate, idx, capacity, cfg):
        buf, meta = dispatch(xt, gate, idx, capacity, cfg)
        keep, order = meta[1], meta[4]
        kept = torch.zeros(cfg.moe.num_experts, dtype=torch.bool,
                           device=idx.device)
        kept[idx.reshape(-1)[order][keep]] = True
        rec["kept"].append(kept)
        return buf, meta

    def spy_apply(params, grads, state, cfg, lr_scale=1.0, **kw):
        g = grads["stack"]["blocks"]["moe"]
        rec["grads"].append((
            g["router"].flatten(1).abs().amax(1) > 0,
            {n: g[n].flatten(2).abs().amax(2) > 0
             for n in ("w_gate", "w_up", "w_down") if n in g}))
        return apply(params, grads, state, cfg, lr_scale, **kw)

    moe._dispatch, adamw.apply_updates = spy_dispatch, spy_apply

    def undo():
        moe._dispatch, adamw.apply_updates = dispatch, apply
    return rec, undo


def _profile_split(torch, tr, batch, label: str):
    """One profiled ``tr.train_step(batch)`` split by where its device time
    goes: the flash forward and backward kernels (by name), the expert
    GEMMs (the ``moe.expert_ffn`` range and the ``bmm`` backward, the only
    ``bmm`` a train step runs), the dispatch and combine (their forward
    ranges; their index backward falls in the rest), the optimizer (a
    range around AdamW's update) and the rest.  The ranges' own
    device-side rows (spans, not kernels) are left out of the sums."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.optim import adamw

    undo_moe = _moe_ranges(torch)
    apply = adamw.apply_updates

    def ranged(*a, **kw):
        with torch.profiler.record_function("optimizer"):
            return apply(*a, **kw)

    adamw.apply_updates = ranged
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tr.train_step(batch)
            torch.cuda.synchronize()
    finally:
        adamw.apply_updates = apply
        undo_moe()
    # each kernel to the range whose device-side span holds its start (a
    # range's own row is a span, not a kernel); the bmm backward by its
    # autograd node's kernels
    spans = {n: [] for n in ("moe.expert_ffn", "moe.dispatch",
                             "moe.combine", "optimizer")}
    kernels, bmm_bwd = [], 0.0
    for ev in prof.events():
        if str(ev.device_type).endswith("CUDA"):
            t = ev.time_range
            (spans[ev.name] if ev.name in spans else kernels).append(
                (ev.name, t.start, t.end) if ev.name not in spans
                else (t.start, t.end))
        elif ev.name == ("autograd::engine::evaluate_function: "
                         "BmmBackward0"):
            bmm_bwd += (getattr(ev, "device_time_total", None)
                        or getattr(ev, "cuda_time_total", 0.0)) / 1e3
    ms = dict.fromkeys(spans, 0.0)
    for name, t0, t1 in kernels:
        for rng, ss in spans.items():
            if any(a <= t0 < b for a, b in ss):
                ms[rng] += (t1 - t0) / 1e3
                break
    busy = sum(t1 - t0 for _, t0, t1 in kernels) / 1e3
    parts = {
        "flash forward": sum(t1 - t0 for n, t0, t1 in kernels
                             if "flash_fwd" in n) / 1e3,
        "flash backward": sum(t1 - t0 for n, t0, t1 in kernels
                              if "flash_bwd" in n) / 1e3,
        "expert GEMMs": ms["moe.expert_ffn"] + bmm_bwd,
        "dispatch + combine (forward)": ms["moe.dispatch"]
        + ms["moe.combine"],
        "optimizer": ms["optimizer"]}
    parts["the rest"] = busy - sum(parts.values())
    print(f"[profile] {label} step split ({busy:.1f} ms of kernels; "
          f"{'measured' if kernels else 'no device time seen'}): "
          + ", ".join(f"{k} {v:.1f} ms ({100 * v / max(busy, 1e-9):.1f}%)"
                      for k, v in parts.items()))
    return parts


def _train_wide(torch, label, cfg, tcfg, B, T, steps, ckpt):
    """``Trainer`` on ``cfg`` at full width: ``steps`` counted steps (the
    first at lr 0) on the bigram stream at B x T, every loss and grad
    norm finite (and ``aux`` > 0 for the moe family), the first layer's
    w_o still after step 1 and moved after step 2, the flash forward, dq and
    dk/dv launched layers x steps; for the moe family a gradient on every
    router and on exactly the experts whose dispatch kept a pair; the
    median step, tokens/s and the phase's peak memory; ``_profile_train
    _step``'s check of the tensor-core kernels and the step's split.
    Returns the launches and the steps."""
    from repro_torch.data.tokens import make_lm_iterator
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves

    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    moe = cfg.family == "moe"
    tr = Trainer(cfg, "cuda", tcfg, TrainerConfig(
        ckpt_dir=ckpt, ckpt_every=0)).initialize(restore=False)
    n_params = sum(p.numel() for p in leaves(tr.params))
    check(n_params == cfg.num_params(),
          f"{label}: {n_params} parameters, not {cfg.num_params()}")
    data = make_lm_iterator(cfg, B, T, seed=0)
    batches = [next(data) for _ in range(steps + 1)]
    init_s = time.monotonic() - t_phase
    counters = _train_counters()
    for fn, _ in counters:
        fn.launches = 0
    rec, undo = _moe_train_spies(torch) if moe else (None, lambda: None)
    L, hist = cfg.num_layers, []
    n_moe = L - (cfg.moe.first_dense_layers if moe else 0)
    try:
        for i in range(steps):
            # the first layer's attention output projection: bf16 values
            # near zero move even at the warmup's first learning rates
            w_o = tr.params["stack"]["blocks"]["attn"]["w_o"][0]
            before = w_o.detach().clone()
            m = tr.train_step(batches[i])
            hist.append(m)
            check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
                  and (m["aux"] > 0 if moe else m["aux"] == 0),
                  f"{label} step {i + 1}: loss {m['loss']} grad norm "
                  f"{m['grad_norm']} aux {m['aux']}")
            moved = not bool(torch.equal(before, w_o))
            check(moved == (i > 0), f"{label} step {i + 1}: the parameters "
                  f"{'moved' if moved else 'did not move'} (step 1 trains "
                  f"at lr 0)")
            if moe:
                kept = torch.stack(rec["kept"][-n_moe:]).cpu()
                router, experts = rec["grads"][-1]
                off = [int((e.cpu() != kept).sum())
                       for e in experts.values()]
                check(bool(router.all()) and not any(off),
                      f"{label} step {i + 1}: router gradients "
                      f"{router.tolist()}; expert gradients differ from the "
                      f"experts that got a token in {off} places")
        launches = {name: fn.launches for fn, name in counters}
        for name, n in launches.items():
            want = _train_launches(name, cfg) * steps
            check(n == want, f"{label}: {name} launched {n} times, not "
                  f"{want} ({steps} steps, remat {cfg.remat_policy!r})")
        TRAIN_LOSSES[label] = [m["loss"] for m in hist]
        secs = sorted(m["step_time_s"] for m in hist)
        med = secs[len(secs) // 2]
        peak = torch.cuda.max_memory_allocated() - start
        print(f"[{label}] {steps} steps: losses "
              f"{[round(m['loss'], 4) for m in hist]}, ce "
              f"{[round(m['ce'], 4) for m in hist]}, aux "
              f"{[round(m['aux'], 5) for m in hist]}, grad norms "
              f"{[round(m['grad_norm'], 3) for m in hist]}, lr "
              f"{[m['lr'] for m in hist]}")
        if moe:
            kept = torch.stack(rec["kept"][-n_moe:])
            print(f"[{label}] the last step's experts with a kept pair: "
                  f"{kept.sum(1).tolist()} of {cfg.moe.num_experts} a MoE "
                  f"layer, each with its gradient; a router gradient in "
                  f"every MoE layer")
        print(f"[{label}] step time median {med * 1e3:.1f} ms (all "
              f"{[round(m['step_time_s'] * 1e3, 1) for m in hist]} ms), "
              f"{B * T / med:.0f} tokens/s; peak {peak} B allocated by the "
              f"phase ({start} B before it); init {init_s:.1f}s; launches "
              f"{launches}")
    finally:
        undo()
    _profile_train_step(torch, tr, batches[steps], med, label)
    _profile_split(torch, tr, batches[steps], label)
    del tr, batches
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{label}] {time.monotonic() - t_phase:.1f}s")
    return launches, steps


def _restart_through_launcher(torch, arch, label):
    """``launch/train.py --arch <arch> --reduced`` on the card: 3 steps,
    then one more from their checkpoint (the stream replayed), against 4
    steps that did not stop: the same last loss."""
    from repro_torch.launch import train

    ckpt = os.path.join(ROOT, "build", f"chip_smoke_{label}_restart")
    for d in (ckpt + "_a", ckpt + "_b"):
        shutil.rmtree(d, ignore_errors=True)
    args = ["--arch", arch, "--reduced", "--batch", "4", "--seq", "64"]
    _, whole = train.main(args + ["--steps", "4", "--ckpt-dir",
                                  ckpt + "_a"])
    train.main(args + ["--steps", "3", "--ckpt-dir", ckpt + "_b"])
    again, rest = train.main(args + ["--steps", "1", "--ckpt-dir",
                                     ckpt + "_b"])
    a, b = whole["loss"][-1], rest["loss"][-1]
    print(f"[{label}] launch/train.py --arch {arch} --reduced (B 4 x T 64) "
          f"on the card: 4 steps losses {[round(x, 6) for x in whole['loss']]}"
          f"; 3 steps, a restart from step {again.step - 1}, one more: "
          f"{b:.6f} against {a:.6f}")
    check(again.step == 4 and np.isfinite(a)
          and abs(a - b) <= 1e-6 * abs(a),
          f"the restarted {arch} run's loss differs")
    del again
    for d in (ckpt + "_a", ckpt + "_b"):
        shutil.rmtree(d, ignore_errors=True)


def _moe_backward_repeats(torch, cfg, n_tok: int, label: str):
    """The MoE layer's gradient repeats on the card: one fp32 MoE layer of
    ``cfg`` at full width (capacity factor 0.25, so that pairs drop) run
    forward and backward twice on the same tokens: dL/dx and every leaf's
    gradient equal bit for bit (the dispatch's gather and the combine's
    scatter have deterministic backward passes)."""
    from repro_torch.models import moe

    cfg = dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype="float32",
        moe=dataclasses.replace(cfg.moe, capacity_factor=0.25))
    gen = torch.Generator(device="cuda").manual_seed(3)
    p = moe.init_moe(gen, cfg)
    x = torch.randn(1, n_tok, cfg.d_model, generator=gen, device="cuda")
    r = torch.randn(1, n_tok, cfg.d_model, generator=gen, device="cuda")
    flat = [t.requires_grad_() for t in
            (p["router"], p["w_gate"], p["w_up"], p["w_down"])]
    if "shared" in p:
        flat += [t.requires_grad_() for t in p["shared"].values()]
    runs = []
    for _ in range(2):
        xi = x.clone().requires_grad_()
        out, aux = moe.apply_moe(p, xi, cfg)
        runs.append(torch.autograd.grad((out * r).sum() + aux,
                                        [xi] + flat))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    print(f"[{label}] fp32 MoE layer at full width ({cfg.moe.num_experts} "
          f"experts of {cfg.moe.d_expert}, top {cfg.moe.top_k}, capacity "
          f"factor 0.25), {n_tok} tokens: two backward passes "
          f"{'equal bit for bit' if same else 'DIFFER'} over dL/dx and "
          f"{len(flat)} leaves")
    check(same, f"{label}: the MoE layer's backward does not repeat")
    del p, x, r, flat, runs
    gc.collect()
    torch.cuda.empty_cache()


def phase_mixtral_train(torch):
    """Phase 6c: mixtral-8x7b trained at full width and cut depth
    (``MIXTRAL_TRAIN_CUT`` of 32 layers: d 4096, 32 heads of 128 over 8
    KV heads, window 4096, 8 experts of 14336, top 2), fp32 parameters
    and the cut config's ``default_train_config`` (fp32 moments, under 30
    B parameters), B 4 x T 1024 (``_train_wide``); then the MoE layer's
    gradient repeats and the launcher's restart on reduced mixtral."""
    from repro_torch.configs import get_config
    from repro_torch.launch import programs

    full = get_config("mixtral-8x7b")
    check(full.d_model == 4096 and full.num_heads == 32
          and full.num_kv_heads == 8 and full.head_dim_ == 128
          and full.sliding_window == 4096 and full.moe.num_experts == 8
          and full.moe.d_expert == 14336 and full.moe.top_k == 2
          and full.param_dtype == "float32",
          f"mixtral-8x7b config {full}")
    cfg = dataclasses.replace(full, num_layers=MIXTRAL_TRAIN_CUT)
    check(cfg.num_params() == 3_164_688_384,
          f"mixtral cut to {cfg.num_layers} layers: {cfg.num_params()}")
    tcfg = programs.default_train_config(cfg)
    check(tcfg.adamw.state_dtype == "float32", "mixtral: fp32 moments")
    _moe_backward_repeats(torch, full, 2048, "mixtral-train")
    out = _train_wide(torch, "mixtral-train", cfg, tcfg, 4, 1024, 4,
                      os.path.join(ROOT, "build", "chip_smoke_mixtral_ckpt"))
    _restart_through_launcher(torch, "mixtral-8x7b", "mixtral-train")
    return out


def phase_deepseek_train(torch):
    """Phase 6d: deepseek-v2-236b trained at full width and cut depth
    (``DEEPSEEK_TRAIN_CUT``: the dense layer and one MoE layer of 160
    experts of 1536, top 6, 2 shared; MLA with q/k 192 over v 128), bf16
    parameters as phase 3i serves them, the full arch's
    ``default_train_config`` (int8 moments) passed as ``tcfg``, B 2 x T
    512 (``_train_wide``), after the MoE layer's gradient repeats; then the
    launcher's restart on reduced deepseek (flash and its backward at q/k
    48 over v 32)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import programs

    full = get_config("deepseek-v2-236b")
    cfg = dataclasses.replace(full, num_layers=DEEPSEEK_TRAIN_CUT,
                              param_dtype="bfloat16")
    check(cfg.num_params() == 5_358_679_040
          and cfg.moe.first_dense_layers == 1,
          f"deepseek cut to {cfg.num_layers} layers: {cfg.num_params()}")
    tcfg = programs.default_train_config(full)
    check(tcfg.adamw.state_dtype == "int8", "deepseek: int8 moments")
    _moe_backward_repeats(torch, full, 1024, "deepseek-train")
    out = _train_wide(torch, "deepseek-train", cfg, tcfg, 2, 512, 4,
                      os.path.join(ROOT, "build",
                                   "chip_smoke_deepseek_ckpt"))
    _restart_through_launcher(torch, "deepseek-v2-236b", "deepseek-train")
    return out


def phase_gemma_train(torch):
    """Phase 6e: gemma-2b trained at full width and depth (18 layers, 8
    heads of 256 over one KV head, vocabulary 256 000), fp32 parameters
    and moments, B 2 x T 1024 (``_train_wide``); then the launcher's
    restart on reduced gemma."""
    from repro_torch.configs import get_config
    from repro_torch.launch import programs

    cfg = get_config("gemma-2b")
    check(cfg.num_layers == 18 and cfg.head_dim_ == 256
          and cfg.num_kv_heads == 1 and cfg.num_params() == 2_506_172_416,
          f"gemma-2b config {cfg}")
    tcfg = programs.default_train_config(cfg)
    check(tcfg.adamw.state_dtype == "float32", "gemma: fp32 moments")
    out = _train_wide(torch, "gemma-train", cfg, tcfg, 2, 1024, 4,
                      os.path.join(ROOT, "build", "chip_smoke_gemma_ckpt"))
    _restart_through_launcher(torch, "gemma-2b", "gemma-train")
    return out


# ---------------------------------------------------------------------------
# phase 6f: training on a device mesh
# ---------------------------------------------------------------------------

def _mesh_trainer_run(torch, mesh, label, cfg, tcfg, B, T, steps):
    """``Trainer`` on ``mesh`` at ``cfg``: ``steps`` steps on the bigram
    stream (seed 0, the batches of phases 6c-6e); per step the bytes the
    forward leaves allocated for the backward (allocated just after
    ``Model.loss`` returns less just before it ran); the losses, the
    median step and the peak."""
    from repro_torch.data.tokens import make_lm_iterator
    from repro_torch.models.model import Model
    from repro_torch.train.trainer import Trainer, TrainerConfig

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tr = Trainer(cfg, mesh, tcfg, TrainerConfig(
        ckpt_dir=os.path.join(ROOT, "build", "chip_smoke_mesh_ckpt"),
        ckpt_every=0)).initialize(restore=False)
    data = make_lm_iterator(cfg, B, T, seed=0)
    act, loss = [], Model.loss

    def measured(self, params, batch):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        out = loss(self, params, batch)
        torch.cuda.synchronize()
        act.append(torch.cuda.memory_allocated() - before)
        return out

    Model.loss = measured
    try:
        hist = [tr.train_step(next(data)) for _ in range(steps)]
    finally:
        Model.loss = loss
    peak = torch.cuda.max_memory_allocated() - base
    secs = sorted(m["step_time_s"] for m in hist)
    out = {"losses": [m["loss"] for m in hist],
           "grad_norms": [m["grad_norm"] for m in hist],
           "median_ms": secs[len(secs) // 2] * 1e3, "peak": peak,
           "activations": max(act)}
    check(all(np.isfinite(out["losses"])) and all(np.isfinite(
        out["grad_norms"])), f"{label}: {out}")
    print(f"[mesh-train] {label}: losses {out['losses']}, median step "
          f"{out['median_ms']:.1f} ms (all "
          f"{[round(m['step_time_s'] * 1e3, 1) for m in hist]}), peak "
          f"{peak} B allocated by the run, the forward's activations "
          f"{out['activations']} B (steps {act})")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mesh_launcher(torch, label):
    """``launch/train.py --arch gemma-2b --reduced --mesh test
    --distributed`` under ``torch.distributed.run`` (one rank, NCCL): 3
    steps, then a restart for one more, whose parameters equal bit for
    bit those of 4 steps that did not stop (run in this process: at world
    size 1 every collective is the identity, so the 1 x 1 mesh computes
    what one device does); and ``--mesh single`` exits non-zero naming
    the world size it needs."""
    from repro_torch.checkpointing import checkpoint as ck
    from repro_torch.launch import train
    from repro_torch.tree import flatten_with_path

    ckpt = os.path.join(ROOT, "build", f"chip_smoke_{label}_launch")
    for d in (ckpt + "_a", ckpt + "_b"):
        shutil.rmtree(d, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    args = ["--arch", "gemma-2b", "--reduced", "--batch", "4", "--seq", "64"]

    def run(*more):
        r = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", "-m", "repro_torch.launch.train",
             *args, *more], capture_output=True, text=True, env=env,
            cwd=ROOT, timeout=300)
        return r, [float(x) for x in re.findall(r"final loss ([0-9.]+)",
                                                r.stdout)]

    t0 = time.monotonic()
    whole, hist = train.main(args + ["--steps", "4", "--ckpt-dir",
                                     ckpt + "_a"])
    first, _ = run("--mesh", "test", "--distributed", "--steps", "3",
                   "--ckpt-dir", ckpt + "_b")
    again, b = run("--mesh", "test", "--distributed", "--steps", "1",
                   "--ckpt-dir", ckpt + "_b")
    for r in (first, again):
        check(r.returncode == 0, f"the launcher under torchrun failed: "
              f"{r.stderr[-2000:]}")
    check("mesh {'data': 1, 'model': 1}" in again.stdout,
          f"the launcher's mesh: {again.stdout[-500:]}")
    tree, _ = ck.restore(ckpt + "_b", 4)
    want = dict(flatten_with_path(whole.params))
    got = dict(flatten_with_path(tree["params"]))
    same = sorted(want) == sorted(got) and all(
        torch.equal(want[k].detach().cpu(), got[k]) for k in want)
    print(f"[mesh-train] torchrun launch/train.py --arch gemma-2b --reduced "
          f"--mesh test --distributed (NCCL, one rank): 3 steps, a restart, "
          f"one more: final loss {b} against 4 unbroken steps' "
          f"{hist['loss'][-1]:.6f}; parameters "
          f"{'bit-equal' if same else 'DIFFER'}")
    check(same and len(b) == 1 and abs(b[0] - hist["loss"][-1]) <= 1e-4,
          "the restarted launcher differs from the unbroken run")
    del whole
    refused, _ = run("--mesh", "single", "--distributed", "--steps", "1",
                     "--ckpt-dir", ckpt + "_c")
    msg = [line for line in refused.stderr.splitlines()
           if "world size 256" in line]
    check(refused.returncode != 0 and msg, f"--mesh single at world size "
          f"1: exit {refused.returncode}, {refused.stderr[-1000:]}")
    print(f"[mesh-train] --mesh single at world size 1 exits "
          f"{refused.returncode}: {msg[0].strip()[:200]}; the launches took "
          f"{time.monotonic() - t0:.1f}s")
    for d in (ckpt + "_a", ckpt + "_b", ckpt + "_c"):
        shutil.rmtree(d, ignore_errors=True)


def _mesh_image(torch, mesh):
    """A decode step of full-width edge-stream-light built as an
    ``ExecutableImage`` with ``in_shardings`` on the 1 x 1 mesh: captured
    (a CUDA graph), replayed twice, each replay's logits, cache and
    lengths equal to the eager step's."""
    from repro_torch.configs import get_config
    from repro_torch.core.executor import ExecutableImage
    from repro_torch.distributed import sharding as shlib
    from repro_torch.launch import programs
    from repro_torch.models.model import Model

    cfg = get_config("edge-stream-light")
    rules = programs.rules_for(mesh)
    model = Model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    B, S = 4, 256
    caches = model.init_caches(B, S)
    cache_len = torch.tensor([3, 17, 0, 100], dtype=torch.int32,
                             device="cuda")
    tokens = torch.arange(B, dtype=torch.int32, device="cuda") + 5
    specs = (shlib.param_partition_specs(params, rules),
             rules.resolve(("batch",), (B,)),
             shlib.cache_partition_specs(caches, rules),
             rules.resolve(("batch",), (B,)))
    step = programs.build_decode_step(cfg, "cuda")
    eager = [step(params, tokens, {k: {n: t.clone() for n, t in v.items()}
                                   for k, v in caches.items()}, cache_len)]
    img = ExecutableImage.build("mesh-decode", step,
                                (params, tokens, caches, cache_len),
                                donate_argnums=(2,), in_shardings=specs,
                                mesh=mesh)
    check(img.captured, "the sharded decode image was not captured")
    same = []
    for _ in range(2):
        fresh = {k: {n: t.clone() for n, t in v.items()}
                 for k, v in caches.items()}
        out = img(*img.place((params, tokens, fresh, cache_len)))
        torch.cuda.synchronize()
        same.append(bool(torch.equal(out[0], eager[0][0]))
                    and bool(torch.equal(out[1]["attn"]["k"],
                                         eager[0][1]["attn"]["k"]))
                    and bool(torch.equal(out[2], eager[0][2])))
    print(f"[mesh-train] sharded decode image (edge-stream-light, B {B} x "
          f"S {S}, in_shardings on the 1 x 1 mesh): captured "
          f"{img.captured_launches}, replays {img.replays}, equal to the "
          f"eager step: {same}")
    check(all(same), "the sharded image's replay differs from the eager "
          "step")
    del img, params, caches
    gc.collect()
    torch.cuda.empty_cache()


def _mixtral_mesh_step(torch, mesh):
    """Two train steps (the first at lr 0) of reduced fp32 mixtral at
    capacity factor E (no pair drops on any rank) on ``mesh``, from seed
    0, B 4 x T 64: each step's loss, grad norm and aux, and the whole
    parameters after them on the CPU."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.data.tokens import make_lm_iterator
    from repro_torch.launch import programs
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig, gather
    from repro_torch.tree import flatten_with_path

    cfg = dataclasses.replace(get_reduced_config("mixtral-8x7b"),
                              compute_dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    tcfg = programs.TrainConfig(adamw=adamw.AdamWConfig(eps=1e-5))
    tr = Trainer(cfg, mesh, tcfg, TrainerConfig(
        ckpt_dir=os.path.join(ROOT, "build", "chip_smoke_mesh_ckpt"),
        ckpt_every=0)).initialize(restore=False)
    data = make_lm_iterator(cfg, 4, 64, seed=0)
    hist = [tr.train_step(next(data)) for _ in range(2)]
    whole = gather(tr.params, tr.param_specs(), tr.comm)
    return ([{k: m[k] for k in ("loss", "grad_norm", "aux")} for m in hist],
            {p: v.detach().float().cpu() for p, v in flatten_with_path(whole)})


def _two_rank_worker(rank: int, store: str) -> None:
    """One of two ranks on the one card: a gloo group over a
    ``FileStore``, the (1, 2) mesh on cuda, ``_mixtral_mesh_step``."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    out = _mixtral_mesh_step(torch, make_test_mesh(1, 2))
    if rank == 0:
        torch.save(out, store + ".out")
    dist.barrier()
    dist.destroy_process_group()


def _two_ranks_on_one_card(torch, want):
    """The (1, 2) mesh of two gloo ranks whose tensors both live on the
    one card (experts and heads over a model axis of 2): reduced mixtral's
    two steps against the one-rank run ``want``, metrics within 1e-5
    relative and parameters within 1e-5 of each leaf's largest
    (``tests/test_torch_mesh_train.py``'s bounds)."""
    import multiprocessing as mp

    store = os.path.join(ROOT, "build", "chip_smoke_two_rank_store")
    for f in (store, store + ".out"):
        if os.path.exists(f):
            os.remove(f)
    t0 = time.monotonic()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_two_rank_worker, args=(r, store))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    check(not alive and all(p.exitcode == 0 for p in procs),
          f"the two ranks on one card: exit codes "
          f"{[p.exitcode for p in procs]}")
    metrics, params = torch.load(store + ".out")
    err = max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(metrics, want[0])
              for k in ("loss", "grad_norm", "aux"))
    perr, where = 0.0, ""
    for path, w in want[1].items():
        e = float((params[path] - w).abs().max() / max(
            float(w.abs().max()), 1e-6))
        if e > perr:
            perr, where = e, path
    print(f"[mesh-train] reduced fp32 mixtral on a (1, 2) mesh of two gloo "
          f"ranks on the one card: losses {[m['loss'] for m in metrics]} "
          f"against one rank's {[m['loss'] for m in want[0]]}; metrics "
          f"within {err:.2e} relative, parameters within {perr:.2e} of a "
          f"leaf (worst {where}); {time.monotonic() - t0:.1f}s")
    check(err <= 1e-5 and perr <= 1e-5, f"two ranks against one: metrics "
          f"{err}, parameters {perr} ({where})")
    for f in (store, store + ".out"):
        if os.path.exists(f):
            os.remove(f)


def phase_mesh_train(torch):
    """Phase 6f: training on a device mesh at world size 1 over NCCL (a
    ``FileStore`` under ``build/``, the 1 x 1 ``make_test_mesh`` on
    cuda; no other backend is tried): gemma-2b at full width and depth
    (fp32, B 2 x T 1024, phase 6e's seed and batches) through the mesh
    ``Trainer``, 3 steps at each ``remat_policy`` (none, minimal: the
    config's, full): the three runs' losses within 1e-6 relative, "none"'s
    against phase 6e's, and the forward's activation bytes in the order
    full < minimal < none; deepseek-v2-236b at ``DEEPSEEK_TRAIN_CUT``
    (bf16 parameters, int8 moments placed by ``opt_state_shardings``,
    remat "full"), 2 steps against phase 6d's losses within 2e-5; the
    launcher under torchrun and its exact restart; a sharded decode
    image; ``hierarchical_psum`` on a (1, 1, 1) pod mesh equal to one
    int8 round trip; and two gloo ranks on the one card training reduced
    mixtral on a (1, 2) mesh as one rank does.  Returns the launches (the
    in-process runs') and the steps."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import programs
    from repro_torch.launch.mesh import make_test_mesh

    t_phase = time.monotonic()
    store_path = os.path.join(ROOT, "build", "chip_smoke_mesh_store")
    if os.path.exists(store_path):
        os.remove(store_path)
    dist.init_process_group("nccl", store=dist.FileStore(store_path, 1),
                            rank=0, world_size=1)
    try:
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
        mesh = make_test_mesh(1, 1)
        check(mesh.device_type == "cuda", f"mesh on {mesh.device_type}")
        before = launch_counts()
        gemma = get_config("gemma-2b")
        check(gemma.remat_policy == "minimal", gemma.remat_policy)
        runs = {}
        for policy in ("none", "minimal", "full"):
            cfg = dataclasses.replace(gemma, remat_policy=policy)
            runs[policy] = _mesh_trainer_run(
                torch, mesh, f"gemma-2b remat {policy}", cfg,
                programs.default_train_config(cfg), 2, 1024, 3)
        ref = runs["none"]["losses"]
        for policy in ("minimal", "full"):
            got = runs[policy]["losses"]
            check(all(abs(a - b) <= 1e-6 * abs(a) for a, b in zip(ref, got)),
                  f"remat {policy}: losses {got} against {ref}")
        e6 = TRAIN_LOSSES["gemma-train"][:3]
        check(all(abs(a - b) <= 1e-6 * abs(b) for a, b in zip(ref, e6)),
              f"the mesh Trainer's losses {ref} against phase 6e's {e6}")
        act = {p: r["activations"] for p, r in runs.items()}
        print(f"[mesh-train] gemma-2b on the 1 x 1 NCCL mesh: losses "
              f"{'bit-equal to' if ref == e6 else 'within 1e-6 of'} phase "
              f"6e's {e6}; across remat policies "
              f"{'bit-equal' if all(r['losses'] == ref for r in runs.values()) else 'within 1e-6'}"
              f"; forward activations {act} B; peaks "
              f"{ {p: r['peak'] for p, r in runs.items()} } B; median steps "
              f"{ {p: round(r['median_ms'], 1) for p, r in runs.items()} } ms")
        check(act["full"] < act["minimal"] < act["none"],
              f"activation bytes not full < minimal < none: {act}")

        full = get_config("deepseek-v2-236b")
        cfg = dataclasses.replace(full, num_layers=DEEPSEEK_TRAIN_CUT,
                                  param_dtype="bfloat16")
        tcfg = programs.default_train_config(full)
        check(tcfg.adamw.state_dtype == "int8"
              and cfg.remat_policy == "full", "deepseek: int8, remat full")
        ds = _mesh_trainer_run(torch, mesh, "deepseek-v2-236b cut",
                               cfg, tcfg, 2, 512, 2)
        d6 = TRAIN_LOSSES["deepseek-train"][:2]
        check(all(abs(a - b) <= 2e-5 * abs(b)
                  for a, b in zip(ds["losses"], d6)),
              f"deepseek on the mesh: {ds['losses']} against phase 6d's "
              f"{d6}")
        print(f"[mesh-train] deepseek-v2-236b cut, int8 moments on the "
              f"mesh: losses {ds['losses']} "
              f"{'bit-equal to' if ds['losses'] == d6 else 'within 2e-5 of'}"
              f" phase 6d's {d6}")
        _mesh_image(torch, mesh)
        launches = {k: v - before[k] for k, v in launch_counts().items()}

        pods = init_device_mesh("cuda", (1, 1, 1),
                                mesh_dim_names=("pod", "data", "model"))
        x = torch.randn(8, 1000, device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(3))
        got = collectives.hierarchical_psum(x, mesh=pods)
        want = collectives.dequantize_block(
            *collectives.quantize_block(x), x.shape)
        err = float((got - x).abs().max() / x.abs().max())
        check(bool(torch.equal(got, want)),
              "hierarchical_psum on a (1, 1, 1) mesh is not one int8 "
              "round trip")
        print(f"[mesh-train] hierarchical_psum(int8_cross_pod=True) on a "
              f"(1, 1, 1) pod mesh: equal to dequantize(quantize(x)) "
              f"({err:.2e} of max|x| from x)")
        one_rank = _mixtral_mesh_step(torch, mesh)
    finally:
        dist.destroy_process_group()
    _two_ranks_on_one_card(torch, one_rank)
    _mesh_launcher(torch, "mesh-train")
    for name in ("flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "decode_attention"):
        check(launches[name] > 0, f"phase 6f never launched {name}")
    print(f"[mesh-train] launches {launches}; phase 6f "
          f"{time.monotonic() - t_phase:.1f}s")
    return launches, 3 * 3 + 2 + 2


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
    want = [_train_launches(name, cfg) for _, name in counters]
    check(moved == want, f"2 layers must launch each kernel twice (the "
          f"forward again under remat): {moved}, not {want}")
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


def phase_encoder_train_consistency(torch):
    """One full-width hubert-xlarge layer in fp32 (d 1280, 16 heads of
    80, non-causal): every gradient leaf of ``Model.loss`` on a [2, 256]
    masked-prediction batch through the kernels against the plain path,
    within 2e-4 relative (the unread embedding's zero aside)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import make_encoder_iterator
    from repro_torch.kernels import ops, ref
    from repro_torch.models.model import Model
    from repro_torch.tree import flatten_with_path

    cfg = dataclasses.replace(get_config("hubert-xlarge"), num_layers=1,
                              compute_dtype="float32")
    model = Model(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = model.init(gen)
    # mask_embed starts at zero, and one layer's masked rows would then
    # normalise to zero: q and k of the only rows the loss reads vanish,
    # and with them w_q's and w_k's gradients
    me = params["frontend"]["mask_embed"]
    me.copy_(torch.randn(me.shape, generator=gen, device="cuda"))
    flat = [(path, p) for path, p in flatten_with_path(params)
            if path not in model.unread_leaves()]
    for _, p in flat:
        p.requires_grad_(True)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in
             next(make_encoder_iterator(cfg, 2, 256, seed=5)).items()}

    def grads():
        loss, _ = model.loss(params, batch)
        return float(loss.detach()), torch.autograd.grad(
            loss, [p for _, p in flat])

    counters = _train_counters()
    before = [fn.launches for fn, _ in counters]
    loss_k, g_k = grads()
    moved = [fn.launches - b for (fn, _), b in zip(counters, before)]
    want = [_train_launches(name, cfg) for _, name in counters]
    check(moved == want, f"one layer must launch each kernel once (the "
          f"forward again under remat): {moved}, not {want}")
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
    print(f"[train-consistency] hubert-xlarge fp32 full width, 1 layer, "
          f"B 2 x T 256: loss {loss_k:.6f} (kernels) vs {loss_p:.6f} "
          f"(plain); every gradient leaf within {worst:.3e} relative "
          f"(worst {where}; bound 2e-4)")
    check(worst < 2e-4, f"encoder gradients through the kernels differ: "
          f"{worst}")
    del model, params, flat, g_k, g_p
    torch.cuda.empty_cache()


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
DENSE_PATHS = ("gemma", "gemma_spec", "command-r", "chameleon", "nemotron")
WIDE_TRAIN_PATHS = ("mixtral_train", "deepseek_train", "gemma_train",
                    "mesh_train")
PATH_OF = {"flash_attention": ("serve", "edge", "fleet", "hubert",
                               "hubert_train", "mixtral", "deepseek")
           + DENSE_PATHS + WIDE_TRAIN_PATHS,
           "paged_decode_attention": ("serve", "edge", "fleet")
           + DENSE_PATHS,
           "paged_verify_attention": ("spec", "gemma_spec"),
           "decode_attention": ("spec", "zamba2", "edge", "gemma_spec",
                                "mixtral", "deepseek", "mesh_train"),
           "flash_attention_bwd_dq": ("train", "hubert_train")
           + WIDE_TRAIN_PATHS,
           "flash_attention_bwd_dkv": ("train", "hubert_train")
           + WIDE_TRAIN_PATHS,
           "ssd_scan": ("mamba2",), "rmsnorm": ("mamba2",)}
UNIT_OF = {"serve": "request", "spec": "request", "train": "step",
           "mamba2": "request", "zamba2": "request", "edge": "dispatch",
           "fleet": "request", "hubert": "batch", "hubert_train": "step",
           "mixtral": "request", "deepseek": "request",
           **{p: "request" for p in DENSE_PATHS},
           **{p: "step" for p in WIDE_TRAIN_PATHS}}


def _path_rate(paths: dict, name: str, tag: str) -> dict:
    """A timed shape named after a serving or training path
    (``@mixtral``, ``@gemma_train``): that path's launches of the kernel
    per 10 requests or per step."""
    if tag not in paths or name not in paths[tag][0]:
        return {}
    launches, n = paths[tag]
    if UNIT_OF.get(tag) == "request":
        return {"path": tag,
                "launches_per_10_requests": 10 * launches[name] / n}
    if UNIT_OF.get(tag) == "step":
        return {"path": tag, "launches_per_step": launches[name] / n}
    return {}


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
             "edge": phase_edge(torch), "fleet": phase_fleet(torch),
             "hubert": phase_hubert(torch)}
    paths.update(phase_dense_variants(torch))
    paths["mixtral"] = phase_mixtral(torch)
    paths["deepseek"] = phase_deepseek(torch)
    phase_consistency(torch)
    phase_ssm_consistency(torch)
    phase_spec_exactness(torch)
    phase_golden(torch)
    paths["train"] = phase_train(torch)
    paths["hubert_train"] = phase_encoder_train(torch)
    paths["mixtral_train"] = phase_mixtral_train(torch)
    paths["deepseek_train"] = phase_deepseek_train(torch)
    paths["gemma_train"] = phase_gemma_train(torch)
    paths["mesh_train"] = phase_mesh_train(torch)
    phase_train_consistency(torch)
    phase_encoder_train_consistency(torch)
    for pre in ("train_", "encoder_train_48_", "encoder_train_80_"):
        phase_golden_train(torch, pre)
    for pre in ("mixtral_train_", "deepseek_train_",
                "dense_gemma-2b_train_"):
        phase_golden_train(torch, pre, loss_tol=2e-5, param_tol=2e-4)
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
                         {**{key: kernels[k][key] for key in (
                             "shape", "ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms")},
                          **({"library": kernels[k]["library"]}
                             if "library" in kernels[k] else {}),
                          **_path_rate(paths, name, k.split("@")[1])}
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
