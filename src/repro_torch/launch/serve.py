"""Serving entry point of the port: a continuous-batching engine deployed
as a ServiceSpec, on the GPU.

Same flags, traffic generator and report lines as ``repro.launch.serve``,
plus ``--device``.  The engine is not hand-built: a declarative spec is
applied to an ``EdgeSystem`` whose builder wraps a ``ServingEngine`` in a
container-class executor (``serving.router.make_engine_builder``).  Every
prompt is submitted up front to the background engine loop, which
overlaps one request's prefill chunks with the others' decode.  The
engine picks its data plane: paged KV for the dense decoder, dense slots
for ``mamba2-2.7b``, ``zamba2-1.2b``, ``mixtral-8x7b`` (sliding-window
rings, exact-length prefill; at full depth its 93 GB of bf16 weights
exceed one card, so run it ``--reduced``) and ``deepseek-v2-236b`` (MLA's
latent cache, pow2-bucketed whole-prompt prefill; at full depth its
235 741 434 880 parameters are 471 GB in bf16, six cards' worth, so run
it ``--reduced``).  ``--save-state`` writes the
applied specs and quotas (``EdgeSystem.restore`` re-applies them).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --reduced --requests 8

On the CPU (``--device cpu``) the node's capacity is the host's memory;
on the card it is the card's.  ``main`` returns the ``EdgeSystem``.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np


def _host_memory() -> int:
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="per-request latency SLO; every 4th request gets "
                         "a tight SLO and should jump the queue")
    ap.add_argument("--save-state", default="",
                    help="persist applied specs + quotas to this path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.core import (EdgeSystem, ExecutorClass, NodeCapacity,
                                  QoSClass, ServiceSpec, Workload,
                                  WorkloadClass, WorkloadKind)
    from repro_torch.device import resolve_device
    from repro_torch.serving.router import make_engine_builder

    cfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    if cfg.encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving")

    device = resolve_device(args.device)
    system = EdgeSystem()
    system.add_node("edge0", NodeCapacity(hbm_bytes=_host_memory())
                    if device.type == "cpu" else None)
    system.register_builder(
        "decode", WorkloadClass.HEAVY,
        make_engine_builder(cfg, max_slots=args.slots, max_seq=args.max_seq,
                            device=device))
    spec = ServiceSpec(
        name="llm-serving",
        workload=Workload("serve", WorkloadKind.DECODE, cfg,
                          batch=args.slots, seq_len=args.max_new),
        executor_class=ExecutorClass.CONTAINER,
        tenant="serving", qos=QoSClass.GUARANTEED,
        latency_slo_ms=args.slo_ms)
    (dep,) = system.apply(spec)
    engine = dep.executor.engine

    # every prefill shape and the decode step run once BEFORE traffic
    engine.warmup()
    plane = "paged KV" if engine.paged else "dense slots"
    print(f"warmup: {engine.warmup_s:.2f}s ({plane}, "
          f"chunk={engine.chunk_tokens}, "
          f"budget={engine.prefill_budget} tok/tick)")

    rng = np.random.default_rng(0)
    t0 = time.monotonic()
    with engine:                       # start the background engine loop
        handles = []
        for i in range(args.requests):
            plen = int(rng.integers(4, args.max_seq // 2))
            # a tight-SLO request every 4th submission: the engine's
            # SLO-slack ordering admits these ahead of FIFO arrivals
            slo = args.slo_ms if (args.slo_ms and i % 4 == 3) else 0.0
            handles.append(engine.submit(
                rng.integers(0, cfg.vocab_size, size=plen),
                max_new_tokens=args.max_new, latency_slo_ms=slo))
        done = [h.result(timeout=300.0) for h in handles]
    dt = time.monotonic() - t0
    toks = sum(len(r.generated) for r in done)
    print(f"served {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / max(dt, 1e-9):.1f} tok/s, {engine.ticks} overlapped "
          f"ticks vs ~{args.requests * args.max_new} serialized) "
          f"via {dep.name} on {dep.node_id} ({engine.device})")
    for r in done[:3]:
        ttft = (r.first_token_at - r.submitted_at) * 1e3
        print(f"  rid={r.rid} prompt={len(r.prompt)} ttft={ttft:.0f}ms "
              f"generated={r.generated[:8]}...")

    stats = engine.stats()
    for key in ("p50_request_wall_s", "p95_request_wall_s",
                "p99_request_wall_s", "p50_ttft_s", "p95_ttft_s",
                "p50_prefill_tick_s", "p95_prefill_tick_s",
                "p50_decode_tick_s", "p95_decode_tick_s"):
        if key in stats:
            print(f"  {key}={stats[key] * 1e3:.1f}ms")
    print(f"  kv: dense-equivalent "
          f"{stats['kv_dense_equivalent_bytes'] / 2**20:.1f}MiB -> "
          f"pool {stats['kv_capacity_bytes'] / 2**20:.1f}MiB, "
          f"peak in-tick budget "
          f"{stats.get('max_prefill_tokens_tick', 0)} prefill tok")
    summary = engine.dispatch_stats.summary()["heavy"]
    if summary:
        print(f"  dispatch_stats: count={summary['count']} "
              f"p50={summary['p50_wall_s'] * 1e3:.1f}ms "
              f"p95={summary['p95_wall_s'] * 1e3:.1f}ms "
              f"p99={summary['p99_wall_s'] * 1e3:.1f}ms")
    print(f"  footprint: static {dep.executor.footprint_bytes() / 2**20:.1f}"
          f"MiB, dynamic "
          f"{dep.executor.dynamic_footprint_bytes() / 2**20:.1f}MiB")

    if args.slo_ms:
        slo_reqs = [r for r in done if r.latency_slo_ms > 0]
        met = sum((r.finished_at - r.submitted_at) * 1e3 <= r.latency_slo_ms
                  for r in slo_reqs)
        print(f"  slo: {met}/{len(slo_reqs)} tight-SLO requests "
              f"within {args.slo_ms:.0f}ms; "
              f"p95_queue_s={stats.get('p95_queue_s', 0.0) * 1e3:.1f}ms")
        n = system.autoscale("llm-serving", mode="slo", max_n=4)
        print(f"  slo-autoscale: engine replicas -> {n}")
    if args.save_state:
        system.save_state(args.save_state)
        print(f"  state saved to {args.save_state} "
              f"(EdgeSystem.restore re-applies it after a manager restart)")
    return system


if __name__ == "__main__":
    main()
