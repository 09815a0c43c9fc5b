"""Serving entry point of the port: a ``ServingEngine`` on the GPU.

Same flags, traffic generator and report lines as ``repro.launch.serve``,
plus ``--device``.  The JAX script deploys the engine through an
``EdgeSystem`` and a ``ServiceSpec``; that control plane is not ported yet
(ROADMAP Queue A item 9), so this script builds the engine directly.
Every prompt is submitted up front to the background engine loop, which
overlaps one request's prefill chunks with the others' decode.  The
engine picks its data plane: paged KV for the dense decoder, dense slots
for ``mamba2-2.7b`` and ``zamba2-1.2b``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --reduced --requests 8
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None) -> None:
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
                    help="persist applied specs + quotas (needs the "
                         "control plane, not ported yet)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    if args.save_state:
        raise NotImplementedError(
            "--save-state needs the EdgeSystem control plane, not ported "
            "yet (ROADMAP Queue A item 9)")

    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.serving.engine import ServingEngine

    cfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    if cfg.encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving")

    engine = ServingEngine(cfg, max_slots=args.slots, max_seq=args.max_seq,
                           device=args.device)
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
            slo = args.slo_ms if (args.slo_ms and i % 4 == 3) else 0.0
            handles.append(engine.submit(
                rng.integers(0, cfg.vocab_size, size=plen),
                max_new_tokens=args.max_new, latency_slo_ms=slo))
        done = [h.result(timeout=300.0) for h in handles]
    dt = time.monotonic() - t0
    toks = sum(len(r.generated) for r in done)
    print(f"served {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, {engine.ticks} overlapped ticks vs "
          f"~{args.requests * args.max_new} serialized) "
          f"via serving-engine on {engine.device}")
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
    if args.slo_ms:
        slo_reqs = [r for r in done if r.latency_slo_ms > 0]
        met = sum((r.finished_at - r.submitted_at) * 1e3 <= r.latency_slo_ms
                  for r in slo_reqs)
        print(f"  slo: {met}/{len(slo_reqs)} tight-SLO requests "
              f"within {args.slo_ms:.0f}ms; "
              f"p95_queue_s={stats.get('p95_queue_s', 0.0) * 1e3:.1f}ms")


if __name__ == "__main__":
    main()
