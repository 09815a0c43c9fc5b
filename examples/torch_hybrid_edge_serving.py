"""The paper's system, end to end (fig 1/2), on the PyTorch/CUDA port: a
mixed IoT workload stream — "images" (heavy inference) and sensor records
(light analytics) — flows through the edge system, which classifies each
task (application-aware), places it on a node with headroom
(resource-aware, orchestrator policy), and runs it on the right executor
class: container-class for the heavy model (the flash attention kernel on
the card), unikernel-class image (one captured CUDA graph) for the stream
task.

Everything is declared up front as ``ServiceSpec`` manifests applied to an
``EdgeSystem`` facade — operators state WHAT to run (replicas, class,
SLO); the runtime decides WHERE.  Mid-run, a node fails; the orchestrator
redeploys from the stored specs and the stream continues.

The four workers share the one card (each is given its memory);
``--device cpu`` runs the plain PyTorch path with the host's memory as
each worker's capacity.  Without a GPU and without ``--device cpu`` it
raises.

    PYTHONPATH=src python examples/torch_hybrid_edge_serving.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.core import (EdgeSystem, LeastLoadedPolicy, Workload,
                              WorkloadKind)
from repro_torch.core.resources import host_capacity
from repro_torch.data import stream as stream_lib
from repro_torch.device import resolve_device
from repro_torch.serving import router


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # ---- edge cluster: 1 manager + 4 workers (paper §III-D)
    system = EdgeSystem(policy=LeastLoadedPolicy())
    for i in range(4):
        system.add_node(f"worker{i}", host_capacity(device), mesh=device)

    heavy_cfg = get_reduced_config("edge-cv-heavy")
    light_cfg = get_reduced_config("edge-stream-light")
    scfg = stream_lib.StreamConfig(num_users=16, batch_records=32)
    router.assemble_edge_system(system, heavy_cfg=heavy_cfg,
                                light_cfg=light_cfg, scfg=scfg,
                                device=device)

    # ---- declare the standing services: 2 CV replicas, 2 stream replicas
    for spec in router.standard_specs(heavy_cfg, replicas_heavy=2,
                                      replicas_stream=2):
        deps = system.apply(spec)
        print(f"applied {spec.name} x{spec.replicas} -> "
              f"{[d.node_id for d in deps]}")

    # ---- mixed workload stream
    rng = np.random.default_rng(0)
    records = stream_lib.make_record_stream(scfg)
    state = stream_lib.init_state(scfg, device)

    for i in range(6):
        # "image" arrives → heavy (container-class)
        feats = torch.as_tensor(
            rng.normal(size=(1, 32, heavy_cfg.frontend_dim)),
            dtype=torch.float32, device=device)
        w = Workload(f"frame{i}", WorkloadKind.GENERIC, heavy_cfg,
                     batch=1, seq_len=32,
                     est_flops=2.0 * heavy_cfg.num_params() * 32 * 300)
        res = system.submit(w, (feats,))
        print(f"[{w.name}] -> {res.workload_class.value:5s} on "
              f"{res.node_id} via {res.executor_name} "
              f"({res.wall_s * 1e3:.1f} ms)")

        # sensor records arrive → light (unikernel-class)
        rec = stream_lib.to_device(next(records), device)
        w2 = Workload(f"sensor{i}", WorkloadKind.STREAM)
        res2 = system.submit(w2, (state, rec))
        state, out = res2.output
        print(f"[{w2.name}] -> {res2.workload_class.value:5s} on "
              f"{res2.node_id} via {res2.executor_name} "
              f"max_avg_steps={float(out['max_avg_steps']):.0f}")

        if i == 2:
            victim = res2.node_id
            # paper P4: failover — instances redeploy from stored specs
            moved = system.orchestrator.on_node_failure(victim)
            print(f"!! node {victim} failed -> redeployed {moved}")

    # ---- elastic: scale the stream service from its stored spec
    n = system.scale("stream-analytics", 3)
    print(f"scaled stream-analytics to {n} replicas")

    print("\n--- system report ---")
    rep = system.report()
    print(f"heavy: {rep['heavy']}")
    print(f"light: {rep['light']}")
    print(f"services: {rep['services']}")
    print(f"events: {system.events}")


if __name__ == "__main__":
    main()
