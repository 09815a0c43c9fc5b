"""The paper's unikernel workload: Fitbit-style stream analytics on a
single-purpose executable with donated state — declared as a
``ServiceSpec`` and dispatched through the ``EdgeSystem`` — on the
PyTorch/CUDA port.

On the card the image is one captured CUDA graph; ``--device cpu`` runs
the plain PyTorch path (each node then gets the host's memory as its
capacity).  Without a GPU and without ``--device cpu`` it raises.

    PYTHONPATH=src python examples/torch_stream_analytics.py [--device cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core import (EdgeSystem, ExecutorClass, ServiceSpec,
                              Workload, WorkloadClass, WorkloadKind)
from repro_torch.core.resources import host_capacity
from repro_torch.data import stream as stream_lib
from repro_torch.device import resolve_device
from repro_torch.serving.router import make_stream_builder


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    scfg = stream_lib.StreamConfig(num_users=32, batch_records=64)

    system = EdgeSystem()
    system.add_node("edge0", host_capacity(device), mesh=device) \
        .add_node("edge1", host_capacity(device), mesh=device)
    system.register_builder("stream", WorkloadClass.LIGHT,
                            make_stream_builder(system.registry, scfg,
                                                device=device))

    t0 = time.monotonic()
    (dep,) = system.apply(ServiceSpec(
        name="fitbit-analytics",
        workload=Workload("fitbit", WorkloadKind.STREAM),
        executor_class=ExecutorClass.UNIKERNEL))
    print(f"built unikernel image in {time.monotonic() - t0:.2f}s "
          f"(footprint {dep.footprint} bytes) on {dep.node_id}")

    state = stream_lib.init_state(scfg, device)
    records = stream_lib.make_record_stream(scfg)
    for i in range(8):
        rec = stream_lib.to_device(next(records), device)
        res = system.submit(Workload(f"batch{i}", WorkloadKind.STREAM),
                            (state, rec))
        state, out = res.output
        print(f"batch {i}: max_avg_steps={float(out['max_avg_steps']):8.1f} "
              f"(user {int(out['argmax_user'])}) "
              f"[{res.wall_s * 1e3:.1f} ms on {res.node_id}]")

    # cached: scaling up pulls the image from the registry, no rebuild
    t1 = time.monotonic()
    system.scale("fitbit-analytics", 2)
    print(f"scale-up image pull: {time.monotonic() - t1:.4f}s "
          f"(registry {system.registry.stats()})")

    rep = system.report()
    print(f"light dispatches: count={rep['light']['count']} "
          f"p95={rep['light']['p95_wall_s'] * 1e3:.1f}ms")


if __name__ == "__main__":
    main()
