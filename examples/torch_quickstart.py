"""Quickstart on the PyTorch/CUDA port — train a model, then serve it
through the EdgeSystem.

The whole runtime sits behind two declarative objects:

``ServiceSpec`` — WHAT to run: a name, a workload template, an optional
executor-class override (container vs unikernel), replicas, placement
policy, latency SLO, and an optional footprint hint.

``EdgeSystem`` — the facade that owns the configuration manager,
orchestrator, image registry and work queue.  The core loop is:

    from repro_torch.core import (EdgeSystem, ServiceSpec, Workload,
                                  WorkloadKind, WorkloadClass)

    system = EdgeSystem()                      # 1. build the system
    system.add_node("edge0")                   # 2. register nodes
    system.register_builder(kind, wclass, builder)   # 3. teach it to build
    system.apply(ServiceSpec(name="svc", workload=..., replicas=2))
    result = system.submit(workload, args)     # routed, least-inflight
    results = system.submit_many(items)        # batched + speculative
    system.scale("svc", 4)                     # redeploys from the spec
    print(system.report())                     # DispatchStats percentiles

Below: train a tiny LM for a few steps, deploy the trained params as a
continuous-batching serving service via a spec, and submit prompts.  The
model is the JAX quickstart's (four heads of 16).  The trainer's
checkpoint goes to a temporary directory.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Without a GPU and without ``--device cpu`` it raises.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np

from repro_torch.configs import get_reduced_config
from repro_torch.core import (EdgeSystem, ExecutorClass, ServiceSpec,
                              Workload, WorkloadClass, WorkloadKind)
from repro_torch.core.resources import host_capacity
from repro_torch.data.tokens import make_lm_iterator
from repro_torch.device import resolve_device
from repro_torch.serving.router import make_engine_builder
from repro_torch.train.trainer import Trainer, TrainerConfig


def model_config():
    """The JAX quickstart's model: reduced tinyllama, 2 layers, d_model
    64, four heads of 16, vocabulary 128."""
    return get_reduced_config("tinyllama-1.1b", num_layers=2, d_model=64,
                              head_dim=16, d_ff=128, vocab_size=128)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1) pick an architecture (any of the 10 assigned, reduced)
    cfg = model_config()
    print(f"arch={cfg.name} params={cfg.num_params():,}")

    # 2) train a few steps
    from repro_torch.launch.programs import TrainConfig
    from repro_torch.optim import adamw, schedule
    tcfg = TrainConfig(adamw=adamw.AdamWConfig(lr=3e-3),
                       sched=schedule.ScheduleConfig(warmup_steps=5,
                                                     decay_steps=200))
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(cfg, device, tcfg,
                          run_cfg=TrainerConfig(ckpt_dir=ckpt_dir,
                                                ckpt_every=0))
        trainer.initialize(restore=False)
        data = make_lm_iterator(cfg, batch_size=8, seq_len=32)
        hist = trainer.fit(data, num_steps=20)
    print(f"loss: {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f}")

    # 3) declare the serving service and submit prompts through the system
    system = EdgeSystem()
    system.add_node("edge0", host_capacity(device), mesh=device)
    system.register_builder(
        "decode", WorkloadClass.HEAVY,
        make_engine_builder(cfg, max_slots=2, max_seq=64,
                            params=trainer.params, device=device))
    system.apply(ServiceSpec(
        name="lm-serving",
        workload=Workload("serve", WorkloadKind.DECODE, cfg, batch=2,
                          seq_len=8),
        executor_class=ExecutorClass.CONTAINER))

    for plen in (8, 5):
        w = Workload(f"prompt{plen}", WorkloadKind.DECODE, cfg, batch=1,
                     seq_len=8)
        res = system.submit(w, (np.arange(plen) % cfg.vocab_size,))
        req = res.output
        print(f"request {req.rid} on {res.node_id}: "
              f"generated {req.generated}")
    rep = system.report()
    # tiny decode requests classify LIGHT even though the spec overrode the
    # substrate to container-class — telemetry buckets by classification
    served = rep["light"] or rep["heavy"]
    print(f"served: {served['count']} requests, "
          f"p95 wall {served['p95_wall_s'] * 1e3:.1f}ms")


if __name__ == "__main__":
    main()
