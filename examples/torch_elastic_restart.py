"""Elastic checkpoint-restart after a simulated host failure, on the
PyTorch/CUDA port.

Phase 1 trains on a 2×2 mesh ("4 hosts": 4 ranks of one gloo process
group) with async checkpoints; a failure detector then marks a host dead,
`plan_elastic_mesh` shrinks the data axis to the surviving power-of-two,
and phase 2 — the job relaunched on the planned mesh's ranks — restores
the SAME checkpoint onto the SMALLER mesh (resharding restore) and keeps
training with the scaled-down global batch.

On the card every rank holds its shards on the one GPU; ``--device cpu``
keeps them on the CPU (one thread a rank).  Each phase's ranks are
spawned processes that must end within ``--deadline`` seconds; the rest
are killed and the run fails.  Phase 1 starts from an empty
``--ckpt-dir`` (a non-empty one is refused; by default a fresh temporary
directory).  The model is the JAX example's (four heads of 16).  Rank
0 of each phase prints the kernel launches of its own process to
standard error.  Without a GPU and without ``--device cpu`` it raises.

    PYTHONPATH=src python examples/torch_elastic_restart.py [--device cpu] \\
        [--ckpt-dir DIR]
"""
import argparse
import datetime
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch

from repro_torch.configs import get_reduced_config
from repro_torch.data.tokens import make_lm_iterator
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import (FailureDetector,
                                                     plan_elastic_mesh)

BATCH, SEQ = 8, 32


def model_config():
    return get_reduced_config("tinyllama-1.1b", num_layers=2, d_model=64,
                              head_dim=16, d_ff=128, vocab_size=128)


def _rank(rank: int, world: int, mesh_shape, device: str, store: str,
          job: dict) -> None:
    """One rank of a phase: join the phase's gloo group, train on the
    ``mesh_shape`` mesh, and (rank 0) print the phase's line and write its
    result to ``store + ".json"``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train.trainer import Trainer, TrainerConfig

    if device == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    cfg = model_config()
    tr = Trainer(cfg, make_test_mesh(*mesh_shape, device=device),
                 run_cfg=TrainerConfig(ckpt_dir=job["ckpt_dir"],
                                       ckpt_every=10))
    tr.initialize(restore=job["restore"])
    restored = tr.step
    data = make_lm_iterator(cfg, batch_size=job["batch"], seq_len=SEQ,
                            **({"seed": job["seed"]} if "seed" in job
                               else {}))
    hist = tr.fit(data, num_steps=job["steps"])
    if rank == 0:
        from repro_torch.kernels import launch_counts

        print(job["line"].format(step=tr.step, first=hist["loss"][0],
                                 last=hist["loss"][-1]), flush=True)
        launched = {k: v for k, v in launch_counts().items() if v}
        print(f"kernel launches on rank 0: {launched}", file=sys.stderr,
              flush=True)
        with open(store + ".json", "w") as f:
            json.dump({"restored": restored, "step": tr.step,
                       "loss": hist["loss"]}, f)
    dist.barrier()
    dist.destroy_process_group()


def run_phase(mesh_shape, device: str, job: dict, deadline: float) -> dict:
    """Spawn the ranks of one phase; raise unless every rank ends with
    code 0 within ``deadline`` seconds (the late ones are killed)."""
    import multiprocessing as mp

    world = mesh_shape[0] * mesh_shape[1]
    tmp = tempfile.mkdtemp(prefix="elastic_store_")
    store = os.path.join(tmp, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank,
                         args=(r, world, mesh_shape, device, store, job))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        end = time.monotonic() + deadline
        for p in procs:
            p.join(max(end - time.monotonic(), 0.0))
        late = [p for p in procs if p.is_alive()]
        for p in late:
            p.kill()
            p.join()
        codes = [p.exitcode for p in procs]
        if late or any(codes):
            raise RuntimeError(f"phase on a {mesh_shape} mesh: exit codes "
                               f"{codes}, {len(late)} killed at the "
                               f"{deadline:.0f} s deadline")
        with open(store + ".json") as f:
            return json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", default=None,
                    help="an empty or new directory for the checkpoints "
                         "(default: a fresh temporary one)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' keeps every "
                         "rank on the CPU)")
    ap.add_argument("--deadline", type=float, default=300.0,
                    help="seconds each phase's ranks have to finish")
    args = ap.parse_args(argv)
    device = resolve_device(args.device).type
    if args.ckpt_dir is None:
        args.ckpt_dir = tempfile.mkdtemp(prefix="torch_elastic_restart_")
    elif os.path.isdir(args.ckpt_dir) and os.listdir(args.ckpt_dir):
        sys.exit(f"--ckpt-dir {args.ckpt_dir} is not empty; phase 1 "
                 "starts from an empty checkpoint directory")

    # ---- phase 1: 4 ranks = (data 2 × model 2), "one device per host"
    t1 = run_phase((2, 2), device, dict(
        ckpt_dir=args.ckpt_dir, restore=False, batch=BATCH, steps=20,
        line="phase 1 (2×2 mesh): step={step} "
             "loss {first:.3f} -> {last:.3f}"), args.deadline)

    # ---- failure: host h1 stops heartbeating
    class Clock:
        t = 0.0

        def __call__(self):
            return self.t
    clock = Clock()
    fd = FailureDetector([f"h{i}" for i in range(4)], timeout=5.0,
                         clock=clock)
    clock.t = 6.0
    for h in ("h0", "h2", "h3"):
        fd.heartbeat(h)
    dead = fd.poll()
    print(f"failure detector: {dead} failed "
          f"(healthy: {fd.healthy_hosts()})")

    plan = plan_elastic_mesh(total_hosts=4, failed_hosts=len(dead),
                             chips_per_host=1, base_mesh=(2, 2))
    print(f"elastic plan: {plan.note}; "
          f"new mesh = ({plan.data_axis}×{plan.model_axis}), "
          f"batch scale ×{plan.global_batch_scale}")

    # ---- phase 2: restore the same checkpoint on the shrunk mesh
    new_batch = max(2, int(BATCH * plan.global_batch_scale))
    t2 = run_phase((plan.data_axis, plan.model_axis), device, dict(
        ckpt_dir=args.ckpt_dir, restore=True, batch=new_batch, seed=999, steps=15,
        line=(f"phase 2 ({plan.data_axis}×{plan.model_axis} mesh, "
              f"batch {BATCH}->{new_batch}): step={{step}} "
              f"loss {{first:.3f}} -> {{last:.3f}}")), args.deadline)
    assert t2["restored"] == t1["step"], (t2["restored"], t1["step"])
    print("elastic restart complete — no training state lost")


if __name__ == "__main__":
    main()
