"""Training entry point of the port: a ``Trainer`` on a device mesh.

Same flags as ``repro.launch.train``, plus ``--device``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --reduced --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch hubert-xlarge \\
        --batch 8 --seq 500 --steps 6
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc_per_node 2 -m repro_torch.launch.train --reduced \\
        --device cpu --mesh test --distributed

Without a GPU it raises unless ``--device cpu`` asks for the plain
PyTorch path.  ``--distributed`` initialises the process group from
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``): NCCL on the card (one rank a device,
``LOCAL_RANK`` picking it), gloo on the CPU.  ``--mesh test`` is the
``(world, 1)`` mesh of every rank on the data axis (1 x 1 without
``--distributed``); ``--mesh single|multi`` are the production meshes,
which need a world size of 256 or 512 and say so otherwise.  Each rank
reads its own rows of the stream (``host_index`` its index on the batch
axes, ``host_count`` their size; ``--batch`` is the global batch).  An
encoder-only arch (``edge-cv-heavy``, ``hubert-xlarge``) trains on
HuBERT-style masked-prediction batches from ``make_encoder_iterator``
(``--seq`` frames a row), a decoder on the bigram token stream; after a
restore either stream skips the batches the restored steps consumed.  A
moe arch (``mixtral-8x7b``, ``deepseek-v2-236b``) trains as a decoder
does, its loss the cross-entropy plus the MoE layers' load-balancing
term (``ce`` and ``aux`` in the step's metrics).  At full depth neither
fits one card; with ``--reduced`` both train on the card and on the CPU.
``main`` returns the ``Trainer`` and the ``fit`` history.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import os


def _init_distributed(device):
    """The process group from torchrun's environment."""
    import torch
    import torch.distributed as dist

    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--distributed needs torchrun's environment ({', '.join(missing)} "
            f"unset): launch with python -m torch.distributed.run")
    cpu = device is not None and str(device).startswith("cpu")
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("--distributed on the card needs a CUDA "
                               "device; pass --device cpu for gloo")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if not dist.is_initialized():
        dist.init_process_group("gloo" if cpu else "nccl",
                                timeout=datetime.timedelta(seconds=600))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="build/train_ckpt")
    ap.add_argument("--mesh", default="test",
                    choices=["test", "single", "multi"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--distributed", action="store_true",
                    help="initialise the process group from torchrun's "
                         "environment")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    if args.distributed:
        _init_distributed(args.device)

    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.data.tokens import (make_encoder_iterator,
                                         make_lm_iterator)
    from repro_torch.distributed import spmd
    from repro_torch.launch import programs
    from repro_torch.launch.mesh import (make_production_mesh,
                                         make_test_mesh)
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    if args.mesh != "test":
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device=args.device)
    elif args.distributed:
        import torch.distributed as dist
        mesh = make_test_mesh(dist.get_world_size(), 1, device=args.device)
    else:
        mesh = args.device
    tcfg = dataclasses.replace(programs.default_train_config(cfg),
                               num_microbatches=args.microbatch)
    # a decoder reads its rank's rows from a per-host stream; an encoder's
    # stream draws its class prototypes from its seed, so every rank reads
    # the global batch and keeps its rows
    trainer = Trainer(cfg, mesh, tcfg, TrainerConfig(
        ckpt_dir=args.ckpt_dir, ckpt_every=25,
        host_batches=not cfg.encoder_only))
    trainer.initialize(restore=True)

    comm = trainer.comm
    dp = spmd.dp_axes(trainer.rules)
    host, hosts = comm.index(dp), comm.size(dp)
    if args.batch % hosts:
        raise ValueError(f"--batch {args.batch} does not split over "
                         f"{hosts} data-parallel ranks")
    if cfg.encoder_only:
        data = make_encoder_iterator(cfg, args.batch, args.seq)
    else:
        data = make_lm_iterator(cfg, args.batch // hosts, args.seq,
                                host_index=host, host_count=hosts)
    for _ in range(trainer.step):
        next(data)                       # deterministic replay after restart

    def log(step, m):
        print(f"step {step:5d} loss={m['loss']:.4f} "
              f"{m['step_time_s'] * 1e3:.0f}ms"
              + (" [straggler]" if m.get("straggler") else ""), flush=True)

    hist = trainer.fit(data, num_steps=args.steps, log_fn=log)
    print(f"final loss {hist['loss'][-1]:.4f}; checkpoints in "
          f"{args.ckpt_dir} ({trainer.device}, mesh {dict(comm.sizes)})")
    return trainer, hist


if __name__ == "__main__":
    main()
