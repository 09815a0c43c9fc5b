"""Training entry point of the port: a ``Trainer`` on the GPU.

Same flags as ``repro.launch.train``, plus ``--device``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --reduced --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch hubert-xlarge \\
        --batch 8 --seq 500 --steps 6

Without a GPU it raises unless ``--device cpu`` asks for the plain
PyTorch path.  An encoder-only arch (``edge-cv-heavy``,
``hubert-xlarge``) trains on HuBERT-style masked-prediction batches from
``make_encoder_iterator`` (``--seq`` frames a row), a decoder on the
bigram token stream; after a restore either stream skips the batches the
restored steps consumed.  ``--mesh single|multi`` and ``--distributed``
need the sharded trainer, not ported yet (ROADMAP Queue A item 13).  A
moe arch (``mixtral-8x7b``, ``deepseek-v2-236b``) trains as a decoder
does, its loss the cross-entropy plus the MoE layers' load-balancing
term (``ce`` and ``aux`` in the step's metrics).  At full depth neither
fits one card; with ``--reduced`` both train on the card and on the CPU.
``main`` returns the ``Trainer`` and the ``fit`` history.
"""
from __future__ import annotations

import argparse
import dataclasses


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
                    help="multi-host training (needs the sharded trainer)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    if args.mesh != "test" or args.distributed:
        raise NotImplementedError(
            "--mesh single|multi and --distributed need the sharded "
            "trainer, not ported yet (ROADMAP Queue A item 13)")

    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.data.tokens import (make_encoder_iterator,
                                         make_lm_iterator)
    from repro_torch.launch import programs
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    tcfg = dataclasses.replace(programs.default_train_config(cfg),
                               num_microbatches=args.microbatch)
    trainer = Trainer(cfg, args.device, tcfg,
                      TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=25))
    trainer.initialize(restore=True)

    if cfg.encoder_only:
        data = make_encoder_iterator(cfg, args.batch, args.seq)
    else:
        data = make_lm_iterator(cfg, args.batch, args.seq)
    for _ in range(trainer.step):
        next(data)                       # deterministic replay after restart

    def log(step, m):
        print(f"step {step:5d} loss={m['loss']:.4f} "
              f"{m['step_time_s'] * 1e3:.0f}ms"
              + (" [straggler]" if m.get("straggler") else ""), flush=True)

    hist = trainer.fit(data, num_steps=args.steps, log_fn=log)
    print(f"final loss {hist['loss'][-1]:.4f}; checkpoints in "
          f"{args.ckpt_dir} ({trainer.device})")
    return trainer, hist


if __name__ == "__main__":
    main()
