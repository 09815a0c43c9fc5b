"""End-to-end training driver with checkpoint/restart on the PyTorch/CUDA
port.

Defaults are small; ``--preset 100m --steps 300`` reproduces the "train a
~100M model for a few hundred steps" configuration on the card.  Kill and
re-run with the same --ckpt-dir to see the restart resume from the last
committed checkpoint.  The end prints the median step time and tokens/s.

    PYTHONPATH=src python examples/torch_edge_train.py [--steps 60] \\
        [--ckpt-dir DIR] [--device cpu]

Without a GPU and without ``--device cpu`` it raises.
"""
import argparse
import os
import statistics
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_reduced_config
from repro_torch.data.tokens import make_lm_iterator
from repro_torch.device import resolve_device
from repro_torch.train.trainer import Trainer, TrainerConfig

PRESETS = {
    # ~2M params — CPU-friendly demo
    "tiny": dict(num_layers=2, d_model=128, head_dim=32, d_ff=256,
                 vocab_size=512),
    # ~100M params — the reference few-hundred-step run (on the card)
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
                 head_dim=64, d_ff=2048, vocab_size=32000),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "torch_edge_train_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_reduced_config("tinyllama-1.1b", **PRESETS[args.preset])
    print(f"model: {cfg.num_params():,} params")

    trainer = Trainer(cfg, device,
                      run_cfg=TrainerConfig(ckpt_dir=args.ckpt_dir,
                                            ckpt_every=20, log_every=10))
    trainer.initialize(restore=True)           # resumes if ckpt exists
    start = trainer.step
    if start:
        print(f"resumed from step {start}")

    data = make_lm_iterator(cfg, batch_size=args.batch, seq_len=args.seq)
    for _ in range(start):                      # deterministic replay
        next(data)

    def log(step, metrics):
        print(f"step {step:4d} loss={metrics['loss']:.4f} "
              f"lr={metrics['lr']:.2e} {metrics['step_time_s'] * 1e3:.0f}ms"
              + (" [straggler]" if metrics["straggler"] else ""))

    hist = trainer.fit(data, num_steps=args.steps, log_fn=log)
    print(f"done: loss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f}; "
          f"checkpoints in {args.ckpt_dir}")
    med = statistics.median(hist["step_time_s"])
    print(f"median step {med * 1e3:.1f} ms, "
          f"{args.batch * args.seq / med:.0f} tokens/s on {device}")


if __name__ == "__main__":
    main()
