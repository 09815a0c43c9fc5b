"""Run one cell of the port's benchmark once.

    python3 port_bench/run.py --workload nemotron-4-340b.chat --seed 7 \\
        --seconds 30 --trace 0

From the root of a checkout.  Prints, as its last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; its last key,
``check``, holds each compared number beside its limit, which are also
the last lines of standard error.  Exits non-zero, printing no result,
without a CUDA card, with JAX or the JAX package loaded, or where the
checkout lacks the program (``src/repro_torch``).
"""
from __future__ import annotations

import time

STARTED = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the checkout has no src/repro_torch: nothing to measure",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from benchlib.cell import forbidden_modules, run
    from benchlib.spec import Cell

    cell = Cell(args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    result, checks = run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", STARTED)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 4
    for name, value, limit in checks:
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
