"""The readings a cell's limit is set from, on the card: for each seed a
short window at the cell's own load, the widest logit gap of what the
program served, and the control's, the plain reference in fp8 (e4m3,
every matrix product's inputs rounded with a scale a row or a column) on
the same prompts and tokens.  The seeds run one after another in one
process, so the kernels build once.

    python3 port_bench/control.py --workload chameleon-34b.camera-vqa \\
        --seconds 10 --seeds 11,12,13 [--control-seeds 11,12,13]

Prints one JSON line a seed: ``program`` (its gap), ``control`` (where
asked), ``correct``, ``attempted`` and the checked tokens.
"""
from __future__ import annotations

import time

STARTED = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    import torch

    from benchlib import check
    from benchlib.cell import run
    from benchlib.spec import Cell

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        keep: dict = {}
        t = time.monotonic()
        res, _ = run(Cell(args.workload), seed, args.seconds, False,
                     "cuda", t, keep=keep)
        line = {"seed": seed, "program": res["check"]["logit_gap"]["value"],
                "correct": res["correct"], "attempted": res["attempted"],
                "failed": res["failed"],
                "checked_tokens": sum(len(g) for _, g in keep["picked"]),
                "checked_requests": len(keep["picked"]),
                "metrics": {k: v["value"] for k, v in res["metrics"].items()}}
        if seed in ctl and keep["picked"]:
            t1 = time.monotonic()
            line["control"] = check.widest_gap(
                keep["ref"], keep["weights"], keep["model"], keep["picked"],
                "cuda", control=True)
            line["control_s"] = time.monotonic() - t1
        line["wall_s"] = time.monotonic() - t
        print(json.dumps(line), flush=True)
        keep.clear()
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
