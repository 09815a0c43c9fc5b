"""Find an open-loop cell's knee once, on the card: the highest offered
rate at which at least 90% of the window's requests meet both
``--ttft-ms`` and ``--tpot-ms`` and the queue does not grow over the
window.  Each rate is a run of the cell with its traffic's ``rate_rps``
replaced; the rates run one after another in one process.

    python3 port_bench/sweep.py --workload nemotron-4-340b.chat \\
        --seconds 20 --rates 6,8,10,12,14 --seed 5

Prints one JSON line a rate.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--ttft-ms", type=float, default=1000.0)
    ap.add_argument("--tpot-ms", type=float, default=50.0)
    args = ap.parse_args(argv)
    import torch

    from benchlib.cell import run
    from benchlib.spec import Cell

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    for rate in (float(r) for r in args.rates.split(",")):
        cell = Cell(args.workload)
        cell.traffic["rate_rps"] = rate
        keep: dict = {}
        t = time.monotonic()
        res, _ = run(cell, args.seed, args.seconds, False, "cuda", t,
                     keep=keep)
        met = sum(a <= args.ttft_ms and b <= args.tpot_ms
                  for a, b in zip(keep["ttft_ms"], keep["tpot_ms"]))
        n = len(keep["ttft_ms"])
        print(json.dumps({"rate": rate, "met": met / n if n else None,
                          "attempted": res["attempted"],
                          "failed": res["failed"],
                          "queued_start_end": keep["queued"],
                          "correct": res["correct"],
                          "metrics": {k: v["value"] for k, v in
                                      res["metrics"].items()},
                          "work": res["work"],
                          "wall_s": time.monotonic() - t}), flush=True)
        keep.clear()
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
