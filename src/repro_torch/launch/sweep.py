"""The dry-run sweep: every (arch x shape x mesh) cell in a fresh
subprocess (a fresh fake process group of the mesh's world size), each
record to JSON under ``build/port_dryrun/`` (``repro.launch.sweep``'s
counterpart).

Usage:  PYTHONPATH=src python -m repro_torch.launch.sweep
        [--mesh single|multi|both] [--arch A ...] [--shape S ...]
        [--only-missing] [--reduced]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ARCH_ORDER = [
    "tinyllama-1.1b", "gemma-2b", "zamba2-1.2b", "mamba2-2.7b",
    "hubert-xlarge", "mixtral-8x7b", "chameleon-34b", "command-r-35b",
    "deepseek-v2-236b", "nemotron-4-340b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
ART_DIR = os.path.join("build", "port_dryrun")


def art_path(arch, shape, mesh, reduced: bool = False):
    tag = "2x16x16" if mesh == "multi" else "16x16"
    return os.path.join(ART_DIR, f"{arch}{'.reduced' if reduced else ''}"
                                 f".{shape}.{tag}.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--arch", nargs="*", default=ARCH_ORDER)
    ap.add_argument("--shape", nargs="*", default=SHAPE_ORDER)
    ap.add_argument("--only-missing", action="store_true")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--reduced", action="store_true",
                    help="the archs' reduced configs")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    os.makedirs(ART_DIR, exist_ok=True)
    t_start = time.time()
    n_ok = n_fail = n_skip = 0
    for mesh in meshes:
        for arch in args.arch:
            for shape in args.shape:
                out = art_path(arch, shape, mesh, args.reduced)
                if args.only_missing and os.path.exists(out):
                    with open(out) as f:
                        if json.load(f).get("ok"):
                            n_skip += 1
                            continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--mesh", mesh,
                       "--out", out] + (["--reduced"] if args.reduced else [])
                t0 = time.time()
                try:
                    r = subprocess.run(cmd, timeout=args.timeout)
                    ok = r.returncode == 0
                except subprocess.TimeoutExpired:
                    ok = False
                    with open(out, "w") as f:
                        json.dump({"arch": arch, "shape": shape,
                                   "mesh": mesh, "ok": False,
                                   "error": "timeout"}, f)
                n_ok += ok
                n_fail += (not ok)
                print(f"[sweep {time.time()-t_start:7.0f}s] {arch} {shape} "
                      f"{mesh}: {'ok' if ok else 'FAIL'} "
                      f"({time.time()-t0:.0f}s)", flush=True)
    print(f"[sweep] done ok={n_ok} fail={n_fail} cached={n_skip} "
          f"total={time.time()-t_start:.0f}s", flush=True)
    return n_fail


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
