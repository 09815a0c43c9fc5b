"""The multi-pod dry-run of the port: one (arch x shape x mesh) cell's step
run on ``meta`` tensors on one rank of the production mesh, with its
per-rank memory and its roofline (``repro.launch.dryrun``'s counterpart).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape decode_32k --mesh multi [--reduced] [--out rec.json]

Before anything else the process joins a process group of the mesh's
world size, 256 ranks for ``single`` (16 x 16) and 512 for ``multi`` (2 x
16 x 16), over PyTorch's fake backend: every collective returns at once
and moves nothing, and this process is rank 0.  The production
``DeviceMesh`` (``launch/mesh.make_production_mesh``) and the groups of
``distributed.spmd`` are then the real ones.  ``programs.lower_program``
builds the cell's step on rank 0's shards and runs it once under
``roofline.analysis``'s counting mode, which counts every layer (the JAX
dry-run fits a line through two depths because XLA counts a scanned
layer once; the port has nothing to fit).

The record mirrors JAX's: ``memory`` (argument, output, temp and alias
bytes a rank), ``roofline`` (``analysis.Roofline.as_dict``), ``ok``,
``skipped``, ``error``, ``chips``; a failed cell is recorded and the
command exits 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback


def _fake_world(world: int) -> None:
    """This process as rank 0 of ``world`` ranks over the fake backend of
    ``torch.testing._internal.distributed.fake_pg`` (PyTorch's internal
    module: the one place this package imports it)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of world size "
                               f"{dist.get_world_size()} is initialised; "
                               f"this mesh needs {world}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True, skip_roofline: bool = False,
             rules_name: str = "default", attn_impl: str = "kernel",
             remat: str = "", capacity: float = 0.0,
             dispatch_quant: str = "", microbatch: int = 1,
             opt_tag: str = "baseline", reduced: bool = False) -> dict:
    _fake_world(512 if multi_pod else 256)
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.launch import programs
    from repro_torch.launch.mesh import make_production_mesh, mesh_num_chips
    from repro_torch.launch.shapes import SHAPES, applicable
    from repro_torch.roofline import analysis

    cfg = (get_reduced_config if reduced else get_config)(arch)
    if remat:
        cfg = dataclasses.replace(cfg, remat_policy=remat)
    if capacity > 0.0 and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=capacity))
    if dispatch_quant and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe,
                                         dispatch_quant=dispatch_quant))
    shape = SHAPES[shape_name]
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": shape.kind, "ok": False, "reduced": reduced,
        "opt": {"tag": opt_tag, "rules": rules_name, "attn": attn_impl,
                "remat": remat or cfg.remat_policy, "capacity": capacity},
    }
    label = f"[dryrun] {arch}{' (reduced)' if reduced else ''} × " \
            f"{shape_name} × {rec['mesh']}"
    skip = applicable(cfg, shape)
    if skip:
        rec.update(ok=True, skipped=skip)
        if verbose:
            print(f"{label}: SKIP ({skip})", flush=True)
        return rec
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        chips = mesh_num_chips(mesh)
        tcfg = None
        if microbatch > 1:
            tcfg = dataclasses.replace(
                programs.default_train_config(cfg),
                num_microbatches=microbatch)
        t0 = time.time()
        seen = programs.lower_program(cfg, shape_name, mesh, tcfg=tcfg,
                                      rules_name=rules_name,
                                      attn_impl=attn_impl)
        mem = seen.memory()
        rec.update(ok=True, chips=chips, lower_s=round(time.time() - t0, 2),
                   memory={k: mem[k] for k in (
                       "argument_bytes", "output_bytes", "temp_bytes",
                       "alias_bytes")})
        if verbose:
            print(f"{label}: OK lower={rec['lower_s']}s"
                  f" args/dev={mem['argument_bytes'] / 2**30:.2f}GiB"
                  f" temp/dev={mem['temp_bytes'] / 2**30:.2f}GiB",
                  flush=True)
        if not skip_roofline:
            c = seen.cost()
            roof = analysis.analyze(
                flops_per_device=c["flops"], bytes_per_device=c["bytes"],
                bytes_fused_per_device=c["bytes_fused"],
                attn_io_bytes=c["attn_io"], collective=c["collectives"],
                num_devices=chips,
                model_flops=analysis.model_flops_estimate(cfg, shape))
            rec["roofline"] = roof.as_dict()
            rec["kernels"] = c["kernels"]
            if verbose:
                print(f"  roofline(s): compute={roof.compute_s:.4f}"
                      f" memory_raw={roof.memory_s:.4f}"
                      f" memory_fused={roof.memory_fused_s:.4f}"
                      f" memory_projected={roof.memory_projected_s:.4f}"
                      f" collective={roof.collective_s:.4f}"
                      f" bottleneck={roof.bottleneck}"
                      f" useful_ratio={roof.useful_flops_ratio:.3f}",
                      flush=True)
    except Exception as e:  # noqa: BLE001 — record the failure, exit 1
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"{label}: FAIL {rec['error']}", flush=True)
    return rec


def main(argv=None) -> dict:
    from repro_torch.launch.shapes import SHAPES

    ap = argparse.ArgumentParser(description="multi-pod dry-run on meta")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", default=None, help="JSON artifact path")
    ap.add_argument("--no-roofline", action="store_true",
                    help="memory only")
    ap.add_argument("--rules", default="default",
                    choices=["default", "seqpar", "serve2d"])
    ap.add_argument("--attn", default="kernel", choices=["kernel", "ref"],
                    help="kernel: the hand-written kernels' formulas; ref: "
                         "the plain versions' aten ops")
    ap.add_argument("--remat", default="", help="override remat policy")
    ap.add_argument("--capacity", type=float, default=0.0,
                    help="override MoE capacity factor")
    ap.add_argument("--dispatch-quant", default="",
                    choices=["", "int8"], help="EP all-to-all payload quant")
    ap.add_argument("--microbatch", type=int, default=1,
                    help="gradient-accumulation microbatches")
    ap.add_argument("--tag", default="baseline", help="optimization tag")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config (the CPU tests' size)")
    args = ap.parse_args(argv)
    # the mesh's world first, as JAX sets its device count first
    _fake_world(512 if args.mesh == "multi" else 256)
    rec = run_cell(args.arch, args.shape, args.mesh == "multi",
                   skip_roofline=args.no_roofline, rules_name=args.rules,
                   attn_impl=args.attn, remat=args.remat,
                   capacity=args.capacity, dispatch_quant=args.dispatch_quant,
                   microbatch=args.microbatch, opt_tag=args.tag,
                   reduced=args.reduced)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    if not rec["ok"]:
        raise SystemExit(1)
    return rec


if __name__ == "__main__":
    main()
