"""Rank-side code of the port's multi-rank CPU tests (no JAX import).

``spawn(scenario, tmp, world)`` starts ``world`` processes that join one
gloo process group through a ``file://`` store under ``tmp`` (one store a
spawn, so parallel test files never share one), each with one thread and
a 120 s collective timeout and a niceness of 10 (the rest of the suite
keeps the CPU it needs); it waits at most ``deadline`` seconds, kills
whatever is left, and raises with the ranks' error files if any rank
failed.  A scenario is a function of this module, ``scenario(rank, world,
tmp)``; it reads its inputs from ``tmp`` and writes its results there
(rank 0 unless it says otherwise).
"""
from __future__ import annotations

import datetime
import json
import os
import pickle
import sys
import time
import traceback

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def _rank_main(scenario: str, rank: int, world: int, tmp: str) -> None:
    # below the test workers' priority: the suite's timing-sensitive
    # tests (an engine loop's batching) run beside these ranks
    os.nice(10)
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp}/store_{scenario}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=120))
        globals()[scenario](rank, world, tmp)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"error_{scenario}_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(scenario: str, tmp: str, world: int = 4,
          deadline: float = 240.0) -> None:
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(scenario, r, world, tmp))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    for p in procs:
        p.join(max(end - time.monotonic(), 0.0))
    late = [p for p in procs if p.is_alive()]
    for p in late:
        p.kill()
        p.join()
    errors = [open(os.path.join(tmp, f)).read() for f in sorted(
        os.listdir(tmp)) if f.startswith(f"error_{scenario}_")]
    codes = [p.exitcode for p in procs]
    if late or any(codes) or errors:
        raise RuntimeError(f"{scenario}: exit codes {codes}, "
                           f"{len(late)} killed at the {deadline:.0f} s "
                           f"deadline\n" + "\n".join(errors))


def save(tmp: str, name: str, obj) -> None:
    with open(os.path.join(tmp, f"{name}.pkl"), "wb") as f:
        pickle.dump(obj, f)


def load(tmp: str, name: str):
    with open(os.path.join(tmp, f"{name}.pkl"), "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# training on a mesh
# ---------------------------------------------------------------------------

def _train_run(tmp, key, spec, mesh_shape, rank, *, restore_dir,
               steps, save_ckpt=None, extra_step=False):
    """A ``Trainer`` on a ``mesh_shape`` mesh restored from
    ``restore_dir``: ``steps`` steps over the stored batches; its metrics
    and whole parameters (rank 0) under ``key``."""
    from repro_torch.launch import programs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.config import ModelConfig
    from repro_torch.optim import adamw, schedule
    from repro_torch.train.trainer import Trainer, TrainerConfig, gather
    from repro_torch.tree import flatten_with_path

    cfg = ModelConfig.from_dict(spec["cfg"])
    tt = programs.TrainConfig(
        adamw=adamw.AdamWConfig(**spec["adamw"]),
        sched=schedule.ScheduleConfig(**spec["sched"]),
        compress_grads=spec.get("compress", False))
    mesh = make_test_mesh(*mesh_shape, device="cpu")
    tr = Trainer(cfg, mesh, tt, TrainerConfig(
        ckpt_dir=restore_dir, ckpt_every=0, keep_ckpts=0))
    tr.initialize(restore=True)
    batches = np.load(os.path.join(tmp, f"batches_{spec['batches']}.npz"))
    hist = []
    for i in range(tr.step, tr.step + steps):
        hist.append(tr.train_step({k: batches[f"{k}_{i}"]
                                   for k in ("tokens", "labels")}))
    out = {"metrics": hist, "mesh": dict(tr.comm.sizes)}
    whole = gather(tr.params, tr.param_specs(), tr.comm)
    out["params"] = {p: v.detach().numpy().copy()
                     for p, v in flatten_with_path(whole)}
    # the shards viewed as DTensors gather to the same whole leaves
    out["dtensors_whole"] = all(
        np.array_equal(d.full_tensor().numpy(), out["params"][p])
        for p, d in flatten_with_path(tr.dtensors()))
    if save_ckpt is not None:
        from repro_torch.checkpointing.checkpoint import AsyncCheckpointer

        tr.checkpointer = AsyncCheckpointer(save_ckpt, keep=0)
        tr.maybe_checkpoint(force=True)
        tr.wait()
    if extra_step:
        i = tr.step
        out["next"] = tr.train_step({k: batches[f"{k}_{i}"]
                                     for k in ("tokens", "labels")})
    if rank == 0:
        save(tmp, key, out)


def mesh_train(rank, world, tmp):
    """Every run ``runs.json`` lists, in order; then the decode cases of
    ``cp_cases.json``, if there is one (``cp_decode``)."""
    with open(os.path.join(tmp, "runs.json")) as f:
        runs = json.load(f)
    for run in runs:
        with open(os.path.join(tmp, f"spec_{run['spec']}.json")) as f:
            spec = json.load(f)
        _train_run(tmp, run["key"], spec, tuple(run["mesh"]), rank,
                   restore_dir=os.path.join(tmp, run["restore"]),
                   steps=run["steps"],
                   save_ckpt=(os.path.join(tmp, run["save"])
                              if run.get("save") else None),
                   extra_step=run.get("extra_step", False))
    if os.path.exists(os.path.join(tmp, "cp_cases.json")):
        cp_decode(rank, world, tmp)


# ---------------------------------------------------------------------------
# the MoE layer's sharded paths and the collectives
# ---------------------------------------------------------------------------

def _moe_inputs(tmp, name):
    import torch

    from repro_torch.models.config import ModelConfig
    from repro_torch.models.weights import from_numpy_tree, unflatten

    with open(os.path.join(tmp, f"moe_{name}.json")) as f:
        cfg = ModelConfig.from_dict(json.load(f))
    arrays = np.load(os.path.join(tmp, f"moe_{name}.npz"))
    p = from_numpy_tree(unflatten({k[2:]: arrays[k] for k in arrays.files
                                   if k.startswith("p/")}), cfg, "cpu")
    return cfg, p, torch.tensor(arrays["x"])


def moe_paths(rank, world, tmp):
    """``apply_moe`` under the default rules on (2, 2) at E 8 (expert
    parallel) and E 5 (per-expert tensor parallel), and the serve2d path
    on (2, 2); each rank's local view cut from the whole inputs, the
    outputs (and the E 8 input gradient) gathered back."""
    import torch

    from repro_torch.distributed import sharding as shlib, spmd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe

    mesh = make_test_mesh(2, 2, device="cpu")
    comm = spmd.comm_of(mesh)
    rules = shlib.ShardingRules(mesh, shlib.single_pod_rules())
    out = {}
    for name in ("ep", "tp", "ep_int8"):
        cfg, p, x = _moe_inputs(tmp, name)
        specs = shlib.param_partition_specs({"moe": p}, rules)["moe"]
        # the trainer's view: fsdp dims gathered, model dims this rank's;
        # for "tp" the experts arrive with their fsdp dim cut too, which
        # the layer gathers itself (_gather_fsdp)
        cut = ("model", "data") if name == "tp" else ("model",)
        local = {k: (spmd.shard_of(v, specs[k], comm,
                                   cut if k.startswith("w_") else ("model",))
                     if k != "shared" else {
                         kk: spmd.shard_of(vv, specs[k][kk], comm,
                                           ("model",))
                         for kk, vv in v.items()})
                 for k, v in p.items()}
        if name == "tp":
            assert local["w_up"].shape[1] == cfg.d_model // 2
        xs = spmd.shard_of(x, ("data",), comm).clone().requires_grad_()
        with shlib.use_rules(mesh, rules.rules):
            y, aux = moe.apply_moe(local, xs, cfg)
        (gx,) = torch.autograd.grad((y * y).sum(), [xs])
        # the rows of every data rank, and aux's shares summed
        y_all = spmd.all_gather_dim(y.detach(), 0, comm.group(("data",)))
        g_all = spmd.all_gather_dim(gx, 0, comm.group(("data",)))
        aux_all = spmd.all_reduce(aux, comm.group(("data",)))
        out[name] = {"y": y_all.numpy(), "gx": g_all.numpy(),
                     "aux": float(aux_all)}

    cfg, p, x = _moe_inputs(tmp, "tp2d")
    rules2 = shlib.ShardingRules(mesh, shlib.serve2d_rules())
    r = comm.coord
    dl, fl = cfg.d_model // 2, cfg.moe.d_expert // 2
    ds = slice(r["data"] * dl, (r["data"] + 1) * dl)
    fs = slice(r["model"] * fl, (r["model"] + 1) * fl)
    sfl = cfg.moe.d_shared_expert // 2
    ss = slice(r["model"] * sfl, (r["model"] + 1) * sfl)
    local = {"router": p["router"][ds], "w_up": p["w_up"][:, ds, fs],
             "w_gate": p["w_gate"][:, ds, fs], "w_down": p["w_down"][:, fs, ds],
             "shared": {"w_up": p["shared"]["w_up"][ds, ss],
                        "w_gate": p["shared"]["w_gate"][ds, ss],
                        "w_down": p["shared"]["w_down"][ss, ds]}}
    with shlib.use_rules(mesh, rules2.rules):
        y, aux = moe.apply_moe(local, x[..., ds], cfg)
    y_all = spmd.all_gather_dim(y, 2, comm.group(("data",)))
    out["tp2d"] = {"y": y_all.numpy(), "aux": float(aux)}
    if rank == 0:
        save(tmp, "moe_paths", out)


def collectives(rank, world, tmp):
    """``a2a_int8`` over a model axis of 4 against the plain all-to-all
    (values and gradients), and ``hierarchical_psum`` on a (pod 2, data 2,
    model 1) mesh, int8 across pods and plain."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import collectives as coll, spmd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe

    arrays = np.load(os.path.join(tmp, "collectives.npz"))
    out = {}
    mesh = make_test_mesh(1, 4, device="cpu")
    group = spmd.comm_of(mesh).group(("model",))
    x = torch.tensor(arrays["a2a_x"][rank]).requires_grad_()
    w = torch.tensor(arrays["a2a_w"][rank])
    q = moe.a2a_int8(x, group, 0, 1)
    (gq,) = torch.autograd.grad((q * w).sum(), [x])
    x2 = x.detach().clone().requires_grad_()
    plain = spmd.all_to_all(x2, 0, 1, group)
    (gp,) = torch.autograd.grad((plain * w).sum(), [x2])
    out["a2a"] = {"int8": q.detach().numpy(), "plain": plain.detach().numpy(),
                  "g_int8": gq.numpy(), "g_plain": gp.numpy()}

    pods = init_device_mesh("cpu", (2, 2, 1),
                            mesh_dim_names=("pod", "data", "model"))
    v = torch.tensor(arrays["psum_x"][rank])
    out["psum"] = {
        "int8": coll.hierarchical_psum(v, mesh=pods).numpy(),
        "plain": coll.hierarchical_psum(v, int8_cross_pod=False,
                                        mesh=pods).numpy()}
    save(tmp, f"collectives_{rank}", out)


# ---------------------------------------------------------------------------
# a sharded image
# ---------------------------------------------------------------------------

def sharded_image(rank, world, tmp):
    """A decode step built as an ``ExecutableImage`` with ``in_shardings``
    on a (2, 1) mesh (batch rows over data, the parameters' fsdp dims
    too), called on its placed arguments: each rank's logits and cache
    shard, and the eager step on the whole arguments for comparison."""
    import torch

    from repro_torch.core.executor import ExecutableImage
    from repro_torch.distributed import sharding as shlib, spmd
    from repro_torch.launch import programs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import Model

    with open(os.path.join(tmp, "image_cfg.json")) as f:
        cfg = ModelConfig.from_dict(json.load(f))
    mesh = make_test_mesh(2, 1, device="cpu")
    comm = spmd.comm_of(mesh)
    rules = programs.rules_for(mesh)
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    B, S = 4, 16
    caches = model.init_caches(B, S, torch.float32)
    tokens = torch.arange(B, dtype=torch.int32) + 3
    cache_len = torch.tensor([2, 5, 0, 7], dtype=torch.int32)
    pspec = shlib.param_partition_specs(params, rules)
    cspec = shlib.cache_partition_specs(caches, rules)
    tspec = rules.resolve(("batch",), (B,))
    step = programs.build_decode_step(cfg, "cpu")
    whole = (params, tokens, caches, cache_len)
    want = step(params, tokens,
                {k: {n: t.clone() for n, t in v.items()}
                 for k, v in caches.items()}, cache_len)
    img = ExecutableImage.build("decode", step, whole, donate_argnums=(2,),
                                in_shardings=(pspec, tspec, cspec, tspec),
                                mesh=mesh)
    placed = img.place(whole)
    logits, new_caches, new_len = img(*placed)
    rows = spmd.shard_of(want[0], (("data",),), comm)
    kcut = spmd.shard_of(want[1]["attn"]["k"], cspec["attn"]["k"], comm)
    save(tmp, f"image_{rank}", {
        "logits": logits.float().numpy(), "want": rows.float().numpy(),
        "k": new_caches["attn"]["k"].float().numpy(),
        "k_want": kcut.float().numpy(),
        "len": new_len.numpy(),
        "len_want": spmd.shard_of(want[2], tspec, comm).numpy(),
        "param_shape": tuple(placed[0]["embed"]["embedding"].shape),
        "param_whole": tuple(params["embed"]["embedding"].shape)})


# ---------------------------------------------------------------------------
# decode over caches split along the sequence
# ---------------------------------------------------------------------------

def cp_decode(rank, world, tmp):
    """Every case of ``cp_cases.json``: the prompt prefilled and ``steps``
    greedy tokens decoded on the case's mesh from the JAX parameters
    (``cp_<name>.npz``), each rank on its shards of the parameters and of
    the dense caches (``cache_partition_specs``); rank 0 keeps the
    gathered logits of every step and the tokens.  A case with
    ``"caches"`` also runs the same tokens through one rank (no rules)
    and keeps each cache leaf's largest difference from the sharded run's
    caches gathered whole, relative to the leaf's largest entry."""
    import torch

    from repro_torch.distributed import sharding as shlib, spmd
    from repro_torch.launch import programs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import Model
    from repro_torch.models.weights import from_numpy_tree, unflatten
    from repro_torch.tree import flatten_with_path, leaves, unflatten_like

    with open(os.path.join(tmp, "cp_cases.json")) as f:
        cases = json.load(f)
    for case in cases:
        name = case["name"]
        src = case.get("spec", name)        # the inputs' file names
        with open(os.path.join(tmp, f"cp_{src}.json")) as f:
            cfg = ModelConfig.from_dict(json.load(f))
        arrays = np.load(os.path.join(tmp, f"cp_{src}.npz"))
        params = from_numpy_tree(unflatten(
            {k[2:]: arrays[k] for k in arrays.files if k.startswith("p/")}),
            cfg, "cpu")
        mesh = make_test_mesh(*case["mesh"], device="cpu")
        comm, rules = spmd.comm_of(mesh), programs.rules_for(mesh)
        B, S = case["B"], case["S"]
        local = unflatten_like(params, [
            spmd.shard_of(p, s, comm).clone() for p, s in zip(
                leaves(params), programs.flat_specs(
                    shlib.param_partition_specs(params, rules)))])
        whole = Model(cfg, "cpu").init_caches(B, S, torch.float32)
        cspec = shlib.cache_partition_specs(whole, rules)
        caches = unflatten_like(whole, [
            spmd.shard_of(c, s, comm).clone() for c, s in zip(
                leaves(whole), programs.flat_specs(cspec))])
        tspec = rules.resolve(("batch",), (B,))
        lspec = rules.resolve(("batch", "vocab"), (B, cfg.vocab_size))
        prompt = spmd.shard_of(torch.tensor(arrays["prompt"]),
                               tspec + (None,), comm)
        pre = programs.build_prefill_step(cfg, "cpu")
        dec = programs.build_decode_step(cfg, "cpu")
        logits_all, tokens = [], []
        with torch.no_grad(), shlib.use_rules(mesh, rules.rules):
            logits, caches, clen = pre(local, {"tokens": prompt}, caches)
            for i in range(case["steps"] + 1):
                whole_logits = spmd.gather_of(logits, lspec, comm)
                logits_all.append(whole_logits.numpy())
                tok = whole_logits.argmax(-1).to(torch.int32)
                tokens.append(tok.numpy())
                if i < case["steps"]:
                    logits, caches, clen = dec(
                        local, spmd.shard_of(tok, tspec, comm), caches, clen)
        out = {"logits": np.stack(logits_all), "tokens": np.stack(tokens),
               "cache_spec": {k: {n: s for n, s in v.items()}
                              for k, v in cspec.items()}}
        if case.get("caches"):
            with torch.no_grad():
                one = Model(cfg, "cpu").init_caches(B, S, torch.float32)
                _, one, clen = pre(params, {"tokens": torch.tensor(
                    arrays["prompt"])}, one)
                for tok in tokens[:-1]:
                    _, one, clen = dec(params, torch.tensor(tok), one, clen)
            out["cache_err"] = {
                path: float((spmd.gather_of(c, s, comm) - w).abs().max()
                            / max(float(w.abs().max()), 1e-12))
                for (path, c), s, w in zip(
                    flatten_with_path(caches), programs.flat_specs(cspec),
                    leaves(one))}
        if rank == 0:
            save(tmp, f"cp_{name}_out", out)
