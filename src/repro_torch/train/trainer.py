"""Training loop: eager train step on a device mesh + async
checkpointing, as ``repro.train.trainer``.

    trainer = Trainer(cfg, mesh, tcfg=tcfg, run_cfg=run_cfg)
    trainer = Trainer(cfg, "cuda", tcfg=tcfg, run_cfg=run_cfg)  # 1 x 1
    trainer.initialize(restore=True)     # fresh init, or the latest ckpt
    history = trainer.fit(data_iter, num_steps)

The mesh is a ``DeviceMesh`` with named dims (``launch.mesh``) over an
initialised process group; a device (``None`` meaning the card) is the
1 x 1 mesh on it, with no process group.  Parameters and optimizer state
are placed by ``param_partition_specs`` and ``opt_state_shardings``:
each rank holds its shards as plain tensors (``dtensors()`` views them as
DTensors), initialised from the seed (every rank draws the whole tree and
keeps its shards) or restored from a checkpoint written on any mesh.
Batches are cut over the batch axes (``_shard_batch``) and the step runs
under the mesh's rules (``launch.programs.build_train_step``).  A
checkpoint gathers every leaf whole and one rank writes it, in the one
file format, so checkpoints move between meshes, and between this port
and the JAX package, in every direction.  Every step is timed through a
``StragglerMonitor``; the JAX trainer's ``FailureDetector`` poll and
``plan_elastic_mesh`` are the driver's (a restart on the planned mesh
restores the last checkpoint).  Parameters are leaf tensors that require
grad, updated in place by the optimizer.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from repro_torch.checkpointing import checkpoint as ckpt_lib
from repro_torch.distributed import sharding as shlib, spmd
from repro_torch.distributed.fault_tolerance import StragglerMonitor
from repro_torch.launch import programs
from repro_torch.launch.mesh import as_mesh, mesh_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.tree import leaves, unflatten_like


def _batch_leaf(v, device) -> torch.Tensor:
    """A batch leaf on ``device`` by its kind, never a floating or boolean
    leaf cast to an integer (the JAX trainer keeps each leaf's dtype)."""
    t = torch.as_tensor(v, device=device)
    if t.dtype == torch.bool:
        return t
    return t.float() if t.is_floating_point() else t.long()


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str = "build/train_ckpt"
    ckpt_every: int = 50
    keep_ckpts: int = 3
    log_every: int = 10
    seed: int = 0
    # each rank's batches hold only its rows of the batch axes (a
    # per-host stream), instead of the global batch
    host_batches: bool = False


def place(tree, spec_tree, comm: spmd.MeshComm):
    """Every leaf of a whole tree cut to this rank's shard (a copy where
    something is cut; the leaf itself on one rank)."""
    return unflatten_like(tree, [
        spmd.shard_of(x, s, comm).contiguous()
        for x, s in zip(leaves(tree), programs.flat_specs(spec_tree))])


def gather(tree, spec_tree, comm: spmd.MeshComm):
    """Every leaf of a sharded tree gathered whole (every rank calls)."""
    return unflatten_like(tree, [
        spmd.gather_of(x.detach(), s, comm)
        for x, s in zip(leaves(tree), programs.flat_specs(spec_tree))])


class Trainer:
    def __init__(self, cfg: ModelConfig, mesh=None,
                 tcfg: Optional[programs.TrainConfig] = None,
                 run_cfg: Optional[TrainerConfig] = None, *, device=None):
        """``mesh``: a device mesh, or a device (``device=`` names one
        too); neither means the card."""
        self.mesh = as_mesh(mesh if mesh is not None else device)
        self.device = mesh_device(self.mesh)
        self.cfg = cfg
        self.tcfg = tcfg or programs.default_train_config(cfg)
        self.run_cfg = run_cfg or TrainerConfig()
        self.model = build_model(cfg, self.device)
        sizes = shlib.axis_sizes(self.mesh)
        self.rules_table = (shlib.multi_pod_rules() if "pod" in sizes
                            else shlib.single_pod_rules())
        self.rules = shlib.ShardingRules(self.mesh, self.rules_table)
        self.comm = spmd.comm_of(self.mesh)
        self.writer = self.comm.index(self.comm.names) == 0
        self.checkpointer = ckpt_lib.AsyncCheckpointer(
            self.run_cfg.ckpt_dir, keep=self.run_cfg.keep_ckpts)
        self.straggler = StragglerMonitor()
        self.step_fn = None
        self.params = None
        self.opt_state = None
        self.step = 0

    # ------------------------------------------------------------------
    def param_specs(self):
        return shlib.param_partition_specs(self.model.init_abstract(),
                                           self.rules)

    def opt_specs(self):
        abstract = self.model.init_abstract()
        return programs.opt_state_shardings(
            adamw.init_state(abstract, self.tcfg.adamw),
            shlib.param_partition_specs(abstract, self.rules), self.rules,
            self.tcfg.adamw)

    def initialize(self, restore: bool = True):
        """Fresh init from ``run_cfg.seed`` or restore-from-latest (the
        elastic restart path: the checkpoint may come from another mesh,
        or from the JAX trainer)."""
        pspecs, ospecs = self.param_specs(), self.opt_specs()
        latest = ckpt_lib.latest_step(self.run_cfg.ckpt_dir) \
            if restore else None
        if latest is not None:
            tree, extra = ckpt_lib.restore(
                self.run_cfg.ckpt_dir, latest, device=self.device,
                shardings=(self.mesh, {"params": pspecs, "opt": ospecs}))
            self.params, self.opt_state = tree["params"], tree["opt"]
            self.step = int(extra.get("step", latest))
        else:
            gen = torch.Generator(device=self.device)
            whole = self.model.init(gen.manual_seed(self.run_cfg.seed))
            opt = adamw.init_state(whole, self.tcfg.adamw)
            self.params = place(whole, pspecs, self.comm)
            self.opt_state = place(opt, ospecs, self.comm)
            del whole, opt
            self.step = 0
        for p in leaves(self.params):
            p.requires_grad_(True)
        self.step_fn = programs.build_train_step(self.cfg, self.tcfg,
                                                 self.device, mesh=self.mesh)
        return self

    def dtensors(self):
        """The parameters as DTensors on the mesh (views of the shards),
        for a ``DeviceMesh``."""
        from torch.distributed.tensor import DTensor

        return unflatten_like(self.params, [
            DTensor.from_local(p.detach(), self.mesh,
                               shlib.placements(s, self.mesh),
                               run_check=False)
            for p, s in zip(leaves(self.params),
                            programs.flat_specs(self.param_specs()))])

    # ------------------------------------------------------------------
    def _shard_batch(self, batch):
        """Each leaf as a tensor on this rank's device (integers int64,
        floats f32, booleans kept), cut to this rank's rows of the batch
        axes unless ``run_cfg.host_batches`` says it holds them already."""
        out = {}
        for k, v in batch.items():
            t = _batch_leaf(v, self.device)
            if not self.run_cfg.host_batches:
                spec = self.rules.resolve(
                    ("batch",) + (None,) * (t.dim() - 1), tuple(t.shape))
                t = spmd.shard_of(t, spec, self.comm)
            out[k] = t
        return out

    def train_step(self, batch) -> Dict[str, float]:
        """One step on a batch of numpy or torch arrays (``_shard_batch``).
        ``step_time_s`` covers the device's work: reading the metrics
        synchronizes."""
        t0 = time.perf_counter()
        batch = self._shard_batch(batch)
        self.params, self.opt_state, metrics = self.step_fn(
            self.params, self.opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        self.step += 1
        dt = time.perf_counter() - t0
        metrics["step_time_s"] = dt
        metrics["straggler"] = float(self.straggler.record(dt))
        return metrics

    def maybe_checkpoint(self, force: bool = False):
        """Every rank gathers the leaves whole; the first rank writes."""
        if force or (self.run_cfg.ckpt_every > 0
                     and self.step % self.run_cfg.ckpt_every == 0):
            tree = {"params": self.params, "opt": self.opt_state}
            if self.comm.size(self.comm.names) > 1:
                tree = gather(tree, {"params": self.param_specs(),
                                     "opt": self.opt_specs()}, self.comm)
            if self.writer:
                self.checkpointer.save(self.step, tree,
                                       extra_meta={"step": self.step})

    def wait(self):
        """The last checkpoint written, on every rank."""
        self.checkpointer.wait()
        if self.comm.size(self.comm.names) > 1:
            torch.distributed.barrier()

    # ------------------------------------------------------------------
    def fit(self, data_iter: Iterator[Any], num_steps: int,
            log_fn: Callable[[int, Dict], None] = None) -> Dict[str, list]:
        history: Dict[str, list] = {"loss": [], "step_time_s": []}
        for _ in range(num_steps):
            batch = next(data_iter)
            metrics = self.train_step(batch)
            history["loss"].append(metrics.get("loss", float("nan")))
            history["step_time_s"].append(metrics["step_time_s"])
            if log_fn and self.step % self.run_cfg.log_every == 0:
                log_fn(self.step, metrics)
            self.maybe_checkpoint()
        self.maybe_checkpoint(force=True)
        self.wait()
        return history
