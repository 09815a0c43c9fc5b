"""Training loop: eager train step + async checkpointing, as
``repro.train.trainer``, on one device.

    trainer = Trainer(cfg, device="cuda", tcfg=tcfg, run_cfg=run_cfg)
    trainer.initialize(restore=True)     # fresh init, or the latest ckpt
    history = trainer.fit(data_iter, num_steps)

Every step is timed through a ``StragglerMonitor``; checkpoints are
atomic and async (one outstanding host write).  The JAX trainer runs on
a mesh and polls a ``FailureDetector`` for elastic restart; both come
with sharding (ROADMAP Queue A item 13).  Parameters are leaf tensors
that require grad, updated in place by the optimizer.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from repro_torch.checkpointing import checkpoint as ckpt_lib
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import StragglerMonitor
from repro_torch.launch import programs
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.tree import leaves


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str = "build/train_ckpt"
    ckpt_every: int = 50
    keep_ckpts: int = 3
    log_every: int = 10
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ModelConfig, device=None,
                 tcfg: Optional[programs.TrainConfig] = None,
                 run_cfg: Optional[TrainerConfig] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tcfg = tcfg or programs.default_train_config(cfg)
        self.run_cfg = run_cfg or TrainerConfig()
        self.model = build_model(cfg, self.device)
        self.checkpointer = ckpt_lib.AsyncCheckpointer(
            self.run_cfg.ckpt_dir, keep=self.run_cfg.keep_ckpts)
        self.straggler = StragglerMonitor()
        self.step_fn = None
        self.params = None
        self.opt_state = None
        self.step = 0

    # ------------------------------------------------------------------
    def initialize(self, restore: bool = True):
        """Fresh init from ``run_cfg.seed`` or restore-from-latest.  A
        checkpoint written by the JAX trainer restores as well."""
        latest = ckpt_lib.latest_step(self.run_cfg.ckpt_dir) \
            if restore else None
        if latest is not None:
            tree, extra = ckpt_lib.restore(self.run_cfg.ckpt_dir, latest,
                                           device=self.device)
            self.params, self.opt_state = tree["params"], tree["opt"]
            self.step = int(extra.get("step", latest))
        else:
            gen = torch.Generator(device=self.device)
            self.params = self.model.init(gen.manual_seed(self.run_cfg.seed))
            self.opt_state = adamw.init_state(self.params, self.tcfg.adamw)
            self.step = 0
        for p in leaves(self.params):
            p.requires_grad_(True)
        self.step_fn = programs.build_train_step(self.cfg, self.tcfg,
                                                 self.device)
        return self

    # ------------------------------------------------------------------
    def train_step(self, batch) -> Dict[str, float]:
        """One step on a batch of numpy or torch arrays.  ``step_time_s``
        covers the device's work: reading the metrics synchronizes."""
        t0 = time.perf_counter()
        batch = {k: torch.as_tensor(v, device=self.device).long()
                 for k, v in batch.items()}
        self.params, self.opt_state, metrics = self.step_fn(
            self.params, self.opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        self.step += 1
        dt = time.perf_counter() - t0
        metrics["step_time_s"] = dt
        metrics["straggler"] = float(self.straggler.record(dt))
        return metrics

    def maybe_checkpoint(self, force: bool = False):
        if force or (self.run_cfg.ckpt_every > 0
                     and self.step % self.run_cfg.ckpt_every == 0):
            self.checkpointer.save(
                self.step, {"params": self.params, "opt": self.opt_state},
                extra_meta={"step": self.step})

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
        self.checkpointer.wait()
        return history
