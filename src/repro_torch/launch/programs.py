"""The training configuration bundle and the train step, as
``repro.launch.programs``.  The JAX module also builds the shardings and
lowers the programs its dry-run compiles; those come with the mesh
(ROADMAP Queue A item 13): this step runs eagerly on one device."""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.optim import adamw, grad as gradlib, schedule


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: adamw.AdamWConfig = adamw.AdamWConfig()
    sched: schedule.ScheduleConfig = schedule.ScheduleConfig()
    num_microbatches: int = 1


def default_train_config(cfg: ModelConfig) -> TrainConfig:
    """8-bit optimizer state for the archs above 30B parameters."""
    big = cfg.num_params() > 30e9
    return TrainConfig(
        adamw=adamw.AdamWConfig(state_dtype="int8" if big else "float32"))


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                     device=None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  The LR multiplier reads the step before the optimizer
    increments it, so step 0 trains at lr 0, as in JAX.  Parameters and
    fp32 moments update in place (``adamw.apply_updates``)."""
    model = build_model(cfg, device)

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = gradlib.accumulate_grads(
            model.loss, params, batch, tcfg.num_microbatches)
        lr_scale = schedule.lr_multiplier(opt_state["step"], tcfg.sched)
        params, opt_state, om = adamw.apply_updates(
            params, grads, opt_state, tcfg.adamw, lr_scale)
        metrics = dict(metrics)
        metrics.update(om)
        return params, opt_state, metrics

    return train_step
