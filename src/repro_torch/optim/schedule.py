"""LR schedules (pure functions of step → multiplier), as
``repro.optim.schedule``: the same f32 arithmetic in the same order."""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_ratio: float = 0.1
    kind: str = "cosine"   # cosine | linear | constant


def lr_multiplier(step, cfg: ScheduleConfig) -> torch.Tensor:
    """The multiplier at ``step`` (an int or an integer tensor) as a 0-d
    f32 tensor, on the step's device when it is a tensor."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.kind == "constant":
        return warm
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.kind == "linear":
        decay = 1.0 - (1.0 - cfg.min_ratio) * frac
    else:  # cosine
        decay = cfg.min_ratio + (1.0 - cfg.min_ratio) * 0.5 * (
            1.0 + torch.cos(math.pi * frac))
    return warm * decay
