"""The paper's "light" workload, transplanted: Fitbit-style activity-stream
analytics as a pure PyTorch program (the port of ``repro.data.stream``).

The paper routes this task to unikernels: records with (user_id, date,
total_steps, total_distance, calories) arrive as a stream; the task is
"calculate the average steps per user and find the maximum average steps"
(§IV-B).  Here it is a small function over fixed-size record batches,
which the unikernel-class executor captures once in a CUDA graph with the
state donated, giving a minimal-footprint single-purpose executable.  The
record generator is the JAX package's, draw for draw, so both packages
fold the same records.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

FIELDS = ("user_id", "total_steps", "total_distance", "calories")


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    num_users: int = 32
    batch_records: int = 64
    seed: int = 7


def make_record_stream(cfg: StreamConfig) -> Iterator[Dict[str, np.ndarray]]:
    """Synthetic Fitbit-shaped daily-activity records."""
    rng = np.random.default_rng(cfg.seed)
    base_steps = rng.integers(2000, 15000, size=cfg.num_users)
    while True:
        users = rng.integers(0, cfg.num_users, size=cfg.batch_records)
        steps = rng.normal(base_steps[users], 1500).clip(0)
        dist = steps * rng.normal(0.00075, 0.00005, size=cfg.batch_records)
        cal = steps * 0.04 + rng.normal(1600, 150, size=cfg.batch_records)
        yield {
            "user_id": users.astype(np.int32),
            "total_steps": steps.astype(np.float32),
            "total_distance": dist.astype(np.float32),
            "calories": cal.astype(np.float32),
        }


def to_device(records: Dict[str, np.ndarray], device=None
              ) -> Dict[str, torch.Tensor]:
    """A record batch as tensors on ``device`` (default: the card)."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(v, device=dev) for k, v in records.items()}


def init_state(cfg: StreamConfig, device=None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {
        "step_sum": torch.zeros((cfg.num_users,), dtype=torch.float32,
                                device=dev),
        "count": torch.zeros((cfg.num_users,), dtype=torch.float32,
                             device=dev),
    }


def analytics_step(state: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, torch.Tensor],
                              Dict[str, torch.Tensor]]:
    """One stream step: fold a record batch, emit the paper's two outputs
    (per-user average steps; maximum average).  Pure: the per-user sums
    are out-of-place ``index_add``s, so a container may call it without
    touching the caller's state, and the unikernel image donates the
    state through its static buffers.  ``argmax`` ties take the first
    index, as in JAX."""
    uid = batch["user_id"].long()
    step_sum = state["step_sum"].index_add(0, uid, batch["total_steps"])
    count = state["count"].index_add(
        0, uid, torch.ones_like(batch["total_steps"]))
    avg = step_sum / torch.clamp(count, min=1.0)
    out = {
        "avg_steps_per_user": avg,
        "max_avg_steps": torch.max(avg),
        "argmax_user": torch.argmax(avg).to(torch.int32),
    }
    return {"step_sum": step_sum, "count": count}, out


def reference_analytics(records: Dict[str, np.ndarray], num_users: int):
    """Numpy oracle for tests."""
    sums = np.zeros(num_users)
    counts = np.zeros(num_users)
    np.add.at(sums, records["user_id"], records["total_steps"])
    np.add.at(counts, records["user_id"], 1.0)
    avg = sums / np.maximum(counts, 1.0)
    return avg, float(avg.max()), int(avg.argmax())
