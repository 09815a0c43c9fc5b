"""Assigned input-shape sets and per-cell applicability, as
``repro.launch.shapes``.

LM transformer shapes are seq_len × global_batch.  ``decode_*`` and
``long_*`` run the serve step (one new token against a KV cache of
seq_len), not the train step.  ``long_500k`` applies only to
sub-quadratic archs (SSM, hybrid, sliding window); encoder-only archs have
no decode step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def is_subquadratic(cfg: ModelConfig) -> bool:
    return cfg.family in ("ssm", "hybrid") or cfg.sliding_window > 0


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """None if the cell runs; otherwise the skip reason."""
    if cfg.encoder_only and shape.kind == "decode":
        return "encoder-only: no decode step"
    if shape.name == "long_500k" and not is_subquadratic(cfg):
        return "pure full attention: 500k decode needs sub-quadratic attention"
    return None


def cells(arch_names: List[str], get_config) -> List[tuple]:
    out = []
    for a in arch_names:
        cfg = get_config(a)
        for s in SHAPES.values():
            out.append((a, s.name, applicable(cfg, s)))
    return out
