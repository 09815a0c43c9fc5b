"""Workload descriptors + application-aware classification (paper P2).

The paper's configuration manager inspects incoming data and routes:
image → container, stream record → unikernel.  Generalized here: a
``Workload`` carries its application kind and analytic cost estimates; the
classifier maps it to an executor class:

  HEAVY → container-class  (training steps, prefill, large-batch decode,
          vision/audio backbones — the paper's CV/DNN tasks)
  LIGHT → unikernel-class  (stream analytics, single-stream small-model
          decode — the paper's Fitbit task)

Classification is *monotone* in the cost estimates (property-tested):
raising FLOPs/bytes/params never flips HEAVY→LIGHT.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

from repro_torch.models.config import ModelConfig


class WorkloadKind(str, enum.Enum):
    TRAIN = "train"
    PREFILL = "prefill"
    DECODE = "decode"
    STREAM = "stream"          # sensor-stream analytics (paper's light task)
    GENERIC = "generic"


class WorkloadClass(str, enum.Enum):
    HEAVY = "heavy"            # → container-class executor
    LIGHT = "light"            # → unikernel-class executor


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    kind: WorkloadKind
    arch: Optional[ModelConfig] = None
    batch: int = 1
    seq_len: int = 1
    latency_slo_ms: float = 0.0        # 0 → no SLO
    # analytic overrides (None → derive from arch/shape)
    est_flops: Optional[float] = None
    est_bytes: Optional[float] = None

    # ------------------------------------------------------------------
    def flops(self) -> float:
        if self.est_flops is not None:
            return self.est_flops
        if self.arch is None:
            return 0.0
        n = self.arch.active_params()
        tokens = self.batch * self.seq_len
        if self.kind == WorkloadKind.TRAIN:
            return 6.0 * n * tokens
        if self.kind == WorkloadKind.PREFILL:
            return 2.0 * n * tokens
        if self.kind == WorkloadKind.DECODE:
            return 2.0 * n * self.batch
        return 0.0

    def bytes_touched(self) -> float:
        if self.est_bytes is not None:
            return self.est_bytes
        if self.arch is None:
            return 0.0
        n = self.arch.active_params()
        if self.kind == WorkloadKind.DECODE:
            kv = (self.arch.kv_bytes_per_token() * self.arch.num_layers
                  * self.batch * self.seq_len)
            return 2.0 * n + kv
        return 2.0 * n

    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind.value,
            "arch": self.arch.to_dict() if self.arch is not None else None,
            "batch": self.batch,
            "seq_len": self.seq_len,
            "latency_slo_ms": self.latency_slo_ms,
            "est_flops": self.est_flops,
            "est_bytes": self.est_bytes,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Workload":
        arch = d.get("arch")
        return cls(name=d["name"], kind=WorkloadKind(d["kind"]),
                   arch=ModelConfig.from_dict(arch) if arch else None,
                   batch=d.get("batch", 1), seq_len=d.get("seq_len", 1),
                   latency_slo_ms=d.get("latency_slo_ms", 0.0),
                   est_flops=d.get("est_flops"),
                   est_bytes=d.get("est_bytes"))


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    """Thresholds between the two substrate classes."""
    flops_threshold: float = 5e9       # per dispatch
    bytes_threshold: float = 2e9       # per dispatch
    params_threshold: float = 5e8      # model size: 0.5B+ is container turf
    train_always_heavy: bool = True


def classify(w: Workload, cfg: ClassifierConfig = ClassifierConfig()
             ) -> WorkloadClass:
    """Application-aware routing rule (paper fig 1/2)."""
    if w.kind == WorkloadKind.STREAM:
        return WorkloadClass.LIGHT
    if cfg.train_always_heavy and w.kind == WorkloadKind.TRAIN:
        return WorkloadClass.HEAVY
    if w.arch is not None and w.arch.num_params() > cfg.params_threshold:
        return WorkloadClass.HEAVY
    if w.flops() > cfg.flops_threshold:
        return WorkloadClass.HEAVY
    if w.bytes_touched() > cfg.bytes_threshold:
        return WorkloadClass.HEAVY
    return WorkloadClass.LIGHT
