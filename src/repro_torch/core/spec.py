"""Declarative service specs — the paper's manifest model (fig 2).

Operators state *what* to run; the runtime decides *where*.  A
``ServiceSpec`` names a service, carries a workload template (used for
classification and builder lookup), and declares intent: how many
replicas, which placement policy, what latency SLO, and optionally a
footprint hint when the operator knows better than the probe build.

v2 adds the QoS surface: every spec belongs to a ``tenant``, carries a
``priority`` and a ``QoSClass`` (``GUARANTEED``/``BURSTABLE``/
``BEST_EFFORT``).  The ``AdmissionController`` (core/admission.py) uses
these for per-tenant quotas and priority-ordered preemption, and specs
round-trip through JSON (``to_json``/``from_json``) so a restarted
manager node can re-apply its whole cluster state — the paper's
configuration-manager restart story.

The spec is the single source of truth for a service's lifecycle: the
orchestrator stores it on every ``Deployment`` so failover, rejoin and
scaling all redeploy from the spec instead of re-threading
``(name, factory, footprint)`` triples through each call.
"""
from __future__ import annotations

import dataclasses
import enum
import json
from typing import Optional

from repro_torch.core.executor import ExecutorClass
from repro_torch.core.workload import (ClassifierConfig, Workload,
                                       WorkloadClass, classify)

# the paper's substrate mapping: heavy → container, light → unikernel
EXECUTOR_FOR_CLASS = {
    WorkloadClass.HEAVY: ExecutorClass.CONTAINER,
    WorkloadClass.LIGHT: ExecutorClass.UNIKERNEL,
}
CLASS_FOR_EXECUTOR = {v: k for k, v in EXECUTOR_FOR_CLASS.items()}


class QoSClass(str, enum.Enum):
    """Kubernetes-style QoS triage for the hybrid edge runtime.

    GUARANTEED   — never refused for lack of node capacity while lower
                   classes occupy it: admission may preempt them.
    BURSTABLE    — the default; admitted while capacity and tenant quota
                   allow, may preempt BEST_EFFORT.
    BEST_EFFORT  — first to be evicted, strictly quota-bound.
    """
    GUARANTEED = "guaranteed"
    BURSTABLE = "burstable"
    BEST_EFFORT = "best-effort"


# lower rank = stronger class (sorts first in admission ordering)
QOS_RANK = {QoSClass.GUARANTEED: 0, QoSClass.BURSTABLE: 1,
            QoSClass.BEST_EFFORT: 2}


@dataclasses.dataclass(frozen=True)
class ServiceSpec:
    """What to run; the orchestration layer decides where."""
    name: str
    workload: Workload                          # template for routing/build
    executor_class: Optional[ExecutorClass] = None   # None → classify
    replicas: int = 1
    placement: Optional[str] = None             # POLICIES name; None → default
    latency_slo_ms: float = 0.0
    footprint_hint: Optional[int] = None        # bytes; None → probe build
    # --- QoS surface (v2) ---
    tenant: str = "default"
    priority: int = 0                           # higher = more important
    qos: QoSClass = QoSClass.BURSTABLE
    donates_inputs: bool = False    # executors donate arg buffers → no
    # speculative re-dispatch of the same args (backups clone instead)
    kv_dtype: str = "auto"          # serving KV-page dtype ("auto" →
    # compute dtype; "int8" → quantized pages, ~2x tokens per byte;
    # another dtype's name → compute-dtype pages counted in it, as in JAX)

    def __post_init__(self):
        if self.replicas < 0:
            raise ValueError(f"spec {self.name!r}: replicas must be >= 0")
        if not self.tenant:
            raise ValueError(f"spec {self.name!r}: tenant must be non-empty")
        if isinstance(self.qos, str) and not isinstance(self.qos, QoSClass):
            object.__setattr__(self, "qos", QoSClass(self.qos))
        if isinstance(self.executor_class, str) and \
                not isinstance(self.executor_class, ExecutorClass):
            object.__setattr__(self, "executor_class",
                               ExecutorClass(self.executor_class))

    # ------------------------------------------------------------------
    def resolve_executor_class(
            self, classifier: ClassifierConfig = ClassifierConfig()
    ) -> ExecutorClass:
        """Executor class override, else application-aware classification."""
        if self.executor_class is not None:
            return self.executor_class
        return EXECUTOR_FOR_CLASS[classify(self.workload, classifier)]

    def resolve_workload_class(
            self, classifier: ClassifierConfig = ClassifierConfig()
    ) -> WorkloadClass:
        return CLASS_FOR_EXECUTOR[self.resolve_executor_class(classifier)]

    def with_replicas(self, n: int) -> "ServiceSpec":
        return dataclasses.replace(self, replicas=n)

    def instance_name(self, index: int) -> str:
        return f"{self.name}/{index}"

    def admission_rank(self) -> tuple:
        """Sort key for QoS-ordered admission: stronger class first, then
        higher priority first (ties break FIFO at the call site)."""
        return (QOS_RANK[self.qos], -self.priority)

    # ------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "workload": self.workload.to_dict(),
            "executor_class": (self.executor_class.value
                               if self.executor_class is not None else None),
            "replicas": self.replicas,
            "placement": self.placement,
            "latency_slo_ms": self.latency_slo_ms,
            "footprint_hint": self.footprint_hint,
            "tenant": self.tenant,
            "priority": self.priority,
            "qos": self.qos.value,
            "donates_inputs": self.donates_inputs,
            "kv_dtype": self.kv_dtype,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ServiceSpec":
        ec = d.get("executor_class")
        return cls(
            name=d["name"],
            workload=Workload.from_dict(d["workload"]),
            executor_class=ExecutorClass(ec) if ec else None,
            replicas=d.get("replicas", 1),
            placement=d.get("placement"),
            latency_slo_ms=d.get("latency_slo_ms", 0.0),
            footprint_hint=d.get("footprint_hint"),
            tenant=d.get("tenant", "default"),
            priority=d.get("priority", 0),
            qos=QoSClass(d.get("qos", QoSClass.BURSTABLE.value)),
            donates_inputs=d.get("donates_inputs", False),
            kv_dtype=d.get("kv_dtype", "auto"))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s) -> "ServiceSpec":
        """Accepts a JSON string (or an already-parsed dict)."""
        return cls.from_dict(json.loads(s) if isinstance(s, str) else s)


def auto_spec(workload: Workload,
              classifier: ClassifierConfig = ClassifierConfig(),
              tenant: str = "default", priority: int = 0,
              qos: QoSClass = QoSClass.BURSTABLE) -> ServiceSpec:
    """Synthesize a single-replica spec for an unapplied workload — keeps
    ad-hoc ``submit`` working while everything stays spec-driven inside."""
    wclass = classify(workload, classifier)
    return ServiceSpec(
        name=f"{wclass.value}:{workload.kind.value}:{workload.name}",
        workload=workload,
        executor_class=EXECUTOR_FOR_CLASS[wclass],
        replicas=1,
        latency_slo_ms=workload.latency_slo_ms,
        tenant=tenant, priority=priority, qos=qos)
