"""AdmissionController — the single gate for every resource decision.

The paper's configuration manager is resource-aware: it watches per-node
utilization and admits work so nodes never overload.  This module turns
that implicit behaviour into one explicit control-plane API.  Nothing in
the runtime calls ``ResourceMonitor.commit`` directly any more — instance
placement (``Orchestrator._deploy_instance``, failover, rejoin,
reconcile), placement-policy scoring, and per-request dispatch all route
through the controller, which layers tenancy and QoS on top of raw
capacity:

**Tenant quotas.**  A ``TenantQuota`` caps a tenant's total committed
instance HBM (``hbm_bytes``) and the sum of analytic FLOP estimates of
its in-flight dispatches (``flops_inflight`` — a rate-limiter proxy for
sustained FLOP/s).  Quota refusals are hard: preemption never raises the
preemptor's own quota, it only frees *node* capacity.  Tenants without a
quota are unlimited (the single-tenant default).

**QoS classes** (``repro_torch.core.spec.QoSClass``), Kubernetes-style:

  GUARANTEED   — may preempt both lower classes for node capacity, and
                 its dispatches are never refused on the FLOP quota
                 (still accounted, so dashboards see the burst).
  BURSTABLE    — the default; may preempt BEST_EFFORT; FLOP-quota bound.
  BEST_EFFORT  — evicted first, strictly quota bound.

**Priority-ordered preemption.**  When a spec's instance does not fit on
the chosen node, the controller evicts instances of *strictly weaker* QoS
class — worst class first, then lowest ``ServiceSpec.priority``, then
newest instance — until the newcomer fits, and reports the victims in
``AdmissionDecision.evicted``.  Same-class preemption is deliberately
disallowed (it thrashes); a GUARANTEED apply therefore cannot be refused
by a saturating BEST_EFFORT tenant, but two GUARANTEED services compete
only on free capacity.

**Page-based HBM accounting.**  Instance footprints are what the
executor reports: the paged serving engine's static reservation is
params + its KV *page pool* (which can be provisioned below the dense
``max_slots × max_seq`` layout), and its live commitment
(``dynamic_footprint_bytes``) is params + pages-in-use — telemetry
samples carry the live number, so dashboards see paging occupancy, not
the worst case.

**Capacity observers.**  ``add_release_observer`` callbacks fire after
every reservation release; the orchestrator uses them to drain its
pending-redeploy queue of preempted instances.  Releases that happen
*inside* a preemption are deferred until the admission completes, so a
victim can't be redeployed into the hole its preemptor is about to fill.

Every admission answer is a typed ``AdmissionDecision(admitted, reason,
evicted)`` so callers (and tests) see *why* something was refused, not
just a boolean.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.resources import ResourceMonitor
from repro_torch.core.spec import QOS_RANK, QoSClass, ServiceSpec


class AdmissionError(RuntimeError):
    """A dispatch or deployment was refused by the admission controller."""


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Per-tenant resource caps; ``None`` means unlimited."""
    hbm_bytes: Optional[int] = None        # total committed instance HBM
    flops_inflight: Optional[float] = None  # sum of in-flight dispatch FLOPs


@dataclasses.dataclass
class AdmissionDecision:
    admitted: bool
    reason: str = ""
    evicted: List[str] = dataclasses.field(default_factory=list)
    node_id: Optional[str] = None


def can_preempt(incoming: ServiceSpec, victim: ServiceSpec) -> bool:
    """An incoming spec may evict only strictly weaker QoS classes."""
    return QOS_RANK[incoming.qos] < QOS_RANK[victim.qos]


# victims are offered to ``admit_instance`` as (name, hbm_bytes, spec)
Victim = Tuple[str, int, ServiceSpec]


class AdmissionController:
    """Wraps a ``ResourceMonitor`` with tenancy, QoS and preemption."""

    def __init__(self, monitor: Optional[ResourceMonitor] = None):
        self.monitor = monitor or ResourceMonitor()
        self.quotas: Dict[str, TenantQuota] = {}
        self._lock = threading.RLock()
        # (node_id, key) → (tenant, hbm_bytes): attribution for release
        self._keys: Dict[Tuple[str, str], Tuple[str, int]] = {}
        self._tenant_hbm: Dict[str, int] = {}
        self._tenant_flops: Dict[str, float] = {}
        # bounded audit trail: every dispatch appends here, so an
        # unbounded list would leak in long-running serving
        self.decisions: Deque[AdmissionDecision] = \
            collections.deque(maxlen=256)
        # capacity observers: notified (outside the lock) whenever an
        # instance reservation is released — the orchestrator uses this to
        # drain its pending-redeploy queue of preempted instances
        self._release_observers: List[Callable[[str], None]] = []
        self._in_admission = 0            # depth guard: defer notifications
        self._deferred_release: List[str] = []

    def add_release_observer(self, fn: Callable[[str], None]):
        """Register a callback fired with the node id after every
        per-instance reservation release (undeploy/evict).  ``forget_node``
        does NOT notify — a dead node frees no usable capacity.  Called
        outside the admission lock, so observers may re-enter the
        controller — but a release that happens *during* an admission
        (preemption) only notifies once that admission completes."""
        self._release_observers.append(fn)

    def _notify_release(self, node_id: str):
        for fn in list(self._release_observers):
            fn(node_id)

    # ------------------------------------------------------------- quotas
    def set_quota(self, tenant: str, quota: Optional[TenantQuota]):
        with self._lock:
            if quota is None:
                self.quotas.pop(tenant, None)
            else:
                self.quotas[tenant] = quota

    def quota_snapshot(self) -> Dict[str, TenantQuota]:
        """Consistent copy for persistence (iterating ``quotas`` unlocked
        races concurrent ``set_quota`` calls)."""
        with self._lock:
            return dict(self.quotas)

    def _hbm_headroom_ok(self, tenant: str, hbm_bytes: int) -> bool:
        quota = self.quotas.get(tenant)
        if quota is None or quota.hbm_bytes is None:
            return True
        return self._tenant_hbm.get(tenant, 0) + hbm_bytes <= quota.hbm_bytes

    def has_quota_headroom(self, tenant: str, hbm_bytes: int) -> bool:
        with self._lock:
            return self._hbm_headroom_ok(tenant, hbm_bytes)

    # ------------------------------------------------- placement scoring
    def fits(self, node_id: str, hbm_bytes: int,
             spec: Optional[ServiceSpec] = None) -> bool:
        """Quota-aware capacity query — what placement policies score with."""
        if spec is not None:
            with self._lock:
                if not self._hbm_headroom_ok(spec.tenant, hbm_bytes):
                    return False
        return self.monitor.fits(node_id, hbm_bytes)

    def hbm_free(self, node_id: str) -> int:
        return self.monitor.hbm_free(node_id)

    # --------------------------------------------------------- instances
    def admit_instance(self, node_id: str, key: str, hbm_bytes: int,
                       spec: ServiceSpec,
                       victims: Sequence[Victim] = (),
                       evict: Optional[Callable[[str], None]] = None
                       ) -> AdmissionDecision:
        """Reserve ``hbm_bytes`` on ``node_id`` for one instance of
        ``spec``, preempting weaker instances from ``victims`` if needed.

        ``victims`` lists the instances currently on the node; ``evict``
        undeploys one by name (the orchestrator's callback, which releases
        the victim's reservation back through this controller).  Victim
        releases during the preemption defer their capacity-freed
        notification until this admission completes.
        """
        with self._lock:
            self._in_admission += 1
            try:
                decision = self._admit_instance_locked(
                    node_id, key, hbm_bytes, spec, victims, evict)
            finally:
                self._in_admission -= 1
                pending, self._deferred_release = self._deferred_release, []
        for freed_node in pending:
            self._notify_release(freed_node)
        return decision

    def _admit_instance_locked(self, node_id, key, hbm_bytes, spec,
                               victims, evict) -> AdmissionDecision:
        if not self._hbm_headroom_ok(spec.tenant, hbm_bytes):
            return self._decide(AdmissionDecision(
                False, reason=f"tenant-quota: {spec.tenant!r} over "
                f"hbm_bytes quota", node_id=node_id))
        if self.monitor.commit(node_id, key, hbm_bytes):
            self._account(node_id, key, spec.tenant, hbm_bytes)
            return self._decide(AdmissionDecision(True, node_id=node_id))
        # node capacity refused — try priority-ordered preemption:
        # worst class first, lowest priority first, newest first
        def eviction_order(v: Victim):
            name, _b, vspec = v
            tail = name.rsplit("/", 1)[-1]
            idx = int(tail) if tail.isdigit() else 0
            return (-QOS_RANK[vspec.qos], vspec.priority, -idx)

        evictable = sorted(
            (v for v in victims if can_preempt(spec, v[2])),
            key=eviction_order)
        if not evictable or evict is None:
            return self._decide(AdmissionDecision(
                False, reason=f"capacity: {hbm_bytes} bytes do not fit "
                f"on {node_id}", node_id=node_id))
        evicted = []
        for name, _vbytes, _vspec in evictable:
            evict(name)
            evicted.append(name)
            if self.monitor.fits(node_id, hbm_bytes):
                break
        if not self.monitor.commit(node_id, key, hbm_bytes):
            return self._decide(AdmissionDecision(
                False, reason=f"capacity: {hbm_bytes} bytes do not fit "
                f"on {node_id} even after preempting {evicted}",
                evicted=evicted, node_id=node_id))
        self._account(node_id, key, spec.tenant, hbm_bytes)
        return self._decide(AdmissionDecision(True, evicted=evicted,
                                              node_id=node_id))

    def _account(self, node_id: str, key: str, tenant: str, hbm_bytes: int):
        self._keys[(node_id, key)] = (tenant, hbm_bytes)
        self._tenant_hbm[tenant] = self._tenant_hbm.get(tenant, 0) + hbm_bytes

    def release(self, node_id: str, key: str):
        """Release one instance reservation (monitor + tenant accounting).

        Observers registered via ``add_release_observer`` see the freed
        capacity — unless this release happens inside an ``admit_instance``
        preemption, where notification is deferred until the preemptor's
        admission completes (redeploying the victim mid-preemption would
        undo the eviction)."""
        with self._lock:
            self.monitor.release(node_id, key)
            owned = self._keys.pop((node_id, key), None)
            if owned is not None:
                tenant, hbm = owned
                self._tenant_hbm[tenant] = \
                    max(0, self._tenant_hbm.get(tenant, 0) - hbm)
            deferred = self._in_admission > 0
            if deferred:
                self._deferred_release.append(node_id)
        if not deferred:
            self._notify_release(node_id)

    def forget_node(self, node_id: str):
        """Drop tenant attribution for a node whose monitor state is gone
        (node failure unregisters it wholesale)."""
        with self._lock:
            for (nid, key) in [k for k in self._keys if k[0] == node_id]:
                tenant, hbm = self._keys.pop((nid, key))
                self._tenant_hbm[tenant] = \
                    max(0, self._tenant_hbm.get(tenant, 0) - hbm)

    # --------------------------------------------------------- dispatches
    def admit_dispatch(self, spec: ServiceSpec, flops: float
                       ) -> AdmissionDecision:
        """Admit one request against the tenant's in-flight FLOP quota.

        GUARANTEED dispatches are never refused (only accounted);
        BURSTABLE/BEST_EFFORT are refused once the tenant is over quota.
        Pair every admitted call with ``release_dispatch``.
        """
        with self._lock:
            quota = self.quotas.get(spec.tenant)
            inflight = self._tenant_flops.get(spec.tenant, 0.0)
            if (quota is not None and quota.flops_inflight is not None
                    and spec.qos is not QoSClass.GUARANTEED
                    and inflight + flops > quota.flops_inflight):
                return self._decide(AdmissionDecision(
                    False, reason=f"tenant-quota: {spec.tenant!r} over "
                    f"flops_inflight quota "
                    f"({inflight + flops:.3g} > {quota.flops_inflight:.3g})"))
            self._tenant_flops[spec.tenant] = inflight + flops
            return self._decide(AdmissionDecision(True))

    def release_dispatch(self, spec: ServiceSpec, flops: float):
        with self._lock:
            self._tenant_flops[spec.tenant] = max(
                0.0, self._tenant_flops.get(spec.tenant, 0.0) - flops)

    # ---------------------------------------------------------- telemetry
    def _decide(self, d: AdmissionDecision) -> AdmissionDecision:
        self.decisions.append(d)
        return d

    def instance_commitments(self) -> Dict[str, Dict[str, object]]:
        """Per-instance charged HBM: ``{instance: {node, tenant,
        hbm_bytes}}`` — shows each fleet replica's static reservation was
        individually admitted (fleet benchmarks/tests assert on this)."""
        with self._lock:
            return {key: {"node": node_id, "tenant": tenant,
                          "hbm_bytes": hbm}
                    for (node_id, key), (tenant, hbm)
                    in sorted(self._keys.items())}

    def tenant_usage(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            tenants = set(self._tenant_hbm) | set(self._tenant_flops) \
                | set(self.quotas)
            out = {}
            for t in sorted(tenants):
                quota = self.quotas.get(t)
                out[t] = {
                    "hbm_bytes": float(self._tenant_hbm.get(t, 0)),
                    "flops_inflight": self._tenant_flops.get(t, 0.0),
                    "hbm_quota": float(quota.hbm_bytes)
                    if quota and quota.hbm_bytes is not None else None,
                    "flops_quota": quota.flops_inflight
                    if quota and quota.flops_inflight is not None else None,
                }
            return out
