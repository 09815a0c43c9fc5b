"""Orchestration across nodes (paper P4 — Swarm/KubeEdge/K3s/Nomad layer).

Nodes are logical slices of the cards (several may share one card, each
with its own capacity); a node's placement handle (``Node.mesh``, the name
kept from the JAX package) is the ``torch.device`` its instances are built
on, or ``None`` to let the builder pick.  The orchestrator owns
  * placement (pluggable policies mirroring the paper's orchestrators:
      round-robin ≙ Swarm's spread, least-loaded ≙ K3s default-ish
      scheduling, bin-pack ≙ Nomad's binpack),
  * spec-driven deployment: ``apply(spec, factory)`` registers a service
    and reconciles to ``spec.replicas`` instances; every ``Deployment``
    carries its ``ServiceSpec``, so scaling, failover and rejoin redeploy
    from the stored spec — no ``(name, factory, footprint)`` threading,
  * failure handling: a dead node's instances are redeployed onto healthy
    nodes from their service records (images come from the registry cache —
    the paper's "containers can be quickly redeployed to alternate
    devices").
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.admission import (AdmissionController, Victim,
                                        can_preempt)
from repro_torch.core.executor import BaseExecutor
from repro_torch.core.resources import NodeCapacity, ResourceMonitor
from repro_torch.core.spec import ServiceSpec
from repro_torch.device import same_device
from repro_torch.distributed.fault_tolerance import FailureDetector


@dataclasses.dataclass
class Node:
    node_id: str
    capacity: NodeCapacity
    mesh: Any = None               # placement handle: torch.device or None
    healthy: bool = True


@dataclasses.dataclass
class Deployment:
    name: str                      # instance name: "<service>/<index>"
    service: str                   # owning spec's name
    node_id: str
    executor: BaseExecutor
    footprint: int
    spec: ServiceSpec


@dataclasses.dataclass
class ServiceRecord:
    """Everything needed to (re)deploy instances of one service."""
    spec: ServiceSpec
    factory: Callable[[Any], BaseExecutor]     # handle → executor
    footprint: int
    policy: Optional["PlacementPolicy"] = None   # per-spec override
    prebuilt: Optional[BaseExecutor] = None    # probe build, consumed once
    next_index: int = 0


def _adoptable(prebuilt: BaseExecutor, handle) -> bool:
    """A probe-built executor may serve a node with no placement handle,
    or one whose handle names the device the probe was built on; a probe
    on the card never serves a node that names another device."""
    return handle is None or same_device(prebuilt.mesh, handle)


# --------------------------------------------------------------------------
# placement policies
# --------------------------------------------------------------------------

class PlacementPolicy:
    """Policies score nodes through the admission controller (``monitor``
    here is an ``AdmissionController`` in normal operation — its ``fits``
    is tenant-quota-aware when a ``spec`` is supplied; a bare
    ``ResourceMonitor`` also satisfies the same call shape)."""
    name = "base"

    def pick(self, nodes: List[Node], monitor, footprint: int,
             spec: Optional[ServiceSpec] = None) -> Optional[str]:
        raise NotImplementedError

    @staticmethod
    def _live(nodes, monitor, footprint, spec):
        return [n for n in nodes if n.healthy
                and monitor.fits(n.node_id, footprint, spec)]


class RoundRobinPolicy(PlacementPolicy):
    """Spread, ignoring load (≙ Docker Swarm).

    The rotation index advances over the *candidate* set (healthy AND
    fitting), so a full node drops out of the rotation instead of skewing
    every subsequent pick toward whichever node happens to follow it.
    """
    name = "round-robin"

    def __init__(self):
        self._idx = 0

    def pick(self, nodes, monitor, footprint, spec=None):
        live = self._live(nodes, monitor, footprint, spec)
        if not live:
            return None
        node = live[self._idx % len(live)]
        self._idx += 1
        return node.node_id


class LeastLoadedPolicy(PlacementPolicy):
    """Most free HBM first (≙ K3s-style load spreading)."""
    name = "least-loaded"

    def pick(self, nodes, monitor, footprint, spec=None):
        live = self._live(nodes, monitor, footprint, spec)
        if not live:
            return None
        return max(live, key=lambda n: monitor.hbm_free(n.node_id)).node_id


class BinPackPolicy(PlacementPolicy):
    """Tightest fit first — frees whole nodes for scale-down (≙ Nomad)."""
    name = "bin-pack"

    def pick(self, nodes, monitor, footprint, spec=None):
        live = self._live(nodes, monitor, footprint, spec)
        if not live:
            return None
        return min(live, key=lambda n: monitor.hbm_free(n.node_id)).node_id


POLICIES = {p.name: p for p in (RoundRobinPolicy, LeastLoadedPolicy,
                                BinPackPolicy)}


# --------------------------------------------------------------------------

class PlacementError(RuntimeError):
    pass


class Orchestrator:
    def __init__(self, policy: Optional[PlacementPolicy] = None,
                 monitor: Optional[ResourceMonitor] = None,
                 detector: Optional[FailureDetector] = None,
                 admission: Optional[AdmissionController] = None):
        self.policy = policy or LeastLoadedPolicy()
        # every resource decision routes through ONE admission controller;
        # the raw monitor stays reachable for telemetry snapshots
        self.admission = admission or AdmissionController(monitor)
        self.monitor = self.admission.monitor
        self.nodes: Dict[str, Node] = {}
        self.services: Dict[str, ServiceRecord] = {}
        self.deployments: Dict[str, Deployment] = {}
        self.events: List[str] = []
        self.detector = detector
        # preempted instances queue here for redeploy; the admission
        # controller's release observer marks freed capacity and the next
        # drain (triggered from undeploy/scale/rejoin) reconciles them
        self.pending_redeploy: collections.deque = collections.deque()
        self.eviction_hooks: List[Callable[[str, str, str], None]] = []
        # evictions recorded during an admission; hooks fire only after
        # the admission completes (outside the admission lock)
        self._pending_evictions: List[tuple] = []
        self._capacity_freed = False
        self._redeploying = False
        self.admission.add_release_observer(self._on_capacity_freed)
        if detector is not None:
            detector.on_change(self._on_health_change)

    # ---------------------------------------------------------------- nodes
    def add_node(self, node_id: str, capacity: NodeCapacity, mesh=None):
        self.nodes[node_id] = Node(node_id, capacity, mesh)
        self.monitor.register_node(node_id, capacity)
        self.events.append(f"node+ {node_id}")

    def _on_health_change(self, host_id: str, healthy: bool):
        if healthy:
            self.on_node_rejoin(host_id)
        else:
            self.on_node_failure(host_id)

    # ----------------------------------------------------------- deployment
    def apply(self, spec: ServiceSpec,
              factory: Callable[[Any], BaseExecutor],
              footprint: Optional[int] = None,
              prebuilt: Optional[BaseExecutor] = None) -> List[Deployment]:
        """Register (or update) a service and reconcile to spec.replicas.

        ``prebuilt`` is the probe-built executor from the manager's single
        builder call; the first instance placed on a node with no handle,
        or whose handle names the device the probe was built on, adopts
        it instead of building a second time.
        """
        if footprint is None:
            footprint = spec.footprint_hint
        if footprint is None and prebuilt is not None:
            footprint = prebuilt.footprint_bytes()
        if footprint is None:
            raise PlacementError(
                f"spec {spec.name!r}: no footprint hint and no probe build")
        policy = POLICIES[spec.placement]() if spec.placement else None
        old = self.services.get(spec.name)
        rec = ServiceRecord(spec=spec, factory=factory, footprint=footprint,
                            policy=policy, prebuilt=prebuilt,
                            next_index=old.next_index if old else 0)
        self.services[spec.name] = rec
        self.events.append(f"apply {spec.name} x{spec.replicas}")
        self.scale(spec.name, spec.replicas)
        return self.instances(spec.name)

    def _policy_for(self, rec: ServiceRecord) -> PlacementPolicy:
        return rec.policy or self.policy

    def _victims_on(self, node_id: str, service: str) -> List[Victim]:
        """Preemption candidates on a node (never the applying service's
        own instances — a re-apply must not cannibalize itself)."""
        return [(d.name, d.footprint, d.spec)
                for d in self.deployments.values()
                if d.node_id == node_id and d.service != service]

    def _preemption_node(self, spec: ServiceSpec,
                         footprint: int) -> Optional[str]:
        """When no node fits outright, find the healthy node where free
        space plus preemptable (strictly weaker QoS) mass covers the
        footprint — most reclaimable space first."""
        best, best_room = None, -1
        for node in self.nodes.values():
            if not node.healthy:
                continue
            evictable = sum(b for _n, b, vspec in
                            self._victims_on(node.node_id, spec.name)
                            if can_preempt(spec, vspec))
            if evictable == 0:
                continue
            room = self.monitor.hbm_free(node.node_id) + evictable
            if room >= footprint and room > best_room:
                best, best_room = node.node_id, room
        return best

    def _on_capacity_freed(self, node_id: str):
        self._capacity_freed = True

    def _evict(self, name: str, preemptor: str):
        dep = self.deployments.pop(name, None)
        if dep is not None:
            self.admission.release(dep.node_id, name)
            self.events.append(f"preempt {name} (for {preemptor})")
            if dep.service in self.services:
                self.pending_redeploy.append(dep.service)
                self.events.append(f"requeue {dep.service}")
            # ``_evict`` runs inside ``admit_instance`` (admission lock
            # held, preemptor not yet committed) — firing user hooks here
            # would invert lock order vs callers holding their own locks
            # and let a hook-driven drain redeploy the victim into the
            # hole the preemptor is about to fill, so they are queued and
            # flushed after the admission returns
            self._pending_evictions.append((name, dep.service, dep.node_id))

    def _flush_eviction_hooks(self):
        events, self._pending_evictions = self._pending_evictions, []
        for args in events:
            for hook in list(self.eviction_hooks):
                hook(*args)

    def on_eviction(self, hook: Callable[[str, str, str], None]):
        """Register a callback fired as ``hook(instance, service, node)``
        whenever an instance is preempted for a stronger QoS class.  Hooks
        fire after the preempting admission has settled (committed or
        refused), never mid-preemption."""
        self.eviction_hooks.append(hook)

    def drain_pending_redeploys(self) -> List[str]:
        """Redeploy services whose instances were preempted, once the
        admission controller has observed freed capacity.  Best-effort and
        single-pass: services that still don't fit stay queued for the
        next capacity-freed event.  Called automatically after undeploy /
        scale-down / rejoin; safe to call any time."""
        if self._redeploying or not self._capacity_freed:
            return []
        # consume the flag even when nothing is queued — a stale True
        # left by an unrelated undeploy would otherwise let a later
        # drain run against capacity that was never actually freed
        self._capacity_freed = False
        if not self.pending_redeploy:
            return []
        self._redeploying = True
        healed: List[str] = []
        try:
            # dedupe, keeping order: one reconcile covers every queued
            # eviction of the same service
            work = list(dict.fromkeys(self.pending_redeploy))
            leftovers: List[str] = []
            self.pending_redeploy.clear()
            for service in work:
                rec = self.services.get(service)
                if rec is None:
                    continue
                missing = rec.spec.replicas - len(self.instances(service))
                for _ in range(missing):
                    try:
                        dep = self._deploy_instance(rec)
                    except PlacementError:
                        leftovers.append(service)
                        break
                    healed.append(dep.name)
                    self.events.append(
                        f"redeploy {dep.name} -> {dep.node_id}")
            self.pending_redeploy.extend(leftovers)
        finally:
            self._redeploying = False
        return healed

    def _deploy_instance(self, rec: ServiceRecord,
                         name: Optional[str] = None) -> Deployment:
        spec = rec.spec
        node_id = self._policy_for(rec).pick(list(self.nodes.values()),
                                             self.admission, rec.footprint,
                                             spec)
        if node_id is None:
            if not self.admission.has_quota_headroom(spec.tenant,
                                                     rec.footprint):
                raise PlacementError(
                    f"admission refused {spec.name!r}: tenant-quota: "
                    f"{spec.tenant!r} over hbm_bytes quota")
            # nothing fits outright — a stronger QoS class may preempt
            node_id = self._preemption_node(spec, rec.footprint)
        if node_id is None:
            raise PlacementError(
                f"no healthy node fits {rec.footprint} bytes for "
                f"{spec.name!r}")
        if name is None:
            name = spec.instance_name(rec.next_index)
            rec.next_index += 1
        decision = self.admission.admit_instance(
            node_id, name, rec.footprint, spec,
            victims=self._victims_on(node_id, spec.name),
            evict=lambda victim: self._evict(victim, name))
        self._flush_eviction_hooks()
        if not decision.admitted:
            if decision.evicted:
                # the preemptor evicted victims and then failed to fit:
                # their capacity is genuinely free, and no later
                # undeploy/scale event may ever come — reclaim it for
                # the victims now instead of stranding them queued
                self.drain_pending_redeploys()
            raise PlacementError(
                f"admission refused {name!r} on {node_id}: "
                f"{decision.reason}")
        node = self.nodes[node_id]
        if rec.prebuilt is not None and _adoptable(rec.prebuilt, node.mesh):
            executor, rec.prebuilt = rec.prebuilt, None
        else:
            executor = rec.factory(node.mesh)
        dep = Deployment(name, spec.name, node_id, executor, rec.footprint,
                         spec)
        self.deployments[name] = dep
        self.events.append(f"deploy {name} -> {node_id}")
        return dep

    def undeploy(self, name: str):
        dep = self.deployments.pop(name, None)
        if dep is not None:
            self.admission.release(dep.node_id, name)
            self.events.append(f"undeploy {name}")
            self.drain_pending_redeploys()

    def remove_service(self, service: str):
        # drop the record first: the undeploys below trigger pending-
        # redeploy drains, which must not resurrect the removed service
        self.services.pop(service, None)
        for dep in self.instances(service):
            self.undeploy(dep.name)

    def instances(self, service: str) -> List[Deployment]:
        def index_key(d: Deployment):
            tail = d.name.rsplit("/", 1)[-1]
            return (int(tail), d.name) if tail.isdigit() else \
                (len(self.deployments), d.name)
        return sorted((d for d in self.deployments.values()
                       if d.service == service), key=index_key)

    # ------------------------------------------------------------- failures
    def on_node_failure(self, node_id: str) -> List[str]:
        """Redeploy everything that lived on the dead node (paper P4) from
        each instance's stored service record."""
        node = self.nodes.get(node_id)
        if node is None:
            return []
        node.healthy = False
        self.monitor.unregister_node(node_id)
        self.admission.forget_node(node_id)
        moved = []
        for dep in [d for d in self.deployments.values()
                    if d.node_id == node_id]:
            self.deployments.pop(dep.name)
            rec = self.services.get(dep.service)
            if rec is None:
                self.events.append(f"failover-ORPHAN {dep.name}")
                continue
            try:
                self._deploy_instance(rec, name=dep.name)
                moved.append(dep.name)
                self.events.append(f"failover {dep.name} {node_id}->"
                                   f"{self.deployments[dep.name].node_id}")
            except PlacementError:
                self.events.append(f"failover-FAILED {dep.name}")
        return moved

    def on_node_rejoin(self, node_id: str) -> List[str]:
        """Mark the node healthy and re-reconcile every service.

        A failover that found no capacity pops the instance from
        ``deployments`` (``failover-FAILED``) — returning capacity must
        heal that loss, so rejoin reconciles each service back to its
        stored ``spec.replicas`` instead of just flipping the health bit.
        """
        node = self.nodes.get(node_id)
        if node is None or node.healthy:
            return []
        node.healthy = True
        self.monitor.register_node(node_id, node.capacity)
        self.events.append(f"rejoin {node_id}")
        self.pending_redeploy.clear()   # reconcile() covers every service
        return self.reconcile()

    def reconcile(self) -> List[str]:
        """Deploy instances until every service meets ``spec.replicas``;
        best-effort — services that still don't fit stay degraded."""
        healed = []
        for service, rec in self.services.items():
            missing = rec.spec.replicas - len(self.instances(service))
            for _ in range(missing):
                try:
                    dep = self._deploy_instance(rec)
                except PlacementError:
                    self.events.append(f"reconcile-FAILED {service}")
                    break
                healed.append(dep.name)
                self.events.append(f"reconcile {dep.name} -> {dep.node_id}")
        return healed

    # ------------------------------------------------------------- elastic
    def scale(self, service: str, target: int) -> int:
        """Scale a service up/down from its stored spec (paper: load-driven
        scaling; scale-down 'conserves energy and reduces operational
        costs')."""
        rec = self.services.get(service)
        if rec is None:
            raise PlacementError(f"unknown service {service!r}")
        current = self.instances(service)
        n = len(current)
        # store the new target BEFORE undeploying: each undeploy drains
        # the pending-redeploy queue, and a stale replica count would
        # resurrect the very instances being scaled away
        rec.spec = rec.spec.with_replicas(target)
        if target > n:
            for _ in range(target - n):
                self._deploy_instance(rec)
        elif target < n:
            for dep in current[target:]:
                self.undeploy(dep.name)
        return len(self.instances(service))

    def autoscale(self, service: str, queue_depth: int, per_instance: int,
                  min_n: int = 1, max_n: int = 64) -> int:
        target = max(min_n, min(max_n,
                                -(-queue_depth // max(per_instance, 1))))
        return self.scale(service, target)

    # ----------------------------------------------------------------- misc
    def load_report(self) -> Dict[str, Dict[str, float]]:
        return self.monitor.snapshot()
