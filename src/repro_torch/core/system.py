"""EdgeSystem — the one-object facade over the hybrid runtime (fig 1).

Examples, benchmarks and serving drivers build ONE ``EdgeSystem`` instead
of hand-assembling orchestrator + manager + registry + queue.  The facade
owns the whole stack and exposes the declarative surface:

    system = EdgeSystem(policy=LeastLoadedPolicy())
    system.add_node("worker0")           # the card's memory as capacity
    system.register_builder("stream", WorkloadClass.LIGHT, builder)
    system.apply(ServiceSpec(name="analytics",
                             workload=Workload("fitbit",
                                               WorkloadKind.STREAM),
                             replicas=2))
    result = system.submit(Workload("rec0", WorkloadKind.STREAM), (st, rec))
    print(system.report())
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.admission import AdmissionController, TenantQuota
from repro_torch.core.manager import (BuilderFn, ConfigurationManager,
                                      DispatchResult)
from repro_torch.core.orchestrator import (Deployment, Orchestrator,
                                           PlacementPolicy)
from repro_torch.core.registry import ImageRegistry
from repro_torch.core.resources import (NodeCapacity, ResourceMonitor,
                                        card_memory)
from repro_torch.core.scheduler import SpeculativeRunner, WorkQueue
from repro_torch.core.spec import ServiceSpec
from repro_torch.core.workload import (ClassifierConfig, Workload,
                                       WorkloadClass)
from repro_torch.distributed.fault_tolerance import FailureDetector


class EdgeSystem:
    """Owns ConfigurationManager + Orchestrator + ImageRegistry + WorkQueue
    behind apply/submit/scale/report."""

    def __init__(self, policy: Optional[PlacementPolicy] = None,
                 classifier: ClassifierConfig = ClassifierConfig(),
                 registry: Optional[ImageRegistry] = None,
                 monitor: Optional[ResourceMonitor] = None,
                 detector: Optional[FailureDetector] = None,
                 runner: Optional[SpeculativeRunner] = None,
                 admission: Optional[AdmissionController] = None):
        self.registry = registry or ImageRegistry()
        self.orchestrator = Orchestrator(policy=policy, monitor=monitor,
                                         detector=detector,
                                         admission=admission)
        self.queue = WorkQueue()
        self.manager = ConfigurationManager(
            self.orchestrator, registry=self.registry, classifier=classifier,
            runner=runner, queue=self.queue)

    @property
    def admission(self) -> AdmissionController:
        return self.orchestrator.admission

    # -------------------------------------------------------------- cluster
    def add_node(self, node_id: str,
                 capacity: Optional[NodeCapacity] = None, mesh=None):
        """Register a node.  ``mesh`` is its placement handle (the
        ``torch.device`` its instances are built on, or ``None``).  With
        no ``capacity`` the node gets the memory of the card its handle
        names (the current CUDA device without one); a CPU node must be
        given its capacity."""
        if capacity is None:
            capacity = NodeCapacity(hbm_bytes=card_memory(mesh))
        self.orchestrator.add_node(node_id, capacity, mesh=mesh)
        return self

    # ------------------------------------------------------------- services
    def register_builder(self, kind: str, wclass: WorkloadClass,
                         builder: BuilderFn) -> "EdgeSystem":
        self.manager.register_builder(kind, wclass, builder)
        return self

    def apply(self, spec: ServiceSpec) -> List[Deployment]:
        return self.manager.apply(spec)

    def deploy_fleet(self, spec: ServiceSpec,
                     replicas: Optional[int] = None,
                     warmup: bool = False, **router_kw):
        """Deploy a replicated engine fleet and return its ``FleetRouter``.

        The fleet is placed *as engines* through the ordinary control
        plane: ``apply(spec.with_replicas(N))`` runs the spec's engine
        builder once per replica (each building its own ``ServingEngine``
        + ``PagedKVCache`` pool), the ``AdmissionController`` charges
        every replica's static footprint at placement and sees its
        pages-in-use via ``dynamic_footprint_bytes``, and the
        orchestrator's failover/rejoin redeploys lost replicas from the
        stored spec — the router's ``refresh()`` (run on every submit)
        then notices the replaced engine objects and reroutes in-flight
        GUARANTEED work.  ``autoscale(mode="slo")`` keeps working on the
        same service name, scaling the replica count on the
        fleet-aggregate queue p95.

        ``router_kw`` is forwarded to ``FleetRouter`` (policy, steal
        thresholds, ...).  Every instance must be engine-backed —
        deploying a fleet over non-engine executors is a ``ValueError``.
        """
        from repro_torch.fleet.router import FleetRouter

        if replicas is not None:
            spec = spec.with_replicas(replicas)
        deps = self.apply(spec)
        bad = [d.name for d in deps
               if getattr(d.executor, "engine", None) is None]
        if bad:
            raise ValueError(
                f"deploy_fleet({spec.name!r}): instances {bad} are not "
                f"engine-backed (use an engine builder, e.g. "
                f"serving.router.make_fleet_builder)")
        router = FleetRouter.for_service(self, spec.name, **router_kw)
        if warmup:
            router.warmup()
        return router

    def scale(self, service: str, target: int) -> int:
        return self.manager.scale(service, target)

    def autoscale(self, service: str, per_instance: int = 1,
                  min_n: int = 1, max_n: int = 64,
                  mode: str = "queue") -> int:
        """Scale an applied service from load signals.

        ``mode="queue"`` (default) targets ``ceil(queue_depth /
        per_instance)`` replicas.  ``mode="slo"`` ignores queue depth and
        scales on tail latency instead: the service's observed p95 (its
        ``DispatchStats`` samples, plus ``p95_queue_s`` from any
        engine-backed replica) against ``ServiceSpec.latency_slo_ms``.
        """
        if mode == "slo":
            return self.manager.autoscale_slo(service, min_n=min_n,
                                              max_n=max_n)
        if mode != "queue":
            raise ValueError(f"unknown autoscale mode {mode!r}")
        return self.manager.autoscale(service, self.queue.depth(),
                                      per_instance, min_n=min_n, max_n=max_n)

    def on_node_loss(self, node_id: str) -> List[str]:
        """Inject/observe a node loss: fail the node and redeploy its
        instances from their stored specs (the chaos harness drives this
        mid-replay; a failure detector drives it in production).  Returns
        the instance names that were moved."""
        with self.manager._route_lock:
            return self.orchestrator.on_node_failure(node_id)

    def on_node_rejoin(self, node_id: str) -> List[str]:
        """Heal a lost node: mark it healthy and reconcile every service
        back to ``spec.replicas``.  Returns the healed instance names."""
        with self.manager._route_lock:
            return self.orchestrator.on_node_rejoin(node_id)

    def set_tenant_weight(self, tenant: str, weight: float) -> "EdgeSystem":
        """Weight a tenant's intra-QoS-class share of ``submit_many``
        dispatch order (weighted deficit round-robin; default 1.0)."""
        self.manager.set_tenant_weight(tenant, weight)
        return self

    def on_eviction(self, hook) -> "EdgeSystem":
        """Register ``hook(instance, service, node)`` fired whenever an
        instance is preempted for a stronger QoS class.  Preempted
        BEST_EFFORT instances also queue on the orchestrator's
        pending-redeploy list and are redeployed automatically when the
        admission controller observes freed capacity (undeploy,
        scale-down, node rejoin)."""
        self.orchestrator.on_eviction(hook)
        return self

    @property
    def pending_redeploys(self):
        """Services with preempted instances awaiting freed capacity."""
        return list(self.orchestrator.pending_redeploy)

    def drain_pending_redeploys(self):
        """Manually attempt redeploy of preempted instances (normally
        automatic on capacity-freeing events)."""
        with self.manager._route_lock:
            return self.orchestrator.drain_pending_redeploys()

    def set_tenant_quota(self, tenant: str,
                         hbm_bytes: Optional[int] = None,
                         flops_inflight: Optional[float] = None
                         ) -> "EdgeSystem":
        """Cap a tenant's committed instance HBM and in-flight dispatch
        FLOPs (``None`` = unlimited; see ``core.admission``)."""
        self.admission.set_quota(
            tenant, TenantQuota(hbm_bytes=hbm_bytes,
                                flops_inflight=flops_inflight))
        return self

    # ---------------------------------------------------------- persistence
    def save_state(self, path: str) -> Dict[str, Any]:
        """Serialize applied specs + tenant quotas to ``path`` (JSON).

        This is the durable half of the paper's configuration-manager
        restart story: everything declarative survives; builders are code
        and re-register on boot.
        """
        with self.manager._route_lock:
            specs = [spec.to_dict() for spec in self.manager.specs.values()]
        quotas = {t: {"hbm_bytes": q.hbm_bytes,
                      "flops_inflight": q.flops_inflight}
                  for t, q in self.admission.quota_snapshot().items()}
        state = {"version": 1, "specs": specs, "quotas": quotas}
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(state, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
        return state

    def restore(self, path: str) -> List[str]:
        """Re-apply every persisted spec (and quota) on a fresh system.

        Call after nodes are added and builders registered — the restored
        manager re-applies each spec, which reconciles every service back
        to ``spec.replicas``.  GUARANTEED specs are applied first so a
        shrunken cluster degrades the weakest QoS class, not the paper's
        critical path.  Returns the applied service names.
        """
        with open(path) as f:
            state = json.load(f)
        for tenant, q in state.get("quotas", {}).items():
            self.admission.set_quota(tenant, TenantQuota(
                hbm_bytes=q.get("hbm_bytes"),
                flops_inflight=q.get("flops_inflight")))
        specs = [ServiceSpec.from_dict(d) for d in state.get("specs", [])]
        applied = []
        for spec in sorted(specs, key=lambda s: s.admission_rank()):
            self.apply(spec)
            applied.append(spec.name)
        return applied

    def instances(self, service: str) -> List[Deployment]:
        return self.orchestrator.instances(service)

    # ------------------------------------------------------------- dispatch
    def submit(self, workload: Workload, args: Tuple = ()) -> DispatchResult:
        return self.manager.submit(workload, args)

    def submit_many(self, items: Sequence[Tuple[Workload, Tuple]],
                    speculative: bool = True, concurrent: bool = True,
                    return_exceptions: bool = False) -> List[Any]:
        return self.manager.submit_many(items, speculative=speculative,
                                        concurrent=concurrent,
                                        return_exceptions=return_exceptions)

    # ------------------------------------------------------------ telemetry
    @property
    def stats(self):
        return self.manager.stats

    @property
    def events(self) -> List[str]:
        return self.orchestrator.events

    def report(self) -> Dict[str, Any]:
        return self.manager.report()

    def stats_json(self, window: Optional[int] = None,
                   indent: Optional[int] = None) -> str:
        """Machine-readable dispatch telemetry (``DispatchStats.to_json``)
        — what trace scorecards and ``BENCH_*.json`` writers consume."""
        return self.stats.to_json(window=window, indent=indent)
