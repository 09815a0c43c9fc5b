"""The configuration manager — the paper's central component (fig 2).

Ties P1–P4 together around the declarative ``ServiceSpec``: ``apply`` a
spec (classify its workload template, build the executor ONCE through the
registered builder, deploy ``replicas`` instances through the
orchestrator); ``submit`` a workload (route to the least-inflight
compatible replica, auto-applying a single-replica spec on first sight);
``submit_many`` dispatches a batch concurrently (every item in flight
before any result is collected, so engine-backed replicas batch requests
in their background loop) with speculative backup dispatch on straggling
replicas.  All telemetry flows into a structured ``DispatchStats`` that
benchmarks and serving consume.

Every resource decision — instance placement and per-request FLOP
admission — routes through the orchestrator's ``AdmissionController``:
dispatches are charged to the serving spec's tenant, ``submit_many``
starts items in QoS order (GUARANTEED before BEST_EFFORT), and
``autoscale_slo`` scales on observed p95 vs the spec's latency SLO.

Builders: the model/serving layers register how to construct executors for
a (kind, class) pair; the manager stays application-agnostic.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.admission import AdmissionError
from repro_torch.core.executor import BaseExecutor, ExecutorClass
from repro_torch.core.orchestrator import (Deployment, Orchestrator,
                                           PlacementError)
from repro_torch.core.registry import ImageRegistry
from repro_torch.core.scheduler import (SpeculativeRunner, WorkQueue,
                                        clone_args)
from repro_torch.core.spec import (EXECUTOR_FOR_CLASS, QOS_RANK, QoSClass,
                                   ServiceSpec, auto_spec)
from repro_torch.core.telemetry import (DispatchSample, DispatchStats,
                                        percentile)
from repro_torch.core.workload import (ClassifierConfig, Workload,
                                       WorkloadClass, classify)

BuilderFn = Callable[[Workload, Any], Tuple[BaseExecutor, int]]
# (workload, placement handle) -> (executor, footprint_bytes); the handle
# is a node's torch.device, or None for the builder's own device


@dataclasses.dataclass
class DispatchResult:
    output: Any
    workload_class: WorkloadClass
    executor_name: str
    node_id: str
    wall_s: float
    deployed_fresh: bool
    service: str = ""
    winner: str = "primary"        # "backup" when a speculative copy won


class ConfigurationManager:
    def __init__(self, orchestrator: Orchestrator,
                 registry: Optional[ImageRegistry] = None,
                 classifier: ClassifierConfig = ClassifierConfig(),
                 runner: Optional[SpeculativeRunner] = None,
                 queue: Optional[WorkQueue] = None):
        self.orchestrator = orchestrator
        self.admission = orchestrator.admission   # the ONE resource gate
        self.registry = registry or ImageRegistry()
        self.classifier = classifier
        self.runner = runner or SpeculativeRunner()
        self.queue = queue or WorkQueue()
        self.builders: Dict[Tuple[str, WorkloadClass], BuilderFn] = {}
        self.specs: Dict[str, ServiceSpec] = {}
        self.stats = DispatchStats()
        # weighted fair dispatch: tenant → WFQ weight (default 1.0)
        self.tenant_weights: Dict[str, float] = {}
        # routing and deployment mutate shared orchestrator state
        # (auto-apply, candidate ordering over the deployments dict);
        # concurrent dispatchers serialize through this, not the dispatch.
        # RLock: apply() is reached both directly and from _route_or_apply
        self._route_lock = threading.RLock()
        self._drain_lock = threading.Lock()

    def register_builder(self, kind: str, wclass: WorkloadClass,
                         builder: BuilderFn):
        self.builders[(kind, wclass)] = builder

    # ------------------------------------------------------------------
    def route(self, workload: Workload) -> WorkloadClass:
        return classify(workload, self.classifier)

    def _builder_for(self, spec: ServiceSpec) -> BuilderFn:
        wclass = spec.resolve_workload_class(self.classifier)
        builder = self.builders.get((spec.workload.kind.value, wclass))
        if builder is None:
            raise PlacementError(
                f"no builder for kind={spec.workload.kind.value} "
                f"class={wclass.value}")
        return builder

    def apply(self, spec: ServiceSpec) -> List[Deployment]:
        """Bring a declared service to its desired state.

        The builder runs exactly once here — the probe build both sizes the
        footprint and becomes the first instance's executor (no double
        compile on the cold path); redeploys go back through the factory,
        where the image registry caches the captured images.
        """
        with self._route_lock:
            builder = self._builder_for(spec)

            def factory(mesh, _b=builder, _w=spec.workload):
                ex, _ = _b(_w, mesh)
                return ex

            prebuilt = None
            footprint = spec.footprint_hint
            if footprint is None:
                prebuilt, footprint = builder(spec.workload, None)
            deps = self.orchestrator.apply(spec, factory,
                                           footprint=footprint,
                                           prebuilt=prebuilt)
            self.specs[spec.name] = spec
            return deps

    def scale(self, service: str, target: int) -> int:
        with self._route_lock:        # deployments mutate under routing lock
            n = self.orchestrator.scale(service, target)
            if service in self.specs:
                self.specs[service] = self.specs[service].with_replicas(n)
            return n

    def autoscale(self, service: str, queue_depth: int, per_instance: int,
                  min_n: int = 1, max_n: int = 64) -> int:
        with self._route_lock:
            n = self.orchestrator.autoscale(service, queue_depth,
                                            per_instance,
                                            min_n=min_n, max_n=max_n)
            if service in self.specs:
                self.specs[service] = self.specs[service].with_replicas(n)
            return n

    def autoscale_slo(self, service: str, min_n: int = 1,
                      max_n: int = 64, window: int = 64) -> int:
        """Tail-latency-driven scaling: observed p95 vs the spec's SLO.

        The observation is the worse of (a) the p95 dispatch wall over the
        service's most recent ``window`` samples — a window, not all-time,
        so a transient slowdown (cold compiles, failover) stops driving
        scale-ups once latency recovers — and (b) the **fleet-aggregate**
        queue p95: recent admission queue waits pooled across every
        engine-backed replica (``ServingEngine.queue_samples()``), so N
        idle replicas beside one hot one read as fleet-level pressure in
        proportion to traffic share rather than the hot replica's p95
        alone (engines without the sampler fall back to their own
        ``p95_queue_s``).  Over SLO → scale up proportionally
        (observed/SLO); under half the SLO → shed one replica (the paper:
        scale-down conserves energy).  Scale-ups past available capacity
        stop where placement stops — best-effort, like failover.
        """
        with self._route_lock:
            spec = self.specs.get(service)
            if spec is None:
                raise PlacementError(f"unknown service {service!r}")
            instances = self.orchestrator.instances(service)
            n = len(instances)
            slo_s = spec.latency_slo_ms / 1e3
            if slo_s <= 0:
                return n
            walls = [s.wall_s
                     for s in self.stats.samples_for(service=service)]
            walls = walls[-window:]
            observed = percentile(walls, 95) if walls else 0.0
            queue_waits: List[float] = []
            for dep in instances:
                engine = getattr(dep.executor, "engine", None)
                if engine is None:
                    continue
                sampler = getattr(engine, "queue_samples", None)
                if sampler is not None:
                    queue_waits.extend(sampler())
                else:
                    observed = max(observed,
                                   engine.stats().get("p95_queue_s", 0.0))
            if queue_waits:
                observed = max(observed, percentile(queue_waits, 95))
            if not observed > 0:                  # no data yet (or NaN)
                return n
            if observed > slo_s:
                target = min(max_n,
                             max(n + 1, math.ceil(n * observed / slo_s)))
            elif observed < slo_s / 2 and n > min_n:
                target = n - 1
            else:
                return n
            try:
                return self.scale(service, target)
            except PlacementError:
                # capacity ran out mid scale-up: keep what deployed and
                # re-sync the stored replica counts to reality
                n_now = len(self.orchestrator.instances(service))
                rec = self.orchestrator.services.get(service)
                if rec is not None:
                    rec.spec = rec.spec.with_replicas(n_now)
                self.specs[service] = spec.with_replicas(n_now)
                return n_now

    # ------------------------------------------------------------------
    def _candidates(self, eclass: ExecutorClass, workload: Workload,
                    args: Tuple) -> List[Deployment]:
        """Compatible instances, least-inflight first (ties: least-used)."""
        deps = [d for d in self.orchestrator.deployments.values()
                if d.executor.executor_class is eclass
                and d.executor.can_run(workload, args)]
        return sorted(deps, key=lambda d: (d.executor.inflight,
                                           len(d.executor.history), d.name))

    def _route_or_apply(self, workload: Workload, args: Tuple
                        ) -> Tuple[List[Deployment], WorkloadClass, bool]:
        wclass = self.route(workload)
        eclass = EXECUTOR_FOR_CLASS[wclass]
        deps = self._candidates(eclass, workload, args)
        fresh = False
        if not deps:
            spec = auto_spec(workload, self.classifier)
            try:
                self._builder_for(spec)
            except PlacementError:
                # no builder for the preferred substrate — a spec may have
                # overridden the class (e.g. serving engines are container-
                # class even for light decode); use those instances instead.
                # Capacity errors from apply() below still propagate.
                other = (ExecutorClass.UNIKERNEL
                         if eclass is ExecutorClass.CONTAINER
                         else ExecutorClass.CONTAINER)
                deps = self._candidates(other, workload, args)
                if not deps:
                    raise
            else:
                self.apply(spec)
                deps = self._candidates(eclass, workload, args)
                fresh = True
            if not deps:
                raise PlacementError(
                    f"no instance can run {workload.name!r} "
                    f"(class={wclass.value})")
        return deps, wclass, fresh

    def _record(self, workload: Workload, wclass: WorkloadClass,
                dep: Deployment, wall: float, fresh: bool,
                winner: str = "primary", backup_launched: bool = False):
        self.stats.record(DispatchSample(
            workload=workload.name, workload_class=wclass.value,
            executor_class=dep.executor.executor_class.value,
            executor=dep.executor.name, node=dep.node_id, wall_s=wall,
            cold=fresh,
            # live commitment, not the static reservation — paged serving
            # engines report KV pages-in-use here
            footprint_bytes=dep.executor.dynamic_footprint_bytes(),
            winner=winner, backup_launched=backup_launched,
            service=dep.service, tenant=dep.spec.tenant,
            replica=dep.name))
        # executors with their own annotation stream (e.g. a serving
        # engine's speculation acceptance counters) surface it here so
        # fig7/scorecards read one DispatchStats, not per-executor ones
        extras = getattr(dep.executor, "stats_extras", None)
        if callable(extras):
            for key, value in extras().items():
                self.stats.set_extra(key, value)

    def submit(self, workload: Workload, args: Tuple = ()) -> DispatchResult:
        t0 = time.monotonic()
        with self._route_lock:
            deps, wclass, fresh = self._route_or_apply(workload, args)
        dep = deps[0]
        flops = workload.flops()
        decision = self.admission.admit_dispatch(dep.spec, flops)
        if not decision.admitted:
            raise AdmissionError(decision.reason)
        try:
            out = dep.executor.dispatch(workload, args)
        finally:
            self.admission.release_dispatch(dep.spec, flops)
        wall = time.monotonic() - t0
        self._record(workload, wclass, dep, wall, fresh)
        return DispatchResult(out, wclass, dep.executor.name, dep.node_id,
                              wall, fresh, service=dep.service)

    @staticmethod
    def _speculation_donates(*deps: Deployment) -> bool:
        return any(d.spec.donates_inputs or d.executor.donates_inputs
                   for d in deps if d is not None)

    def _dispatch_one(self, workload: Workload, args: Tuple,
                      speculative: bool) -> DispatchResult:
        t0 = time.monotonic()
        with self._route_lock:
            deps, wclass, fresh = self._route_or_apply(workload, args)
        primary, backup = deps[0], deps[1] if len(deps) > 1 else None
        flops = workload.flops()
        decision = self.admission.admit_dispatch(primary.spec, flops)
        if not decision.admitted:
            raise AdmissionError(decision.reason)
        # bind workload/args as defaults: a losing speculative thread
        # can outlive this call and must not see later items
        backup_fn = None
        if speculative and backup is not None:
            # donated-input executors consume caller buffers: the backup
            # copy must run on a CLONE taken before the primary launches,
            # never on the same args (unclonable args → no speculation)
            backup_args = args
            if self._speculation_donates(primary, backup):
                try:
                    backup_args = clone_args(args)
                except Exception:  # noqa: BLE001
                    backup_args = None
            if backup_args is not None:
                backup_fn = (lambda _d=backup, _w=workload, _a=backup_args:
                             _d.executor.dispatch(_w, _a))
        try:
            task = self.runner.run(
                lambda _d=primary, _w=workload, _a=args:
                _d.executor.dispatch(_w, _a),
                backup=backup_fn)
        finally:
            self.admission.release_dispatch(primary.spec, flops)
        dep = backup if task.winner == "backup" else primary
        wall = time.monotonic() - t0
        self._record(workload, wclass, dep, wall, fresh,
                     winner=task.winner,
                     backup_launched=task.backup_launched)
        return DispatchResult(
            task.value, wclass, dep.executor.name, dep.node_id, wall,
            fresh, service=dep.service, winner=task.winner)

    def _qos_key(self, workload: Workload, args: Tuple
                 ) -> Tuple[Tuple[int, int], str]:
        """Admission-ordering key for a queued item: the QoS rank of the
        spec that will serve it (stronger class first, then higher
        priority) plus the serving tenant for weighted fair interleaving;
        unroutable items sort as default BURSTABLE, unattributed."""
        eclass = EXECUTOR_FOR_CLASS[self.route(workload)]
        with self._route_lock:
            deps = self._candidates(eclass, workload, args)
            if not deps:
                other = (ExecutorClass.UNIKERNEL
                         if eclass is ExecutorClass.CONTAINER
                         else ExecutorClass.CONTAINER)
                deps = self._candidates(other, workload, args)
        if not deps:
            return (QOS_RANK[QoSClass.BURSTABLE], 0), ""
        return deps[0].spec.admission_rank(), deps[0].spec.tenant

    def set_tenant_weight(self, tenant: str, weight: float):
        """Weight a tenant's share of intra-class dispatch order in
        ``submit_many`` (default 1.0; higher = more starts per round)."""
        if not weight > 0:
            raise ValueError(f"tenant weight must be > 0, got {weight}")
        self.tenant_weights[tenant] = float(weight)

    def _wfq_order(self, work: Sequence[Tuple[Workload, Tuple]]
                   ) -> List[int]:
        """Dispatch-start order: QoS classes strictly rank-ordered as
        before, but *inside* one (class, priority) level tenants
        interleave by weighted deficit round-robin instead of arrival
        order — one tenant's burst can no longer put all of its items
        ahead of a same-class peer's, bounding intra-class latency skew.
        FIFO is preserved per tenant, and a level with a single tenant
        degenerates to the old FIFO exactly."""
        levels: Dict[Tuple[int, int], Dict[str, List[int]]] = {}
        for i, (w, a) in enumerate(work):
            rank, tenant = self._qos_key(w, a)
            levels.setdefault(rank, {}).setdefault(tenant, []).append(i)
        order: List[int] = []
        for rank in sorted(levels):
            queues = levels[rank]
            if len(queues) == 1:
                order.extend(next(iter(queues.values())))
                continue
            # deficit round-robin, quantum = tenant weight, cost 1/request
            credit = {t: 0.0 for t in queues}
            heads = {t: 0 for t in queues}
            live = list(queues)          # first-arrival tenant order
            while live:
                for t in list(live):
                    q = queues[t]
                    credit[t] += self.tenant_weights.get(t, 1.0)
                    while heads[t] < len(q) and credit[t] >= 1.0:
                        order.append(q[heads[t]])
                        heads[t] += 1
                        credit[t] -= 1.0
                    if heads[t] >= len(q):
                        live.remove(t)
        return order

    def submit_many(self, items: Sequence[Tuple[Workload, Tuple]],
                    speculative: bool = True, concurrent: bool = True,
                    max_workers: int = 16,
                    return_exceptions: bool = False) -> List[Any]:
        """Batched dispatch through the work queue.

        With ``concurrent=True`` (default) every item is dispatched before
        any result is collected: each dispatch runs in a worker thread, so
        container-class requests landing on a shared ``ServingEngine``
        batch in its engine loop while unikernel-class work proceeds in
        parallel — overlapped, not one-request-at-a-time.
        ``concurrent=False`` restores the strictly serial drain.

        Speculation rides along in either mode: when a replica straggles
        past the runner's latency budget, a backup copy races on the
        next-least-inflight instance and the first completion wins.

        Dispatch is QoS-ordered, not FIFO: items are started in
        ``(QoS class, -priority)`` order of the spec that will serve them,
        so a flood of BEST_EFFORT arrivals cannot starve a GUARANTEED
        tenant's items in the same batch.  Within one (class, priority)
        level, tenants interleave by weighted deficit round-robin
        (``set_tenant_weight``; default weight 1.0, FIFO per tenant) so a
        same-class burst from one tenant cannot push a peer's whole batch
        to the back.  Results still come back in the caller's item order.

        Speculative copies are donation-safe: when either racing executor
        donates its input buffers (unikernel images) or the spec is marked
        ``donates_inputs``, the backup runs on a clone of the args taken
        before the primary launches.

        Quota refusals are a steady-state event for quota-bound tenants:
        with ``return_exceptions=True`` a refused (or failed) item yields
        its exception at that position instead of aborting the batch — the
        other tenants' results survive.  With the default ``False``, every
        dispatched item still runs to completion before the first error is
        re-raised (no work is silently cancelled mid-flight).
        """
        # put+get atomically: two concurrent batches must not interleave
        # each other's queue round-trip, and the queue is drained of
        # exactly len(items) entries even when validation fails below
        with self._drain_lock:
            for item in items:
                self.queue.put(item)
            work = [self.queue.get() for _ in range(len(items))]
        for item in work:
            if not (isinstance(item, tuple) and len(item) == 2
                    and isinstance(item[0], Workload)):
                raise TypeError(
                    f"work queue item {item!r} is not a (Workload, args) "
                    f"pair — the system queue carries dispatchable work")
        # QoS-ranked start order; weighted deficit round-robin across
        # tenants inside one (class, priority) level (FIFO per tenant)
        order = self._wfq_order(work)
        results: List[Any] = [None] * len(work)
        first_error: Optional[Exception] = None
        if concurrent and len(work) > 1:
            with ThreadPoolExecutor(
                    max_workers=min(len(work), max_workers),
                    thread_name_prefix="submit-many") as pool:
                futures = [(i, pool.submit(self._dispatch_one, work[i][0],
                                           work[i][1], speculative))
                           for i in order]
                for i, fut in futures:
                    try:
                        results[i] = fut.result()
                    except Exception as e:  # noqa: BLE001
                        results[i] = e
                        first_error = first_error or e
        else:
            for i in order:
                try:
                    results[i] = self._dispatch_one(work[i][0], work[i][1],
                                                    speculative)
                except Exception as e:  # noqa: BLE001
                    results[i] = e
                    first_error = first_error or e
        if first_error is not None and not return_exceptions:
            raise first_error
        return results

    # ------------------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        with self._route_lock:
            services = {name: spec.replicas
                        for name, spec in self.specs.items()}
        return {
            **self.stats.summary(),
            "services": services,
            "queue": {"enqueued": self.queue.enqueued,
                      "dequeued": self.queue.dequeued,
                      "depth": self.queue.depth()},
            "registry": self.registry.stats(),
            "nodes": self.orchestrator.load_report(),
            "tenants": {"usage": self.admission.tenant_usage(),
                        "latency": self.stats.per_tenant()},
        }
