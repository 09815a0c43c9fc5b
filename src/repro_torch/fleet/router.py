"""FleetRouter: replicated serving data plane with KV-aware routing; the
port of ``repro.fleet.router``.

Fronts N replica ``ServingEngine``s (each with its own ``PagedKVCache``
pool) and routes per request:

1. **session stickiness** — multi-turn traffic pins to the replica that
   served the session's earlier turns (its KV pages are warm there);
2. **prefix affinity** — a chained token-block fingerprint index
   (``affinity.PrefixAffinityIndex``) maps prompt prefixes to the
   replica that already served them;
3. **least-pages / least-inflight** — on a miss, the replica with the
   smallest ``(queued + active, marginal pages, kv bytes in use, router
   inflight)`` tuple wins: *marginal* pages are what the replica's
   prefix-sharing radix says it would actually allocate for this prompt
   (``engine.estimate_marginal_pages``), so equal queue depth tie-breaks
   to the replica already holding the prompt's prefix pages — and then
   to the emptier page pool.

Requests queued on an overloaded replica (queue depth above the fleet
median by a threshold) are **stolen** onto underloaded responsive
replicas by ``rebalance()``; a replica lost to failover has its
in-flight GUARANTEED work rerouted by ``mark_replica_lost`` /
``refresh()``.

Concurrency contract (the lock-order story the static analyzer gates):

- The router lock may be held while *probing* an engine (timed,
  lock-free, or bounded-timeout calls: ``load``, ``queue_depth``,
  ``responsive``, ``cancel_queued``) — this is the router→engine lock
  edge in the analysis lock graph.
- Engine completion callbacks run in the completing engine's loop
  thread, potentially under the engine lock, and therefore **never**
  take the router lock: success resolves the outer future directly
  (guarded by a per-binding token + ``InvalidStateError``), bookkeeping
  and failures land on lock-free deques drained by the next locked
  entry point (``poke``/``submit``/``rebalance``/``stats``).
- ``engine.submit`` can block for seconds on a stalled engine, so
  actual submissions happen *outside* the router lock: locked sections
  only decide placement and emit ``(request, replica, token)`` launch
  tuples that the caller performs after release.  A binding that was
  stolen or rerouted while its launch was in flight is detected by the
  token bump and the orphaned engine request is cancelled best-effort.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as FutureTimeout
from typing import (TYPE_CHECKING, Dict, List, Optional, Sequence, Set,
                    Tuple)

import numpy as np

from repro_torch.core.telemetry import (DispatchSample, DispatchStats,
                                        percentile)
from repro_torch.fleet.affinity import DEFAULT_BLOCK, PrefixAffinityIndex

if TYPE_CHECKING:                                    # annotation-only dep
    from repro_torch.serving.engine import ServingEngine

POLICIES = ("affinity", "round-robin")

# (request, replica, token) emitted under the lock, launched outside it
_Launch = Tuple["FleetRequest", "ReplicaRef", int]


class ReplicaRef:
    """Router-side view of one replica engine."""

    def __init__(self, key: str, engine: "ServingEngine"):
        self.key = key
        self.engine = engine
        self.alive = True
        self.submitted = 0          # bindings launched at this replica
        self.completed = 0
        self.affinity_hits = 0      # chosen via session/prefix affinity
        self.stolen_in = 0
        self.stolen_out = 0


class FleetRequest:
    """One fleet-level request; may be bound to several engines over its
    life (steal, failure reroute, replica loss).  ``token`` increments
    on every rebind so completions from stale bindings are ignored."""

    __slots__ = ("fid", "prompt", "max_new_tokens", "eos_token",
                 "latency_slo_ms", "session", "guaranteed", "qos", "outer",
                 "replica", "inner", "token", "moves", "submitted_at")

    def __init__(self, fid: int, prompt, max_new_tokens: int,
                 eos_token: Optional[int], latency_slo_ms: float,
                 session: str, guaranteed: bool, qos: str = ""):
        self.fid = fid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.eos_token = eos_token
        self.latency_slo_ms = latency_slo_ms
        self.session = session
        self.guaranteed = guaranteed
        # engine-level page-preemption rank; defaults from `guaranteed`
        self.qos = qos or ("guaranteed" if guaranteed else "burstable")
        self.outer: Future = Future()
        self.replica = ""           # current binding's replica key
        self.inner = None           # current engine RequestHandle
        self.token = 0              # bumped on every (re)bind
        self.moves = 0              # reroutes/steals consumed
        self.submitted_at = time.monotonic()


class FleetHandle:
    """Caller-facing handle; resolves when any binding completes."""

    _poll_s = 0.05

    def __init__(self, router: "FleetRouter", rec: FleetRequest):
        self._router = router
        self._rec = rec

    @property
    def fid(self) -> int:
        return self._rec.fid

    def done(self) -> bool:
        return self._rec.outer.done()

    def result(self, timeout: Optional[float] = None):
        """Completed engine ``Request`` (raises the failure if every
        binding failed).  Polls so deferred failure handling (reroutes)
        makes progress even when no new traffic arrives."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                return self._rec.outer.result(timeout=self._poll_s)
            except FutureTimeout:
                self._router.poke()
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"fleet request {self._rec.fid} timed out") from None


class FleetRouter:
    """Routes requests across replica ``ServingEngine``s.

    ``policy="affinity"`` is the full session/prefix/least-pages path;
    ``policy="round-robin"`` is the naive baseline the benchmarks
    compare against (blind rotation, no affinity, no stall probe).
    """

    def __init__(self, replicas=None, *, policy: str = "affinity",
                 block_tokens: int = DEFAULT_BLOCK,
                 index_capacity: int = 4096, max_sessions: int = 2048,
                 steal_factor: float = 1.5, steal_min: int = 2,
                 steal_queue_p95_s: float = 0.0,
                 probe_timeout_s: float = 0.05, max_moves: int = 3,
                 auto_rebalance_s: Optional[float] = None,
                 system=None, service: str = ""):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; one of {POLICIES}")
        self.policy = policy
        self.steal_factor = steal_factor
        self.steal_min = steal_min
        self.steal_queue_p95_s = steal_queue_p95_s
        self.probe_timeout_s = probe_timeout_s
        self.max_moves = max_moves
        self.auto_rebalance_s = auto_rebalance_s
        self.service = service
        self.stats_sink = DispatchStats()

        self._system = system
        self._lock = threading.RLock()
        self._replicas: Dict[str, ReplicaRef] = {}
        self._affinity = PrefixAffinityIndex(block=block_tokens,
                                             capacity=index_capacity)
        self._sessions: Dict[str, str] = {}      # session → replica key
        self._max_sessions = max_sessions
        self._requests: Dict[int, FleetRequest] = {}
        self._by_replica: Dict[str, Set[int]] = {}
        self._fids = itertools.count()
        self._rr = 0
        # lock-free mailboxes fed by engine-thread callbacks
        self._done_events: deque = deque()       # (fid, key, wall_s)
        self._failures: deque = deque()          # (rec, token, exc)
        self._last_rebalance = time.monotonic()
        self.counters: Dict[str, int] = {
            "submitted": 0, "completed": 0, "failed": 0,
            "prefix_hits": 0, "session_hits": 0, "misses": 0,
            "steals": 0, "reroutes": 0, "stall_evasions": 0,
        }
        for i, engine in enumerate(replicas or []):
            key = getattr(engine, "replica_id", "") or f"replica/{i}"
            self._register_locked(key, engine)

    # ------------------------------------------------------------------
    # construction / membership
    # ------------------------------------------------------------------

    @classmethod
    def for_service(cls, system, service: str, **kw) -> "FleetRouter":
        """Router over the engine-backed instances of a deployed service;
        ``refresh()`` (run on every submit) tracks failover/scale."""
        router = cls(system=system, service=service, **kw)
        router.refresh()
        if not router._replicas:
            raise ValueError(
                f"service {service!r} has no engine-backed instances")
        return router

    def _register_locked(self, key: str, engine) -> None:
        engine.replica_id = key
        start = getattr(engine, "start", None)
        if start is not None:
            start()
        self._replicas[key] = ReplicaRef(key, engine)
        self._by_replica.setdefault(key, set())

    def refresh(self) -> None:
        with self._lock:
            launches = self._refresh_locked()
        self._do_launches(launches)

    def _refresh_locked(self) -> List[_Launch]:
        """Reconcile membership against the control plane: a replica
        whose deployment vanished or whose engine object was replaced
        (failover redeploys build a *new* engine) is marked lost and its
        GUARANTEED work rerouted; new instances are registered."""
        if self._system is None:
            return []
        deps = {d.name: d for d in self._system.instances(self.service)}
        launches: List[_Launch] = []
        for key in list(self._replicas):
            dep = deps.get(key)
            engine = getattr(dep.executor, "engine", None) if dep else None
            if engine is not self._replicas[key].engine:
                launches += self._mark_lost_locked(key)
        for name in sorted(deps):
            engine = getattr(deps[name].executor, "engine", None)
            if engine is not None and name not in self._replicas:
                self._register_locked(name, engine)
        return launches

    def mark_replica_lost(self, key: str) -> int:
        """Drop a replica: invalidate its affinity/session pins and
        reroute its outstanding GUARANTEED requests.  Returns how many
        requests were rerouted."""
        with self._lock:
            launches = self._mark_lost_locked(key)
        self._do_launches(launches)
        return len(launches)

    def _mark_lost_locked(self, key: str) -> List[_Launch]:
        ref = self._replicas.pop(key, None)
        if ref is None:
            return []
        ref.alive = False
        self._affinity.drop_replica(key)
        for sess in [s for s, k in self._sessions.items() if k == key]:
            del self._sessions[sess]
        launches: List[_Launch] = []
        live = self._live()
        for fid in sorted(self._by_replica.pop(key, ())):
            rec = self._requests.get(fid)
            if rec is None or rec.outer.done() or rec.replica != key:
                continue
            if rec.guaranteed and live and rec.moves < self.max_moves:
                rec.moves += 1
                self.counters["reroutes"] += 1
                launches.append(self._bind_locked(rec, min(
                    live, key=self._score)))
            else:
                # non-GUARANTEED: the orphaned engine may still finish it
                # (node loss is a control-plane event; the old loop thread
                # lives on), so leave the binding to complete or fail
                self._by_replica.setdefault(key, set()).add(fid)
        return launches

    # ------------------------------------------------------------------
    # submission path
    # ------------------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 16,
               eos_token: Optional[int] = None,
               latency_slo_ms: float = 0.0, session: str = "",
               guaranteed: bool = False, qos: str = "") -> FleetHandle:
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        rec = FleetRequest(next(self._fids), prompt, max_new_tokens,
                           eos_token, latency_slo_ms, session, guaranteed,
                           qos)
        with self._lock:
            launches = self._drain_mail_locked()
            launches += self._refresh_locked()
            ref, how = self._choose_locked(prompt, session)
            if self.policy == "affinity" and \
                    not self._responsive(ref) and len(self._live()) > 1:
                others = [r for r in self._live()
                          if r is not ref and self._responsive(r)]
                if others:
                    ref = min(others, key=self._score)
                    how = "evade"
            self._note_choice_locked(rec, ref, how)
            launches.append(self._bind_locked(rec, ref))
            launches += self._maybe_rebalance_locked()
        ref.engine.note_prefix(how in ("session", "affinity"))
        self._do_launches(launches)
        return FleetHandle(self, rec)

    def _choose_locked(self, prompt, session: str) -> Tuple[ReplicaRef, str]:
        live = self._live()
        if not live:
            raise RuntimeError("fleet has no live replicas")
        if self.policy == "round-robin":
            ref = live[self._rr % len(live)]
            self._rr += 1
            return ref, "rr"
        if session:
            key = self._sessions.get(session)
            if key is not None and key in self._replicas:
                return self._replicas[key], "session"
        key, _blocks = self._affinity.lookup(prompt)
        if key is not None and key in self._replicas:
            return self._replicas[key], "affinity"
        return min(live,
                   key=lambda r: self._score(r, prompt)), "least"

    def _note_choice_locked(self, rec: FleetRequest, ref: ReplicaRef,
                            how: str) -> None:
        self.counters["submitted"] += 1
        if how == "session":
            self.counters["session_hits"] += 1
            ref.affinity_hits += 1
        elif how == "affinity":
            self.counters["prefix_hits"] += 1
            ref.affinity_hits += 1
        else:
            self.counters["misses"] += 1
            if how == "evade":
                self.counters["stall_evasions"] += 1
        if rec.session:
            self._sessions[rec.session] = ref.key
            while len(self._sessions) > self._max_sessions:
                self._sessions.pop(next(iter(self._sessions)))
        if self.policy == "affinity":
            self._affinity.record(rec.prompt, ref.key)
        self._requests[rec.fid] = rec

    def _live(self) -> List[ReplicaRef]:
        return [r for r in self._replicas.values() if r.alive]

    def _score(self, ref: ReplicaRef, prompt=None) -> Tuple:
        """Load tuple, least wins.  With a prompt, the second component
        charges *marginal* (post-sharing) pages: a replica whose prefix
        radix already holds the prompt's prefix would allocate only the
        suffix, so an affinity-warm replica beats an equally-loaded cold
        one — the affinity hit buys physical page reuse, not just
        locality."""
        queued, active, kv_bytes = ref.engine.load()
        marginal = 0
        if prompt is not None:
            est = getattr(ref.engine, "estimate_marginal_pages", None)
            if est is not None:
                marginal = est(prompt)
        return (queued + active, marginal, kv_bytes,
                ref.submitted - ref.completed, ref.key)

    def _responsive(self, ref: ReplicaRef) -> bool:
        if not hasattr(ref.engine, "responsive"):
            return True
        return ref.engine.responsive(self.probe_timeout_s)

    # -- binding -------------------------------------------------------

    def _bind_locked(self, rec: FleetRequest, ref: ReplicaRef) -> _Launch:
        rec.token += 1
        rec.inner = None
        rec.replica = ref.key
        ref.submitted += 1
        self._by_replica.setdefault(ref.key, set()).add(rec.fid)
        return (rec, ref, rec.token)

    def _do_launches(self, launches: Sequence[_Launch]) -> None:
        """Perform engine submissions decided under the lock.  Runs
        lock-free: a stalled engine blocks only this caller, and a
        concurrent rebind is detected by the token bump."""
        for rec, ref, token in launches:
            try:
                handle = ref.engine.submit(
                    rec.prompt, max_new_tokens=rec.max_new_tokens,
                    eos_token=rec.eos_token,
                    latency_slo_ms=rec.latency_slo_ms, qos=rec.qos)
            except Exception as exc:  # noqa: BLE001 — engine refused
                # lock-free mailbox: deque appends are atomic and the
                # entries are drained under the lock
                self._failures.append(  # analysis: unguarded-ok
                    (rec, token, exc))
                continue
            with self._lock:
                stale = rec.token != token
                if not stale:
                    rec.inner = handle
            if stale:
                ref.engine.cancel_queued(handle.rid,
                                         timeout=self.probe_timeout_s)
                continue
            handle.future.add_done_callback(
                self._completion_cb(rec, token, ref.key))

    def _completion_cb(self, rec: FleetRequest, token: int, key: str):
        submitted_at = rec.submitted_at

        def _cb(fut: Future) -> None:
            # engine loop thread, possibly under the engine lock: never
            # touch the router lock here (AB-BA with the submit path)
            if rec.token != token:
                return
            exc = fut.exception()
            if exc is not None:
                # lock-free mailboxes: deque appends are atomic and the
                # entries are drained under the lock
                self._failures.append(  # analysis: unguarded-ok
                    (rec, token, exc))
                return
            try:
                rec.outer.set_result(fut.result())
            except InvalidStateError:
                return
            wall = time.monotonic() - submitted_at
            self._done_events.append(  # analysis: unguarded-ok
                (rec.fid, key, wall))
            self.stats_sink.record(DispatchSample(
                workload=f"fleet-{rec.fid}", workload_class="heavy",
                executor_class="container", executor="fleet-router",
                node="", wall_s=wall, cold=False, footprint_bytes=0,
                service=self.service or "fleet", replica=key))

        return _cb

    # -- deferred bookkeeping ------------------------------------------

    def poke(self) -> None:
        """Drain completion/failure mailboxes (reroutes happen here) and
        run the auto-rebalancer when due.  Safe from any non-engine
        thread; ``FleetHandle.result`` calls it while polling."""
        with self._lock:
            launches = self._drain_mail_locked()
            launches += self._maybe_rebalance_locked()
        self._do_launches(launches)

    def _drain_mail_locked(self) -> List[_Launch]:
        while self._done_events:
            fid, key, _wall = self._done_events.popleft()
            rec = self._requests.pop(fid, None)
            if rec is None:
                continue
            self._by_replica.get(key, set()).discard(fid)
            ref = self._replicas.get(key)
            if ref is not None:
                ref.completed += 1
            self.counters["completed"] += 1
        launches: List[_Launch] = []
        while self._failures:
            rec, token, exc = self._failures.popleft()
            if rec.token != token or rec.outer.done():
                continue
            self._by_replica.get(rec.replica, set()).discard(rec.fid)
            live = [r for r in self._live() if r.key != rec.replica]
            if rec.guaranteed and live and rec.moves < self.max_moves:
                rec.moves += 1
                self.counters["reroutes"] += 1
                responsive = [r for r in live if self._responsive(r)]
                target = min(responsive or live, key=self._score)
                launches.append(self._bind_locked(rec, target))
            else:
                self._requests.pop(rec.fid, None)
                self.counters["failed"] += 1
                try:
                    rec.outer.set_exception(exc)
                except InvalidStateError:
                    pass
        return launches

    # ------------------------------------------------------------------
    # work stealing
    # ------------------------------------------------------------------

    def rebalance(self) -> Dict[str, float]:
        """Migrate queued work off replicas whose queue depth (or recent
        queue-wait p95) exceeds the fleet median by the steal threshold.

        A responsive donor has its queued engine requests cancelled and
        re-bound elsewhere; a *stalled* donor can't be cancelled into,
        so only its GUARANTEED requests are speculatively re-bound (the
        token bump orphans whichever copy loses)."""
        with self._lock:
            moved, median, launches = self._rebalance_locked()
        self._do_launches(launches)
        return {"moved": moved, "median_depth": median}

    def _maybe_rebalance_locked(self) -> List[_Launch]:
        if self.auto_rebalance_s is None:
            return []
        now = time.monotonic()
        if now - self._last_rebalance < self.auto_rebalance_s:
            return []
        _moved, _median, launches = self._rebalance_locked()
        return launches

    def _rebalance_locked(self) -> Tuple[int, float, List[_Launch]]:
        self._last_rebalance = time.monotonic()
        live = self._live()
        if len(live) < 2:
            return 0, 0.0, []
        depths = {r.key: r.engine.queue_depth() for r in live}
        median = percentile(list(depths.values()), 50)
        threshold = max(median * self.steal_factor,
                        median + self.steal_min)
        moved = 0
        launches: List[_Launch] = []
        for donor in sorted(live, key=lambda r: -depths[r.key]):
            depth = depths[donor.key]
            hot_p95 = self.steal_queue_p95_s > 0 and \
                donor.engine.recent_queue_p95() > self.steal_queue_p95_s
            if depth <= threshold and not hot_p95:
                continue
            donor_ok = self._responsive(donor)
            targets = [r for r in live
                       if r is not donor and self._responsive(r)]
            if not targets:
                continue
            floor = int(median)
            for fid in sorted(self._by_replica.get(donor.key, ())):
                if depth <= floor:
                    break
                rec = self._requests.get(fid)
                if rec is None or rec.outer.done() or rec.inner is None:
                    continue
                if donor_ok:
                    # only still-queued work is stealable; active decodes
                    # own KV pages and stay put
                    got = donor.engine.cancel_queued(
                        rec.inner.rid, timeout=self.probe_timeout_s)
                    if got is None:
                        continue
                elif not (rec.guaranteed and rec.moves < self.max_moves):
                    continue
                else:
                    # stalled donor: can't cancel, speculatively re-bind
                    rec.moves += 1
                    self.counters["reroutes"] += 1
                target = min(targets, key=self._score)
                self._by_replica.get(donor.key, set()).discard(fid)
                launches.append(self._bind_locked(rec, target))
                donor.stolen_out += 1
                target.stolen_in += 1
                self.counters["steals"] += 1
                if rec.session:
                    self._sessions[rec.session] = target.key
                moved += 1
                depth -= 1
        return moved, median, launches

    # ------------------------------------------------------------------
    # lifecycle / introspection
    # ------------------------------------------------------------------

    def warmup(self) -> None:
        """Warm every replica up before taking traffic (the snapshot is
        taken under the lock; the slow first launches run outside it)."""
        with self._lock:
            refs = self._live()
        for ref in refs:
            warm = getattr(ref.engine, "warmup", None)
            if warm is not None:
                warm()

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Wait for every outstanding request to resolve."""
        deadline = time.monotonic() + timeout_s
        while True:
            self.poke()
            with self._lock:
                outstanding = sum(
                    0 if r.outer.done() else 1
                    for r in self._requests.values())
            if outstanding == 0:
                return True
            if time.monotonic() > deadline:
                return False
            time.sleep(0.02)

    def shutdown(self) -> None:
        """Stop every replica engine loop (benchmarks/tests teardown)."""
        with self._lock:
            refs = list(self._replicas.values())
        for ref in refs:
            stop = getattr(ref.engine, "stop", None)
            if stop is not None:
                stop(drain=False)

    def stats(self) -> dict:
        """Fleet rollup + per-replica load/affinity/steal counters."""
        with self._lock:
            launches = self._drain_mail_locked()
            per = {}
            for key, ref in sorted(self._replicas.items()):
                queued, active, kv_bytes = ref.engine.load()
                per[key] = {
                    "alive": ref.alive,
                    "submitted": ref.submitted,
                    "completed": ref.completed,
                    "affinity_hits": ref.affinity_hits,
                    "stolen_in": ref.stolen_in,
                    "stolen_out": ref.stolen_out,
                    "queue_depth": queued,
                    "active": active,
                    "kv_bytes_in_use": kv_bytes,
                }
            c = dict(self.counters)
            outstanding = len(self._requests)
            index_size = len(self._affinity)
            sessions = len(self._sessions)
        self._do_launches(launches)
        hits = c["prefix_hits"] + c["session_hits"]
        routed = hits + c["misses"]
        return {
            "policy": self.policy,
            "replicas": per,
            "affinity_hit_rate": round(hits / routed, 4) if routed else 0.0,
            "outstanding": outstanding,
            "index_size": index_size,
            "sessions": sessions,
            **c,
        }
