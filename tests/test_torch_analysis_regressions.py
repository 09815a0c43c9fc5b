"""The port's classes held to the concurrency regressions that
``tests/test_analysis_regressions.py`` pins on the JAX package's
(``ConfigurationManager.report`` reads its specs under ``_route_lock``,
``ImageRegistry.stats`` snapshots under its lock,
``ServingEngine.run_until_drained`` reads ``completed`` under the lock, a
concurrent ``stop`` claims ``_thread`` exactly once), and the two repairs
of the port's first analysis: ``ServingEngine.loop_running`` stays a
lock-free fast path, and ``ExecutableImage._freeze`` publishes the
residency table under the lock a call holds.

The lock-discipline tests are deterministic, not timing races: the
guarded container is swapped for a subclass that records whether the
owning lock is held at every read, then the accessor runs once."""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.core import (EdgeSystem, ExecutorClass, NodeCapacity,
                              ServiceSpec, Workload, WorkloadClass,
                              WorkloadKind)
from repro_torch.core.executor import ExecutableImage
from repro_torch.core.registry import ImageRegistry
from repro_torch.serving.engine import ServingEngine
from repro_torch.tree import leaves

torch.set_num_threads(1)


class LockCheckedDict(dict):
    """Dict recording, per iteration-style read, whether ``lock`` was
    held by the calling thread."""

    def attach(self, lock):
        self.lock = lock
        self.unlocked_reads = []
        return self

    def _note(self, op):
        if not self.lock._is_owned():
            self.unlocked_reads.append(op)

    def items(self):
        self._note("items")
        return super().items()

    def values(self):
        self._note("values")
        return super().values()


class _NullExecutor:
    name = "null"
    inflight = 0

    def footprint_bytes(self, workload):
        return 10

    def can_run(self, workload, args):
        return True

    def dispatch(self, workload, args):
        return ("null", workload.name)


def _system():
    system = EdgeSystem()
    system.add_node("n0", NodeCapacity(chips=1, hbm_bytes=1000,
                                       flops_per_s=1.0), mesh="cpu")
    system.register_builder(
        "generic", WorkloadClass.HEAVY,
        lambda workload, mesh: (_NullExecutor(), 10))
    return system


def _spec(name="svc"):
    return ServiceSpec(name=name,
                       workload=Workload(name, WorkloadKind.GENERIC),
                       executor_class=ExecutorClass.CONTAINER,
                       replicas=1, footprint_hint=10)


@pytest.fixture(scope="module")
def tiny_cfg():
    cfg = get_reduced_config("tinyllama-1.1b")
    return dataclasses.replace(cfg, compute_dtype="float32")


def test_manager_report_reads_specs_under_route_lock():
    system = _system()
    system.apply(_spec())
    mgr = system.manager
    checked = LockCheckedDict(mgr.specs).attach(mgr._route_lock)
    mgr.specs = checked
    report = mgr.report()
    assert report["services"] == {"svc": 1}
    assert checked.unlocked_reads == []


def test_registry_stats_snapshot_under_lock():
    orig_stats = ImageRegistry.stats
    observed = []

    class Probe(ImageRegistry):
        def stats(self):
            out = orig_stats(self)
            observed.append(self._lock.locked())
            return out

    # stats() snapshots inside the lock and leaves it free; hammered
    # while another thread bumps the counters under the lock, it never
    # sees a half-done increment
    probe = Probe()
    done = threading.Event()

    def hammer():
        while not done.is_set():
            probe.stats()

    t = threading.Thread(target=hammer, daemon=True)
    t.start()
    try:
        for _ in range(20):
            with probe._lock:
                probe.builds += 1
    finally:
        done.set()
        t.join(5.0)
    assert probe.stats()["builds"] == 20
    assert observed and not probe._lock.locked()


def test_run_until_drained_reads_completed_under_lock(tiny_cfg):
    eng = ServingEngine(tiny_cfg, max_slots=2, max_seq=32, device="cpu")
    checked = LockCheckedDict(eng.completed).attach(eng._lock)
    eng.completed = checked
    h = eng.submit(np.arange(4) % tiny_cfg.vocab_size, max_new_tokens=2)
    done = eng.run_until_drained()
    assert len(done) == 1 and done[0].rid == h.rid
    assert checked.unlocked_reads == []


def test_concurrent_stop_claims_thread_exactly_once(tiny_cfg):
    """Two racing stop() calls both return cleanly: exactly one joins the
    loop thread, neither trips on a half-cleared _thread."""
    eng = ServingEngine(tiny_cfg, max_slots=2, max_seq=32, device="cpu")
    eng.start()
    assert eng.loop_running
    errors = []
    barrier = threading.Barrier(2)

    def stopper():
        try:
            barrier.wait(timeout=5.0)
            eng.stop(drain=False, timeout=10.0)
        except Exception as e:  # pragma: no cover - the regression
            errors.append(e)

    threads = [threading.Thread(target=stopper) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert not errors
    assert eng._thread is None and not eng.loop_running
    eng.stop(drain=False)       # stop() on a stopped engine is a no-op


def test_loop_running_is_a_lock_free_fast_path(tiny_cfg):
    """The pragma's contract: ``loop_running`` reads ``_running`` and
    ``_thread`` without the engine lock, so a probe never waits on a
    tick; ``start`` and ``stop`` re-check it under the lock."""
    eng = ServingEngine(tiny_cfg, max_slots=2, max_seq=32, device="cpu")
    seen = []
    with eng._lock:
        t = threading.Thread(target=lambda: seen.append(eng.loop_running))
        t.start()
        t.join(5.0)
        assert not t.is_alive() and seen == [False]
    eng.start()
    try:
        with eng._lock:
            t = threading.Thread(
                target=lambda: seen.append(eng.loop_running))
            t.start()
            t.join(5.0)
            assert not t.is_alive() and seen == [False, True]
        assert eng.start() is eng and eng.loop_running   # idempotent
    finally:
        eng.stop(drain=False)
    assert not eng.loop_running


class _ReplayGraph:
    """Stands in for a captured CUDA graph on the CPU: a replay runs the
    function over the static buffers into the capture's output buffers."""

    def __init__(self, fn, static, out):
        self.fn, self.static, self.out = fn, static, out

    def replay(self):
        for o, n in zip(leaves(self.out), leaves(self.fn(*self.static))):
            o.copy_(n)


def test_freeze_publishes_residency_under_the_call_lock():
    """An image frozen while another thread is inside a call of it: the
    freeze waits for the call to leave the lock before it resets the
    residency table the call rewrites, and the image then serves the new
    capture."""
    img = ExecutableImage.build("double", lambda x: x * 2,
                                (torch.ones(4),), mesh="cpu")

    def freeze(scale):
        static = (torch.ones(4),)
        fn = (lambda x: x * scale)
        out = fn(*static)
        img._freeze(_ReplayGraph(fn, static, out), static, out, set())

    freeze(2.0)
    x = torch.arange(4.0)
    assert torch.equal(img(x), x * 2)
    assert img._resident[0] is not None          # x is held resident
    frozen = threading.Event()
    with img._lock:                              # a call in progress
        t = threading.Thread(target=lambda: (freeze(3.0), frozen.set()))
        t.start()
        assert not frozen.wait(0.3)              # the freeze waits
        assert img._resident[0] is not None
    t.join(5.0)
    assert frozen.is_set() and img._resident == [None]
    assert torch.equal(img(x), x * 3)            # copied into the new one
    assert img.replays == 2
