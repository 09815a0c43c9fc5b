"""Executor classes — the paper's container/unikernel split on the card (P1).

ContainerExecutor  (≙ Docker/Podman/Singularity)
    General-purpose: holds live params, serves *any* compatible entry point
    (train/prefill/decode/generic), runs it eagerly on whatever shapes
    arrive (feature-rich, biggest footprint).  The first dispatch of an
    (entry point, argument shapes, dtypes) key is the "fresh" one, where
    the JAX executor compiles.

UnikernelExecutor  (≙ Unikraft/OSv/Nanos)
    Single-purpose: ONE ``ExecutableImage`` with frozen (shape, dtype,
    device) arguments; donated buffers; no other path — a workload that
    doesn't match the image is REJECTED (the paper's "unikernels are not
    ready for image processing": C3 by construction).  On the card the
    image is one captured CUDA graph over static buffers it owns, and a
    dispatch is a replay; the registry caches images like an OCI registry
    caches layers.

Both execute on a placement handle (``mesh``, the name kept from the JAX
package): the ``torch.device`` of their node, or ``None``.  A unikernel's
footprint is its static argument buffers plus what its capture grew the
allocator by; a container's is the bytes of its state.
"""
from __future__ import annotations

import dataclasses
import enum
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.workload import Workload
from repro_torch.device import same_device
from repro_torch.tree import (flatten_with_path, leaves, tree_map,
                               unflatten_like)


class ExecutorClass(str, enum.Enum):
    CONTAINER = "container"
    UNIKERNEL = "unikernel"


class IncompatibleWorkload(RuntimeError):
    """Unikernel-class executor asked to run something it wasn't built for."""


def arg_spec(args) -> Tuple:
    """The frozen spec of an argument tree: (path, shape, dtype, device)
    of every tensor leaf; any other leaf raises ``TypeError``."""
    out = []
    for path, leaf in flatten_with_path(tuple(args)):
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"image argument {path} is a "
                            f"{type(leaf).__name__}, not a tensor")
        out.append((path, tuple(leaf.shape), leaf.dtype, leaf.device))
    return tuple(out)


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size()
               for _, x in flatten_with_path(tree)
               if isinstance(x, torch.Tensor))


def _same_buffer(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.stride() == b.stride() and a.dtype == b.dtype)


class ExecutableImage:
    """A single-purpose program with a frozen argument spec (≙ a unikernel
    image).

    On the card ``build`` copies the arguments into static buffers the
    image owns, runs ``fn`` once eagerly on a side stream (its first
    kernel launches also set the kernels' attributes), and captures one
    ``torch.cuda.CUDAGraph`` of ``fn`` over the static buffers.  The static
    buffers never leave the image, so callers that share it (one image
    may serve two executors after a failover, or two streams of one
    service) keep their own state.  A call copies the arguments into the
    static buffers, replays the graph, writes each output that is a
    donated argument's buffer back into the caller's own argument (the
    donated buffer becomes the output, as XLA's donation reuses it) and
    returns clones of the other outputs.  An argument is not copied in
    when the static buffer already holds it: the same tensor as the last
    call's, unchanged since (its version counter), that the graph does not
    write or that the last call wrote back.  So a stream that hands its
    donated cache back pays one copy out a step and no copy in.  A lock
    holds copy-in, replay and copy-out together.

    A failed capture raises: the image never runs eagerly on the card.
    Nothing on a captured path may synchronize with the host (``.item()``,
    ``.tolist()``, ``.cpu()``, ``torch.cuda.synchronize``).  The kernel
    wrappers count the capture's launches once; ``captured_launches`` holds
    them per kernel and ``replays`` the number of replays, so a kernel ran
    ``captured_launches[name] * replays`` times after the build.

    On the CPU (a caller's explicit choice) the image keeps the frozen spec
    and its rejection and runs ``fn`` eagerly on the caller's arguments;
    the donated ones are updated in place where ``fn`` does so.

    Footprint: ``arg_bytes`` (the static inputs) + ``temp_bytes`` (the
    allocator's ``allocated_bytes.all.current`` grown by the capture: what
    the graph's private pool keeps allocated); ``pool_bytes`` is the
    memory that pool reserved.  Both are 0 on the CPU.
    """

    def __init__(self, name: str, fn: Callable, spec: Tuple,
                 device: torch.device, donated_argnums: Tuple[int, ...]):
        self.name = name
        self.fn = fn
        self.arg_spec = spec
        self.device = device
        self.donated_argnums = tuple(donated_argnums)
        self.build_time_s = 0.0
        self.arg_bytes = 0
        self.temp_bytes = 0
        self.output_bytes = 0
        self.pool_bytes = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static_args: Optional[Tuple] = None
        self.static_out: Any = None
        self.captured_launches: Dict[str, int] = {}
        self.replays = 0
        self.placement: Optional[_Placement] = None   # on a device mesh
        self.copied_bytes = 0          # argument bytes copied in by calls
        self._lock = threading.Lock()
        self._static: List[torch.Tensor] = []     # static_args' leaves
        self._donated: List[int] = []      # their indices in donated args
        self._written: set = set()     # indices the graph may write
        # per static leaf: (caller's tensor, its version) the leaf holds
        self._resident: List[Optional[Tuple[weakref.ref, int]]] = []

    @property
    def footprint_bytes(self) -> int:
        # donated args alias outputs; temp is the graph's working set
        return self.arg_bytes + self.temp_bytes

    @property
    def captured(self) -> bool:
        return self.graph is not None

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, name: str, fn: Callable, args: Tuple,
              donate_argnums: Tuple[int, ...] = (),
              in_shardings: Any = None, mesh=None) -> "ExecutableImage":
        """``mesh`` is the placement handle: a ``torch.device`` the
        arguments must live on, ``None``, or a device mesh (a
        ``DeviceMesh`` with named dims, or a ``LocalMesh``).  On a mesh
        the arguments given here are whole tensors on this rank's device:
        ``in_shardings`` (a tree of specs shaped like ``args``; every leaf
        replicated without it) cuts each to this rank's shard, the image
        is built (and on the card captured) over the shards, and ``fn``
        runs under the mesh's default rules.  Its calls take placed
        arguments (``place``)."""
        placement = None
        if in_shardings is not None or _is_mesh(mesh):
            if not _is_mesh(mesh):
                raise TypeError(f"image {name!r}: in_shardings need a device "
                                f"mesh as the placement handle, got {mesh!r}")
            placement = _Placement(mesh, in_shardings)
            args, fn = placement.place(args), placement.wrap(fn)
            mesh = placement.device
        elif not (mesh is None or isinstance(mesh, (str, torch.device))):
            raise TypeError(f"image {name!r}: unknown placement handle "
                            f"{mesh!r} (a device, a device mesh or None)")
        t0 = time.monotonic()
        args = tuple(args)
        spec = arg_spec(args)
        devices = {s[3] for s in spec}
        if len(devices) != 1:
            raise ValueError(f"image {name!r}: arguments must live on one "
                             f"device, got {sorted(map(str, devices))}")
        (dev,) = devices
        if mesh is not None and not same_device(mesh, dev):
            raise ValueError(f"image {name!r}: arguments on {dev}, "
                             f"placement handle {mesh}")
        img = cls(name, fn, spec, dev, donate_argnums)
        img.placement = placement
        img.arg_bytes = tree_bytes(args)
        if dev.type == "cuda":
            img._capture(args)
        else:
            with torch.no_grad():       # output sizes, on a scratch copy
                out = fn(*tree_map(lambda a: a.clone(), args))
            img.output_bytes = tree_bytes(out)
        img.build_time_s = time.monotonic() - t0
        return img

    def place(self, args: Tuple) -> Tuple:
        """Whole arguments cut to this rank's shards, as ``build`` cut
        them (the arguments themselves for an image built without a
        mesh)."""
        if self.placement is None:
            return tuple(args)
        return self.placement.place(args)

    def _capture(self, args: Tuple) -> None:
        from repro_torch.kernels import launch_counts

        dev = self.device
        with torch.cuda.device(dev), torch.no_grad():
            static = tree_map(lambda a: a.detach().clone(), args)
            flat = leaves(static)
            v0 = [_version(t) for t in flat]
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                warm = self.fn(*static)
            torch.cuda.current_stream(dev).wait_stream(side)
            del warm
            # what the function writes in place (its version counter moved)
            written = {i for i, (t, v) in enumerate(zip(flat, v0))
                       if _version(t) != v}
            # the warm-up ran on the static buffers: put the arguments back
            for s, a in zip(leaves(static), leaves(args)):
                s.copy_(a)
            torch.cuda.synchronize(dev)
            before = launch_counts()
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph,
                                      capture_error_mode="thread_local"):
                    # read inside: entering the capture empties the cache
                    mem0 = torch.cuda.memory_stats(dev)
                    out = self.fn(*static)
            except Exception as e:
                raise RuntimeError(f"CUDA-graph capture of image "
                                   f"{self.name!r} failed: {e}") from e
            torch.cuda.synchronize(dev)
            mem1 = torch.cuda.memory_stats(dev)
        after = launch_counts()
        self.captured_launches = {k: after[k] - before[k] for k in after
                                  if after[k] != before[k]}
        self.temp_bytes = max(0, mem1["allocated_bytes.all.current"]
                              - mem0["allocated_bytes.all.current"])
        self.pool_bytes = max(0, mem1["reserved_bytes.all.current"]
                              - mem0["reserved_bytes.all.current"])
        self._freeze(graph, static, out, written)

    def _freeze(self, graph, static: Tuple, out, written: set) -> None:
        """Keep a captured ``graph`` over the ``static`` argument buffers
        and its ``out`` buffers; ``written``: the indices of the static
        leaves the function wrote at its warm-up (with the donated ones,
        those the graph may write)."""
        self.graph, self.static_args, self.static_out = graph, static, out
        self.output_bytes = tree_bytes(out)
        self._static = leaves(static)
        first = [len(leaves(static[:i])) for i in range(len(static) + 1)]
        self._donated = [j for i in self.donated_argnums
                         for j in range(first[i], first[i + 1])]
        self._written = written | set(self._donated)
        self._resident = [None] * len(self._static)

    # ------------------------------------------------------------------
    def matches(self, args: Tuple) -> bool:
        try:
            return arg_spec(args) == self.arg_spec
        except TypeError:               # a leaf that is not a tensor
            return False

    def __call__(self, *args):
        if self.graph is None:
            with torch.no_grad():
                return self.fn(*args)
        with self._lock, torch.no_grad():
            flat = leaves(args)
            for i, (s, a) in enumerate(zip(self._static, flat)):
                held = self._resident[i]
                if held is None or held[0]() is not a or \
                        held[1] != _version(a):
                    if not _same_buffer(s, a):
                        s.copy_(a)
                        self.copied_bytes += a.numel() * a.element_size()
                    self._resident[i] = None
            self.graph.replay()
            self.replays += 1
            resident = [None if i in self._written else
                        self._resident[i] or _held(a)
                        for i, a in enumerate(flat)]

            def hand_out(t):
                if not isinstance(t, torch.Tensor):
                    return t
                for i in self._donated:
                    if _same_buffer(t, self._static[i]):
                        mine = flat[i]
                        mine.copy_(t)
                        resident[i] = _held(mine)
                        return mine
                return t.clone()

            out = tree_map(hand_out, self.static_out)
            self._resident = resident
            return out


def _is_mesh(mesh) -> bool:
    from repro_torch.launch.mesh import LocalMesh

    return hasattr(mesh, "mesh_dim_names") or isinstance(mesh, LocalMesh)


class _Placement:
    """An image's device mesh and argument specs: cuts whole arguments to
    this rank's shards and runs the function under the mesh's rules."""

    def __init__(self, mesh, in_shardings):
        from repro_torch.distributed import spmd
        from repro_torch.launch.mesh import mesh_device

        self.mesh, self.specs = mesh, in_shardings
        self.comm = spmd.comm_of(mesh)
        self.device = mesh_device(mesh)

    def place(self, args: Tuple) -> Tuple:
        from repro_torch.distributed import spmd
        from repro_torch.launch.programs import flat_specs

        args = tuple(args)
        flat = leaves(args)
        specs = flat_specs(self.specs) if self.specs is not None \
            else [()] * len(flat)
        if len(specs) != len(flat):
            raise ValueError(f"in_shardings has {len(specs)} specs for "
                             f"{len(flat)} argument leaves")
        return unflatten_like(args, [
            spmd.shard_of(a, s, self.comm).contiguous()
            for a, s in zip(flat, specs)])

    def wrap(self, fn: Callable) -> Callable:
        from repro_torch.distributed.sharding import use_rules

        def run(*args):
            with use_rules(self.mesh):
                return fn(*args)
        return run


def _version(t: torch.Tensor) -> Optional[int]:
    """A tensor's in-place version counter; ``None`` where it keeps none
    (an inference tensor), which never matches."""
    try:
        return t._version
    except RuntimeError:
        return None


def _held(t: torch.Tensor) -> Optional[Tuple[weakref.ref, int]]:
    v = _version(t)
    return None if v is None else (weakref.ref(t), v)


@dataclasses.dataclass
class DispatchRecord:
    workload: str
    wall_s: float
    compiled_fresh: bool


class BaseExecutor:
    executor_class: ExecutorClass

    def __init__(self, name: str, mesh=None):
        self.name = name
        self.mesh = mesh
        self.history: list[DispatchRecord] = []
        self.inflight = 0

    @property
    def donates_inputs(self) -> bool:
        """True when dispatch consumes caller buffers (donated args) — the
        manager then clones args before racing a speculative backup."""
        return False

    def footprint_bytes(self) -> int:
        """Static device-memory reservation — what placement admits
        against."""
        raise NotImplementedError

    def dynamic_footprint_bytes(self) -> int:
        """Live device-memory commitment.  Executors with elastic state
        (the paged serving engine counts KV *pages in use*, not worst-case
        rows) override this; everything else is static."""
        return self.footprint_bytes()

    def can_run(self, workload: Workload, args: Tuple) -> bool:
        raise NotImplementedError

    def dispatch(self, workload: Workload, args: Tuple):
        raise NotImplementedError


def _shape_key(args) -> Tuple:
    """(path, shape, dtype) of every array leaf — the JAX executor's
    compile-cache key."""
    return tuple((path, tuple(leaf.shape), str(leaf.dtype))
                 for path, leaf in flatten_with_path(tuple(args))
                 if hasattr(leaf, "shape") and hasattr(leaf, "dtype"))


class ContainerExecutor(BaseExecutor):
    """Feature-rich general executor: named entry points, run eagerly."""

    executor_class = ExecutorClass.CONTAINER

    def __init__(self, name: str, entry_points: Dict[str, Callable],
                 state: Optional[Dict[str, Any]] = None, mesh=None):
        super().__init__(name, mesh)
        self.entry_points = dict(entry_points)
        self.state = state or {}          # live params etc.
        self._seen_shapes: Dict[str, set] = {k: set()
                                             for k in self.entry_points}
        self._state_bytes = tree_bytes(self.state)

    def footprint_bytes(self) -> int:
        return self._state_bytes

    def can_run(self, workload: Workload, args: Tuple) -> bool:
        return workload.kind.value in self.entry_points or \
            "generic" in self.entry_points

    def dispatch(self, workload: Workload, args: Tuple):
        ep = workload.kind.value if workload.kind.value in self.entry_points \
            else "generic"
        fn = self.entry_points[ep]
        key = _shape_key(args)
        fresh = key not in self._seen_shapes[ep]
        t0 = time.monotonic()
        self.inflight += 1
        try:
            # entry points close over live state (params); args are payload
            with torch.no_grad():
                out = fn(*args)
            _wait_for(out)
        finally:
            self.inflight -= 1
        self._seen_shapes[ep].add(key)
        self.history.append(DispatchRecord(workload.name,
                                           time.monotonic() - t0, fresh))
        return out


def _wait_for(out) -> None:
    """Block until the device work behind ``out`` is done (JAX's
    ``block_until_ready``): the dispatch wall is the work's, not its
    launch's."""
    for dev in {leaf.device for leaf in leaves(out)
                if isinstance(leaf, torch.Tensor) and leaf.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()


class UnikernelExecutor(BaseExecutor):
    """Single-purpose executor: exactly one image, donated buffers."""

    executor_class = ExecutorClass.UNIKERNEL

    def __init__(self, name: str, image: ExecutableImage, mesh=None):
        super().__init__(name, mesh)
        self.image = image

    @property
    def donates_inputs(self) -> bool:
        return bool(self.image.donated_argnums)

    def footprint_bytes(self) -> int:
        return self.image.footprint_bytes

    def can_run(self, workload: Workload, args: Tuple) -> bool:
        return self.image.matches(args)

    def dispatch(self, workload: Workload, args: Tuple):
        if not self.image.matches(args):
            raise IncompatibleWorkload(
                f"unikernel {self.name!r} was built for "
                f"{self.image.arg_spec}; got mismatching args "
                f"(paper C3: single-purpose by construction)")
        t0 = time.monotonic()
        self.inflight += 1
        try:
            out = self.image(*args)
            _wait_for(out)
        finally:
            self.inflight -= 1
        self.history.append(DispatchRecord(workload.name,
                                           time.monotonic() - t0, False))
        return out
