"""Builders wiring the model/stream layers into the hybrid runtime: the
port of ``repro.serving.router``.

This module is the concrete edge-system assembly (paper fig 1): it teaches
the ConfigurationManager how to construct
  * container-class executors for heavy workloads: eager prefill/decode/
    generic/train entry points over live params, or a ``ServingEngine``;
  * unikernel-class executors for light workloads: images (one captured
    CUDA graph each on the card) for single-stream decode and for the
    Fitbit-analytics step, with donated state buffers, built through the
    shared image registry.

Every builder takes ``device`` (default: the card) and ``params`` (e.g.
from ``repro_torch.models.weights``); a builder called with a node's
placement handle builds on that device instead.  The replicated fleet's
``make_fleet_builder`` and ``fleet_service_spec`` come with the fleet
(ROADMAP Queue A item 10).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.executor import (BaseExecutor, ContainerExecutor,
                                       ExecutorClass, UnikernelExecutor)
from repro_torch.core.registry import ImageRegistry
from repro_torch.core.scheduler import clone_args
from repro_torch.core.spec import ServiceSpec
from repro_torch.core.workload import Workload, WorkloadClass, WorkloadKind
from repro_torch.data import stream as stream_lib
from repro_torch.device import resolve_device
from repro_torch.launch import programs
from repro_torch.models.model import build_model, to_device


def _where(handle, default: torch.device) -> torch.device:
    """The node's placement handle when it gives one, else the builder's
    own device."""
    return default if handle is None else resolve_device(handle)


def _params(cfg, params, seed: int, dev: torch.device):
    if params is not None:
        return to_device(params, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return build_model(cfg, dev).init(gen)


def _trainable(tree):
    """A copy of a params tree whose floating leaves require grad."""
    def leaf(x):
        x = x.detach().clone()
        return x.requires_grad_(True) if x.is_floating_point() else x
    if isinstance(tree, dict):
        return {k: _trainable(v) for k, v in tree.items()}
    return leaf(tree)


def make_container_builder(cfg, params=None, seed: int = 0, device=None):
    """Container-class: feature-rich LM executor (prefill+decode+train).
    The entry points leave the caller's buffers as they were: prefill and
    decode write into copies of the caches they are given (the JAX
    executor returns new caches the same way), train steps a copy of the
    params and optimizer state."""
    dev0 = resolve_device(device)
    p0 = _params(cfg, params, seed, dev0)

    def builder(workload: Workload, mesh) -> Tuple[BaseExecutor, int]:
        dev = _where(mesh, dev0)
        p = to_device(p0, dev)
        model = build_model(cfg, dev)

        def prefill(tokens, caches):
            caches = clone_args(caches)
            logits, cache_len = model.prefill(p, {"tokens": tokens}, caches)
            return logits, caches, cache_len

        def decode(tokens, caches, cache_len):
            caches = clone_args(caches)
            return model.decode(p, tokens, caches, cache_len), caches

        def train(opt_state, batch, tcfg=programs.default_train_config(cfg)):
            step = programs.build_train_step(cfg, tcfg, dev)
            with torch.enable_grad():
                return step(_trainable(p), clone_args(opt_state), batch)

        def infer(inputs):
            """Generic single-shot inference (the paper's CV-detection
            analogue): tokens in → class predictions out."""
            logits = model.forward(p, {"tokens": inputs})
            return torch.argmax(logits, dim=-1).to(torch.int32)

        ex = ContainerExecutor(
            name=f"container[{cfg.name}]",
            entry_points={"prefill": prefill, "decode": decode,
                          "train": train, "generic": infer},
            state={"params": p}, mesh=dev)
        return ex, ex.footprint_bytes()

    return builder


def make_unikernel_decode_builder(cfg, registry: ImageRegistry,
                                  params=None, seed: int = 0,
                                  max_seq: int = 128, device=None):
    """Unikernel-class: single-stream (batch=1) decode, one frozen shape.
    The dense caches are in the compute dtype (the decode kernel reads
    caches in its query's dtype; the JAX image's are bf16, the default
    compute dtype) and donated."""
    dev0 = resolve_device(device)
    p0 = _params(cfg, params, seed, dev0)

    def builder(workload: Workload, mesh) -> Tuple[BaseExecutor, int]:
        dev = _where(mesh, dev0)
        model = build_model(cfg, dev)

        def decode_step(params_, tokens, caches, cache_len):
            logits = model.decode(params_, tokens, caches, cache_len)
            return (torch.argmax(logits, dim=-1).to(torch.int32), caches,
                    cache_len + 1)

        caches = model.init_caches(1, max_seq, cfg.cdtype)
        args = (to_device(p0, dev),
                torch.zeros((1,), dtype=torch.int32, device=dev), caches,
                torch.zeros((1,), dtype=torch.int32, device=dev))
        image = registry.get_or_build(
            f"unikernel-decode[{cfg.name}]", decode_step, args,
            donate_argnums=(2,), mesh=dev)
        ex = UnikernelExecutor(f"unikernel[{cfg.name}]", image, mesh=dev)
        return ex, ex.footprint_bytes()

    return builder


def _zero_records(scfg: stream_lib.StreamConfig, dev: torch.device):
    n = scfg.batch_records
    return {"user_id": torch.zeros((n,), dtype=torch.int32, device=dev),
            **{k: torch.zeros((n,), dtype=torch.float32, device=dev)
               for k in ("total_steps", "total_distance", "calories")}}


def make_stream_builder(registry: ImageRegistry,
                        scfg: stream_lib.StreamConfig, device=None):
    """Unikernel-class: the paper's Fitbit analytics task, one image with
    the state donated."""
    dev0 = resolve_device(device)

    def builder(workload: Workload, mesh) -> Tuple[BaseExecutor, int]:
        dev = _where(mesh, dev0)
        state = stream_lib.init_state(scfg, dev)
        image = registry.get_or_build(
            "unikernel-stream", stream_lib.analytics_step,
            (state, _zero_records(scfg, dev)), donate_argnums=(0,),
            mesh=dev)
        ex = UnikernelExecutor("unikernel[stream]", image, mesh=dev)
        return ex, ex.footprint_bytes()

    return builder


def make_stream_container_builder(scfg: stream_lib.StreamConfig,
                                  device=None):
    """The SAME analytics task on a container-class executor — the paper's
    fig 5 comparison (container vs unikernel on one data-science job)."""
    dev0 = resolve_device(device)

    def builder(workload: Workload, mesh) -> Tuple[BaseExecutor, int]:
        ex = ContainerExecutor(
            name="container[stream]",
            entry_points={"stream": stream_lib.analytics_step,
                          "generic": stream_lib.analytics_step},
            state={}, mesh=_where(mesh, dev0))
        return ex, ex.footprint_bytes()

    return builder


def make_engine_builder(cfg, max_slots: int = 4, max_seq: int = 128,
                        params=None, seed: int = 0, autostart: bool = True,
                        device=None, **engine_kw):
    """Container-class: a continuous-batching ``ServingEngine`` wrapped as
    an executor, so serving deployments go through ``ServiceSpec`` too.

    With ``autostart=True`` (default) the executor starts the engine's
    background loop on first dispatch — concurrent ``submit_many``
    dispatches then batch in one decode loop instead of serializing whole
    requests; ``autostart=False`` keeps the engine caller-driven (each
    blocked ``dispatch`` steps the shared engine inline).  ``engine_kw``
    passes the data-plane knobs through (``paged``, ``page_size``,
    ``num_pages``, ``prefill_chunk``, ``prefill_budget``, ``kv_dtype``
    for int8 pages, and the speculative trio ``draft_cfg``/
    ``draft_params``/``spec_k_max``).  Every builder call makes a fresh
    engine with its own KV pool."""
    from repro_torch.serving.engine import EngineExecutor, ServingEngine

    dev0 = resolve_device(device)

    def builder(workload: Workload, mesh) -> Tuple[BaseExecutor, int]:
        dev = _where(mesh, dev0)
        engine = ServingEngine(cfg, max_slots=max_slots, max_seq=max_seq,
                               params=params, seed=seed, device=dev,
                               **engine_kw)
        ex = EngineExecutor(f"engine[{cfg.name}]", engine, mesh=dev,
                            autostart=autostart)
        return ex, ex.footprint_bytes()

    return builder


def assemble_edge_system(system, heavy_cfg, light_cfg=None, scfg=None,
                         params_heavy=None, params_light=None, device=None):
    """Register the standard builder set (used by examples + benchmarks).

    ``system`` is an ``EdgeSystem`` (or anything exposing
    ``register_builder`` + ``registry``).
    """
    scfg = scfg or stream_lib.StreamConfig()
    registry = system.registry
    cb = make_container_builder(heavy_cfg, params=params_heavy,
                                device=device)
    for kind in ("train", "prefill", "decode", "generic"):
        system.register_builder(kind, WorkloadClass.HEAVY, cb)
    if light_cfg is not None:
        ub = make_unikernel_decode_builder(light_cfg, registry,
                                           params=params_light,
                                           device=device)
        system.register_builder("decode", WorkloadClass.LIGHT, ub)
        system.register_builder("generic", WorkloadClass.LIGHT, ub)
    system.register_builder("stream", WorkloadClass.LIGHT,
                            make_stream_builder(registry, scfg,
                                                device=device))
    return system


def standard_specs(heavy_cfg, replicas_heavy: int = 1,
                   replicas_stream: int = 1) -> Tuple[ServiceSpec, ...]:
    """Declarative manifests for the paper's two standing services: the
    heavy CV-style inference path and the light stream-analytics path."""
    cv = ServiceSpec(
        name="cv-infer",
        workload=Workload("cv-frame", WorkloadKind.GENERIC, heavy_cfg,
                          batch=1, seq_len=32,
                          est_flops=2.0 * heavy_cfg.num_params() * 32 * 300),
        executor_class=ExecutorClass.CONTAINER,
        replicas=replicas_heavy)
    analytics = ServiceSpec(
        name="stream-analytics",
        workload=Workload("fitbit", WorkloadKind.STREAM),
        executor_class=ExecutorClass.UNIKERNEL,
        replicas=replicas_stream)
    return cv, analytics
