"""Continuous-batching serving engine: ``repro.serving.engine.
ServingEngine`` over its two data planes.

Paged (the dense decoder, by default): every tick admits queued requests
while slots and pages last (attaching a radix-matched prefix by reference
and copy-seeding a mid-page divergence), runs at most ``prefill_budget``
prompt tokens of pow2-bucketed chunks round-robin in SLO-slack order,
then advances the whole decode batch by one token, growing pages on
demand through the reclaim ladder (radix eviction, then preemption of a
strictly-lower-QoS request, else a stall).

Dense slots (the ssm and hybrid families, and the dense decoder with
``paged=False``): a request claims a slot of a ``SlotKVCache``.  The
stateful families prefill in exact-length chunks that resume a batch-1
staging cache of their own (their SSM state must not see pad tokens); the
dense decoder prefills the whole prompt at once, right-padded to a pow2
bucket.  A finished prefill is copied into the slot, and decode advances
every slot together (the states of idle slots move on stale tokens, and
the next ``insert`` overwrites them).  A failed chunk wrote only its own
staging cache, so it fails only its own request.

The engine is caller-driven (``step``/``run_until_drained``/a handle's
``result``) or runs a background loop (``start``/``stop``/``drain``).

With a draft model (``draft_cfg``) each decode tick is speculative: the
draft proposes k tokens per row, the target verifies all k+1 positions in
one paged pass and commits the accepted prefix plus its own correction
token, so greedy output is the same as without the draft.  A failing
draft turns speculation off, as in the JAX engine, except when a kernel
failed to build or launch (``KernelError``): that fails the batch, so a
broken kernel never hides behind the plain tick.  ``kv_dtype="int8"``
stores the pages as int8 with per-token scales.  Speculation and int8
pages are the paged plane's only.

Where the JAX engine jits each step with buffer donation, this one runs
eagerly and updates the pools, slot caches, page table and lengths in
place; the tensors live on the engine's device (``cuda`` unless
``device="cpu"``).  The dense slot tree is in the compute dtype from the
start (the JAX engine's starts in bf16 and takes the compute dtype at its
first decode; ROADMAP Queue C).  MoE, sliding-window, MLA and encoder
models and ``EngineExecutor`` raise ``NotImplementedError`` naming their
ROADMAP item.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.telemetry import DispatchSample, DispatchStats, percentile
from repro_torch.device import resolve_device
from repro_torch.kernels.build import KernelError
from repro_torch.kernels.paged_verify_attention import MAX_K1
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model, cast_params, to_device
from repro_torch.serving.kv_cache import (PagedKVCache, SlotKVCache,
                                         autotune_page_size)
from repro_torch.serving.prefix import PrefixRadixIndex
from repro_torch.serving.spec_decode import DraftSpeculator

# page-growth preemption order: a dry pool preempts strictly-lower-rank
# requests only; preemption requeues, it never drops
_QOS_RANK = {"best-effort": 0, "burstable": 1, "guaranteed": 2}


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [T] int32
    max_new_tokens: int = 16
    eos_token: Optional[int] = None
    latency_slo_ms: float = 0.0
    qos: str = "burstable"
    submitted_at: float = 0.0
    # filled by the engine
    slot: Optional[int] = None
    phase: str = "queued"              # queued | prefill | decode
    pos: int = 0                       # prompt tokens prefilled so far
    chunks: int = 0                    # prefill chunks executed
    table_row: Any = None              # [1, MP] page-table row (paged)
    staging: Any = None                # batch-1 cache tree (dense slots)
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    error: Optional[str] = None
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    future: Optional["Future[Request]"] = None
    shared_nodes: List[Any] = dataclasses.field(default_factory=list)
    kv_shared_tokens: int = 0
    # speculative decoding: acceptance-rate EMA driving this request's
    # preferred draft length (0.5 = neutral prior)
    spec_ema: float = 0.5


def slo_slack(req: Request, now: float) -> float:
    """Seconds of SLO budget left (infinite without an SLO, so SLO-less
    requests keep FIFO order behind every deadline-bearing one)."""
    if req.latency_slo_ms <= 0:
        return float("inf")
    return req.latency_slo_ms / 1e3 - (now - req.submitted_at)


class RequestHandle:
    """Caller-side view of a submitted request: ``result()`` waits on the
    future when the loop runs, else drives ``step()`` inline.  A failed
    request re-raises its error here."""

    def __init__(self, engine: "ServingEngine", req: Request):
        self._engine = engine
        self._req = req

    @property
    def rid(self) -> int:
        return self._req.rid

    def done(self) -> bool:
        return self._req.future.done()

    def result(self, timeout: Optional[float] = None) -> Request:
        if self._engine.loop_running:
            return self._req.future.result(timeout)
        return self._engine._drive(self._req, timeout)


def _buckets(max_seq: int) -> List[int]:
    out, b = [], 16
    while b < max_seq:
        out.append(b)
        b *= 2
    out.append(max_seq)
    return out


class ServingEngine:
    def __init__(self, cfg: ModelConfig, max_slots: int = 4,
                 max_seq: int = 256, params: Optional[Dict] = None,
                 seed: int = 0, device=None,
                 paged: Optional[bool] = None, page_size=16,
                 num_pages: Optional[int] = None,
                 prefill_chunk: int = 64,
                 prefill_budget=None,
                 prefix_sharing: bool = True,
                 kv_dtype: str = "auto",
                 draft_cfg: Optional[ModelConfig] = None,
                 draft_params: Optional[Dict] = None,
                 spec_k_max: int = 4):
        budget_auto = isinstance(prefill_budget, str) and \
            prefill_budget == "auto"
        if not (prefill_budget is None or budget_auto or (
                isinstance(prefill_budget, (int, np.integer))
                and not isinstance(prefill_budget, bool))):
            raise ValueError(f"prefill_budget must be an int, None or "
                             f"'auto', got {prefill_budget!r}")
        if kv_dtype not in ("auto", "int8"):
            raise ValueError(f"kv_dtype must be 'auto' (the compute dtype) "
                             f"or 'int8', got {kv_dtype!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg, self.device)    # raises if unported
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen)
        self.params = to_device(params, self.device)
        # cast once: each use casts its weight to the compute dtype anyway
        self._run_params = cast_params(self.params, cfg.cdtype)
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.buckets = _buckets(max_seq)

        # data plane: paged pools for the dense decoder (the only
        # paged-capable family the port has), dense slots otherwise
        self.paged = cfg.family == "dense" and paged is not False
        if self.paged:
            # int8 pages carry per-token f32 scales, dequantized in the
            # kernels
            self.kv_dtype = cfg.cdtype if kv_dtype == "auto" else torch.int8
            if page_size == "auto":
                page_size = autotune_page_size(cfg, dtype=self.kv_dtype)
            self.kv: Any = PagedKVCache(
                cfg, max_slots, max_seq, page_size=page_size,
                num_pages=num_pages, dtype=self.kv_dtype, device=self.device)
        else:
            if kv_dtype != "auto":
                raise ValueError(
                    "kv_dtype is a paged-data-plane knob; the dense slot "
                    "cache serves in the compute dtype")
            self.kv_dtype = cfg.cdtype
            self.kv = SlotKVCache(cfg, max_slots, max_seq, dtype=cfg.cdtype,
                                  device=self.device)

        # prefix sharing (paged): radix index + COW accounting, under the
        # lock
        self.prefix: Optional[PrefixRadixIndex] = (
            PrefixRadixIndex(self.kv.page_size)
            if self.paged and prefix_sharing else None)
        self.kv_prefix_hits = 0
        self.kv_prefix_misses = 0
        self.preemptions = 0
        self.decode_stalls = 0

        # chunked prefill: chunk sizes reuse the pow2 prefill buckets
        self.chunk_tokens = max(
            [b for b in self.buckets if b <= prefill_chunk] or
            [self.buckets[0]])
        self.chunk_buckets = [b for b in self.buckets
                              if b <= self.chunk_tokens]
        # stateful chunks are exact-length (an SSM state may not see pad
        # tokens); the dense decoder on dense slots prefills whole prompts
        self._chunkable_stateful = cfg.family in ("ssm", "hybrid")
        self._chunkable = self.paged or self._chunkable_stateful
        # "auto" starts from the provisional 2 chunks; on the paged plane
        # warmup() refines it from timed chunk and decode walls
        self._budget_auto = budget_auto
        self.prefill_budget = 2 * self.chunk_tokens \
            if prefill_budget is None or self._budget_auto \
            else int(prefill_budget)

        self.queue: List[Request] = []
        self.active: Dict[int, Request] = {}
        self.completed: Dict[int, Request] = {}
        self.failed: Dict[int, Request] = {}
        self.last_tokens = torch.zeros((max_slots,), dtype=torch.int32,
                                       device=self.device)
        self._rid = itertools.count()
        self.ticks = 0
        self.chunks_run = 0           # prefill chunks of traffic (not warmup)
        self.decode_steps = 0         # decode launches of traffic
        self.dispatch_stats = DispatchStats()
        # per tick: (prefill_s, decode_s, prefill_tokens, decode_rows,
        # decode_tokens)
        self._tick_log: collections.deque = collections.deque(maxlen=512)
        self._warm = False
        self.warmup_s = 0.0

        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._tick = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._running = False

        # ---- speculative decoding --------------------------------------
        self.spec_k_max = int(spec_k_max)
        self._draft: Optional[DraftSpeculator] = None
        self._spec_disabled_reason: Optional[str] = None
        self.spec_proposed = 0        # draft tokens offered to the target
        self.spec_accepted = 0        # draft tokens the target kept
        self.spec_rounds = 0          # verify launches
        self.draft_ticks = 0          # draft propose launches
        if draft_cfg is not None:
            if not self.paged:
                raise ValueError(
                    "speculative decoding needs the paged data plane "
                    f"(family={cfg.family!r}, paged={paged!r})")
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab_size} != target vocab "
                    f"{cfg.vocab_size}: the models must share a tokenizer")
            if not 1 <= self.spec_k_max < MAX_K1:
                raise ValueError(f"spec_k_max must be in [1, {MAX_K1 - 1}] "
                                 f"(the verify kernel takes at most {MAX_K1}"
                                 f" query tokens), got {spec_k_max}")
            self._draft = DraftSpeculator(draft_cfg, max_slots, max_seq,
                                          params=draft_params, seed=seed + 1,
                                          device=self.device)

    # ------------------------------------------------------------ steps
    def _chunk(self, tokens, table_row, start, new_len):
        """One prefill chunk straight into the request's pages → logits."""
        with torch.no_grad():
            return self.model.prefill_chunk(
                self._run_params, {"tokens": tokens}, self.kv.pools, start,
                new_len, page_table=table_row)

    def _chunk_stateful(self, staging, tokens, start, new_len):
        """One exact-length chunk resuming a batch-1 staging cache →
        logits."""
        with torch.no_grad():
            return self.model.prefill_chunk(
                self._run_params, {"tokens": tokens}, staging, start,
                new_len)

    def _prefill(self, tokens, last_index):
        """Monolithic prefill of a right-padded prompt into a fresh batch-1
        cache (the dense decoder on dense slots) → (logits, cache)."""
        staging = self.model.init_caches(1, self.max_seq, self.cfg.cdtype)
        with torch.no_grad():
            logits, _ = self.model.prefill(self._run_params,
                                           {"tokens": tokens}, staging,
                                           last_index)
        return logits, staging

    def _decode(self, tokens, cache_len, active, caches=None):
        """One decode step for every slot of either plane (``caches``
        defaults to the live pools or slot tree) → (next tokens, new
        lengths); inactive rows keep their token and length."""
        with torch.no_grad():
            if self.paged:
                logits = self.model.decode_paged(
                    self._run_params, tokens, self.kv.pools,
                    self.kv.page_table, cache_len)
            else:
                logits = self.model.decode(
                    self._run_params, tokens,
                    self.kv.caches if caches is None else caches, cache_len)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            nxt = torch.where(active, nxt, tokens)
            new_len = torch.where(active, cache_len + 1, cache_len)
        return nxt, new_len

    def _verify(self, page_table, tokens_blk, cache_len, last_tokens,
                active):
        """Target-verify one speculative block → (tgt, acc, nxt, new_len).

        ``tokens_blk`` [B, K1=k+1] is ``[last, d1..dk]`` per row; their KV
        lands at ``cache_len..cache_len+k``.  ``acc`` counts the leading
        drafts that match the target's greedy choice, ``nxt`` is the
        target's token at the first disagreement (the plain greedy
        continuation when every draft matched), and the new length winds
        back past the rejected suffix."""
        with torch.no_grad():
            logits = self.model.verify_paged(self._run_params, tokens_blk,
                                             self.kv.pools, page_table,
                                             cache_len)
            tgt = torch.argmax(logits, dim=-1).to(torch.int32)    # [B, K1]
            match = (tgt[:, :-1] == tokens_blk[:, 1:]).to(torch.int32)
            acc = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
            acc = torch.where(active, acc, 0)
            new_len = torch.where(active, cache_len + 1 + acc, cache_len)
            nxt = torch.gather(tgt, 1, acc[:, None].long())[:, 0]
            nxt = torch.where(active, nxt, last_tokens)
        return tgt, acc, nxt, new_len

    def _i32(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int32),
                               device=self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- warmup
    def warmup(self) -> "ServingEngine":
        """Run the decode step and the prefill shapes once before traffic
        (first CUDA launches, kernel builds, library handles): every chunk
        bucket on the paged plane, with a draft also every speculative
        depth's propose and verify and every draft prefill bucket; one
        chunk or every prompt bucket on dense slots.

        State-neutral: paged chunks run against an all-zero table row with
        ``new_len = 0`` (every token is masked padding, every write lands
        on the trash page), decode, propose and verify run with an
        all-inactive mask, and the draft lengths go back to 0 after the
        prefills wrote slot 0's scratch.  On dense slots the chunks and the
        decode step run on scratch caches of the same shapes, so the slot
        tree is not touched.  With ``prefill_budget="auto"`` on the paged
        plane it then sets the budget from timed runs
        (``_autotune_budget``).  Idempotent."""
        with self._lock:
            if self._warm:
                return self
            t0 = time.monotonic()
            zero1 = self._i32([0])
            inactive = torch.zeros((self.max_slots,), dtype=torch.bool,
                                   device=self.device)
            if self.paged:
                row = torch.zeros((1, self.kv.pages_per_slot),
                                  dtype=torch.int32, device=self.device)
                for b in self.chunk_buckets:
                    self._chunk(torch.zeros((1, b), dtype=torch.int32,
                                            device=self.device),
                                row[:, :self._kv_span_pages(b)], zero1,
                                zero1)
                self.last_tokens, self.kv.cache_len = self._decode(
                    self.last_tokens, self.kv.cache_len, inactive)
            else:
                def zeros(b):
                    return torch.zeros((1, b), dtype=torch.int32,
                                       device=self.device)

                if self._chunkable_stateful:
                    self._chunk_stateful(
                        self.model.init_caches(1, self.max_seq,
                                               self.cfg.cdtype),
                        zeros(self.chunk_tokens), zero1, zero1)
                else:
                    for b in self.buckets:
                        self._prefill(zeros(b), zero1)
                self._decode(self.last_tokens, self.kv.cache_len, inactive,
                             caches=self.model.init_caches(
                                 self.max_slots, self.max_seq,
                                 self.cfg.cdtype))
            if self._draft is not None:
                for kk in range(1, self.spec_k_max + 1):
                    drafts = self._draft.propose(self.last_tokens, inactive,
                                                 kk)
                    blk = torch.cat([self.last_tokens[:, None], drafts], 1)
                    _, _, self.last_tokens, self.kv.cache_len = self._verify(
                        self.kv.page_table, blk, self.kv.cache_len,
                        self.last_tokens, inactive)
                for b in self.buckets:
                    self._draft.prefill(np.zeros((b,), np.int32), 0)
                self._draft.kv.cache_len.zero_()
            self._sync()
            if self._budget_auto and self.paged:
                self._autotune_budget()
            self.warmup_s = time.monotonic() - t0
            self._warm = True
        return self

    def _autotune_budget(self):
        """Refine ``prefill_budget`` from timed walls (the first launches
        are behind us): as many chunk-tokens a tick as keep the prefill
        phase within about 4 decode steps' wall, clamped to [1, 8] chunks,
        so decode latency stays flat without starving prompt streaming.
        The minimum of two runs of one ``chunk_tokens`` chunk and of one
        decode step, each synchronised on both sides (a launch on the
        card returns before the device is done), and state-neutral as
        the warmup's runs are: an all-zero table row with ``new_len = 0``
        and an all-inactive decode."""
        b = self.chunk_tokens
        row = torch.zeros((1, self._kv_span_pages(b)), dtype=torch.int32,
                          device=self.device)
        tokens = torch.zeros((1, b), dtype=torch.int32, device=self.device)
        zero1 = self._i32([0])
        inactive = torch.zeros((self.max_slots,), dtype=torch.bool,
                               device=self.device)
        chunk_wall = decode_wall = float("inf")
        for _ in range(2):                       # min of 2: absorb jitter
            self._sync()
            t = time.monotonic()
            self._chunk(tokens, row, zero1, zero1)
            self._sync()
            chunk_wall = min(chunk_wall, time.monotonic() - t)
            t = time.monotonic()
            self.last_tokens, self.kv.cache_len = self._decode(
                self.last_tokens, self.kv.cache_len, inactive)
            self._sync()
            decode_wall = min(decode_wall, time.monotonic() - t)
        chunks = max(1, min(8, round(4 * decode_wall / max(chunk_wall,
                                                           1e-9))))
        self.prefill_budget = chunks * b

    # ------------------------------------------------------- loop lifecycle
    @property
    def loop_running(self) -> bool:
        return self._running and self._thread is not None \
            and self._thread.is_alive()

    def start(self) -> "ServingEngine":
        """Start the background engine loop (idempotent)."""
        with self._lock:
            if self.loop_running:
                return self
            self._running = True
            self._thread = threading.Thread(
                target=self._loop, name=f"engine-loop-{id(self):x}",
                daemon=True)
            self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = 30.0):
        """Stop the loop thread; by default finish in-flight work first."""
        if drain and self.loop_running:
            self.drain(timeout=timeout)
        with self._lock:
            self._running = False
            self._work.notify_all()
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout)

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=exc[0] is None)

    def _loop(self):
        while True:
            with self._lock:
                while self._running and not self.queue and not self.active:
                    self._work.wait(timeout=0.5)
                if not self._running:
                    return
            try:
                self.step()
            except Exception:  # noqa: BLE001 — step fails the offending
                # requests itself; back off rather than hot-spin if
                # something still escapes
                time.sleep(0.05)

    def drain(self, timeout: Optional[float] = None) -> List[Request]:
        """Block until the queue and active set are empty."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while self.queue or self.active:
                if not self.loop_running:
                    self.step()
                    continue
                wait = 0.1 if deadline is None else \
                    min(0.1, deadline - time.monotonic())
                if wait <= 0 or not self._tick.wait(timeout=wait):
                    if deadline is not None and \
                            time.monotonic() >= deadline:
                        raise TimeoutError(
                            f"engine drain timed out: {len(self.queue)} "
                            f"queued, {len(self.active)} active")
            return list(self.completed.values())

    def _drive(self, req: Request, timeout: Optional[float] = None
               ) -> Request:
        """Caller-driven mode: step until ``req`` completes (or fails)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not req.future.done():
            with self._lock:
                if self.loop_running:
                    break
                self.step()
                if not req.future.done() and not self.queue \
                        and not self.active:
                    raise RuntimeError(
                        f"request {req.rid} cannot complete: engine idle")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"request {req.rid} timed out")
        return req.future.result(timeout)

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 16,
               eos_token: Optional[int] = None,
               latency_slo_ms: float = 0.0,
               qos: str = "burstable") -> RequestHandle:
        """Enqueue a request; invalid prompts raise ``ValueError`` here,
        never inside the loop thread."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1:
            raise ValueError(f"prompt must be 1-D, got shape {prompt.shape}")
        if prompt.size == 0:
            raise ValueError("empty prompt: prefill needs >= 1 token")
        if prompt.size > self.max_seq:
            raise ValueError(f"prompt length {prompt.size} exceeds max_seq "
                             f"{self.max_seq}")
        if qos not in _QOS_RANK:
            raise ValueError(f"unknown qos {qos!r}; "
                             f"expected one of {sorted(_QOS_RANK)}")
        req = Request(next(self._rid), prompt, max_new_tokens, eos_token,
                      latency_slo_ms, qos, submitted_at=time.monotonic(),
                      future=Future())
        with self._lock:
            self.queue.append(req)
            self._work.notify_all()
        return RequestHandle(self, req)

    def release_prefix_cache(self) -> int:
        """Drop every unpinned radix node, returning its pages."""
        with self._lock:
            return 0 if self.prefix is None else self.prefix.clear(self.kv)

    def _fail(self, req: Request, err: Exception):
        req.done = True
        req.error = str(err)
        req.finished_at = time.monotonic()
        self.failed[req.rid] = req
        if req.future is not None and not req.future.done():
            req.future.set_exception(err)
        self._tick.notify_all()

    def _fail_all(self, err: Exception):
        """A step that writes the SHARED pools failed: every admitted
        request's cache is suspect, so fail them all through their
        futures instead of ticking on."""
        for req in list(self.active.values()):
            self._release(req)
            del self.active[req.rid]
            self._fail(req, err)

    def _release(self, req: Request):
        """Return the request's slot and pages; unpin its radix nodes."""
        if req.slot is not None:
            self.kv.free(req.slot)
            req.slot = None
        if req.shared_nodes:
            if self.prefix is not None:
                self.prefix.unpin(req.shared_nodes)
            req.shared_nodes = []
        req.table_row = None
        req.staging = None

    # ---------------------------------------------------- prefix matching
    def _match_prefix(self, prompt: np.ndarray):
        """``(pins, shared_pages, cow_src, w)``: ``w`` resident prompt
        tokens (at most ``plen - 1``, so prefill always runs a token),
        the ``w // page_size`` whole pages to attach, and the page to
        copy-seed from when ``w`` ends mid-page."""
        plen = len(prompt)
        m = self.prefix.match(prompt)
        w = min(m.matched_tokens, plen - 1)
        ps = self.kv.page_size
        boundary = w // ps
        chain = m.nodes[:boundary]
        shared = [n.page for n in chain]
        pins = list(chain)
        cow_src = None
        if w > boundary * ps:
            cow_node = m.nodes[boundary] if boundary < len(m.nodes) \
                else m.tail
            cow_src = cow_node.page
            pins.append(cow_node)
        return pins, shared, cow_src, w

    # ---------------------------------------------------------- admission
    def _admit(self):
        """Move queued requests into prefill while slots (and pages) last,
        in SLO-slack order, stopping at the first that does not fit.
        Paged admission reserves the prompt + one decode token (marginal
        pages); on dense slots a stateful request gets its staging
        cache."""
        if len(self.queue) > 1:
            now = time.monotonic()
            self.queue.sort(key=lambda r: slo_slack(r, now))
        while self.queue:
            req = self.queue[0]
            plen = len(req.prompt)
            if plen == 0 or plen > self.max_seq:
                self.queue.pop(0)
                self._fail(req, ValueError(
                    f"prompt length {plen} outside (0, {self.max_seq}]"))
                continue
            if not self.kv.free_slots:
                break
            if not self.paged:
                self.queue.pop(0)
                req.slot = self.kv.alloc()
                if self._chunkable_stateful:
                    req.staging = self.model.init_caches(1, self.max_seq,
                                                         self.cfg.cdtype)
                self._start_prefill(req)
                continue
            pins, shared, cow_src, w = [], [], None, 0
            if self.prefix is not None:
                pins, shared, cow_src, w = self._match_prefix(req.prompt)
                self.prefix.pin(pins)
            n_alloc = min(plen + 1, self.max_seq)
            got = self.kv.alloc(n_alloc, shared_pages=shared,
                                cow_src=cow_src)
            if got is None and self.prefix is not None:
                deficit = (self.kv.pages_needed(n_alloc) - len(shared)
                           - len(self.kv.free_pages))
                if deficit > 0 and \
                        self.prefix.evict(self.kv, deficit) >= deficit:
                    got = self.kv.alloc(n_alloc, shared_pages=shared,
                                        cow_src=cow_src)
            if got is None:
                if self.prefix is not None:
                    self.prefix.unpin(pins)
                break
            req.slot, req.table_row = got
            req.shared_nodes = pins
            req.kv_shared_tokens = w
            if self.prefix is not None:
                if w:
                    self.kv_prefix_hits += 1
                else:
                    self.kv_prefix_misses += 1
            self.queue.pop(0)
            self._start_prefill(req)

    def _start_prefill(self, req: Request):
        req.phase = "prefill"
        req.pos = req.kv_shared_tokens         # resume after the shared part
        req.admitted_at = time.monotonic()
        self.active[req.rid] = req

    # ------------------------------------------------------ prefill phase
    def _chunk_plan(self, req: Request):
        """(bucket, real): paged, full chunks of ``chunk_tokens``, then the
        smallest bucket covering the tail (right-padded); stateful, exact
        chunks of at most ``chunk_tokens`` (no bucket); the dense decoder
        on dense slots, the whole prompt."""
        remaining = len(req.prompt) - req.pos
        if not self._chunkable:
            return len(req.prompt), len(req.prompt)
        if self._chunkable_stateful:
            return None, min(self.chunk_tokens, remaining)
        if remaining >= self.chunk_tokens:
            return self.chunk_tokens, self.chunk_tokens
        return next(b for b in self.buckets if b >= remaining), remaining

    def _kv_span_pages(self, valid_len: int) -> int:
        """Pages covering the smallest pow2 bucket ≥ ``valid_len`` — the
        KV span a prefill chunk gathers and attends over."""
        span = next(b for b in self.buckets if b >= valid_len)
        return -(-span // self.kv.page_size)

    def _run_chunk(self, req: Request) -> int:
        """Run one prefill chunk (or the whole prompt on dense slots when
        the family cannot chunk); returns the real prompt tokens it
        processed.  On error every active request fails on the paged plane
        (the chunk wrote the shared pools); on dense slots only this one
        (the chunk wrote its own staging cache)."""
        plen = len(req.prompt)
        bucket, real = self._chunk_plan(req)
        start = req.pos
        try:
            if self.paged:
                padded = np.zeros((1, bucket), np.int32)
                padded[0, :real] = req.prompt[start:start + real]
                kv_pages = self._kv_span_pages(start + real)
                logits = self._chunk(self._i32(padded),
                                     req.table_row[:, :kv_pages],
                                     self._i32([start]),
                                     self._i32([start + real]))
            elif self._chunkable_stateful:
                logits = self._chunk_stateful(
                    req.staging,
                    self._i32(req.prompt[None, start:start + real]),
                    self._i32([start]), self._i32([start + real]))
            else:
                bucket = next(b for b in self.buckets if b >= plen)
                padded = np.zeros((1, bucket), np.int32)
                padded[0, :plen] = req.prompt
                logits, req.staging = self._prefill(self._i32(padded),
                                                    self._i32([plen - 1]))
            first = None
            if start + real >= plen:
                first = int(torch.argmax(logits, dim=-1)[0])
        except Exception as e:  # noqa: BLE001 — surfaces via the futures
            if self.paged:
                self._fail_all(e)
            else:
                self._release(req)
                del self.active[req.rid]
                self._fail(req, e)
            return 0
        self.chunks_run += 1
        req.pos += real
        req.chunks += 1
        if first is None:
            return real
        # ---- prompt complete: publish the cache and enter decode --------
        if self.paged:
            self.kv.install(req.slot, req.table_row, plen)
        else:
            self.kv.insert(req.staging, req.slot, plen)
            req.staging = None
        self.last_tokens[req.slot] = first
        if self._draft is not None and req.max_new_tokens > 1:
            # mirror the prompt into the draft's slot so the first
            # speculative tick starts in sync; a draft failure turns
            # speculation off and never fails the request, unless a
            # kernel failed to build or launch
            try:
                self._draft.prefill(req.prompt, req.slot)
            except KernelError as e:
                self._fail_all(e)
                return real
            except Exception as e:  # noqa: BLE001 — the draft's cache is
                # its own; the target's pools are untouched
                self._disable_spec(f"draft prefill: {e}")
        req.generated.append(first)
        now = time.monotonic()
        req.first_token_at = now
        req.phase = "decode"
        if (req.eos_token is not None and first == req.eos_token) or \
                req.max_new_tokens <= 1:
            self._finish(req, now)
        return real

    def _prefill_tick(self) -> int:
        """Up to ``prefill_budget`` prompt tokens of chunks, round-robin
        over prefilling requests in SLO-slack order."""
        pref = [r for r in self.active.values() if r.phase == "prefill"]
        if not pref:
            return 0
        now = time.monotonic()
        pref.sort(key=lambda r: slo_slack(r, now))
        budget = self.prefill_budget
        total = 0
        progressed = True
        while budget > 0 and pref and progressed:
            progressed = False
            for req in list(pref):
                if budget <= 0:
                    break
                if req.rid not in self.active:   # failed by a batch error
                    pref.remove(req)
                    continue
                cost = self._chunk_plan(req)[1]
                if cost > budget and total > 0:
                    continue                    # wait for a fresh budget
                done = self._run_chunk(req)
                total += done
                budget -= max(done, 1)
                progressed = True
                if req.phase != "prefill":
                    pref.remove(req)
        return total

    # ----------------------------------------------- on-demand page growth
    def _requeue(self, victim: Request):
        """Preempt: release the victim and re-run it from scratch at the
        queue head (its future stays pending; greedy decode reproduces
        the same tokens)."""
        self.preemptions += 1
        self._release(victim)
        self.active.pop(victim.rid, None)
        victim.phase = "queued"
        victim.pos = 0
        victim.chunks = 0
        victim.generated = []
        victim.first_token_at = None
        victim.admitted_at = None
        victim.kv_shared_tokens = 0
        self.queue.insert(0, victim)

    def _preempt_for(self, req: Request) -> Optional[Request]:
        """Requeue one strictly-lower-QoS active request (lowest rank,
        youngest first); ``None`` when nothing ranks below ``req``."""
        rank = _QOS_RANK.get(req.qos, 1)
        victims = [r for r in self.active.values()
                   if r.rid != req.rid and _QOS_RANK.get(r.qos, 1) < rank]
        if not victims:
            return None
        victim = min(victims, key=lambda r: (_QOS_RANK.get(r.qos, 1),
                                             -(r.admitted_at or 0.0)))
        self._requeue(victim)
        return victim

    def _grow_decode_pages(self, dec: List[Request], span: int = 1) -> set:
        """Give each decoding row about to write past its last page the
        pages it needs: free list, then radix eviction, then preemption of
        a lower-QoS request; a row that still lacks one stalls this tick.
        ``span`` is how many consecutive KV positions the tick writes: 1
        for plain decode, k+1 for a speculative tick, which can cross more
        than one page boundary.  Returns the stalled rids."""
        stalled = set()
        order = sorted(dec, key=lambda r: (-_QOS_RANK.get(r.qos, 1),
                                           r.admitted_at or 0.0))
        for req in order:
            if req.rid not in self.active:       # preempted below us
                continue
            # decode writes KV at cache_len = plen + generated - 1
            pos = len(req.prompt) + len(req.generated) - 1
            if pos >= self.max_seq:
                continue
            last = min(pos + span - 1, self.max_seq - 1)
            need = last // self.kv.page_size + 1
            ok = True
            while len(self.kv.slot_pages[req.slot]) < need:
                if self.kv.append_page(req.slot) is not None:
                    continue
                if self.prefix is not None and \
                        self.prefix.evict(self.kv, 1) and \
                        self.kv.append_page(req.slot) is not None:
                    continue
                if self._preempt_for(req) is not None and \
                        self.kv.append_page(req.slot) is not None:
                    continue
                ok = False
                break
            if not ok:
                stalled.add(req.rid)
                self.decode_stalls += 1
        # deadlock valve: every row stalled and no prefill under way →
        # requeue the lowest-QoS youngest so the rest make progress
        still = [r for r in dec if r.rid in self.active
                 and r.phase == "decode"]
        if stalled and len(stalled) == len(still) and \
                not any(r.phase == "prefill" for r in self.active.values()):
            victim = min(still, key=lambda r: (_QOS_RANK.get(r.qos, 1),
                                               -(r.admitted_at or 0.0)))
            self._requeue(victim)
            stalled.discard(victim.rid)
            for req in still:
                if req.rid in stalled and \
                        self.kv.append_page(req.slot) is not None:
                    stalled.discard(req.rid)
        return stalled

    # -------------------------------------------------- speculative decode
    def _disable_spec(self, reason: str):
        self._draft = None
        self._spec_disabled_reason = reason

    def _spec_k(self, dec: List[Request]) -> int:
        """Batch draft length for this tick: the min over rows of each
        request's EMA-preferred k, clamped so the k+1 verify positions fit
        under ``max_seq`` for every row.  < 1 → a normal tick."""
        k = self.spec_k_max
        for r in dec:
            pos = len(r.prompt) + len(r.generated) - 1
            room = self.max_seq - 1 - pos     # need pos + k <= max_seq - 1
            pref = max(1, round(r.spec_ema * self.spec_k_max))
            k = min(k, pref, room)
        return k

    def _spec_decode_tick(self, dec: List[Request],
                          k: int) -> Optional[Tuple[int, int]]:
        """One speculative tick: the draft proposes k tokens per decoding
        row, the target verifies all k+1 positions in one paged pass, and
        the accepted prefix plus the target's correction token commit.
        Returns ``(rows, committed_tokens)``, or ``None`` when the draft
        failed: speculation turns itself off and the caller serves the
        batch with a normal tick.  A ``KernelError`` from the draft fails
        the batch instead."""
        stalled = self._grow_decode_pages(dec, span=k + 1)
        dec = [r for r in dec if r.rid in self.active
               and r.phase == "decode" and r.rid not in stalled]
        if not dec:
            return 0, 0
        active_mask = np.zeros((self.max_slots,), bool)
        for req in dec:
            active_mask[req.slot] = True
        active = torch.as_tensor(active_mask, device=self.device)
        try:
            drafts = self._draft.propose(self.last_tokens, active, k)
            self.draft_ticks += 1
        except KernelError as e:
            # a kernel that fails to build or launch is a fault of the
            # build or the card, which serving on without speculation
            # would hide: fail the batch, as a failed verify does
            self._fail_all(e)
            return 0, 0
        except Exception as e:  # noqa: BLE001 — the draft writes only its
            # own cache; the target's pools are untouched, so serve on
            # without speculation instead of failing the batch
            self._disable_spec(f"draft propose: {e}")
            return None
        tokens_blk = torch.cat([self.last_tokens[:, None], drafts], dim=1)
        try:
            tgt, acc, nxt, new_len = self._verify(
                self.kv.page_table, tokens_blk, self.kv.cache_len,
                self.last_tokens, active)
            self.kv.cache_len = new_len
            self.last_tokens = nxt
            self._draft.observe(new_len, active)
            # ONE device sync per tick (not one per request)
            tgt_np = tgt.cpu().numpy()
            drafts_np = drafts.cpu().numpy()
            accs = acc.cpu().numpy()
            clens = new_len.cpu().numpy()
        except Exception as e:  # noqa: BLE001 — verify writes the SHARED
            # pools: the same blast radius as a failed decode
            self._fail_all(e)
            return 0, 0
        now = time.monotonic()
        committed_total = 0
        finished = []
        for req in dec:
            a = int(accs[req.slot])
            committed = [int(x) for x in drafts_np[req.slot, :a]]
            committed.append(int(tgt_np[req.slot, a]))
            self.spec_proposed += k
            self.spec_accepted += a
            req.spec_ema = 0.7 * req.spec_ema + 0.3 * (a / k)
            for t in committed:
                req.generated.append(t)
                committed_total += 1
                if (req.eos_token is not None and t == req.eos_token) or \
                        len(req.generated) >= req.max_new_tokens:
                    finished.append(req)
                    break
            else:
                if int(clens[req.slot]) >= self.kv.max_seq - 1:
                    finished.append(req)
        self.spec_rounds += 1
        self.dispatch_stats.set_extra("speculation", {
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "acceptance_rate": self.spec_accepted / self.spec_proposed
            if self.spec_proposed else 0.0,
            "draft_ticks": self.draft_ticks,
        })
        for req in finished:
            self._finish(req, now)
        return len(dec), committed_total

    # ------------------------------------------------------- decode phase
    def _decode_tick(self) -> Tuple[int, int]:
        """Advance the decode batch; (rows, tokens committed).  A
        speculative tick commits up to k+1 tokens per row, a normal tick
        exactly one."""
        dec = [r for r in self.active.values() if r.phase == "decode"]
        if not dec:
            return 0, 0
        if self._draft is not None:
            k = self._spec_k(dec)
            if k >= 1:
                out = self._spec_decode_tick(dec, k)
                if out is not None:
                    return out
                # the draft failed mid-tick: growth may have requeued
                # rows, so recompute the batch and serve it normally
                dec = [r for r in self.active.values()
                       if r.phase == "decode"]
                if not dec:
                    return 0, 0
        if self.paged:
            stalled = self._grow_decode_pages(dec)
            dec = [r for r in dec if r.rid in self.active
                   and r.phase == "decode" and r.rid not in stalled]
            if not dec:
                return 0, 0
        active_mask = np.zeros((self.max_slots,), bool)
        for req in dec:
            active_mask[req.slot] = True
        try:
            tokens, new_len = self._decode(
                self.last_tokens, self.kv.cache_len,
                torch.as_tensor(active_mask, device=self.device))
            self.kv.cache_len = new_len
            self.last_tokens = tokens
            self.decode_steps += 1
            # ONE device sync per tick (not one per request)
            toks = tokens.cpu().numpy()
            clens = new_len.cpu().numpy()
        except Exception as e:  # noqa: BLE001 — a decode error poisons the
            # shared pools or slot tree for every admitted request
            self._fail_all(e)
            return 0, 0
        now = time.monotonic()
        finished = []
        for req in dec:
            t = int(toks[req.slot])
            req.generated.append(t)
            if (req.eos_token is not None and t == req.eos_token) or \
                    len(req.generated) >= req.max_new_tokens or \
                    int(clens[req.slot]) >= self.kv.max_seq - 1:
                finished.append(req)
        for req in finished:
            self._finish(req, now)
        return len(dec), len(dec)

    # ---------------------------------------------------------------- tick
    def step(self) -> int:
        """One tick under the engine lock: admit, budgeted prefill chunks,
        one decode for every decoding slot.  Returns the active count."""
        with self._lock:
            self._admit()
            if not self.active:
                self._tick.notify_all()
                return 0
            t0 = time.monotonic()
            prefill_tokens = self._prefill_tick()
            t1 = time.monotonic()
            decode_rows, decode_tokens = self._decode_tick()
            t2 = time.monotonic()
            if prefill_tokens or decode_rows:
                self.ticks += 1
                self._tick_log.append((t1 - t0, t2 - t1, prefill_tokens,
                                       decode_rows, decode_tokens))
            self._tick.notify_all()
            return len(self.active)

    def _finish(self, req: Request, now: float):
        req.done = True
        req.finished_at = now
        if self.prefix is not None and req.slot is not None:
            # donate the written pages (prompt + generated[:-1]; the last
            # token's KV is never written) to the radix before release
            cached = min(len(req.prompt) + max(len(req.generated) - 1, 0),
                         self.max_seq)
            tokens = np.concatenate(
                [req.prompt,
                 np.asarray(req.generated[:-1], np.int32)])[:cached]
            self.prefix.insert(tokens, self.kv.slot_pages[req.slot],
                               self.kv)
        self._release(req)
        del self.active[req.rid]
        self.completed[req.rid] = req
        self.dispatch_stats.record(DispatchSample(
            workload=f"request-{req.rid}", workload_class="heavy",
            executor_class="container", executor="serving-engine",
            node="local", wall_s=now - req.submitted_at, cold=False,
            footprint_bytes=self.kv.bytes_in_use()))
        if req.future is not None and not req.future.done():
            req.future.set_result(req)

    def run_until_drained(self, max_ticks: int = 10_000) -> List[Request]:
        if self.loop_running:
            return self.drain()
        for _ in range(max_ticks):
            with self._lock:
                if not self.queue and not self.active:
                    break
            self.step()
        with self._lock:
            return list(self.completed.values())

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        with self._lock:
            done = list(self.completed.values())
            out = {
                "ticks": self.ticks,
                "prefill_chunks": self.chunks_run,
                "decode_steps": self.decode_steps,
                "active": len(self.active),
                "queued": len(self.queue),
                "failed": len(self.failed),
                "slot_utilization": self.kv.utilization(),
                "paged": self.paged,
                "device": str(self.device),
                "kv_dtype": str(self.kv_dtype).replace("torch.", ""),
                "kv_bytes_in_use": self.kv.bytes_in_use(),
                "kv_capacity_bytes": self.kv.capacity_bytes(),
                "kv_dense_equivalent_bytes":
                    self.kv.dense_equivalent_bytes(),
                # speculative decoding (zeros while off or disabled)
                "speculative": self._draft is not None,
                "spec_proposed": self.spec_proposed,
                "spec_accepted": self.spec_accepted,
                "acceptance_rate": self.spec_accepted / self.spec_proposed
                if self.spec_proposed else 0.0,
                "spec_rounds": self.spec_rounds,
                "draft_ticks": self.draft_ticks,
            }
            if self._spec_disabled_reason:
                out["spec_disabled_reason"] = self._spec_disabled_reason
            if self.paged:
                out.update({
                    "pages_in_use": self.kv.pages_in_use(),
                    "page_utilization": self.kv.page_utilization(),
                    "cow_copies": self.kv.cow_copies,
                    "kv_prefix_hits": self.kv_prefix_hits,
                    "kv_prefix_misses": self.kv_prefix_misses,
                    "preemptions": self.preemptions,
                    "decode_stalls": self.decode_stalls,
                    "kv_shared_pages_attached": sum(
                        self.kv.slot_shared.values()),
                })
            if self.prefix is not None:
                for k, v in self.prefix.stats().items():
                    out[f"radix_{k}"] = v
            ticks = list(self._tick_log)
        pre = [p for p, _d, ptoks, _n, _tk in ticks if ptoks]
        dec = [d for _p, d, _t, n, _tk in ticks if n]
        dec_tok = [d / tk for _p, d, _t, n, tk in ticks if n and tk]
        for name, xs in (("prefill_tick_s", pre), ("decode_tick_s", dec),
                         ("decode_s_per_token", dec_tok)):
            if xs:
                for q in (50, 95):
                    out[f"p{q}_{name}"] = percentile(xs, q)
        if ticks:
            out["max_prefill_tokens_tick"] = max(t[2] for t in ticks)
            out["decode_tokens_committed"] = sum(t[4] for t in ticks)
        ttfts = [r.first_token_at - r.submitted_at for r in done
                 if r.first_token_at is not None]
        queued = [r.admitted_at - r.submitted_at for r in done
                  if r.admitted_at is not None]
        walls = [r.finished_at - r.submitted_at for r in done
                 if r.finished_at is not None]
        for name, xs in (("ttft_s", ttfts), ("queue_s", queued),
                         ("request_wall_s", walls)):
            if xs:
                for q in (50, 95, 99):
                    out[f"p{q}_{name}"] = percentile(xs, q)
        return out


class EngineExecutor:
    """The control-plane wrapper of the engine (``repro.serving.engine.
    EngineExecutor``) comes with the ``core/`` port."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "EngineExecutor is not ported yet (ROADMAP Queue A item 9)")
