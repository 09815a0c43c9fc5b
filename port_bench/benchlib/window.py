"""What one window did, as the metric readers see it.

Built from the requests the harness sent and the two edge snapshots
(``serve.Edge``).  An open loop's window requests are those due inside
it; a closed loop's, those sent inside it.  A request that failed, or had
not finished when the harness stopped waiting (``closed_at``), counts in
every latency as the time from when it was due to ``closed_at``: it
misses any limit a run could meet.
"""
from __future__ import annotations

from typing import List, Optional

from benchlib import cost


class Window:
    def __init__(self, model: dict, engine: dict, sent: list, start, end,
                 closed_at: float, open_loop: bool, setup_s: float,
                 peak_bytes: int, profile: Optional[dict] = None):
        self.model = model
        self.engine = engine
        self.sent = sent
        self.start = start
        self.end = end
        self.closed_at = closed_at
        self.open_loop = open_loop
        self.setup_s = setup_s
        self.peak_bytes = peak_bytes
        self.profile = profile
        self.seconds = end.t - start.t
        if open_loop:
            self.requests = [s for s in sent
                             if start.t <= s.due < end.t]
        else:
            self.requests = [s for s in sent if start.t <= s.sent < end.t]
        self._work = None

    # ------------------------------------------------------- per request
    def lost(self) -> List:
        """Window requests that failed, or, in an open loop, never
        finished (a closed loop's window cuts its last turns short)."""
        if self.open_loop:
            return [s for s in self.requests if s.request() is None]
        return [s for s in self.requests if s.error() is not None]

    def _t0(self, s) -> float:
        return s.due if s.due is not None else s.sent

    def latencies_ms(self, field: str) -> List[float]:
        """``first_token_at`` or ``admitted_at`` minus the time each window
        request was due, in ms."""
        out = []
        for s in self.requests:
            r = s.request()
            t = getattr(r, field) if r is not None else None
            out.append(((t if t is not None else self.closed_at)
                        - self._t0(s)) * 1e3)
        return out

    def tpot_ms(self) -> List[float]:
        out = []
        for s in self.requests:
            r = s.request()
            if r is None:
                out.append((self.closed_at - self._t0(s)) * 1e3)
            elif len(r.generated) > 1:
                out.append((r.finished_at - r.first_token_at)
                           / (len(r.generated) - 1) * 1e3)
        return out

    def prefix_share(self) -> Optional[float]:
        shared = prompt = 0
        for s in self.requests:
            r = s.request()
            i = self.sent.index(s)
            shared += r.kv_shared_tokens if r is not None \
                else self.end.progress[i][2] if i < len(self.end.progress) \
                else 0
            prompt += len(s.prompt)
        return shared / prompt if prompt else None

    # ------------------------------------------------- work in the window
    def work(self) -> dict:
        """The work done between the edges, from each request's progress:
        ``chunks`` [(start, tokens)], decode ``rows`` (row-steps),
        ``keys`` (keys those rows attended), ``pages`` (pages holding
        them), ``steps`` (decode launches), ``ticks`` and ``tokens``
        committed."""
        if self._work is not None:
            return self._work
        C = self.engine["prefill_chunk"]
        ps = self.engine["page_size"]
        chunks, rows, keys, pages, tokens = [], 0, 0, 0, 0
        n0 = len(self.start.progress)
        n1 = len(self.end.progress)
        for i, s in enumerate(self.sent[:n1]):
            g0, p0, _ = self.start.progress[i] if i < n0 else (0, 0, 0)
            g1, p1, w = self.end.progress[i]
            plen = len(s.prompt)
            tokens += g1 - g0
            a = w
            while a < p1:
                n = min(C, plen - a)
                if a >= p0:
                    chunks.append((a, n))
                a += n
            for j in range(max(g0, 1) + 1, g1 + 1):
                k = plen + j - 1          # the cache and the new token
                rows += 1
                keys += k
                pages += -(-k // ps)
        self._work = {"chunks": chunks, "rows": rows, "keys": keys,
                      "pages": pages, "tokens": tokens,
                      "steps": self.end.decode_steps
                      - self.start.decode_steps,
                      "ticks": self.end.ticks - self.start.ticks,
                      "chunks_run": self.end.chunks_run
                      - self.start.chunks_run}
        return self._work

    def least_step_seconds(self) -> float:
        """The least time the card could have taken for the window's
        model steps: each prefill chunk's FLOPs over the peak, and the
        decode steps' FLOPs over the peak or their bytes over the
        bandwidth, whichever is larger (summed over the steps, which at
        these batches all lie on the bytes' side)."""
        m, w = self.model, self.work()
        t = sum(cost.chunk_flops(m, a, n) / cost.PEAK_FLOPS
                for a, n in w["chunks"])
        if w["steps"]:
            t += cost.step_seconds(
                cost.decode_flops(m, w["rows"], w["keys"]),
                cost.decode_bytes(m, w["steps"], w["rows"], w["keys"]))
        return t

    def kernel_s(self, name: str) -> Optional[float]:
        """Device seconds of the kernels whose name holds ``name``, from
        the trace; ``None`` without one or where none ran."""
        if not self.profile:
            return None
        t = sum(v for k, v in self.profile["kernel_s"].items() if name in k)
        return t or None
