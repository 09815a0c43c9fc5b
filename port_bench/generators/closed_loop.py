"""Closed-loop sessions: each client sends its next turn when the answer
to the last one comes back.

Parameters (a traffic file's keys):

- ``clients``: how many clients run at once;
- ``header``: tokens of one instruction every client's every frame opens
  with (shared, so the prefix cache can hold it);
- ``image``: ``{"tokens"}``: each frame's image, that many ids from the
  configuration's ``image`` block, between its ``begin_image`` and
  ``end_image`` ids;
- ``question``: ``{"min", "max"}``, a uniform number of text ids;
- ``turns``: ``{"min", "max"}``, a uniform number of turns a frame; a
  follow-up is the whole previous prompt, the answer it got and a new
  question;
- ``answer``: ``{"median", "sigma", "min", "max"}``, a clipped lognormal,
  the tokens each turn asks for;
- ``stagger_s``: the clients start their first frames one after another,
  evenly over this many seconds from the traffic's start (camera workers
  do not start on one clock edge, and a burst of every client's first
  image would keep the window in its transient);
- ``pool``: how many frame shapes are drawn; ``shape_seed``: their seed;
- ``check_tokens``, ``check_requests``: as in ``open_loop``.

Every seed gets the same work: the frame shapes (turns, question and
answer lengths) are drawn once from ``shape_seed``; the clients' k-th
frames are the pool's k-th block of ``clients`` shapes under every seed,
and the run's seed only rotates which client takes which of them and
draws the token ids.
"""
from __future__ import annotations

import numpy as np

from benchlib.draws import lognormal

LOOP = "closed"


class Frames:
    """``frame(client, k)``: the k-th frame of a client, ``{"image": ids,
    "turns": [(question ids, answer tokens), ...]}``; ``header``: the
    shared instruction."""

    def __init__(self, traffic: dict, vocab: dict, seed: int):
        shape = np.random.default_rng(traffic["shape_seed"])
        n = traffic["pool"]
        turns = shape.integers(traffic["turns"]["min"],
                               traffic["turns"]["max"] + 1, size=n)
        total = int(turns.sum())
        qlen = shape.integers(traffic["question"]["min"],
                              traffic["question"]["max"] + 1, size=total)
        alen = lognormal(shape, traffic["answer"], total)
        ends = np.cumsum(turns)
        self._shapes = [list(zip(qlen[e - t:e], alen[e - t:e]))
                        for t, e in zip(turns, ends)]
        self._shift = int(np.random.default_rng(int(seed)).integers(
            traffic["clients"]))
        self._seed = int(seed)
        self._t = traffic
        self._v = vocab
        self.clients = traffic["clients"]
        lo, hi = vocab["text"]
        self.header = np.random.default_rng([self._seed, 0]).integers(
            lo, hi, size=traffic["header"]).astype(np.int32)

    def start_s(self, client: int) -> float:
        """When the client sends its first frame, from the traffic's
        start."""
        return self._t["stagger_s"] * client / self.clients

    def frame(self, client: int, k: int) -> dict:
        i = (k * self.clients + (client + self._shift) % self.clients) \
            % len(self._shapes)
        rng = np.random.default_rng([self._seed, 1, client, k])
        ilo, ihi = self._v["image"]
        image = np.concatenate([
            [self._v["begin_image"]],
            rng.integers(ilo, ihi, size=self._t["image"]["tokens"]),
            [self._v["end_image"]]]).astype(np.int32)
        lo, hi = self._v["text"]
        turns = [(rng.integers(lo, hi, size=int(q)).astype(np.int32),
                  int(a)) for q, a in self._shapes[i]]
        return {"image": image, "turns": turns}


def generate(traffic: dict, vocab: dict, seed: int, **_) -> Frames:
    return Frames(traffic, vocab, seed)
