"""The traffic generators: the same seed gives the same traffic, another
seed another order and other ids over the same sizes and gaps."""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from benchlib.spec import Cell  # noqa: E402

OPEN = ["nemotron-4-340b.chat", "nemotron-4-340b.docqa"]
SEED = 2 ** 31 + 11          # past 32 signed bits: seeds may be large


def _open(cell: str, seed: int, window_s: float = 30.0):
    c = Cell(cell)
    t = c.traffic
    return c.generator().generate(t, c.config["vocab"], seed,
                                  lead_s=t["lead_s"], window_s=window_s,
                                  tail_s=t["drain_s"])


def _key(plan):
    return [(r["offset_s"], r["max_new"], r["prompt"].tobytes())
            for r in plan["requests"]]


@pytest.mark.parametrize("cell", OPEN)
def test_open_loop_same_seed_same_traffic(cell):
    assert _key(_open(cell, SEED)) == _key(_open(cell, SEED))


@pytest.mark.parametrize("cell", OPEN)
def test_open_loop_other_seed_same_work_other_order(cell):
    a, b = _open(cell, SEED), _open(cell, SEED + 1)
    assert _key(a) != _key(b)
    for plan in (a, b):
        assert all(-30 <= r["offset_s"] for r in plan["requests"])

    def window(plan):
        return [r for r in plan["requests"] if 0 <= r["offset_s"] < 30.0]

    wa, wb = window(a), window(b)
    assert len(wa) == len(wb) > 0
    assert sorted(r["max_new"] for r in wa) == sorted(r["max_new"]
                                                      for r in wb)
    assert sorted(len(r["prompt"]) for r in wa) == sorted(
        len(r["prompt"]) for r in wb)
    # the same gaps and requests, the sequence rotated
    def seq(w):
        gaps = np.diff([0.0] + [r["offset_s"] for r in w])
        return [(round(g, 9), r["max_new"], len(r["prompt"]))
                for g, r in zip(gaps, w)]
    sa, sb = seq(wa), seq(wb)
    k = next(i for i in range(len(sa)) if sa[i:] + sa[:i] == sb)
    assert 0 <= k < len(sa)


def test_chat_sizes_and_rate():
    c = Cell("nemotron-4-340b.chat")
    t = c.traffic
    plan = _open("nemotron-4-340b.chat", SEED)
    win = [r for r in plan["requests"] if 0 <= r["offset_s"] < 30.0]
    assert len(win) == round(t["rate_rps"] * 30.0)
    lens = np.array([len(r["prompt"]) for r in plan["requests"]])
    assert lens.min() >= 32 and lens.max() <= 2048
    assert 200 < np.median(lens) < 700
    lo, hi = c.config["vocab"]["text"]
    ids = np.concatenate([r["prompt"] for r in plan["requests"]])
    assert ids.min() >= lo and ids.max() < hi
    assert not plan["preload"]


def test_docqa_documents_and_popularity():
    c = Cell("nemotron-4-340b.docqa")
    docs = c.traffic["docs"]
    plan = _open("nemotron-4-340b.docqa", SEED)
    assert len(plan["preload"]) == docs["count"]
    assert all(docs["min"] <= len(d) <= docs["max"]
               for d in plan["preload"])
    ranks = np.array([r["doc"] for r in plan["requests"]])
    counts = np.bincount(ranks, minlength=docs["count"])
    assert counts[0] > counts[-1]          # Zipf: the first is the most read
    for r in plan["requests"]:
        d = plan["preload"][r["doc"]]
        assert np.array_equal(r["prompt"][:len(d)], d)
        q = len(r["prompt"]) - len(d)
        assert c.traffic["prompt"]["min"] <= q <= c.traffic["prompt"]["max"]
    assert max(len(r["prompt"]) + r["max_new"] for r in plan["requests"]) \
        < c.config["engine"]["max_seq"]


def _frames(seed):
    c = Cell("chameleon-34b.camera-vqa")
    return c, c.generator().generate(c.traffic, c.config["vocab"], seed)


def test_closed_loop_frames():
    c, f = _frames(SEED)
    _, g = _frames(SEED)
    _, h = _frames(SEED + 1)
    v, t = c.config["vocab"], c.traffic
    assert f.clients == t["clients"] and len(f.header) == t["header"]
    a, b = f.frame(3, 5), g.frame(3, 5)
    assert np.array_equal(a["image"], b["image"])
    assert [(q.tobytes(), n) for q, n in a["turns"]] == \
        [(q.tobytes(), n) for q, n in b["turns"]]
    assert not np.array_equal(a["image"], h.frame(3, 5)["image"])
    img = a["image"]
    assert len(img) == t["image"]["tokens"] + 2
    assert img[0] == v["begin_image"] and img[-1] == v["end_image"]
    assert img[1:-1].min() >= v["image"][0] and \
        img[1:-1].max() < v["image"][1]
    assert t["turns"]["min"] <= len(a["turns"]) <= t["turns"]["max"]
    # every client starts within the stagger, in order
    assert f.start_s(0) == 0 and f.start_s(f.clients - 1) < t["stagger_s"]
    # the same pool of frame shapes under every seed, in another order
    def shapes(fr):
        return [tuple((len(q), n) for q, n in
                      fr.frame(i % fr.clients, i // fr.clients)["turns"])
                for i in range(t["pool"])]

    assert sorted(shapes(f)) == sorted(shapes(h)) and \
        shapes(f) != shapes(h)
    # each round of frames holds the same shapes under every seed
    first = sorted(shapes(f)[:f.clients])
    assert first == sorted(shapes(h)[:h.clients])
    longest = len(f.header) + len(img) + t["turns"]["max"] * (
        t["question"]["max"] + t["answer"]["max"])
    assert longest < c.config["engine"]["max_seq"]
