"""The harness's arithmetic on hand-made windows: latencies from the time
a request was due, percentiles over every request (a lost one misses),
tokens counted at the window's edges, the work of each chunk and decode
step, and the frozen cost formulas against counts made by hand."""
from __future__ import annotations

import sys
import threading
from concurrent.futures import Future
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from benchlib import cost, spec  # noqa: E402
from benchlib.serve import Edge, Sent, settle  # noqa: E402
from benchlib.stats import percentile  # noqa: E402
from benchlib.window import Window  # noqa: E402

MODEL = {"num_layers": 2, "d_model": 8, "num_heads": 4, "num_kv_heads": 2,
         "head_dim": 2, "d_ff": 16, "vocab_size": 10, "activation": "relu2",
         "norm": "layernorm", "qk_norm": False}
ENGINE = {"prefill_chunk": 4, "page_size": 2}


def _sent(plen, due, result=None, error=None, sent=None):
    f = Future()
    if result is not None:
        f.set_result(SimpleNamespace(**result))
    elif error is not None:
        f.set_exception(RuntimeError(error))
    return Sent(np.zeros(plen, np.int32), 8,
                SimpleNamespace(future=f, rid=0), due,
                due if sent is None else sent)


def _req(first, fin, n, admitted=None, shared=0):
    return {"first_token_at": first, "finished_at": fin,
            "generated": list(range(n)), "admitted_at": admitted,
            "kv_shared_tokens": shared}


def _edge(t, progress, ticks=0, steps=0, chunks=0):
    return Edge(t, ticks, steps, chunks, 0, progress)


def _window(sent, start, end, closed_at=20.0, open_loop=True, prof=None):
    return Window(MODEL, ENGINE, sent, start, end, closed_at, open_loop,
                  1.5, 2 ** 30, prof)


def _reader(name):
    return spec.module("metrics", name)


def test_ttft_from_due_time_and_all_request_p95():
    # due at 1.0 and 2.0 and sent late: TTFT counts from when it was due
    a = _sent(4, 1.0, _req(1.5, 3.0, 6, admitted=1.2), sent=1.3)
    b = _sent(4, 2.0, _req(2.1, 2.6, 6, admitted=2.05))
    lost = _sent(4, 3.0, error="boom")
    before = _sent(4, 0.5, _req(0.6, 0.9, 6))           # due before the window
    w = _window([before, a, b, lost], _edge(1.0, []), _edge(11.0, []))
    assert w.requests == [a, b, lost]
    ttft = w.latencies_ms("first_token_at")
    assert ttft == pytest.approx([500.0, 100.0, 17000.0])
    assert w.latencies_ms("admitted_at") == pytest.approx(
        [200.0, 50.0, 17000.0])
    assert _reader("ttft_p95_ms").read(w) == pytest.approx(
        percentile(ttft, 95))
    # TPOT: (finished - first token) / (tokens - 1); the lost one misses
    assert w.tpot_ms() == pytest.approx([300.0, 100.0, 17000.0])
    assert len(w.lost()) == 1
    # the percentile of every request, not of a subset: with the lost
    # request the p95 lies past every limit a run could meet
    assert _reader("tpot_p95_ms").read(w) > 10000


def test_settle_waits_for_late_requests_and_keeps_the_lost():
    # after the drain: one request finishes late and counts as served,
    # one failed, one never comes within the wait and stays lost
    late, failed, stuck = (_sent(3, 1.0), _sent(3, 2.0, error="boom"),
                           _sent(3, 3.0))
    late.handle.rid, stuck.handle.rid = 1, 3
    decoding = SimpleNamespace(phase="decode", generated=[5, 6])
    engine = SimpleNamespace(queue=[SimpleNamespace(rid=3)],
                             active={1: decoding})
    timer = threading.Timer(0.05, late.handle.future.set_result,
                            (SimpleNamespace(**_req(4.0, 9.0, 8)),))
    timer.start()
    out = settle(engine, [late, failed, stuck], wait_s=1.0)
    timer.join()
    assert [(d["sent"], d["phase"], d["generated"], d["finished"])
            for d in out] == [(late, "decode", 2, True),
                              (stuck, "queued", 0, False)]
    assert out[1]["error"] is None
    w = _window([late, failed, stuck], _edge(0.5, []), _edge(11.0, []))
    assert w.lost() == [failed, stuck]
    assert settle(engine, [late], wait_s=1.0) == []


def test_percentile_interpolates():
    assert percentile([4.0, 1.0, 3.0, 2.0], 50) == pytest.approx(2.5)
    assert percentile(list(range(101)), 95) == pytest.approx(95.0)
    assert percentile([7.0], 95) == 7.0


def test_tokens_counted_at_the_edges():
    # a straddles the start (2 tokens before, 5 after), b the end, c lies
    # inside, d was sent after the end
    a = _sent(5, 0.0, _req(0.2, 5.0, 7), sent=0.0)
    b = _sent(5, 0.0, None, sent=9.0)
    c = _sent(5, 0.0, _req(3.0, 6.0, 4), sent=2.0)
    d = _sent(5, 0.0, None, sent=12.0)
    start = _edge(1.0, [(2, 5, 0)], ticks=10, steps=7)
    end = _edge(11.0, [(7, 5, 0), (3, 5, 0), (4, 5, 0)], ticks=30, steps=20)
    w = _window([a, b, c, d], start, end, open_loop=False)
    assert w.requests == [c, b] or w.requests == [b, c]
    work = w.work()
    assert work["tokens"] == 5 + 3 + 4
    assert _reader("output_tok_s").read(w) == pytest.approx(12 / 10.0)
    assert _reader("tick_ms.closed").read(w) == pytest.approx(10e3 / 20)
    # decode row-steps: a's tokens 3..7, b's 2..3, c's 2..4, each
    # attending its prompt and the tokens before it
    assert work["rows"] == 5 + 2 + 3
    keys = sum(5 + j - 1 for j in range(3, 8)) + \
        sum(5 + j - 1 for j in range(2, 4)) + sum(5 + j - 1 for j in range(2, 5))
    assert work["keys"] == keys
    assert work["pages"] == sum(-(-(5 + j - 1) // 2) for j in range(3, 8)) \
        + sum(-(-(5 + j - 1) // 2) for j in range(2, 4)) \
        + sum(-(-(5 + j - 1) // 2) for j in range(2, 5))
    assert work["steps"] == 13 and work["ticks"] == 20


def test_chunks_in_the_window():
    # a 10-token prompt in chunks of 4 after 3 shared tokens: [3,7) before
    # the window, [7,10) inside; another admitted inside from scratch
    a = _sent(10, 0.0, None, sent=0.0)
    b = _sent(9, 0.0, None, sent=2.0)
    start = _edge(1.0, [(0, 7, 3)])
    end = _edge(3.0, [(1, 10, 3), (0, 8, 0)], chunks=3)
    w = _window([a, b], start, end, open_loop=False)
    assert w.work()["chunks"] == [(7, 3), (0, 4), (4, 4)]
    assert w.prefix_share() == pytest.approx(0 / 9)   # only b is inside


def test_prefix_share_of_window_requests():
    a = _sent(100, 1.0, _req(1.1, 1.5, 4, shared=96))
    b = _sent(50, 2.0, _req(2.1, 2.5, 4, shared=0))
    w = _window([a, b], _edge(0.5, []), _edge(10.0, []))
    assert _reader("prefix_hit_share.online").read(w) == \
        pytest.approx(100.0 * 96 / 150)


def test_cost_formulas_by_hand():
    m = MODEL
    # q, o: 8·4·2 each; k, v: 8·2·2 each; relu2 MLP: 2 matrices 8x16
    assert cost.layer_matmul_params(m) == 64 + 64 + 32 + 32 + 2 * 128
    assert cost.layer_params(m) == cost.layer_matmul_params(m) + 2 * 2 * 8
    assert cost.causal_pairs(0, 3) == 1 + 2 + 3
    assert cost.causal_pairs(5, 2) == 6 + 7
    # 2 layers · 4 heads · 13 pairs · 2·(2 + 2)
    assert cost.attention_flops(m, 13) == 2 * 2 * 4 * 13 * 2 * 2
    assert cost.chunk_flops(m, 5, 2) == 2 * 2 * 2 * 448 + \
        cost.attention_flops(m, 13) + 2 * 80
    assert cost.kv_bytes_per_token(m) == 2 * 2 * 2 * 2 * 2
    # one step of 3 rows over 30 keys: weights once (layers, head, final
    # norm), each row's embedding row, new KV and logits, the keys' KV
    wbytes = (2 * cost.layer_params(m) + 80 + 8) * 2
    per_row = 8 * 2 + 32 + 10 * 2
    assert cost.decode_bytes(m, 1, 3, 30) == wbytes + 3 * per_row + 30 * 32
    assert cost.decode_flops(m, 3, 30) == 2 * 3 * (2 * 448 + 80) + \
        cost.attention_flops(m, 30)
    # paged decode: q and out (4 heads · 2 · 2 B each) and the length a
    # row, K and V of 2 heads a key, 4 B a page-table entry, every layer
    assert cost.paged_decode_bytes(m, 3, 30, 16) == \
        2 * (3 * (2 * 4 * 2 * 2 + 4) + 30 * 2 * 2 * 2 * 2 + 16 * 4)
    assert cost.flash_bytes(m, 5, 2) == 2 * (2 * 2 * 4 * 2 * 2
                                             + 7 * 2 * 2 * 2 * 2)
    assert cost.step_seconds(989e12, 0) == pytest.approx(1.0)
    assert cost.step_seconds(1.0, 3.35e12) == pytest.approx(1.0)


def test_published_sizes():
    """The configurations' layer and head counts against the issue's
    reckoning (23 253 553 152 and 17 683 593 216 parameters)."""
    for name, total in (("nemotron-4-340b", 23_253_553_152),
                        ("chameleon-34b", 17_683_593_216)):
        m = spec.load_json(HERE / "configs" / f"{name}.json")["model"]
        n = m["num_layers"] * cost.layer_params(m) + 2 * cost.head_params(m)
        n += m["d_model"] * (2 if m["norm"] == "layernorm" else 1)
        assert n == total
        ref = spec.module("reference", "dense_decoder")
        assert ref.n_params(m) == total


def test_roofline_and_mfu_readers():
    prof = {"window_s": 10.0, "busy_s": 8.0, "gaps": {},
            "kernel_s": {"void paged_attention_kernel<1>": 0.5,
                         "flash_fwd_wgmma_kernel<128>": 0.25,
                         "gemm": 6.0}}
    a = _sent(5, 0.0, None, sent=0.0)
    start = _edge(0.0, [(2, 5, 0)], steps=0)
    end = _edge(10.0, [(4, 5, 0)], steps=2, chunks=0)
    w = _window([a], start, end, open_loop=False, prof=prof)
    assert _reader("device_idle_pct.online").read(w) == pytest.approx(20.0)
    got = _reader("paged_decode_roofline.online").read(w)
    least = cost.step_seconds(cost.attention_flops(MODEL, 7 + 8),
                              cost.paged_decode_bytes(MODEL, 2, 15, 8))
    assert got == pytest.approx(100 * least / 0.5)
    assert _reader("flash_roofline.closed").read(w) is None   # no chunk
    mfu = _reader("mfu.closed").read(w)
    least = cost.step_seconds(cost.decode_flops(MODEL, 2, 15),
                              cost.decode_bytes(MODEL, 2, 2, 15))
    assert mfu == pytest.approx(100 * least / 10.0)
    # no trace: the device metrics have nothing to read
    w = _window([a], start, end, open_loop=False)
    for name in ("device_idle_pct.closed", "paged_decode_roofline.online",
                 "flash_roofline.closed"):
        assert _reader(name).read(w) is None
