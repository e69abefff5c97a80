"""Span arithmetic on hand-built spans with known answers, the idle gaps
and the two clock anchors on synthetic events, and tiny runs of each
cell with the port's tracer on (``bench/program_trace.py``) and off."""
from typing import NamedTuple, Optional

import numpy as np
import pytest

from bench import devtrace
from bench import spans as sp
from bench.tests import tiny


class S(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    trace_id: object
    wait: bool = False
    attrs: Optional[dict] = None


def _chunk(t, tid, base):
    """One update chunk of 100 ns: encode 10, apply 70 (lock 5, dispatch
    20, read-back 30, compaction test 10), results 15."""
    return [S("client.submit_many", t, t + 100, base, 0, tid),
            S("client.encode", t, t + 10, base + 1, base, tid),
            S("service.apply", t + 10, t + 80, base + 2, base, tid),
            S("service.lock_wait", t + 10, t + 15, base + 3, base + 2, tid,
              True),
            S("service.dispatch", t + 15, t + 35, base + 4, base + 2, tid),
            S("service.read_back", t + 40, t + 70, base + 5, base + 2, tid,
              True),
            S("service.compact_check", t + 70, t + 80, base + 6, base + 2,
              tid, True),
            S("client.results", t + 80, t + 95, base + 7, base, tid)]


def test_self_and_layer_time():
    spans = _chunk(0, "a/1", 1)
    kids = sp.children(spans)
    root, apply_ = spans[0], spans[2]
    assert sp.self_ns(root, kids) == 100 - 10 - 70 - 15
    assert sp.self_ns(apply_, kids) == 70 - 5 - 20 - 30 - 10
    assert sp.layer_ns(root, kids) == 30  # all but the service's 70
    assert sp.covered_ns(0, 10, [(2, 5), (4, 8), (9, 20)]) == 7
    assert sp.covered_ns(0, 10, []) == 0


def test_ingest_numbers_by_chunk():
    spans = _chunk(0, "a/1", 1) + _chunk(200, "a/2", 11) \
        + _chunk(400, "a/3", 21)
    got = sp.ingest_numbers([s._replace(start_ns=s.start_ns * 10 ** 4,
                                        end_ns=s.end_ns * 10 ** 4)
                             for s in spans])
    # in ms at 10 us a unit: client 30, host 70 - 45, card 40, lock 5
    assert got == {"client_self_ms": 0.3, "service_host_ms": 0.25,
                   "card_wait_ms": 0.4, "lock_wait_ms": 0.05,
                   "submit_ms": 1.0, "chunks": 3}
    assert got["client_self_ms"] + got["service_host_ms"] \
        + got["card_wait_ms"] + got["lock_wait_ms"] \
        == pytest.approx(got["submit_ms"])
    assert {k: len(v) for k, v in sp.by_trace(spans).items()} == \
        {"a/1": 8, "a/2": 8, "a/3": 8}
    assert sp.in_window(spans, 150, 450) == spans[8:]


def test_serve_numbers():
    spans = []
    for i in range(20):  # requests queued 1..20 ms
        spans.append(S("broker.queued", 0, (i + 1) * 10 ** 6, 100 + i, 0,
                       f"r/q{i}", True, {"flush": 1}))
    spans += [S("broker.flush", 0, 5 * 10 ** 6, 1, 0, 1),
              S("query.sweep", 0, 10 ** 6, 2, 1, 1),
              S("query.read_back", 10 ** 6, 4 * 10 ** 6, 3, 1, 1, True)]
    got = sp.serve_numbers(spans)
    assert got["queue_wait_ms"] == pytest.approx(
        np.percentile(np.arange(1, 21), 95))
    assert got["flush_host_ms"] == 2.0
    assert (got["requests"], got["flushes"]) == (20, 1)


def test_idle_gaps_and_idle_by_span():
    dev = [(10, 20), (15, 30), (50, 60), (95, 130)]
    gaps = sp.idle_gaps(dev, 0, 100)
    assert gaps == [(0, 10), (30, 50), (60, 95)]
    host = [("bench.update_chunk", 0, 100), ("client.submit_many", 0, 99),
            ("client.encode", 0, 12), ("service.apply", 28, 70),
            ("service.dispatch", 29, 41)]
    idle = sp.idle_by_span(gaps, host)
    # (0, 10) in client.encode; (30, 50): service.dispatch covers 11 of
    # 20, the shortest over half; (60, 95): service.apply covers 10 of 35,
    # so the shortest covering half is client.submit_many
    assert idle == pytest.approx({"client.submit_many": 35e-9,
                                  "service.dispatch": 20e-9,
                                  "client.encode": 10e-9})
    assert sp.share_under(idle, "client.") == pytest.approx(45 / 65)
    assert sp.idle_by_span([(0, 10)], []) == {"nothing traced": 1e-8}
    assert sp.share_under({}, "client.") is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_idle_by_span_names_each_gap_as_the_trace_summary_does(seed):
    """The sweep names every gap as ``devtrace`` names its longest ones
    (random nested and overlapping spans; no two of one length)."""
    rng = np.random.default_rng(seed)
    dev = sorted((int(a), int(a) + int(d)) for a, d in
                 zip(rng.integers(0, 10 ** 6, 300),
                     rng.integers(1, 3000, 300)))
    gaps = sp.idle_gaps(dev, 0, 10 ** 6)
    starts = rng.integers(0, 10 ** 6, 400)
    lens = rng.permutation(np.arange(1, 401)) * 97
    host = [(f"s{i}", int(a), int(a + n))
            for i, (a, n) in enumerate(zip(starts, lens))]
    cs = np.asarray([a for _, a, _ in host], np.int64)
    ce = np.asarray([b for _, _, b in host], np.int64)
    names = [n for n, _, _ in host]
    want = {}
    for a, b in gaps:
        k = devtrace._host_activity(cs, ce, names, a, b)
        want[k] = want.get(k, 0.0) + (b - a) / 1e9
    assert sp.idle_by_span(gaps, host) == pytest.approx(want)


def test_the_window_and_the_two_anchors_from_events():
    events = [("bench.window", 1000, 9000, False),
              ("aten::copy_", 1200, 1300, False),
              ("kernel_a", 1500, 2500, True),
              ("bench.anchor_close", 8900, 8905, False),
              ("kernel_b", 3000, 3100, True)]
    win, close, dev = sp.window_events(events, "bench.window",
                                       "bench.anchor_close")
    assert win == (1000, 9000) and close == 8900
    assert dev == [(1500, 2500), (3000, 3100)]
    # perf_counter read 20 ns after the window's start and 25 ns after
    # the marker's: the clocks lie 5 ns apart
    assert sp.anchors(1000, 980, 8900, 8875) == {"open": 20, "close": 25,
                                                 "apart": 5}


def _program_run(cell, trace, tracer=True):
    from bench import harness, program_trace
    spec = harness.load_spec()
    entry = harness.cell_of(spec, cell)
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return program_trace.run(
            cell, 5, 0.6, trace, tracer, device="cpu", spec=spec,
            config=tiny.config(entry["config"]),
            mix=tiny.mix(entry["traffic"]), note=lambda msg: None)
    finally:
        torch.set_num_threads(threads)


def test_a_tiny_traced_ingest_run_reads_every_number():
    from repro_torch import trace
    result, rep = _program_run("smscc-1m.ingest", True)
    assert result["correct"] and not trace.enabled()
    assert rep["dropped"] == 0 and rep["chunks"] >= 2
    for k in ("client_self_ms", "service_host_ms", "card_wait_ms"):
        assert rep[k] > 0, k
    parts = rep["client_self_ms"] + rep["service_host_ms"] \
        + rep["card_wait_ms"] + rep["lock_wait_ms"]
    # each chunk's parts add up to its submit_many; their medians nearly
    assert parts == pytest.approx(rep["submit_ms"], rel=0.05)
    assert rep["chunk_cover_min"] > 0.9
    assert rep["host_reads_per_chunk"] == 2.0  # a read-back, a fill count
    assert rep["idle_in_client_share"] is None  # no card: no device gap
    assert set(rep["anchors_ns"]) == {"open", "close", "apart"}
    assert rep["queue_wait_ms"] is None
    assert isinstance(rep["gc"], dict)  # the window's collections, timed


def test_a_tiny_traced_serving_run_reads_every_number():
    result, rep = _program_run("smscc-1m.reach-serve", True)
    assert result["correct"]
    assert rep["requests"] > 0 and rep["queue_wait_ms"] >= 0
    assert rep["flush_host_ms"] > 0 and rep["flushes"] >= 1
    assert rep["chunks"] >= 1 and rep["host_reads_per_chunk"] >= 2.0


@pytest.mark.parametrize("tracer", [False, True])
def test_an_untraced_run_leaves_the_tracer_as_it_was(tracer):
    """The benchmark's own untraced run records nothing; the tool's
    untraced run records spans only with the tracer on, and turns it off
    after."""
    from repro_torch import trace
    trace.take()
    result, _ = tiny.run("smscc-1m.ingest", seconds=0.3)
    assert result["correct"] and trace.take() == ([], 0)
    result, rep = _program_run("smscc-1m.ingest", False, tracer)
    assert result["correct"] and not trace.enabled()
    assert (rep["spans"] > 0) == tracer and rep["dropped"] == 0
    assert rep["host_reads"] > 0
    assert "gc" not in rep  # collections are timed in traced runs only
