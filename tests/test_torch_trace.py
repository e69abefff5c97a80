"""The port's span recorder (``repro_torch.trace``): off it records
nothing; on, one update chunk through the typed client nests under one
trace id, a Reachable request's time in the broker's queue names the
flush that collected it, the store drops past its capacity, and threads
record at once.  The service's and broker's new counters count where
they should."""
import threading

import numpy as np
import pytest

from repro_torch import api, trace
from repro_torch.api.client import _runs
from repro_torch.core import graph_state as gs
from repro_torch.core.broker import QueryBroker
from repro_torch.core.service import HOST_READ_SITES, SCCService


@pytest.fixture(autouse=True)
def clean_tracer():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


def _service():
    cfg = gs.GraphConfig(n_vertices=64, edge_capacity=512)
    return SCCService(cfg, buckets=(32,), scan_lengths=(1, 4), device="cpu")


def _adds(n, seed=0):
    rng = np.random.default_rng(seed)
    return [api.AddEdge(int(u), int(v))
            for u, v in rng.integers(0, 64, (n, 2))]


def _client(svc, broker=None):
    """A client of ``svc`` after all 64 vertices were added, untraced."""
    client = api.GraphClient(svc, broker=broker)
    client.submit_many([api.AddVertex(i) for i in range(64)])
    return client


def test_off_returns_the_shared_noop_and_records_nothing():
    assert not trace.enabled() and trace.current() is None
    sp = trace.span("client.submit_many", "t")
    assert sp is trace.NOOP and trace.span("x", wait=True) is sp
    with sp as s:
        s.set("k", 1)
    trace.record("broker.queued", 1, 2, "t")
    svc = _service()
    with api.GraphClient(svc) as client:
        client.submit_many(_adds(40))
        client.submit_many([api.Reachable(1, 2)])
    assert trace.take() == ([], 0)


def test_an_update_chunk_nests_under_one_trace_id():
    svc = _service()
    client = _client(svc)
    reads = sum(svc.host_reads.values())
    ops = _adds(100)
    assert next(_runs(ops))[1] is ops  # the fast split takes it whole
    trace.enable()
    res = client.submit_many(ops)  # one scan-4 super-chunk
    trace.disable()
    spans, dropped = trace.take()
    assert dropped == 0 and len(res) == 100
    by = {s.name: [x for x in spans if x.name == s.name] for s in spans}
    root, = by["client.submit_many"]
    assert root.parent == 0
    assert root.trace_id == f"{client.session_id}/2"
    assert sum(r.value for r in res) > 80
    assert {s.trace_id for s in spans} == {root.trace_id}
    ids = {s.id: s for s in spans}
    apply_, = by["service.apply"]
    for name, parent in [("client.encode", root), ("client.results", root),
                         ("service.apply", root),
                         ("service.lock_wait", apply_),
                         ("service.dispatch", apply_),
                         ("service.read_back", apply_),
                         ("service.compact_check", apply_)]:
        for s in by[name]:
            assert ids[s.parent] is parent, name
            assert parent.start_ns <= s.start_ns <= s.end_ns \
                <= parent.end_ns
    waits = {s.name for s in spans if s.wait}
    assert waits == {"service.lock_wait", "service.read_back",
                     "service.compact_check"}
    assert [s.attrs for s in by["service.dispatch"]] == [{"k": 4}]
    assert len(by["client.encode"]) == len(by["client.results"]) == 1
    # one read of the super-chunk's outputs and one compaction test
    assert len(by["service.read_back"]) == 1
    assert sum(svc.host_reads.values()) - reads == 2
    assert svc.stats()["host_reads"] == svc.host_reads
    assert set(svc.host_reads) == set(HOST_READ_SITES)


def test_a_grow_counts_its_reads_and_replays_under_a_span():
    cfg = gs.GraphConfig(n_vertices=64, edge_capacity=64, max_probes=8)
    svc = SCCService(cfg, buckets=(32,), scan_lengths=(1,), device="cpu")
    client = _client(svc)
    trace.enable()
    client.submit_many(_adds(120, seed=3))
    trace.disable()
    names = {s.name for s in trace.take()[0]}
    assert svc.grow_count > 0
    assert {"service.replay", "service.grow"} <= names
    assert svc.host_reads["grow"] >= 2 * svc.grow_count
    assert svc.host_reads["replay"] > 0


def test_a_queued_request_names_the_flush_that_took_it():
    svc = _service()
    broker = QueryBroker(svc, buckets=(8,)).start()
    try:
        client = _client(svc, broker)
        client.submit_many(_adds(40))
        trace.enable()
        client.submit_many([api.Reachable(1, 2), api.Reachable(3, 4)])
        trace.disable()
    finally:
        broker.stop()
    spans, _ = trace.take()
    ids = {s.id: s for s in spans}
    root, = [s for s in spans if s.name == "client.submit_many"]
    assert root.trace_id == f"{client.session_id}/q1"
    queued, = [s for s in spans if s.name == "broker.queued"]
    flush = ids[queued.attrs["flush"]]
    assert flush.name == "broker.flush" and flush.parent == 0
    assert queued.wait and queued.trace_id == root.trace_id
    assert ids[queued.parent] is root
    assert queued.end_ns <= flush.start_ns
    assert flush.attrs == {"requests": 1, "queries": 2}
    assert flush.thread != root.thread  # the dispatcher's
    below = {s.name for s in spans if s.parent == flush.id}
    assert {"query.seeds", "query.sweep", "query.read_back",
            "broker.distribute"} <= below
    wait, = [s for s in spans if s.name == "client.wait"]
    assert wait.wait and wait.parent == root.id
    assert broker.stats()["max_coalesced"] >= flush.attrs["queries"]


def test_the_store_drops_past_its_capacity(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 5)
    trace.enable()
    for i in range(8):
        with trace.span(f"s{i}"):
            pass
    trace.record("r", 0, 1)
    spans, dropped = trace.take()
    assert [s.name for s in spans] == [f"s{i}" for i in range(5)]
    assert dropped == 4
    assert trace.take() == ([], 0)


def test_threads_record_at_once():
    """Eight threads nest spans under their own roots: each thread's
    spans keep their own parents and trace ids, and none is lost."""
    n_threads, n = 8, 500
    go = threading.Barrier(n_threads)
    trace.enable()

    def work(t):
        go.wait()
        for i in range(n):
            with trace.span("client.submit_many", f"{t}/{i}"):
                with trace.span("service.apply"):
                    pass
    threads = [threading.Thread(target=work, args=(t,))
               for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    trace.disable()
    spans, dropped = trace.take()
    assert dropped == 0 and len(spans) == 2 * n_threads * n
    assert len({s.id for s in spans}) == len(spans)
    ids = {s.id: s for s in spans}
    for s in spans:
        if s.name == "service.apply":
            p = ids[s.parent]
            assert p.name == "client.submit_many"
            assert p.trace_id == s.trace_id and p.thread == s.thread
