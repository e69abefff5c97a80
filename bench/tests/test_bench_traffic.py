"""The sliding-window generator: determinism, live removes, a steady live
edge count, disjoint pairs and the readers' arrivals."""
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import harness
from bench.tests import tiny
from bench.traffic import window

BENCH = Path(__file__).resolve().parents[1]
SMALL = dict(generator="window", sessions=3, chunk_ops=64, ring=4, lag=2,
             rate_ops_per_s=0, readers=2, reader_rate_queries_per_s=800,
             reader_batch=8, reader_pool=64, broker_buckets=[8],
             reach_check_sample=0)


def _window(seed, nv=64, deg=2, mix=SMALL):
    src, dst = window.preload(nv, deg, seed, "cpu")
    taken = torch.unique(src.long() * nv + dst.long())
    return (src, dst), window.Rings(nv, dict(mix), taken, seed, "cpu")


def _same(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def test_window_is_deterministic_in_the_seed():
    (s1, d1), w1 = _window(2 ** 31 + 7)
    (s2, d2), w2 = _window(2 ** 31 + 7)
    (s3, d3), w3 = _window(2 ** 31 + 8)
    assert torch.equal(d1, d2) and not torch.equal(d1, d3)
    for s in range(SMALL["sessions"]):
        assert _same(w1.fill[s], w2.fill[s])
        for p in range(SMALL["ring"]):
            assert _same(w1.ring[s][p], w2.ring[s][p])
    assert not _same(w1.ring[0][0], w3.ring[0][0])
    r1 = window.reader_pairs(100, SMALL, 9)
    assert _same(r1, window.reader_pairs(100, SMALL, 9))
    assert not _same(r1, window.reader_pairs(100, SMALL, 10))


@pytest.mark.parametrize("seed", [0, 1, 2 ** 33])
def test_every_remove_is_live_and_the_live_count_holds(seed):
    """64 vertices are crowded enough that uniform pairs would collide
    often: every RemoveEdge must still name a live edge, and every chunk
    boundary see the same number of live edges, in any interleaving of
    the sessions."""
    nv = 64
    (src, dst), w = _window(seed, nv)
    live = set(zip(src.tolist(), dst.tolist()))
    for s in range(SMALL["sessions"]):
        kind, u, v = w.fill[s]
        assert (kind == window.ADD_EDGE).all()
        for e in zip(u.tolist(), v.tolist()):
            assert e not in live
            live.add(e)
    steady = len(live)
    assert steady == len(set(zip(src.tolist(), dst.tolist()))) \
        + w.live_adds()
    rng = np.random.default_rng(seed)
    nxt = [0] * SMALL["sessions"]
    for _ in range(40):  # sessions in a random interleaving
        s = int(rng.integers(SMALL["sessions"]))
        kind, u, v = w.chunk(s, nxt[s])
        nxt[s] += 1
        assert (kind == window.ADD_EDGE).sum() == \
            (kind == window.REM_EDGE).sum()
        rem = kind == window.REM_EDGE
        for e in zip(u[rem].tolist(), v[rem].tolist()):
            assert e in live
            live.remove(e)
        for e in zip(u[~rem].tolist(), v[~rem].tolist()):
            assert e not in live
            live.add(e)
        assert len(live) == steady


def test_sessions_pairs_are_distinct_from_each_other_and_the_preload():
    nv = 64
    (src, dst), w = _window(3, nv)
    pre = set(zip(src.tolist(), dst.tolist()))
    pairs = []
    for s in range(SMALL["sessions"]):
        for p in range(SMALL["ring"]):
            kind, u, v = w.ring[s][p]
            add = kind == window.ADD_EDGE
            pairs += list(zip(u[add].tolist(), v[add].tolist()))
    assert len(set(pairs)) == len(pairs)
    assert not set(pairs) & pre


@pytest.mark.parametrize("cell", ["smscc-1m.ingest",
                                  "smscc-1m.reach-serve"])
def test_the_cells_mixes_fit_their_configurations(cell):
    """At the cells' own sizes (arithmetic only: the sizes are not drawn
    here): chunks are whole steps of the bucket, the ring's pairs are a
    small share of all pairs, and the live edges fill at most about a
    quarter of the table (at half, the 64-slot probe bound drops edges)."""
    spec = harness.load_spec()
    entry = harness.cell_of(spec, cell)
    cfg = harness.config_of(spec, entry["config"])
    mix = harness.mix_of(entry["traffic"])
    nv = cfg["n_vertices"]
    assert mix["chunk_ops"] % cfg["bucket"] == 0
    ring_pairs = mix["sessions"] * mix["ring"] * mix["chunk_ops"] // 2
    assert ring_pairs < 1e-3 * nv * nv
    live = nv * cfg["preload_out_degree"] + \
        mix["sessions"] * mix["lag"] * mix["chunk_ops"] // 2
    assert live <= 0.26 * cfg["edge_capacity"]
    if mix["readers"]:
        assert mix["reader_pool"] % mix["reader_batch"] == 0
        assert mix["reader_batch"] in mix["broker_buckets"]


def test_check_mix_rejects_unknown_keys_and_short_rings():
    with pytest.raises(ValueError):
        window.check_mix(dict(SMALL, burst=3))
    with pytest.raises(ValueError):
        window.check_mix(dict(SMALL, ring=3))
    with pytest.raises(ValueError):
        window.check_mix(dict(SMALL, reader_rate_queries_per_s=0))
    with pytest.raises(ValueError):
        window.check_mix(dict(SMALL, generator="rmat"))
    for path in (BENCH / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        harness.generator_of(mix["generator"]).check_mix(mix)


@pytest.mark.parametrize("seconds", [0.5, 10.0, 50.0])
def test_arrivals_are_one_set_of_gaps_in_the_seeds_order(seconds):
    """Every seed sends the same number of requests, all inside the
    window, with the same gaps in another order, at the mix's rate."""
    a = window.arrivals(SMALL, seconds, 2 ** 31 + 3)
    b = window.arrivals(SMALL, seconds, 2 ** 31 + 4)
    n = round(SMALL["reader_rate_queries_per_s"] / SMALL["reader_batch"]
              * seconds)
    assert a.shape == b.shape == (n,)
    assert a[0] == b[0] == 0.0 and a[-1] < seconds and b[-1] < seconds
    assert (np.diff(a) > 0).all() and not np.array_equal(a, b)
    gaps = np.sort(np.diff(np.append(a, seconds)))
    assert np.allclose(gaps, np.sort(np.diff(np.append(b, seconds))))
    assert np.array_equal(a, window.arrivals(SMALL, seconds, 2 ** 31 + 3))


def test_a_generator_built_on_window_replaces_its_draw(monkeypatch):
    """A new draw is a new module beside this one, named by its mixes:
    here one that wraps the uniform draw, run whole at the tiny size."""
    drawn = []

    class Traffic(window.Traffic):
        @staticmethod
        def draw(nv, n, taken, seed, device):
            u, v = window.fresh_pairs(nv, n, taken, seed, device)
            drawn.append(n)
            return u, v

    keys = dict(window.MIX_KEYS, generator="this module: wrapped")
    mod = types.ModuleType("bench.traffic.wrapped")
    mod.check_mix = lambda mix: window.check_mix(mix, keys, "wrapped")
    mod.Traffic = Traffic
    monkeypatch.setitem(sys.modules, "bench.traffic.wrapped", mod)
    spec = harness.load_spec()
    mix = dict(tiny.mix("ingest"), generator="wrapped")
    result, _ = harness.run_cell(
        "smscc-1m.ingest", 5, 0.3, device="cpu", spec=spec,
        config=tiny.config(), mix=mix, note=lambda msg: None)
    assert result["correct"] and drawn == [mix["ring"] * 128]
