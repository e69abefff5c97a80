"""The roofline arithmetic, pinned at update_1m's sizes, and its
independence of the edge table's capacity."""
import copy
import types

import numpy as np
import pytest

from bench import harness, roofline

NV = 2 ** 20
LIVE = 2 ** 21 + 32768  # preload (before its few duplicates) + ring


def test_sweep_bytes_at_update_1m():
    # 8 B an edge once, a 4-byte state word in and an output word out
    assert roofline.sweep_bytes(LIVE, NV) == 8 * LIVE + 8 * NV == 25427968
    # 0.7456 ms for the boolean sweep (PERF.md's kernel table) is 1.02%
    share = roofline.share_pct(roofline.sweep_bytes(LIVE, NV), 0.7456e-3)
    assert share == pytest.approx(100 * 25427968 / 3.35e12 / 0.7456e-3)
    assert 1.0 < share < 1.1


def test_packed_sweeps_and_table_bytes():
    # two sweeps answering 160 queries: the graph twice, 5 words a vertex
    assert roofline.packed_sweeps_bytes(2, LIVE, NV, 160) == \
        2 * 8 * LIVE + 2 * NV * 4 * 5
    assert roofline.insert_bytes(4096) == 4096 * 18
    assert roofline.remove_bytes(4096) == 4096 * 10
    assert roofline.share_pct(0, 1.0) is None
    assert roofline.share_pct(1.0, 0.0) is None


def _run(cfg, trace_ops, served=0):
    chunk = types.SimpleNamespace(
        t_ack=1.0, arrays=(np.array([0, 1] * 4096), None, None))
    return harness.Run(
        "smscc-1m.reach-serve", cfg, {}, 10.0, 1.0, 0.0, 10.0, 10.0,
        [chunk], [], {"n_vertices": cfg["n_vertices"], "live_edges": LIVE,
                      "bucket": cfg["bucket"], "steps_per_chunk": 1},
        {"broker": {"flushes": 10, "served": served}},
        {"ops": trace_ops, "busy_s": 1.0, "window_s": 2.0})


@pytest.mark.parametrize("metric", ["frontier_min_roofline.ingest",
                                    "frontier_min_roofline.serve",
                                    "hash_probe_roofline"])
def test_rooflines_do_not_move_with_the_table_capacity(metric):
    ops = {"void fixpoint_rounds<0>(FixArgs)": (3, 2e-3),
           "void fixpoint_rounds<4>(FixArgs)": (5, 4e-3),
           "void scc_rounds<false>(SccArgs)": (1, 3e-3),
           "insert_rounds(int*, ...)": (1, 1e-4),
           "remove_first(int const*, ...)": (1, 5e-5)}
    cfg = harness.config_of(harness.load_spec(), "smscc-1m")
    big = copy.deepcopy(cfg)
    big["edge_capacity"] *= 4
    read = harness.reader_of(metric)
    a, b = read(_run(cfg, ops, 160)), read(_run(big, ops, 160))
    assert a is not None and a == b
    assert 0 < a < 100


def test_roofline_readers_read_nothing_without_a_trace():
    cfg = harness.config_of(harness.load_spec(), "smscc-1m")
    run = _run(cfg, {})
    run.trace = None
    for m in ("frontier_min_roofline.ingest", "frontier_min_roofline.serve",
              "hash_probe_roofline", "device_idle_share.ingest"):
        assert harness.reader_of(m)(run) is None
