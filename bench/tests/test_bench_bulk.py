"""The bulk-load generator and the port's bulk load under it: every
preloaded key kept where ``graph_state.from_arrays`` drops some, the same
state as ``from_arrays`` where it drops none, the capacity limit, a chunk
after the load, the new cell at the tiny size, and the check that tells
the two loads apart."""
import pytest
import torch

from bench import harness
from bench.reference import smscc as ref
from bench.tests import tiny
from bench.traffic import bulk, window
from repro_torch.api import AddEdge, GraphClient, RemoveEdge
from repro_torch.core import dynamic
from repro_torch.core import graph_state as gs
from repro_torch.core.service import SCCService
from repro_torch.fault.errors import CapacityExhausted

NV = 512
# out-degree 2 into 1024 slots: every seed's preload overflows 4 probes
CROWDED = gs.GraphConfig(n_vertices=NV, edge_capacity=1024, max_probes=4)
ROOMY = gs.GraphConfig(n_vertices=NV, edge_capacity=8192, max_probes=64)


def _live_keys(state):
    t = state.edges
    live = t.state == 1
    return torch.sort(t.src[live].long() * NV + t.dst[live].long())[0]


def _load(cfg, seed, **options):
    src, dst = window.preload(NV, 2, seed, "cpu")
    svc = SCCService.from_edges(cfg, src, dst, device="cpu", buckets=(64,),
                                **options)
    return src, dst, svc


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11])
def test_the_load_keeps_every_key_where_from_arrays_drops_some(seed):
    src, dst, svc = _load(CROWDED, seed)
    assert torch.equal(_live_keys(svc.state),
                       ref.EdgeSetReplay(NV, src, dst).live)
    assert torch.equal(svc.state.ccid.long(), ref.scc_labels(NV, src, dst))
    assert svc.grow_count >= 1 and svc.load_replaced_keys > 0
    assert svc.cfg.edge_capacity >= 2 * CROWDED.edge_capacity
    assert int(svc.state.overflow) == 0
    assert int(gs.from_arrays(CROWDED, src, dst, device="cpu").overflow) > 0


def test_without_overflow_the_load_is_from_arrays_bit_for_bit():
    src, dst, svc = _load(ROOMY, 3)
    want = dynamic.recompute(gs.from_arrays(ROOMY, src, dst, device="cpu"),
                             ROOMY)
    got = svc.state
    for a, b in zip(got.edges, want.edges):
        assert torch.equal(a, b)
    for name in ("v_alive", "ccid", "n_ccs", "gen", "overflow"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert svc.gen == int(want.gen) == 1 and svc.cfg == ROOMY
    assert svc.load_replaced_keys == svc.grow_count == 0
    assert svc._live_ub == int(gs.live_edge_count(want))


def test_the_load_stops_at_the_capacity_limit():
    with pytest.raises(CapacityExhausted):
        _load(CROWDED, 0, max_edge_capacity=CROWDED.edge_capacity)


def test_a_chunk_after_the_load_acks_as_the_reference():
    src, dst, svc = _load(CROWDED, 5)
    replay = ref.EdgeSetReplay(NV, src, dst)
    g = torch.Generator().manual_seed(5)
    live = replay.live[torch.randperm(replay.live.numel(), generator=g)]
    rem = live[:100]
    add = torch.randint(0, NV, (2, 156), generator=g)
    kind = torch.cat([torch.full((100,), ref.REM_EDGE),
                      torch.full((156,), ref.ADD_EDGE)])
    u = torch.cat([rem // NV, add[0]])
    v = torch.cat([rem % NV, add[1]])
    order = torch.randperm(256, generator=g)
    kind, u, v = kind[order], u[order], v[order]
    cls = {ref.ADD_EDGE: AddEdge, ref.REM_EDGE: RemoveEdge}
    ops = [cls[k](x, y) for k, x, y in zip(kind.tolist(), u.tolist(),
                                           v.tolist())]
    with GraphClient(svc) as client:
        got = [r.value for r in client.submit_many(ops)]
    want = torch.cat([replay.step(kind[lo:lo + 64], u[lo:lo + 64],
                                  v[lo:lo + 64]) for lo in range(0, 256, 64)])
    assert got == want.tolist()
    assert torch.equal(_live_keys(svc.state), replay.live)


def test_the_new_cells_mix_fits_its_configuration():
    """At the cell's own size (arithmetic only): chunks are whole steps of
    the bucket and the ring's pairs a small share of all pairs."""
    spec = harness.load_spec()
    entry = harness.cell_of(spec, "smscc-16m.ingest")
    cfg = harness.config_of(spec, entry["config"])
    mix = harness.mix_of(entry["traffic"])
    assert mix["generator"] == "bulk" and not mix["readers"]
    assert mix["chunk_ops"] == 4 * cfg["bucket"]
    nv = cfg["n_vertices"]
    assert mix["sessions"] * mix["ring"] * mix["chunk_ops"] // 2 \
        < 1e-3 * nv * nv
    with pytest.raises(ValueError):
        bulk.check_mix(dict(mix, generator="window"))


def test_the_new_cell_runs_correct_at_the_tiny_size():
    result, lines = tiny.run("smscc-16m.ingest", seed=2 ** 31 + 5)
    assert result["correct"], lines
    assert result["attempted"] > 0
    assert set(result["metrics"]) == {"update_ops_per_s", "setup_s"}


def test_the_check_sees_the_dropped_keys_that_bulk_keeps():
    """A tiny config whose preload overflows 4 probes: window's load
    drops keys and its run reads edge set mismatches; bulk's does not."""
    spec = harness.load_spec()
    cfg = tiny.config("smscc-16m")
    cfg.update(edge_capacity=1024)
    cfg["engine"]["max_probes"] = 4
    seen = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for gen in ("window", "bulk"):
            mix = dict(tiny.mix("bulk-ingest"), generator=gen)
            _, lines = harness.run_cell(
                "smscc-16m.ingest", 9, 0.3, device="cpu", spec=spec,
                config=cfg, mix=mix, note=lambda msg: None)
            seen[gen] = dict(line.split()[1:3] for line in lines)
    finally:
        torch.set_num_threads(threads)
    assert int(seen["window"]["edge_set_mismatches"]) > 0
    assert seen["bulk"] == dict.fromkeys(seen["bulk"], "0")

