"""The port's serving slice (SCCService + QueryBroker + GraphClient) held
to the JAX package end to end, plus the carry round trip and the rule that
the port imports nothing of JAX.

Both services start from one carried state and take the same typed
stream (the port's copy of the workload generator is checked to draw the
same ops).  Per-op results, generation stamps, final labels, the edge set
and the counters that mean the same in both packages must be identical:
exact equality, since every value is an integer or a boolean.
"""
import ast
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import dynamic as jdyn
from repro.core import graph_state as jgs
from repro.core.service import SCCService as JService
from repro.launch import stream as jstream
from repro_torch import api as tapi
from repro_torch import carry, trace
from repro_torch.core import graph_state as tgs
from repro_torch.core.broker import QueryBroker
from repro_torch.core.service import HOST_READ_SITES
from repro_torch.core.service import SCCService as TService
from repro_torch.kernels.frontier_expand import ops as tfops
from repro_torch.kernels.hash_probe import ops as thops
from repro_torch.kernels.reach_blockmm import ops as tbops
from repro_torch.launch import stream as tstream

ROOT = Path(__file__).resolve().parents[1]
NV = 48
SHARED_STATS = ("gen", "n_ccs", "live_edges", "tombstones", "edge_capacity",
                "overflow_total", "grows", "proactive_grows", "replayed_ops",
                "compactions", "pipelined_chunks", "fallback_chunks",
                "scanned_chunks", "scan_dispatches", "repair_dense_steps",
                "repair_compact_steps", "repair_full_steps",
                "repair_skipped_steps", "repair_region_v_max",
                "repair_region_e_max", "client_updates", "client_queries")


def jax_arrays(st) -> dict:
    return {"v_alive": np.asarray(st.v_alive), "ccid": np.asarray(st.ccid),
            "src": np.asarray(st.edges.src), "dst": np.asarray(st.edges.dst),
            "state": np.asarray(st.edges.state),
            "n_ccs": np.asarray(st.n_ccs), "gen": np.asarray(st.gen),
            "overflow": np.asarray(st.overflow)}


def _queries(api, rng):
    qu = rng.integers(-1, NV + 1, 12)
    qv = rng.integers(0, NV, 12)
    return ([api.SameSCC(int(a), int(b)) for a, b in zip(qu, qv)]
            + [api.Reachable(int(a), int(b)) for a, b in zip(qu[:6], qv)]
            + [api.SccMembers(int(a)) for a in qu[:3]]
            + [api.CommunityOf(int(a)) for a in qu[:6]]
            + [api.CommunitySizes()])


def _run(api, svc, ops_stream, n_chunks, seed):
    """Apply chunk after chunk through a GraphClient, with a query run of
    every kind after each chunk; returns every Result's (value, gen)."""
    rng = np.random.default_rng(seed)
    out = []
    client = api.GraphClient(svc)
    try:
        for step in range(n_chunks):
            for r in client.submit_many(ops_stream(step)):
                out.append((r.value, r.gen))
            for r in client.submit_many(_queries(api, rng)):
                out.append((np.asarray(r.value).tolist(), r.gen))
        stats = client.stats()
    finally:
        client.close()
    return out, stats


# Both scenarios share one GraphConfig and one batch bucket, so the JAX
# side compiles each (capacity, bucket) step once for the two of them.
SCENARIOS = {
    # undersized table: reactive grow-and-replay (two grows) through the
    # pipelined path, plus tombstone compactions
    "reactive_grow": dict(edge_capacity=64, max_probes=8,
                          svc=dict(buckets=(64,), scan_lengths=(1, 4))),
    # proactive growth and the serial path (no in-flight window)
    "proactive_serial": dict(edge_capacity=64, max_probes=8,
                             svc=dict(buckets=(64,), inflight_window=0,
                                      proactive_grow=True)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_service_and_client_match_jax(name):
    sc = SCENARIOS[name]
    jcfg = jgs.GraphConfig(n_vertices=NV, edge_capacity=sc["edge_capacity"],
                           max_probes=sc["max_probes"], max_outer=NV + 1,
                           max_inner=NV + 2, region_vertex_capacity=16,
                           region_edge_buckets=(16, 64))
    tcfg = carry.config_from_dict(dataclasses.asdict(jcfg))
    jstate = jgs.all_singletons(jcfg)
    jsvc = JService(jcfg, state=jstate, compact_tomb_frac=0.2, **sc["svc"])
    tsvc = TService(tcfg, state=carry.state_from_numpy(jax_arrays(jstate),
                                                       device="cpu"),
                    compact_tomb_frac=0.2, **sc["svc"])

    def stream(mod):
        return lambda step: mod.typed_op_stream(NV, 80, step=step,
                                                add_frac=0.7, seed=3)

    jout, jstats = _run(japi, jsvc, stream(jstream), 8, seed=5)
    tout, tstats = _run(tapi, tsvc, stream(tstream), 8, seed=5)
    assert len(tout) == len(jout)
    for i, (t, j) in enumerate(zip(tout, jout)):
        assert t == j, f"result {i}: port {t} != jax {j}"
    for k in SHARED_STATS:
        assert tstats[k] == jstats[k], f"{k}: {tstats[k]} != {jstats[k]}"
    assert jstats["grows"] + jstats["proactive_grows"] > 0
    assert tsvc.edge_set() == jsvc.edge_set()
    got = carry.state_to_numpy(tsvc.state)
    for k, want in jax_arrays(jsvc.state).items():
        if k in ("v_alive", "ccid", "n_ccs", "gen", "overflow"):
            np.testing.assert_array_equal(got[k], want, err_msg=k)
    if name == "reactive_grow":
        assert jstats["grows"] >= 2
        assert jstats["compactions"] > 0 and jstats["fallback_chunks"] > 0


def test_typed_op_stream_is_the_same_stream():
    for step in range(3):
        j = jstream.typed_op_stream(1000, 64, step=step, add_frac=0.6,
                                    seed=9)
        t = tstream.typed_op_stream(1000, 64, step=step, add_frac=0.6,
                                    seed=9)
        assert [(type(o).__name__, tuple(dataclasses.astuple(o)))
                for o in t] == [(type(o).__name__,
                                 tuple(dataclasses.astuple(o))) for o in j]


def test_dispatcher_broker_answers_like_inline():
    cfg = tgs.GraphConfig(n_vertices=NV, edge_capacity=256)
    svc = TService(cfg, state=tgs.all_singletons(cfg, "cpu"), buckets=(64,))
    inline = tapi.GraphClient(svc)
    inline.submit_many(tstream.typed_op_stream(NV, 64, step=0,
                                               add_frac=0.9, seed=1))
    qs = _queries(tapi, np.random.default_rng(2))
    want = [np.asarray(r.value).tolist() for r in inline.submit_many(qs)]
    with QueryBroker(svc) as broker:
        shared = tapi.GraphClient(svc, broker=broker)
        got = [np.asarray(r.value).tolist() for r in shared.submit_many(qs)]
        fut = shared.submit(qs[0])
        assert fut.result(timeout=30).value == want[0]
    assert got == want


def test_service_query_methods_match_client():
    cfg = tgs.GraphConfig(n_vertices=NV, edge_capacity=256)
    svc = TService(cfg, state=tgs.all_singletons(cfg, "cpu"), buckets=(64,))
    client = tapi.GraphClient(svc)
    client.submit_many(tstream.typed_op_stream(NV, 64, step=0, add_frac=0.9,
                                               seed=4))
    u = [0, 5, -1, NV, 17]
    v = [3, 5, 2, 1, 40]
    gen = svc.gen
    for snap in (svc.same_scc(u, v), svc.reachable(u, v),
                 svc.community_of(u), svc.community_sizes(),
                 svc.scc_members(5)):
        assert snap.gen == gen
    via_client = client.submit_many(
        [tapi.SameSCC(a, b) for a, b in zip(u, v)]
        + [tapi.Reachable(a, b) for a, b in zip(u, v)]
        + [tapi.CommunityOf(a) for a in u] + [tapi.SccMembers(5)])
    n = len(u)
    assert [r.value for r in via_client[:n]] == \
        svc.same_scc(u, v).value.tolist()
    assert [r.value for r in via_client[n:2 * n]] == \
        svc.reachable(u, v).value.tolist()
    assert [r.value for r in via_client[2 * n:3 * n]] == \
        svc.community_of(u).value.tolist()
    np.testing.assert_array_equal(via_client[-1].value,
                                  svc.scc_members(5).value)
    assert not svc.scc_members(-1).value.any()


def test_serve_runs_on_cpu():
    from repro_torch.launch import serve
    rep = serve.serve_smscc(2, nv=256, chunk=64, device="cpu")
    assert rep["ops"] == 128 and rep["queries"] > 0
    assert rep["device"] == "cpu"


def test_carry_round_trip():
    jcfg = jgs.GraphConfig(n_vertices=16, edge_capacity=64, shortcut=True,
                           region_edge_buckets=(8, 32))
    d = dataclasses.asdict(jcfg)
    tcfg = carry.config_from_dict(d)
    assert carry.config_to_dict(tcfg) == d
    jstate = jgs.from_arrays(jcfg, jnp.arange(10), (jnp.arange(10) + 1) % 16)
    arrays = jax_arrays(jstate)
    back = carry.state_to_numpy(carry.state_from_numpy(arrays, "cpu"))
    assert back.keys() == arrays.keys()
    for k in arrays:
        assert back[k].dtype == arrays[k].dtype, k
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
    with pytest.raises(ValueError, match="missing"):
        carry.state_from_numpy({"ccid": arrays["ccid"]}, "cpu")


def test_cpu_tensors_take_the_plain_versions():
    before = (tfops.frontier_min.launches, thops.probe.launches,
              tbops.bool_matmul.launches)
    cfg = tgs.GraphConfig(n_vertices=8, edge_capacity=16, dense_capacity=8,
                          sparse_impl="pallas", dense_matmul_impl="pallas")
    svc = TService(cfg, state=tgs.all_singletons(cfg, "cpu"), buckets=(8,))
    tapi.GraphClient(svc).submit_many(
        [tapi.AddEdge(i, (i + 1) % 8) for i in range(8)])
    assert svc.stats()["repair_dense_steps"] > 0
    assert svc.state.ccid.tolist() == [0] * 8
    assert (tfops.frontier_min.launches, thops.probe.launches,
            tbops.bool_matmul.launches) == before


def test_entry_points_default_to_cuda():
    cfg = tgs.GraphConfig(n_vertices=8, edge_capacity=16)
    assert tgs.DEFAULT_DEVICE == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            TService(cfg)


def _crowded_edges():
    """Out-degree 2 on 512 vertices into 1024 slots under 4 probes: the
    bulk load overflows."""
    cfg = tgs.GraphConfig(n_vertices=512, edge_capacity=1024, max_probes=4)
    g = torch.Generator().manual_seed(4)
    src = torch.arange(512, dtype=torch.int32).repeat_interleave(2)
    dst = torch.randint(0, 512, (1024,), generator=g, dtype=torch.int32)
    return cfg, src, dst


def test_bulk_load_span_host_reads_and_counters():
    """``from_edges`` records one ``service.load`` span with its lanes,
    grows and re-placed keys, each grow's span inside it, one ``load``
    read a round, and the two counters in ``stats()``."""
    cfg, src, dst = _crowded_edges()
    trace.take()
    trace.enable()
    try:
        svc = TService.from_edges(cfg, src, dst, device="cpu",
                                  buckets=(64,))
    finally:
        trace.disable()
    spans, dropped = trace.take()
    assert dropped == 0
    load, = [s for s in spans if s.name == "service.load"]
    grows = [s for s in spans if s.name == "service.grow"]
    assert load.parent == 0 and not load.wait
    assert load.attrs == {"edges": 1024, "grows": svc.grow_count,
                          "replaced": svc.load_replaced_keys}
    assert svc.grow_count >= 1 and len(grows) == svc.grow_count
    assert all(s.parent == load.id for s in grows)
    # the first round drops what from_arrays drops; later rounds place it
    dropped_keys = int(tgs.from_arrays(cfg, src, dst, device="cpu").overflow)
    assert svc.load_replaced_keys == dropped_keys > 0
    assert svc.host_reads["load"] == svc.grow_count + 1
    assert set(svc.host_reads) == set(HOST_READ_SITES)
    st = svc.stats()
    assert st["load_replaced_keys"] == svc.load_replaced_keys
    assert st["grows"] == len(grows)
    assert st["live_edges"] == len(set(zip(src.tolist(), dst.tolist())))
    assert st["overflow_total"] == 0 and st["gen"] == 1
    assert st["edge_capacity"] == svc.cfg.edge_capacity > 1024


def test_bulk_load_without_overflow_matches_jax():
    """Where no key passes the probe bound, ``from_edges`` is the JAX
    package's ``from_arrays`` and ``recompute``, array for array."""
    jcfg = jgs.GraphConfig(n_vertices=NV, edge_capacity=256)
    rng = np.random.default_rng(6)
    src = np.repeat(np.arange(NV, dtype=np.int32), 2)
    dst = rng.integers(0, NV, 2 * NV).astype(np.int32)
    jstate = jdyn.recompute(jgs.from_arrays(jcfg, src, dst), jcfg)
    tcfg = carry.config_from_dict(dataclasses.asdict(jcfg))
    svc = TService.from_edges(tcfg, src, dst, device="cpu")
    got = carry.state_to_numpy(svc.state)
    for k, want in jax_arrays(jstate).items():
        np.testing.assert_array_equal(got[k], want, err_msg=k)
    assert svc.gen == int(jstate.gen) and svc.grow_count == 0

def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_nothing_of_jax():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    assert [p.name for p in examples] == [
        "community_detection_torch.py", "dynamic_scc_serving_torch.py",
        "quickstart_torch.py", "train_lm_torch.py"]
    files += examples
    files += [ROOT / "scripts" / name for name in (
        "device_profile.py", "profile_lm_torch.py", "profile_train_torch.py",
        "profile_smscc_torch.py")]
    assert len(files) > 20
    port = ROOT / "src" / "repro_torch"
    for rel in ("ckpt/checkpoint.py", "ckpt/oplog.py", "ckpt/durable.py",
                "core/replicas.py", "fault/inject.py", "ha/lease.py",
                "launch/replica.py", "launch/stream.py", "launch/chaos.py",
                "tenancy/engine.py", "tenancy/multi_service.py",
                "tenancy/queue.py", "core/baselines.py", "models/moe.py",
                "models/recsys/mind.py", "graph/segment_ops.py",
                "configs/mind.py", "configs/moonshot_v1_16b_a3b.py",
                "configs/qwen3_moe_235b_a22b.py", "data/pipeline.py",
                "optim/optimizer.py", "optim/compression.py",
                "train/trainer.py", "launch/train.py", "tree.py",
                "graph/batching.py", "graph/sampler.py",
                "models/gnn/common.py", "models/gnn/tasks.py",
                "models/gnn/egnn.py", "models/gnn/gatedgcn.py",
                "models/gnn/nequip.py", "models/gnn/mace.py",
                "configs/egnn.py", "configs/gatedgcn.py",
                "configs/nequip.py", "configs/mace.py",
                "configs/gnn_shapes.py", "carry.py"):
        assert port / rel in files, rel
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"
