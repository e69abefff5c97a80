"""The port's multi-tenant serving held to the JAX package and to its own
single-tenant service, on the CPU.

Each case is the counterpart of a reference test in tests/test_tenancy.py
at its sizes (NV 24, its ``tiny_cfg``, buckets (8, 16), scan lengths
(1, 4)): the lane-batched step against ``jax.vmap`` of the JAX scan
(``repro.tenancy.engine._vmapped_scan``) on the same stacked states, bit
for bit, both its per-decision form and the device-decided form the lane
step graph captures (run here under ``tier_stream.HostCond``) over waves
whose lanes take different branches; the lane-batched kernels' plain
versions against per-lane calls;
``TenantEngine`` against the JAX engine and against one port
``SCCService`` per tenant; the service's typed clients; evict and
rehydrate (with the port's store opened by the JAX package); the
admission queue.  The port runs on CPU tensors, through its kernels'
plain versions.
"""
import dataclasses
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tier_stream

from repro.core import dynamic as jdyn
from repro.core import edge_table as jet
from repro.core import graph_state as jgs
from repro.tenancy import TenantEngine as JTenantEngine
from repro.tenancy.engine import _vmapped_scan
from repro_torch import carry
from repro_torch.core import dynamic, edge_table as et
from repro_torch.core import graph_state as gs
from repro_torch.core.service import SCCService
from repro_torch.kernels.frontier_expand import ops as fops
from repro_torch.tenancy import (MultiTenantService, QueueFull,
                                 TenantEngine, TransferBufferPool,
                                 WorkQueue)

NV = 24
CPU = torch.device("cpu")


def tiny_cfg(edge_capacity=64, nv=NV, **kw):
    return gs.GraphConfig(n_vertices=nv, edge_capacity=edge_capacity,
                          max_probes=8, max_outer=nv + 1,
                          max_inner=nv + 2, **kw)


# the reference's tiny_cfg, and the same with the dense and compact tiers
CFGS = {"tiny": tiny_cfg(),
        "tiered": tiny_cfg(dense_capacity=2, region_vertex_capacity=20,
                           region_edge_buckets=(8, 32))}
KNOBS = dict(buckets=(8, 16), scan_lengths=(1, 4))


def jax_cfg(cfg):
    return jgs.GraphConfig(**dataclasses.asdict(cfg))


def oracle_for(cfg):
    return SCCService(cfg, device=CPU, **KNOBS)


def rand_chunk(rng, n, nv=NV):
    """Mixed update chunk: mostly edge churn, some vertex churn."""
    kind = rng.choice(
        [dynamic.ADD_EDGE, dynamic.ADD_EDGE, dynamic.ADD_EDGE,
         dynamic.REM_EDGE, dynamic.ADD_VERTEX, dynamic.ADD_VERTEX,
         dynamic.REM_VERTEX], size=n).astype(np.int32)
    u = rng.integers(0, nv, n).astype(np.int32)
    v = rng.integers(0, nv, n).astype(np.int32)
    return kind, u, v


def leaves(state) -> dict:
    """A port state's leaves as numpy arrays, by carry's field names."""
    return carry.state_to_numpy(state)


def jax_leaves(st) -> dict:
    return {"v_alive": np.asarray(st.v_alive), "ccid": np.asarray(st.ccid),
            "src": np.asarray(st.edges.src), "dst": np.asarray(st.edges.dst),
            "state": np.asarray(st.edges.state),
            "n_ccs": np.asarray(st.n_ccs), "gen": np.asarray(st.gen),
            "overflow": np.asarray(st.overflow)}


def to_jax(arrays: dict):
    """A JAX GraphState from carry's numpy leaves (any leading axes)."""
    a = {k: jnp.asarray(v) for k, v in arrays.items()}
    return jgs.GraphState(
        v_alive=a["v_alive"], ccid=a["ccid"],
        edges=jet.EdgeTable(src=a["src"], dst=a["dst"], state=a["state"]),
        n_ccs=a["n_ccs"], gen=a["gen"], overflow=a["overflow"])


def assert_leaves_equal(got: dict, want: dict, ctx=""):
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{ctx} {k}")


def assert_tenant_matches(engine_state, engine_cfg, engine_gen, oracle,
                          ctx=""):
    assert engine_gen == oracle.gen, ctx
    assert engine_cfg == oracle.cfg, ctx
    assert torch.equal(engine_state.ccid, oracle.state.ccid), ctx
    got_edges = SCCService(engine_cfg, state=engine_state).edge_set()
    assert got_edges == oracle.edge_set(), ctx


def _history_states(cfg, n_lanes, seed):
    """One state per lane, each after its own random history (port solo
    steps, which tests/test_torch_engine.py holds to the JAX step)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_lanes):
        st = gs.all_singletons(cfg, CPU)
        for _ in range(2 + i):
            k, u, v = rand_chunk(rng, 16)
            st = dynamic.apply_batch(st, dynamic.make_ops(k, u, v), cfg)[0]
        out.append(st)
    return out


# ------------------------------------------------------ the lane step ---


@pytest.mark.parametrize("name", list(CFGS))
def test_lane_scan_matches_jax_vmapped_scan(name):
    """dynamic.apply_batch_scan_lanes == jax.vmap of the JAX scan on the
    same stacked states: state leaves, ok [T, K, B], overflow [T, K] and
    RepairStats [T, K], bit for bit; lane 2 runs NOPs only."""
    cfg = CFGS[name]
    t_n, k_n, b = 3, 4, 8
    solos = _history_states(cfg, t_n, seed=5)
    stacked = gs.stack(solos)
    rng = np.random.default_rng(17)
    pk = np.full((t_n, k_n, b), dynamic.NOP, np.int32)
    pu = np.zeros((t_n, k_n, b), np.int32)
    pv = np.zeros((t_n, k_n, b), np.int32)
    for t in range(t_n - 1):
        for k in range(k_n):
            pk[t, k], pu[t, k], pv[t, k] = rand_chunk(rng, b)
    pu[0, 1, 0], pv[1, 2, 3] = -1, NV  # out-of-range lanes
    got = dynamic.apply_batch_scan_lanes(stacked,
                                         dynamic.make_ops(pk, pu, pv), cfg)
    jstates = to_jax(leaves(stacked))
    want = _vmapped_scan(jstates, jdyn.make_ops(pk, pu, pv), jax_cfg(cfg))
    assert_leaves_equal(leaves(got[0]), jax_leaves(want[0]), name)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for t_leaf, j_leaf in zip(got[3], want[3]):
        np.testing.assert_array_equal(t_leaf, np.asarray(j_leaf))
    tiers = set(got[3].tier[:t_n - 1].reshape(-1).tolist())
    assert tiers - {dynamic.TIER_SKIP}, "no lane ran a repair"
    assert set(got[3].tier[t_n - 1].tolist()) == {dynamic.TIER_SKIP}
    if name == "tiered":
        assert {dynamic.TIER_DENSE, dynamic.TIER_COMPACT} <= tiers
    # T = 1 is today's apply_batch_scan
    one = dynamic.apply_batch_scan_lanes(
        gs.stack(solos[:1]), dynamic.make_ops(pk[:1], pu[:1], pv[:1]), cfg)
    solo = dynamic.apply_batch_scan(solos[0], dynamic.make_ops(
        pk[0], pu[0], pv[0]), cfg)
    assert_leaves_equal(leaves(gs.lane(one[0], 0)), leaves(solo[0]), "T=1")
    assert torch.equal(one[1][0], solo[1])
    assert torch.equal(one[2][0], solo[2])
    assert [tuple(x[0]) for x in one[3]] == [tuple(x) for x in solo[3]]


def _decided_scan(states, ops, cfg):
    """The lane step graph's body (``dynamic._step_lanes`` handed a
    capture) step by step on the CPU, each IF node a ``HostCond``:
    ``(states, ok [T, K, B], ovf [T, K], stats int32[T, K, 3])``."""
    outs = []
    for k in range(ops.kind.shape[1]):
        states, *out = dynamic._step_lanes(
            states, dynamic.OpBatch(*(x[:, k] for x in ops)), cfg,
            graph=tier_stream.HostCond())
        outs.append(out)
    return (states, *(torch.stack(x, 1) for x in zip(*outs)))


def _branch(cfg, stats):
    tier, rv, re_ = (int(x) for x in stats)
    if tier == dynamic.TIER_SKIP:
        return "skip"
    code = dynamic.tier_code(cfg, torch.tensor(rv, dtype=torch.int32),
                             torch.tensor(re_, dtype=torch.int32))
    return dynamic.branches(cfg)[int(code)]


def _lane_waves(t_n, k_n, b, seed):
    """tier_stream's built wave, then a seeded random one."""
    rng = np.random.default_rng(seed)
    rand = [np.empty((t_n, k_n, b), np.int32) for _ in range(3)]
    for t in range(t_n):
        for k in range(k_n):
            for x, y in zip(rand, rand_chunk(rng, b)):
                x[t, k] = y
    return [tier_stream.lane_wave(), tuple(rand)]


def test_decided_lane_step_matches_eager_and_jax():
    """The device-decided lane step (the lane graph's IF nodes run on the
    host) == the per-decision lane step == ``jax.vmap`` of the JAX scan,
    bit for bit, over two waves from all singletons: state leaves, ok,
    overflow and per-lane RepairStats.  In the first wave the lanes of
    one step choose different branches, and the wave takes the skip, the
    dense tier, both compact buckets and the full tier."""
    cfg = CFGS["tiered"]
    assert cfg == gs.GraphConfig(**tier_stream.LANE_CONFIG)
    t_n, k_n, b = 3, 4, tier_stream.LANE_B
    states = gs.stack([gs.all_singletons(cfg, CPU)] * t_n)
    jstates = to_jax(leaves(states))
    for w, (pk, pu, pv) in enumerate(_lane_waves(t_n, k_n, b, seed=23)):
        ops = dynamic.make_ops(pk, pu, pv)
        got = _decided_scan(states, ops, cfg)
        eager = dynamic.apply_batch_scan_lanes(states, ops, cfg)
        want = _vmapped_scan(jstates, jdyn.make_ops(pk, pu, pv),
                             jax_cfg(cfg))
        assert_leaves_equal(leaves(got[0]), leaves(eager[0]), f"wave {w}")
        assert_leaves_equal(leaves(got[0]), jax_leaves(want[0]), f"wave {w}")
        for x, e, j in zip(got[1:3], eager[1:3], want[1:3]):
            assert torch.equal(x, e)
            np.testing.assert_array_equal(x.numpy(), np.asarray(j))
        assert torch.equal(got[3], torch.stack(tuple(eager[3]), -1))
        np.testing.assert_array_equal(
            got[3].numpy(), np.stack([np.asarray(x) for x in want[3]], -1))
        if w == 0:
            by_step = [{_branch(cfg, got[3][t, k]) for t in range(t_n)}
                       for k in range(k_n)]
            assert max(len(x) for x in by_step) == t_n, by_step
            assert set().union(*by_step) == \
                {"skip", *dynamic.branches(cfg)}, by_step
        states, jstates = got[0], want[0]


def test_decided_lane_step_gate_off_matches_eager():
    """With the repair gate off every lane repairs: the device-decided
    lane step == the per-decision one over tier_stream's lane wave."""
    cfg = dataclasses.replace(CFGS["tiered"], repair_gate=False)
    ops = dynamic.make_ops(*tier_stream.lane_wave())
    states = gs.stack([gs.all_singletons(cfg, CPU)] * 3)
    got = _decided_scan(states, ops, cfg)
    eager = dynamic.apply_batch_scan_lanes(states, ops, cfg)
    assert_leaves_equal(leaves(got[0]), leaves(eager[0]))
    for x, e in zip(got[1:3], eager[1:3]):
        assert torch.equal(x, e)
    assert torch.equal(got[3], torch.stack(tuple(eager[3]), -1))
    assert (got[3][..., 0] != dynamic.TIER_SKIP).all()


# ------------------------------------------- lane-batched plain versions ---


@pytest.mark.parametrize("mode", ["min", "pair", "or"])
def test_frontier_gather_lanes_match_per_lane_calls(mode):
    """The [T, E] form of frontier_gather == one call per lane, with
    ragged rows (dead edges, -1 and out-of-range ids)."""
    g = torch.Generator().manual_seed(3)
    t_n, e, nv = 4, 60, 20
    src = torch.randint(-1, nv + 2, (t_n, e), generator=g, dtype=torch.int32)
    dst = torch.randint(-1, nv + 2, (t_n, e), generator=g, dtype=torch.int32)
    live = torch.rand((t_n, e), generator=g) < 0.7
    live[2] = False  # a row with no live edge
    f = {"min": 3, "pair": 2, "or": 2}[mode]
    val = torch.randint(-2 ** 31, 2 ** 31 - 1, (t_n, f, nv), generator=g,
                        dtype=torch.int32)
    if mode != "or":
        val[torch.rand(val.shape, generator=g) < 0.4] = fops.SENT_WORD
    got = fops.frontier_gather(src, dst, live, val, nv, mode=mode)
    want = torch.stack([fops.frontier_gather(src[t], dst[t], live[t],
                                             val[t], nv, mode=mode)
                        for t in range(t_n)])
    assert torch.equal(got, want)
    if mode == "min":  # the [T, n_src] form (F = 1)
        one = fops.frontier_gather(src, dst, live,
                                   val[:, 0].contiguous(), nv)
        assert torch.equal(one, want[:, 0])


def test_edge_table_lanes_match_per_row_calls():
    """Insert, lookup and remove over a [T, C] table == the same calls per
    row: a key duplicated across rows lands in each row, duplicates within
    a row once, and one nearly full row has failing lanes while the
    others place every key."""
    rng = np.random.default_rng(8)
    t_n, cap, b, mp = 3, 64, 12, 6
    rows = [et.empty(cap, CPU) for _ in range(t_n)]
    # row 1 nearly full: later inserts there run out of probes
    fill_u = torch.arange(100, 160, dtype=torch.int32)
    rows[1], _, _ = et.insert(rows[1], fill_u, fill_u + 1, cap)
    table = et.EdgeTable(*(torch.stack(c) for c in zip(*rows)))
    u = torch.from_numpy(rng.integers(0, 6, (t_n, b)).astype(np.int32))
    v = torch.from_numpy(rng.integers(0, 6, (t_n, b)).astype(np.int32))
    u[:, 0], v[:, 0] = 2, 3  # the same key in every row
    enable = torch.from_numpy(rng.random((t_n, b)) < 0.9)
    got_t, placed, failed = et.insert(table, u, v, mp, enable=enable)
    outs = [et.insert(rows[t], u[t], v[t], mp, enable=enable[t])
            for t in range(t_n)]
    for t, (row_t, pl, fl) in enumerate(outs):
        for k in ("src", "dst", "state"):
            assert torch.equal(getattr(got_t, k)[t], getattr(row_t, k))
        assert torch.equal(placed[t], pl) and torch.equal(failed[t], fl)
    assert bool(failed[1].any()) and not bool(failed[[0, 2]].any())
    assert bool(placed[[0, 2], 0].all())  # the shared key, once per row
    found, slot = et.lookup(got_t, u, v, mp)
    for t, (row_t, _, _) in enumerate(outs):
        f1, s1 = et.lookup(row_t, u[t], v[t], mp)
        assert torch.equal(found[t], f1) and torch.equal(slot[t], s1)
    gone_t, removed = et.remove(got_t, u, v, mp)
    for t, (row_t, _, _) in enumerate(outs):
        row_g, r1 = et.remove(row_t, u[t], v[t], mp)
        assert torch.equal(gone_t.state[t], row_g.state)
        assert torch.equal(removed[t], r1)
    live, tomb = et.fill_stats(gone_t)
    assert live.tolist() == [int(et.fill_stats(r)[0]) for r in
                             (et.EdgeTable(*(c[t] for c in gone_t))
                              for t in range(t_n))]
    assert tomb.shape == (t_n,)


# --------------------------------------------------------------- engine


def test_engine_differential_vs_jax_engine_and_oracles():
    """3 tenants, 14 interleaved waves of random mixed chunks (varying
    sizes -> different buckets, shape-grouped dispatches, idle tenants):
    acks, gens, labels and edge sets match the JAX package's TenantEngine
    and three port single-tenant services bit for bit."""
    cfg = CFGS["tiny"]
    eng = TenantEngine(tenant_batches=(1, 2, 3), device=CPU, **KNOBS)
    jeng = JTenantEngine(tenant_batches=(1, 2, 3), **KNOBS)
    tids = ["a", "b", "c"]
    for tid in tids:
        eng.create_tenant(tid, cfg)
        jeng.create_tenant(tid, jax_cfg(cfg))
    oracles = {tid: oracle_for(cfg) for tid in tids}
    rng = np.random.default_rng(7)
    for round_i in range(14):
        wave, want = [], {}
        for tid in tids:
            if round_i and rng.random() < 0.25:
                continue            # idle tenant: must not be stepped
            n = int(rng.integers(1, 25))
            kind, u, v = rand_chunk(rng, n)
            wave.append((tid, kind, u, v))
            want[tid] = oracles[tid]._apply_ops(kind, u, v)
        res = eng.apply_chunks(wave)
        jres = jeng.apply_chunks(wave)
        for tid, (want_ok, want_gen) in want.items():
            got_ok, got_gen = res[tid]
            assert np.array_equal(got_ok, want_ok), (round_i, tid)
            assert np.array_equal(got_ok, jres[tid][0]), (round_i, tid)
            assert got_gen == want_gen == jres[tid][1], (round_i, tid)
    for tid in tids:
        assert_tenant_matches(eng.tenant_state(tid), eng.tenant_cfg(tid),
                              eng.tenant_gen(tid), oracles[tid], tid)
        assert_leaves_equal(leaves(eng.tenant_state(tid)),
                            jax_leaves(jeng.tenant_state(tid)), tid)
    assert eng.compile_count <= eng.compile_bound
    assert eng.compile_count == jeng.compile_count
    # cross-tenant queries answer from committed lanes, as the JAX engine
    items = [(tid, rng.integers(-1, NV + 1, 5), rng.integers(0, NV, 5))
             for tid in tids]
    got = eng.same_scc_many(items)
    jgot = jeng.same_scc_many(items)
    for tid in tids:
        assert np.array_equal(got[tid][0], jgot[tid][0])
        assert got[tid][1] == jgot[tid][1]
    got = eng.community_of_many([(tid, u) for tid, u, _ in items])
    jgot = jeng.community_of_many([(tid, u) for tid, u, _ in items])
    for tid in tids:
        assert np.array_equal(got[tid][0], jgot[tid][0])


def test_engine_overflow_isolation():
    """Tenant 'hog' overflows its tiny table and takes the solo
    grow-and-replay fallback; the victims sharing its dispatches commit
    from the same wave untouched (zero fallbacks) and everyone stays
    bit-identical to their oracle."""
    cfg = tiny_cfg(edge_capacity=8)
    eng = TenantEngine(tenant_batches=(1, 2, 3), device=CPU, **KNOBS)
    tids = ["hog", "v1", "v2"]
    for tid in tids:
        eng.create_tenant(tid, cfg)
    oracles = {tid: oracle_for(cfg) for tid in tids}
    rng = np.random.default_rng(11)
    boot = np.arange(NV, dtype=np.int32)
    for tid in tids:
        kind = np.full(NV, dynamic.ADD_VERTEX, np.int32)
        want = oracles[tid]._apply_ops(kind, boot, boot)
        got = eng.apply_chunks([(tid, kind, boot, boot)])[tid]
        assert np.array_equal(got[0], want[0])
    for round_i in range(6):
        wave, want = [], {}
        ku = rng.integers(0, NV, 16).astype(np.int32)
        kv = rng.integers(0, NV, 16).astype(np.int32)
        kind = np.full(16, dynamic.ADD_EDGE, np.int32)
        wave.append(("hog", kind, ku, kv))
        want["hog"] = oracles["hog"]._apply_ops(kind, ku, kv)
        for tid in ("v1", "v2"):
            k, u, v = rand_chunk(rng, 4)
            k[:] = np.where(k == dynamic.ADD_EDGE, dynamic.NOP, k)
            wave.append((tid, k, u, v))
            want[tid] = oracles[tid]._apply_ops(k, u, v)
        res = eng.apply_chunks(wave)
        for tid in tids:
            got_ok, got_gen = res[tid]
            assert np.array_equal(got_ok, want[tid][0]), (round_i, tid)
            assert got_gen == want[tid][1], (round_i, tid)
    hog = eng.tenant_telemetry("hog")
    assert hog["fallback_chunks"] > 0, "hog never overflowed"
    assert hog["grows"] > 0
    assert eng.tenant_cfg("hog").edge_capacity > 8
    assert eng.stats()["solo_replays"] == hog["fallback_chunks"]
    for tid in ("v1", "v2"):
        assert eng.tenant_telemetry(tid)["fallback_chunks"] == 0
    for tid in tids:
        assert_tenant_matches(eng.tenant_state(tid), eng.tenant_cfg(tid),
                              eng.tenant_gen(tid), oracles[tid], tid)


def test_engine_compile_bound():
    """The dispatch registry stays under the asserted ``tenant_batches x
    scan_lengths x buckets x cfgs`` ceiling, and idle-shape entries are
    never minted: 3 tenants split as tb=2 + tb=1."""
    cfg = tiny_cfg()
    eng = TenantEngine(buckets=(8,), scan_lengths=(1,),
                       tenant_batches=(1, 2), device=CPU)
    for tid in ("a", "b", "c"):
        eng.create_tenant(tid, cfg)
    rng = np.random.default_rng(3)
    for _ in range(4):
        eng.apply_chunks([(tid, *rand_chunk(rng, 8))
                          for tid in ("a", "b", "c")])
    assert eng.compile_count == 2
    assert eng.compile_count <= eng.compile_bound == 2


# -------------------------------------------------------------- service


def test_service_clients_differential():
    """Typed per-tenant GraphClient sessions over the admission queue:
    update acks and RYW generations match per-tenant oracles, and queries
    answer from the committed lane."""
    from repro_torch.api import AddEdge, AddVertex, SameSCC
    from repro_torch.core.service import same_scc_on

    cfg = tiny_cfg()
    mts = MultiTenantService(cfg, tenant_batches=(1, 2), coalesce_ops=64,
                             flush_deadline_s=0.0, device=CPU, **KNOBS)
    t0, t1 = mts.create_tenant(), mts.create_tenant()
    oracles = {t0: oracle_for(cfg), t1: oracle_for(cfg)}
    clients = {tid: mts.client(tid) for tid in (t0, t1)}
    rng = np.random.default_rng(5)
    for tid in (t0, t1):
        res = clients[tid].submit_many([AddVertex(i) for i in range(NV)])
        kind = np.full(NV, dynamic.ADD_VERTEX, np.int32)
        ids = np.arange(NV, dtype=np.int32)
        want_ok, want_gen = oracles[tid]._apply_ops(kind, ids, ids)
        assert [r.value for r in res] == want_ok.tolist()
        assert all(r.gen == want_gen for r in res)
    for _ in range(5):
        for tid in (t0, t1):
            pairs = rng.integers(0, NV, (6, 2)).astype(np.int32)
            res = clients[tid].submit_many(
                [AddEdge(int(a), int(b)) for a, b in pairs])
            kind = np.full(6, dynamic.ADD_EDGE, np.int32)
            want_ok, want_gen = oracles[tid]._apply_ops(
                kind, pairs[:, 0], pairs[:, 1])
            assert [r.value for r in res] == want_ok.tolist()
            assert all(r.gen == want_gen for r in res)
    for tid in (t0, t1):
        qs = [SameSCC(int(a), int(b)) for a, b in
              rng.integers(0, NV, (8, 2))]
        got = [r.value for r in clients[tid].submit_many(qs)]
        want = same_scc_on(oracles[tid].state, oracles[tid].cfg,
                           [q.u for q in qs], [q.v for q in qs])
        assert got == want.tolist()
        assert mts.tenant_gen(tid) == oracles[tid].gen
    for tid in (t0, t1):
        clients[tid].close()
    mts.close()


def test_service_evict_rehydrate_roundtrip(tmp_path):
    """Evict parks the tenant on disk (lane released, stats preserved);
    the next touch rebuilds it from snapshot + WAL tail bit-identically,
    post-rehydration writes keep matching the oracle, and the port's
    per-tenant store opens in the JAX package's DurableService."""
    from repro.ckpt.durable import DurableService as JDurableService

    cfg = tiny_cfg()
    mts = MultiTenantService(cfg, tenant_batches=(1, 2),
                             directory=str(tmp_path), coalesce_ops=64,
                             flush_deadline_s=0.0, device=CPU, **KNOBS)
    tid = mts.create_tenant()
    other = mts.create_tenant()
    oracle = oracle_for(cfg)
    sess = mts.session(tid)
    rng = np.random.default_rng(9)
    boot = np.arange(NV, dtype=np.int32)
    kind = np.full(NV, dynamic.ADD_VERTEX, np.int32)
    sess._apply_ops(kind, boot, boot)
    oracle._apply_ops(kind, boot, boot)
    for _ in range(4):
        k, u, v = rand_chunk(rng, 12)
        got = sess._apply_ops(k, u, v)
        want = oracle._apply_ops(k, u, v)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    pre_gen = mts.tenant_gen(tid)
    pre_ccid = sess.state.ccid.clone()

    mts.evict(tid)
    st = mts.tenant_stats(tid)
    assert st["resident"] is False and st["evictions"] == 1
    assert st["gen"] == pre_gen
    assert mts.tenant_gen(tid) == pre_gen
    assert mts.engine.occupancy()["tenants"] == 1, \
        "evicted lane was not released"
    assert other in mts.engine.tenant_ids()

    assert torch.equal(sess.state.ccid, pre_ccid)   # touch: rehydrate
    assert mts.tenant_stats(tid)["rehydrations"] == 1
    assert mts.tenant_gen(tid) == pre_gen
    for _ in range(3):
        k, u, v = rand_chunk(rng, 10)
        got = sess._apply_ops(k, u, v)
        want = oracle._apply_ops(k, u, v)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    assert_tenant_matches(sess.state, sess.cfg, mts.tenant_gen(tid),
                          oracle, "post-rehydration")
    mts.close()
    j = JDurableService.open(str(tmp_path / "tenants" / tid),
                             snapshot_every=0)
    assert j.gen == oracle.gen
    assert_leaves_equal(leaves(oracle.state), jax_leaves(j.state), "jax")
    j.close()


# ---------------------------------------------------------------- queue


def test_queue_backpressure_and_flush_triggers():
    """Over-budget submits are rejected immediately with a retry hint; an
    under-budget lone submit flushes by deadline; a size-triggered wave
    coalesces several tenants."""
    gate = threading.Event()
    waves = []

    def apply_fn(reqs):
        gate.wait(10)
        waves.append(sorted(t for t, *_ in reqs))
        return {t: (np.ones(k.shape[0], bool), 1) for t, k, u, v in reqs}

    q = WorkQueue(apply_fn, max_pending_ops=8, coalesce_ops=64,
                  flush_deadline_s=0.01)
    z4 = np.zeros(4, np.int32)
    leader = threading.Thread(target=lambda: q.submit("a", z4, z4, z4))
    leader.start()
    time.sleep(0.1)          # leader hit its deadline, is inside apply_fn
    z8 = np.zeros(8, np.int32)
    follower = threading.Thread(target=lambda: q.submit("b", z8, z8, z8))
    follower.start()
    time.sleep(0.05)         # follower admitted: budget now full
    with pytest.raises(QueueFull) as ei:
        q.submit("c", z4, z4, z4)
    assert ei.value.retry_after > 0 and ei.value.retryable
    assert q.stats()["rejects"] == 1
    gate.set()
    leader.join(5)
    follower.join(5)
    assert not leader.is_alive() and not follower.is_alive()
    assert q.stats()["flush_causes"]["deadline"] >= 1
    assert ["a"] in waves and ["b"] in waves

    q2 = WorkQueue(apply_fn, max_pending_ops=64, coalesce_ops=8,
                   flush_deadline_s=5.0)
    gate.clear()
    waves.clear()
    ts = [threading.Thread(target=lambda t=t: q2.submit(t, z4, z4, z4))
          for t in ("x", "y")]
    for t in ts:
        t.start()
    time.sleep(0.1)
    gate.set()
    for t in ts:
        t.join(5)
        assert not t.is_alive()
    assert q2.stats()["flush_causes"]["size"] >= 1
    assert ["x", "y"] in waves, f"no coalesced wave in {waves}"


def test_transfer_pool_reuse():
    """Steady-state submits recycle pooled buffers (no allocation)."""
    pool = TransferBufferPool(buckets=(8, 32), per_bucket=2)
    a = pool.acquire(5)
    assert a.cap == 8
    pool.release(a)
    assert pool.acquire(7) is a, "freelist buffer was not reused"
    big = pool.acquire(100)          # oversize: one-off exact alloc
    assert big.cap == 100
    pool.release(big)                # not pooled
    assert pool.acquire(100) is not big
    s = pool.stats()
    assert s["hits"] == 1 and s["misses"] >= 2
