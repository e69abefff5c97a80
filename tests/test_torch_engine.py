"""The port's engine modules held to the JAX package, bit for bit.

Each test makes its inputs from a seeded numpy generator, starts both
packages from one state (``repro_torch.carry``) and compares every output
with exact equality: edge-table results, reachability sweeps with their
round counts, static SCC labels, both region tiers, and the 5-phase step
(state, per-op ``ok``, overflow delta and RepairStats) under the repair
configurations of tests/test_repair_tiers.py.  The port runs on CPU
tensors here, i.e. through its kernels' plain versions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dynamic as jdyn
from repro.core import edge_table as _jet
from repro.core import graph_state as jgs
from repro.core import reach as _jreach
from repro.core import scc as _jscc
from repro_torch import carry
from repro_torch.core import dynamic as tdyn
from repro_torch.core import edge_table as tet
from repro_torch.core import reach as treach
from repro_torch.core import scc as tscc

SEEDS = (0, 1)


def _jit(fn, *static):
    return jax.jit(fn, static_argnames=static)


class jet:  # the JAX edge table, each op compiled once per shape
    empty = staticmethod(_jet.empty)
    _hash = staticmethod(_jet._hash)
    fill_stats = staticmethod(_jet.fill_stats)
    insert = staticmethod(_jit(_jet.insert, "max_probes"))
    remove = staticmethod(_jit(_jet.remove, "max_probes"))
    lookup = staticmethod(_jit(_jet.lookup, "max_probes"))
    remove_incident = staticmethod(jax.jit(_jet.remove_incident))
    rehash = staticmethod(_jit(_jet.rehash, "new_capacity", "max_probes"))
    compact = staticmethod(_jit(_jet.compact, "max_probes"))


class jreach:
    forward_reach = staticmethod(_jit(_jreach.forward_reach, "max_iters"))
    backward_reach = staticmethod(_jit(_jreach.backward_reach, "max_iters"))
    fused_fw_bw_reach = staticmethod(
        _jit(_jreach.fused_fw_bw_reach, "max_iters"))
    propagate_min_labels = staticmethod(
        _jit(_jreach.propagate_min_labels, "max_iters", "shortcut"))
    propagate_min_prio = staticmethod(
        _jit(_jreach.propagate_min_prio, "max_iters"))
    multi_forward_reach = staticmethod(
        _jit(_jreach.multi_forward_reach, "max_iters"))


class jscc:
    scc_static = staticmethod(_jscc.scc_static)
    compact_region = staticmethod(
        _jit(_jscc.compact_region, "v_capacity", "e_capacity"))
    scc_compact_region = staticmethod(
        _jit(_jscc.scc_compact_region, "v_capacity", "e_capacity",
             "max_outer", "max_inner"))
    scc_dense_region = staticmethod(
        _jit(_jscc.scc_dense_region, "capacity"))
NV = 32
_BASE = dict(n_vertices=NV, edge_capacity=256, max_probes=256,
             max_outer=NV + 1, max_inner=NV + 2)
# the repair configurations of tests/test_repair_tiers.py, plus the gate,
# FW/BW fusion and pointer-doubling switches
CONFIGS = {
    "full": jgs.GraphConfig(**_BASE),
    "compact": jgs.GraphConfig(**_BASE, region_vertex_capacity=16,
                               region_edge_buckets=(8, 64)),
    "tiered": jgs.GraphConfig(**_BASE, dense_capacity=8,
                              dense_matmul_impl="pallas_interpret",
                              region_vertex_capacity=16,
                              region_edge_buckets=(8, 64)),
    "tiny_edges": jgs.GraphConfig(**_BASE, region_vertex_capacity=16,
                                  region_edge_buckets=(8,)),
    "tiered_gate_off": jgs.GraphConfig(**_BASE, dense_capacity=8,
                                       dense_matmul_impl="xla",
                                       region_vertex_capacity=16,
                                       region_edge_buckets=(8, 64),
                                       repair_gate=False),
    "fuse_fwbw": jgs.GraphConfig(**_BASE, fuse_fwbw=True,
                                 region_vertex_capacity=16,
                                 region_edge_buckets=(8, 64)),
    "shortcut": jgs.GraphConfig(**_BASE, shortcut=True,
                                region_vertex_capacity=16,
                                region_edge_buckets=(8, 64)),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def jax_arrays(st) -> dict:
    return {"v_alive": np.asarray(st.v_alive), "ccid": np.asarray(st.ccid),
            "src": np.asarray(st.edges.src), "dst": np.asarray(st.edges.dst),
            "state": np.asarray(st.edges.state),
            "n_ccs": np.asarray(st.n_ccs), "gen": np.asarray(st.gen),
            "overflow": np.asarray(st.overflow)}


def port_cfg(cfg):
    return carry.config_from_dict(dataclasses.asdict(cfg))


def assert_same_state(tstate, jstate, ctx=""):
    got = carry.state_to_numpy(tstate)
    for k, want in jax_arrays(jstate).items():
        np.testing.assert_array_equal(got[k], want, err_msg=f"{ctx} {k}")


def assert_same_table(ttable, jtable, ctx=""):
    for k in ("src", "dst", "state"):
        np.testing.assert_array_equal(_np(getattr(ttable, k)),
                                      np.asarray(getattr(jtable, k)),
                                      err_msg=f"{ctx} {k}")


# ---------------------------------------------------------- edge table ---

def _table(seed, cap, n_keys, max_probes, *, n_remove=0, key_range=12):
    """The same table built in both packages by insert (+ remove)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, key_range, n_keys).astype(np.int32)
    v = rng.integers(0, key_range, n_keys).astype(np.int32)
    jt, _, _ = jet.insert(jet.empty(cap), jnp.asarray(u), jnp.asarray(v),
                          max_probes)
    tt, _, _ = tet.insert(tet.empty(cap, "cpu"), _t(u), _t(v), max_probes)
    if n_remove:
        ru, rv = u[:n_remove], v[:n_remove]
        jt, _ = jet.remove(jt, jnp.asarray(ru), jnp.asarray(rv), max_probes)
        tt, _ = tet.remove(tt, _t(ru), _t(rv), max_probes)
    return jt, tt, rng


@pytest.mark.parametrize("seed", SEEDS)
def test_insert_with_duplicates_and_enable_mask(seed):
    jt, tt, rng = _table(seed, 64, 20, 16)
    assert_same_table(tt, jt, "build")
    u = rng.integers(0, 12, 40).astype(np.int32)
    v = rng.integers(0, 12, 40).astype(np.int32)
    u[20:30], v[20:30] = u[:10], v[:10]  # intra-batch duplicates
    en = rng.random(40) < 0.8
    jt2, jins, jfail = jet.insert(jt, jnp.asarray(u), jnp.asarray(v), 16,
                                  enable=jnp.asarray(en))
    tt2, tins, tfail = tet.insert(tt, _t(u), _t(v), 16, enable=_t(en))
    assert_same_table(tt2, jt2, "insert")
    np.testing.assert_array_equal(_np(tins), np.asarray(jins))
    np.testing.assert_array_equal(_np(tfail), np.asarray(jfail))
    assert_same_table(tt, jt, "input untouched")


@pytest.mark.parametrize("seed", SEEDS)
def test_insert_overflow_reports_failed(seed):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 50, 24).astype(np.int32)
    v = rng.integers(0, 50, 24).astype(np.int32)
    jt, jins, jfail = jet.insert(jet.empty(16), jnp.asarray(u),
                                 jnp.asarray(v), 2)
    tt, tins, tfail = tet.insert(tet.empty(16, "cpu"), _t(u), _t(v), 2)
    assert np.asarray(jfail).any()
    assert_same_table(tt, jt)
    np.testing.assert_array_equal(_np(tins), np.asarray(jins))
    np.testing.assert_array_equal(_np(tfail), np.asarray(jfail))


@pytest.mark.parametrize("seed", SEEDS)
def test_lookup_remove_and_remove_incident(seed):
    jt, tt, rng = _table(seed, 64, 40, 32, n_remove=10)
    assert_same_table(tt, jt, "with tombstones")
    u = rng.integers(-1, 12, 30).astype(np.int32)
    v = rng.integers(-1, 12, 30).astype(np.int32)
    u[15:], v[15:] = u[:15], v[:15]  # duplicate removals
    jf, js = jet.lookup(jt, jnp.asarray(u), jnp.asarray(v), 32)
    tf, ts = tet.lookup(tt, _t(u), _t(v), 32)
    np.testing.assert_array_equal(_np(tf), np.asarray(jf))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    jt2, jrem = jet.remove(jt, jnp.asarray(u), jnp.asarray(v), 32)
    tt2, trem = tet.remove(tt, _t(u), _t(v), 32)
    assert_same_table(tt2, jt2, "remove")
    np.testing.assert_array_equal(_np(trem), np.asarray(jrem))
    mask = rng.random(12) < 0.3
    jt3, jkill = jet.remove_incident(jt2, jnp.asarray(mask))
    tt3, tkill = tet.remove_incident(tt2, _t(mask))
    assert_same_table(tt3, jt3, "remove_incident")
    np.testing.assert_array_equal(_np(tkill), np.asarray(jkill))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("new_cap", [64, 128])
def test_rehash_and_compact(seed, new_cap):
    jt, tt, _ = _table(seed, 64, 40, 32, n_remove=15)
    if new_cap == 64:
        jt2, tt2 = jet.compact(jt, 32), tet.compact(tt, 32)
    else:
        jt2, tt2 = jet.rehash(jt, new_cap, 32), tet.rehash(tt, new_cap, 32)
    assert_same_table(tt2, jt2)
    for a, b in zip(tet.fill_stats(tt2), jet.fill_stats(jt2)):
        assert int(a) == int(b)


def test_hash_matches_for_negative_and_large_keys():
    u = np.array([-1, 0, 1, 2 ** 31 - 1, -2 ** 31, 12345], np.int32)
    v = np.array([-1, 7, -5, 3, 2 ** 31 - 1, 0], np.int32)
    np.testing.assert_array_equal(
        _np(tet._hash(_t(u), _t(v), 1 << 20)),
        np.asarray(jet._hash(jnp.asarray(u), jnp.asarray(v), 1 << 20)))


# ------------------------------------------------------- reachability ---

def _graph(seed, nv=64, e=200):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, nv, e).astype(np.int32)
    dst = rng.integers(0, nv, e).astype(np.int32)
    live = rng.random(e) < 0.85
    allowed = rng.random(nv) < 0.9
    seeds = rng.random(nv) < 0.05
    return rng, src, dst, live, allowed, seeds


@pytest.mark.parametrize("seed", SEEDS)
def test_forward_backward_and_fused_reach(seed):
    _, src, dst, live, allowed, seeds = _graph(seed)
    ja = [jnp.asarray(x) for x in (src, dst, live)]
    ta = [_t(x) for x in (src, dst, live)]
    for jf, tf in ((jreach.forward_reach, treach.forward_reach),
                   (jreach.backward_reach, treach.backward_reach)):
        jr, jn = jf(*ja, jnp.asarray(seeds), jnp.asarray(allowed), 40)
        tr, tn = tf(*ta, _t(seeds), _t(allowed), 40)
        np.testing.assert_array_equal(_np(tr), np.asarray(jr))
        assert tn == int(jn)
    seed_b = np.roll(seeds, 7)
    jfw, jbw, jn = jreach.fused_fw_bw_reach(
        *ja, jnp.asarray(seeds), jnp.asarray(seed_b), jnp.asarray(allowed),
        40)
    tfw, tbw, tn = treach.fused_fw_bw_reach(
        *ta, _t(seeds), _t(seed_b), _t(allowed), 40)
    np.testing.assert_array_equal(_np(tfw), np.asarray(jfw))
    np.testing.assert_array_equal(_np(tbw), np.asarray(jbw))
    assert tn == int(jn)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shortcut", [False, True])
@pytest.mark.parametrize("max_iters", [3, 80])
def test_label_and_priority_propagation(seed, shortcut, max_iters):
    rng, src, dst, live, allowed, _ = _graph(seed)
    labels = np.where(rng.random(64) < 0.8, np.arange(64),
                      2 ** 31 - 1).astype(np.int32)
    jl, jn = jreach.propagate_min_labels(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(live),
        jnp.asarray(labels), jnp.asarray(allowed), max_iters,
        shortcut=shortcut)
    tl, tn = treach.propagate_min_labels(
        _t(src), _t(dst), _t(live), _t(labels), _t(allowed), max_iters,
        shortcut=shortcut)
    np.testing.assert_array_equal(_np(tl), np.asarray(jl))
    assert tn == int(jn)
    jw, jn = jreach.propagate_min_prio(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(live),
        jnp.asarray(allowed), max_iters)
    tw, tn = treach.propagate_min_prio(_t(src), _t(dst), _t(live),
                                       _t(allowed), max_iters)
    np.testing.assert_array_equal(_np(tw), np.asarray(jw))
    assert tn == int(jn)


def _giant_scc_queries(nv=1024, n_sets=2, f=32):
    """update_1m's shape of graph, small: out-degree 2 to random targets
    (one giant SCC), and ``n_sets`` Reachable batches of ``f``
    single-source frontiers, each drawn anew."""
    rng = np.random.default_rng(7)
    src = np.repeat(np.arange(nv, dtype=np.int32), 2)
    dst = rng.integers(0, nv, 2 * nv).astype(np.int32)
    live, allowed = np.ones(2 * nv, bool), np.ones(nv, bool)
    batches = []
    for _ in range(n_sets):
        seeds = np.zeros((f, nv), bool)
        seeds[np.arange(f), rng.integers(0, nv, f)] = True
        batches.append(seeds)
    return src, dst, live, allowed, batches


@pytest.mark.parametrize("seed", SEEDS + ("giant",))
def test_multi_forward_reach(seed):
    if seed == "giant":  # two seed sets over one giant-SCC graph
        src, dst, live, allowed, batches = _giant_scc_queries()
    else:
        rng, src, dst, live, allowed, _ = _graph(seed)
        batches = [rng.random((5, 64)) < 0.03]
    for seeds in batches:
        jr, jn = jreach.multi_forward_reach(
            jnp.asarray(src), jnp.asarray(dst), jnp.asarray(live),
            jnp.asarray(seeds), jnp.asarray(allowed), 40)
        tr, tn = treach.multi_forward_reach(_t(src), _t(dst), _t(live),
                                            _t(seeds), _t(allowed), 40)
        np.testing.assert_array_equal(_np(tr), np.asarray(jr))
        assert tn == int(jn)


# --------------------------------------------------------- static SCC ---

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shortcut", [False, True])
@pytest.mark.parametrize("max_outer", [2, 65])
def test_scc_static(seed, shortcut, max_outer):
    _, src, dst, live, active, _ = _graph(seed, nv=64, e=150)
    want = jscc.scc_static(jnp.asarray(src), jnp.asarray(dst),
                           jnp.asarray(live), jnp.asarray(active),
                           max_outer=max_outer, max_inner=66,
                           shortcut=shortcut)
    got = tscc.scc_static(_t(src), _t(dst), _t(live), _t(active),
                          max_outer=max_outer, max_inner=66,
                          shortcut=shortcut)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("vcap,ecap", [(64, 256), (20, 40), (8, 16)])
def test_compact_region(seed, vcap, ecap):
    rng, src, dst, live, _, _ = _graph(seed, nv=64, e=150)
    region = rng.random(64) < 0.3
    ja = [jnp.asarray(x) for x in (src, dst, live, region)]
    ta = [_t(x) for x in (src, dst, live, region)]
    for got, want in zip(tscc.compact_region(*ta, vcap, ecap),
                         jscc.compact_region(*ja, vcap, ecap)):
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    jl, jf = jscc.scc_compact_region(*ja, vcap, ecap, max_outer=65,
                                     max_inner=66)
    tl, tf = tscc.scc_compact_region(*ta, vcap, ecap, max_outer=65,
                                     max_inner=66)
    np.testing.assert_array_equal(_np(tl), np.asarray(jl))
    assert bool(tf) == bool(jf)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("capacity", [8, 24, 64])
def test_dense_region(seed, capacity):
    rng, src, dst, live, _, _ = _graph(seed, nv=64, e=150)
    region = rng.random(64) < 0.3
    ja = [jnp.asarray(x) for x in (src, dst, live, region)]
    ta = [_t(x) for x in (src, dst, live, region)]
    jl, jf = jscc.scc_dense_region(*ja, capacity)
    tl, tf = tscc.scc_dense_region(*ta, capacity)
    np.testing.assert_array_equal(_np(tl), np.asarray(jl))
    assert bool(tf) == bool(jf)


# ----------------------------------------------------- the dynamic step ---

def _op_batches(seed, n_steps, b):
    """Mixed op batches over NV vertices: edge adds dominate (so SCCs
    form and merge), with edge and vertex removals, re-adds, and a few
    out-of-range ids."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        kind = rng.choice([0, 1, 2, 3, 4], b, p=[0.55, 0.2, 0.1, 0.1, 0.05])
        u = rng.integers(0, NV, b)
        v = rng.integers(0, NV, b)
        u[rng.random(b) < 0.03] = -1
        v[rng.random(b) < 0.03] = NV
        out.append((kind.astype(np.int32), u.astype(np.int32),
                    v.astype(np.int32)))
    return out


def _boot(cfg):
    """All vertices live, plus one random ring-ish edge set, in JAX;
    carried to the port."""
    st = jgs.all_singletons(cfg)
    rng = np.random.default_rng(99)
    for _ in range(2):  # batches of 24: the step shape the tests compile
        u = rng.integers(0, NV, 24)
        v = (u + rng.integers(1, 4, 24)) % NV
        st = jdyn.apply_batch_async(
            st, jdyn.make_ops(np.zeros(24, np.int32), u, v), cfg)[0]
    return st, carry.state_from_numpy(jax_arrays(st), device="cpu")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_apply_batch_matches(name):
    cfg = CONFIGS[name]
    tcfg = port_cfg(cfg)
    jst, tst = _boot(cfg)
    assert_same_state(tst, jst, "boot")
    tiers = set()
    for i, (k, u, v) in enumerate(_op_batches(0, 8, 24)):
        jst, jok, jovf, jrep = jdyn.apply_batch_async(
            jst, jdyn.make_ops(k, u, v), cfg)
        tst, tok, tovf, trep = tdyn.apply_batch_stats(
            tst, tdyn.make_ops(k, u, v), tcfg)
        ctx = f"{name} step {i}"
        assert_same_state(tst, jst, ctx)
        np.testing.assert_array_equal(_np(tok), np.asarray(jok), ctx)
        assert int(tovf) == int(jovf), ctx
        assert tuple(trep) == tuple(int(x) for x in jrep), ctx
        tiers.add(trep.tier)
    assert tiers - {tdyn.TIER_SKIP}, f"{name}: no step ran a repair"


@pytest.mark.parametrize("name", ["tiered", "shortcut"])
def test_scan_entry_and_recompute_match(name):
    cfg = CONFIGS[name]
    tcfg = port_cfg(cfg)
    jst, tst = _boot(cfg)
    batches = _op_batches(7, 4, 24)
    stacked = [np.stack(col) for col in zip(*batches)]
    jst, jok, jovf, jrep = jdyn.apply_batch_scan(
        jst, jdyn.make_ops(*stacked), cfg)
    tst, tok, tovf, trep = tdyn.apply_batch_scan(
        tst, tdyn.make_ops(*stacked), tcfg)
    assert_same_state(tst, jst, "scan")
    np.testing.assert_array_equal(_np(tok), np.asarray(jok))
    np.testing.assert_array_equal(_np(tovf), np.asarray(jovf))
    for t_leaf, j_leaf in zip(trep, jrep):
        np.testing.assert_array_equal(np.asarray(t_leaf), np.asarray(j_leaf))
    assert_same_state(tdyn.recompute(tst, tcfg), jdyn.recompute(jst, cfg),
                      "recompute")


def test_step_overflow_and_out_of_range_lanes():
    """A table too small for the batch: both packages report the same
    overflow delta and the same accepted lanes."""
    cfg = jgs.GraphConfig(n_vertices=NV, edge_capacity=16, max_probes=2)
    jst = jgs.all_singletons(cfg)
    tst = carry.state_from_numpy(jax_arrays(jst), device="cpu")
    k, u, v = _op_batches(3, 1, 48)[0]
    k[:] = tdyn.ADD_EDGE
    jst, jok, jovf, _ = jdyn.apply_batch_async(jst, jdyn.make_ops(k, u, v),
                                               cfg)
    plain_st, plain_ok = tdyn.apply_batch(tst, tdyn.make_ops(k, u, v),
                                          port_cfg(cfg))
    tst, tok, tovf, _ = tdyn.apply_batch_stats(tst, tdyn.make_ops(k, u, v),
                                              port_cfg(cfg))
    assert int(jovf) > 0
    assert int(tovf) == int(jovf)
    np.testing.assert_array_equal(_np(tok), np.asarray(jok))
    assert_same_state(tst, jst)
    # the entry without telemetry takes the same step
    np.testing.assert_array_equal(_np(plain_ok), np.asarray(jok))
    assert_same_state(plain_st, jst)
