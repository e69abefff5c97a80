"""The port's §7 baselines held to the JAX package's, bit for bit.

Both packages start from one booted state (``carry``) and take one seeded
stream of mixed ops (edge and vertex adds and removes, NOPs, a few ids out
of range) through ``sequential_apply``, ``coarse_apply`` and
``static_per_batch_apply``: the state (labels, edge table, counters) and
the per-op acks must be equal, and every baseline's labels must equal a
static recompute of its own final graph.  The port runs on CPU tensors,
through its kernels' plain versions.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import dynamic as jdyn
from repro.core import graph_state as jgs
from repro_torch import carry
from repro_torch.core import baselines as tbase
from repro_torch.core import dynamic as tdyn

NV = 32
_BASE = dict(n_vertices=NV, edge_capacity=256, max_probes=256,
             max_outer=NV + 1, max_inner=NV + 2)
CONFIGS = {
    "full": jgs.GraphConfig(**_BASE),
    "tiered": jgs.GraphConfig(**_BASE, dense_capacity=8,
                              dense_matmul_impl="pallas_interpret",
                              region_vertex_capacity=16,
                              region_edge_buckets=(8, 64)),
}
FNS = ("sequential_apply", "coarse_apply", "static_per_batch_apply")


def _arrays(st) -> dict:
    return {"v_alive": np.asarray(st.v_alive), "ccid": np.asarray(st.ccid),
            "src": np.asarray(st.edges.src), "dst": np.asarray(st.edges.dst),
            "state": np.asarray(st.edges.state),
            "n_ccs": np.asarray(st.n_ccs), "gen": np.asarray(st.gen),
            "overflow": np.asarray(st.overflow)}


def _ops(seed, b=24):
    rng = np.random.default_rng(seed)
    kind = rng.choice([0, 1, 2, 3, 4], b, p=[0.55, 0.2, 0.1, 0.1, 0.05])
    u = rng.integers(0, NV, b)
    v = rng.integers(0, NV, b)
    u[rng.random(b) < 0.05] = -1
    v[rng.random(b) < 0.05] = NV
    return kind.astype(np.int32), u.astype(np.int32), v.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _boot(name):
    """All vertices live plus ring-ish edges, in JAX, as numpy leaves."""
    cfg = CONFIGS[name]
    st = jgs.all_singletons(cfg)
    rng = np.random.default_rng(99)
    u = rng.integers(0, NV, 48)
    v = (u + rng.integers(1, 4, 48)) % NV
    st, _ = jdyn.apply_batch(st, jdyn.make_ops(np.zeros(48, np.int32), u, v),
                             cfg)
    return _arrays(st)


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_baseline_matches_jax(name, fn):
    cfg = CONFIGS[name]
    tcfg = carry.config_from_dict(dataclasses.asdict(cfg))
    boot = _boot(name)
    jst = jgs.GraphState(
        v_alive=jnp.asarray(boot["v_alive"]), ccid=jnp.asarray(boot["ccid"]),
        edges=type(jgs.empty(cfg).edges)(
            src=jnp.asarray(boot["src"]), dst=jnp.asarray(boot["dst"]),
            state=jnp.asarray(boot["state"])),
        n_ccs=jnp.asarray(boot["n_ccs"]), gen=jnp.asarray(boot["gen"]),
        overflow=jnp.asarray(boot["overflow"]))
    tst = carry.state_from_numpy(boot, device="cpu")
    k, u, v = _ops(1)
    jst, jok = getattr(jbase, fn)(jst, jdyn.make_ops(k, u, v), cfg)
    tst, tok = getattr(tbase, fn)(tst, tdyn.make_ops(k, u, v), tcfg)
    got, want = carry.state_to_numpy(tst), _arrays(jst)
    for leaf in want:
        np.testing.assert_array_equal(got[leaf], want[leaf], err_msg=leaf)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok.dtype == torch.bool and tok.shape == (24,)
    assert 0 < int(tok.sum()) < 24  # some ops applied, some refused
    # the baseline's labels are those of a static recompute of its graph
    fresh = tdyn.recompute(tst, tcfg)
    assert torch.equal(fresh.ccid, tst.ccid)


def _edge_ops(seed, b=24):
    """Edge adds and removes (70% adds) of distinct pairs, half of the
    removes on edges the boot made: ops that commute, so every order of
    them ends on one graph with the same acks."""
    rng = np.random.default_rng(seed)
    boot = _boot("full")
    live = boot["state"] == 1
    booted = np.stack([boot["src"][live], boot["dst"][live]], 1)
    pairs = {tuple(p) for p in booted[rng.permutation(len(booted))[:b // 4]]}
    while len(pairs) < b:
        pairs.add(tuple(int(x) for x in rng.integers(0, NV, 2)))
    u, v = np.array(sorted(pairs), np.int32)[rng.permutation(b)].T
    kind = np.where(rng.random(b) < 0.7, tdyn.ADD_EDGE, tdyn.REM_EDGE)
    return kind.astype(np.int32), u, v


def test_baselines_agree_with_the_batch_step():
    """On ops that commute, all four end on one graph, one labelling and
    the same acks."""
    cfg = carry.config_from_dict(dataclasses.asdict(CONFIGS["full"]))
    boot = _boot("full")
    ops = tdyn.make_ops(*_edge_ops(2))
    batch_st, batch_ok = tdyn.apply_batch(
        carry.state_from_numpy(boot, device="cpu"), ops, cfg)
    assert 0 < int((~batch_ok).sum()) < 24
    for fn in FNS:
        st, ok = getattr(tbase, fn)(
            carry.state_from_numpy(boot, device="cpu"), ops, cfg)
        assert torch.equal(st.ccid, batch_st.ccid), fn
        assert torch.equal(ok, batch_ok), fn
        live = st.edges.state == 1
        want = batch_st.edges.state == 1
        assert sorted(zip(st.edges.src[live].tolist(),
                          st.edges.dst[live].tolist())) == \
            sorted(zip(batch_st.edges.src[want].tolist(),
                       batch_st.edges.dst[want].tolist())), fn


def test_empty_op_batch():
    cfg = carry.config_from_dict(dataclasses.asdict(CONFIGS["full"]))
    st = carry.state_from_numpy(_boot("full"), device="cpu")
    out, ok = tbase.sequential_apply(st, tdyn.make_ops([], [], []), cfg)
    assert ok.shape == (0,) and ok.dtype == torch.bool
    assert torch.equal(out.ccid, st.ccid)
