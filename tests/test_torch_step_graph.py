"""The step graph's decisions, held to the JAX package on the CPU.

On the card an SMSCC update step is one replay of a captured CUDA graph
(``repro_torch.core.step_graph``): the static SCC's outer loop runs inside
the frontier kernel's ``scc`` form, and the repair gate and the tier
choice are conditional nodes fed by device values (``dynamic.tier_code``).
The kernel and the graph are held to the eager step on the card by
``tests/test_torch_gpu.py`` (marker ``gpu``).  Here, on CPU tensors, the
plain versions of those decisions are held to the JAX package, exactly:

- the ``scc`` form's plain version (``ref.scc_loop`` over the plain
  fixpoints) equals JAX ``scc_static`` with pointer doubling on and off,
  under ``max_outer`` caps that cut a deep chain of SCCs short, on an
  empty active set, and over tenant lanes of different depths (each lane
  its solo JAX run, its outer rounds its own);
- ``tier_code`` equals ``_tier_of`` on a grid of region sizes that takes
  every bucket edge and capacity and one either side, and equals the tier
  the JAX step reports for regions built to those sizes;
- the port's RepairStats (int32 tensors) equal the JAX step's over a
  seeded stream that takes the skip, the dense tier, every compact bucket
  and the full tier (``tier_stream.py``), step by step and through the
  scan entry;
- the step's device-decided form, the body the step graph captures, run
  here with its IF nodes decided on the host (``tier_stream.HostCond``),
  equals the per-decision step at every step of that stream.

Inputs come from seeded numpy generators at a few dozen vertices.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tier_stream
from repro.core import dynamic as jdyn
from repro.core import edge_table as jet
from repro.core import graph_state as jgs
from repro.core import scc as _jscc
from repro_torch import carry
from repro_torch.core import dynamic as tdyn
from repro_torch.core import graph_state as tgs
from repro_torch.kernels.frontier_expand import ref as fref

INT32_MAX = 2 ** 31 - 1
NV = 96
CHAIN = 8  # SCCs in the chain: one outer round each

jscc_static = jax.jit(_jscc.scc_static,
                      static_argnames=("max_outer", "max_inner", "shortcut"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _chain_graph(seed, depth=CHAIN, nv=NV, e=150, p_active=0.9):
    """``depth`` 2-cycles {2i, 2i+1} chained 2i+1 -> 2i+2 (with min
    labels the static SCC settles one a round: each one's forward label is
    0 until those before it are assigned), then random edges among the
    other vertices and random inactive slots."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for i in range(depth):
        src += [2 * i, 2 * i + 1]
        dst += [2 * i + 1, 2 * i]
        if i + 1 < depth:
            src.append(2 * i + 1)
            dst.append(2 * i + 2)
    lo = 2 * depth
    src += list(rng.integers(lo, nv, e))
    dst += list(rng.integers(lo, nv, e))
    src, dst = np.array(src, np.int32), np.array(dst, np.int32)
    live = rng.random(src.shape[0]) < 0.9
    live[:3 * depth] = True
    active = rng.random(nv) < p_active
    active[:lo] = True
    return src, dst, live, active


def _jax_scc(src, dst, live, active, max_outer, shortcut):
    return np.asarray(jscc_static(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(live),
        jnp.asarray(active), max_outer=max_outer, max_inner=NV + 2,
        shortcut=shortcut))


@pytest.mark.parametrize("shortcut", [False, True])
@pytest.mark.parametrize("max_outer", [1, 2, NV + 1])
def test_scc_form_plain_matches_jax(shortcut, max_outer):
    args = _chain_graph(3)
    tally = {}
    got, outer = fref.frontier_fixpoint(
        "scc", *(_t(x) for x in args[:3]), _t(args[3]), None, NV + 2,
        shortcut=shortcut, max_outer=max_outer, tally=tally)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_scc(*args, max_outer, shortcut))
    _, needed = fref.frontier_fixpoint(
        "scc", *(_t(x) for x in args[:3]), _t(args[3]), None, NV + 2,
        shortcut=shortcut, max_outer=NV + 1)
    assert int(needed) > 2  # so caps 1 and 2 cut the loop short
    assert int(outer) == min(max_outer, int(needed)) == tally["scc"]
    if max_outer < int(needed):  # the cap left vertices unassigned
        assert (got.numpy()[args[3]] == INT32_MAX).any()
    assert tally["trim"] >= int(outer)
    assert tally["prio" if shortcut else "label"] >= 2 * int(outer)


@pytest.mark.parametrize("shortcut", [False, True])
def test_scc_form_plain_empty_active(shortcut):
    src, dst, live, active = _chain_graph(4)
    active[:] = False
    tally = {}
    got, outer = fref.frontier_fixpoint(
        "scc", _t(src), _t(dst), _t(live), _t(active), None, NV + 2,
        shortcut=shortcut, max_outer=NV + 1, tally=tally)
    assert (got.numpy() == INT32_MAX).all() and int(outer) == 0
    assert tally == {"scc": 0}
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_scc(src, dst, live, active, NV + 1,
                                           shortcut))


@pytest.mark.parametrize("shortcut", [False, True])
def test_scc_form_plain_lanes_match_solo_jax(shortcut):
    """Lanes of chains 0 (no active vertex), 3 and 8 deep: each lane's
    labels are its solo JAX run and its outer rounds its own, under a cap
    that cuts the deepest."""
    depths = (0, 3, CHAIN)
    cap = 5
    lanes = []
    for i, d in enumerate(depths):
        src, dst, live, active = _chain_graph(10 + i, depth=max(d, 1))
        if d == 0:
            active[:] = False
        lanes.append((src, dst, live, active))
    e = max(x[0].shape[0] for x in lanes)

    def pad(a, fill):
        return np.concatenate([a, np.full(e - a.shape[0], fill, a.dtype)])
    stack = [np.stack([pad(x[k], f) for x in lanes])
             for k, f in ((0, 0), (1, 0), (2, False))]
    stack.append(np.stack([x[3] for x in lanes]))
    got, outer = fref.frontier_fixpoint(
        "scc", *(_t(x) for x in stack), None, NV + 2, shortcut=shortcut,
        max_outer=cap)
    assert outer.tolist() == [min(d, cap) for d in depths]
    for t, x in enumerate(lanes):
        np.testing.assert_array_equal(got[t].numpy(),
                                      _jax_scc(*x, cap, shortcut))


GRID_CFGS = {
    "tiered": tgs.GraphConfig(**tier_stream.CONFIG),
    "compact": tgs.GraphConfig(**dict(tier_stream.CONFIG, dense_capacity=0)),
    "dense_full": tgs.GraphConfig(**dict(tier_stream.CONFIG,
                                         region_vertex_capacity=0)),
    "full": tgs.GraphConfig(**dict(tier_stream.CONFIG, dense_capacity=0,
                                   region_vertex_capacity=0)),
}


def _edges_of_grid(cfg):
    """Every bucket edge, capacity and one either side."""
    pts = {0, 1}
    for x in (cfg.dense_capacity, cfg.region_vertex_capacity,
              *cfg.region_edge_buckets):
        pts |= {x - 1, x, x + 1}
    return sorted(p for p in pts if p >= 0)


@pytest.mark.parametrize("name", list(GRID_CFGS))
def test_tier_code_matches_tier_of_on_a_grid(name):
    cfg = GRID_CFGS[name]
    pts = _edges_of_grid(cfg)
    rv, re_ = (torch.tensor(x, dtype=torch.int32)
               for x in zip(*itertools.product(pts, pts)))
    codes = tdyn.tier_code(cfg, rv, re_)
    br = tdyn.branches(cfg)
    for v, e, c in zip(rv.tolist(), re_.tolist(), codes.tolist()):
        assert br[c] == tdyn._tier_of(cfg, v, e), (v, e)
        # a 0-d pair, as the step computes it
        assert int(tdyn.tier_code(cfg, torch.tensor(v, dtype=torch.int32),
                                  torch.tensor(e, dtype=torch.int32))) == c


def _star_state(cfg, rv, re_):
    """A state whose one multi-vertex class is vertex 0 joined both ways
    to 1..rv, with ``re_`` more edges among 1..rv: removing vertex 0
    leaves a region of exactly rv vertices and re_ live edges.  Built in
    the port (CPU), carried to JAX."""
    pairs = [(a, b) for a in range(1, rv + 1) for b in range(1, rv + 1)
             if a != b][:re_]
    src = [0] * rv + list(range(1, rv + 1)) + [a for a, _ in pairs]
    dst = list(range(1, rv + 1)) + [0] * rv + [b for _, b in pairs]
    tst = tdyn.recompute(tgs.from_arrays(cfg, src, dst, device="cpu"), cfg)
    j = carry.state_to_numpy(tst)
    jst = jgs.GraphState(
        v_alive=jnp.asarray(j["v_alive"]), ccid=jnp.asarray(j["ccid"]),
        edges=jet.EdgeTable(src=jnp.asarray(j["src"]),
                            dst=jnp.asarray(j["dst"]),
                            state=jnp.asarray(j["state"])),
        n_ccs=jnp.asarray(j["n_ccs"]), gen=jnp.asarray(j["gen"]),
        overflow=jnp.asarray(j["overflow"]))
    return tst, jst


@pytest.mark.parametrize("name", ["tiered", "compact"])
def test_tier_code_matches_the_jax_step(name):
    """Regions built to each grid size the graph allows (rv >= 1, re <=
    rv (rv - 1)): the JAX step reports those sizes and the tier that
    tier_code picks; the port's step reports the same stats."""
    cfg = GRID_CFGS[name]
    jcfg = jgs.GraphConfig(**dataclasses.asdict(cfg))
    pts = [p for p in _edges_of_grid(cfg) if 1 <= p <= 17]
    kind = np.full(4, tdyn.NOP, np.int32)
    kind[0] = tdyn.REM_VERTEX
    zeros = np.zeros(4, np.int32)
    for rv, re_ in itertools.product(pts, _edges_of_grid(cfg)):
        if re_ > rv * (rv - 1):
            continue
        tst, jst = _star_state(cfg, rv, re_)
        _, _, _, jrep = jdyn.apply_batch_async(
            jst, jdyn.make_ops(kind, zeros, zeros), jcfg)
        _, _, _, trep = tdyn.apply_batch_stats(
            tst, tdyn.make_ops(kind, zeros, zeros), cfg)
        want = tuple(int(x) for x in jrep)
        assert want[1:] == (rv, re_)
        code = int(tdyn.tier_code(cfg, torch.tensor(rv, dtype=torch.int32),
                                  torch.tensor(re_, dtype=torch.int32)))
        assert tdyn.branches(cfg)[code][0] == want[0], (rv, re_)
        assert tuple(int(x) for x in trep) == want, (rv, re_)


def _jax_state(cfg):
    st = jgs.all_singletons(cfg)
    return st, carry.state_from_numpy({
        "v_alive": np.asarray(st.v_alive), "ccid": np.asarray(st.ccid),
        "src": np.asarray(st.edges.src), "dst": np.asarray(st.edges.dst),
        "state": np.asarray(st.edges.state), "n_ccs": np.asarray(st.n_ccs),
        "gen": np.asarray(st.gen), "overflow": np.asarray(st.overflow)},
        device="cpu")


def _same_state(tst, jst):
    j = {"v_alive": jst.v_alive, "ccid": jst.ccid, "src": jst.edges.src,
         "dst": jst.edges.dst, "state": jst.edges.state, "n_ccs": jst.n_ccs,
         "gen": jst.gen, "overflow": jst.overflow}
    for k, v in carry.state_to_numpy(tst).items():
        np.testing.assert_array_equal(v, np.asarray(j[k]), k)


@pytest.mark.parametrize("name", ["tiered", "compact", "gate_off",
                                  "shortcut"])
def test_repair_stats_match_jax_over_every_branch(name):
    kw = dict(tier_stream.CONFIG)
    if name == "compact":
        kw["dense_capacity"] = 0
    kw["repair_gate"] = name != "gate_off"
    kw["shortcut"] = name == "shortcut"
    cfg = tgs.GraphConfig(**kw)
    jcfg = jgs.GraphConfig(**kw)
    jst, tst = _jax_state(jcfg)
    seen = set()
    batches = tier_stream.batches()
    for i, (k, u, v) in enumerate(batches):
        jst, jok, jovf, jrep = jdyn.apply_batch_async(
            jst, jdyn.make_ops(k, u, v), jcfg)
        tst, tok, tovf, trep = tdyn.apply_batch_stats(
            tst, tdyn.make_ops(k, u, v), cfg)
        assert all(isinstance(x, torch.Tensor) and x.dtype == torch.int32
                   for x in trep)
        _same_state(tst, jst)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        stats = tuple(int(x) for x in trep)
        assert (int(tovf),) + stats == (int(jovf),) + tuple(
            int(x) for x in jrep), f"{name} step {i}"
        if stats[0] == tdyn.TIER_SKIP:
            seen.add("skip")
        else:
            seen.add(tdyn.branches(cfg)[int(tdyn.tier_code(
                cfg, trep.region_vertices, trep.region_edges))])
    want = set(tdyn.branches(cfg)) | ({"skip"} if cfg.repair_gate else set())
    assert seen == want
    # the scan entry over the same stream: one read of its stats
    jst0, tst0 = _jax_state(jcfg)
    stacked = [np.stack(col) for col in zip(*batches)]
    jst, jok, jovf, jrep = jdyn.apply_batch_scan(
        jst0, jdyn.make_ops(*stacked), jcfg)
    tst, tok, tovf, trep = tdyn.apply_batch_scan(
        tst0, tdyn.make_ops(*stacked), cfg)
    _same_state(tst, jst)
    ok_h, ovf_h, stats_h = tdyn.read_back(tok, tovf, trep)
    np.testing.assert_array_equal(ok_h, np.asarray(jok))
    np.testing.assert_array_equal(ovf_h, np.asarray(jovf))
    np.testing.assert_array_equal(
        stats_h, np.stack([np.asarray(x) for x in jrep], -1))


@pytest.mark.parametrize("name", ["tiered", "gate_off", "shortcut"])
def test_decided_step_matches_eager(name):
    """The step graph's body (``dynamic._step`` handed a capture, its IF
    nodes run on the host by ``tier_stream.HostCond``) == the
    per-decision step, which the test above holds to JAX: state, ok,
    overflow and RepairStats at every step of the stream that takes every
    branch."""
    kw = dict(tier_stream.CONFIG)
    kw["repair_gate"] = name != "gate_off"
    kw["shortcut"] = name == "shortcut"
    cfg = tgs.GraphConfig(**kw)
    got = want = tgs.all_singletons(cfg, "cpu")
    for i, (k, u, v) in enumerate(tier_stream.batches()):
        ops = tdyn.make_ops(k, u, v)
        got, gok, govf, gstats = tdyn._step(got, ops, cfg,
                                            graph=tier_stream.HostCond())
        want, wok, wovf, wrep = tdyn.apply_batch_stats_eager(want, ops, cfg)
        for a, b in zip(carry.state_to_numpy(got).values(),
                        carry.state_to_numpy(want).values()):
            np.testing.assert_array_equal(a, b, f"step {i}")
        assert torch.equal(gok, wok) and int(govf) == int(wovf)
        assert gstats.tolist() == [int(x) for x in wrep], f"step {i}"
