"""The fixpoint forms of the frontier kernel, held to the JAX package.

Every sweep of ``repro_torch.core.reach`` and ``scc.trim`` is one form of
``kernels/frontier_expand/ops.frontier_fixpoint``: on the card one
cooperative launch runs all of its rounds.  Here, on CPU tensors, the
wrapper takes its plain version (``ref.frontier_fixpoint``) and the
sweeps take the per-round loop; both are held to the JAX functions on the
same inputs, made from a seeded numpy generator: states and round counts
exactly, including a chain deeper than ``max_iters`` (the cap ends the
loop on an unconverged state) and tenant lanes of different depths, each
equal to its solo JAX run.  So is the kernel's own schedule in plain
torch (``ref.fixpoint_schedule``: the first round over every slot, later
rounds over the listed edges with only the sources that changed in the
previous round sending), which shows on the CPU that the skip is exact.
The kernel itself is held to these on the card by
``tests/test_torch_gpu.py`` (marker ``gpu``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reach as _jreach
from repro.core import scc as _jscc
from repro_torch.core import reach as treach
from repro_torch.core import scc as tscc
from repro_torch.core.sync import SYNCS
from repro_torch.kernels.frontier_expand import ops as fops
from repro_torch.kernels.frontier_expand import ref as fref

INT32_MAX = 2 ** 31 - 1
NV = 96
DEPTH = 40  # the chain's length: deeper than CAP_SHORT
CAP_SHORT, CAP_LONG = 9, 200


def _jit(fn, *static):
    return jax.jit(fn, static_argnames=static)


class jreach:  # each JAX sweep compiled once per shape
    forward_reach = staticmethod(_jit(_jreach.forward_reach, "max_iters"))
    fused_fw_bw_reach = staticmethod(
        _jit(_jreach.fused_fw_bw_reach, "max_iters"))
    propagate_min_labels = staticmethod(
        _jit(_jreach.propagate_min_labels, "max_iters", "shortcut"))
    propagate_min_prio = staticmethod(
        _jit(_jreach.propagate_min_prio, "max_iters"))
    multi_forward_reach = staticmethod(
        _jit(_jreach.multi_forward_reach, "max_iters"))


@jax.jit
def _jtrim_round(carry, src, dst, live, vid):
    """The body of ``repro.core.scc.trim``, as it is written there."""
    unassigned, ccid = carry
    emask = live & unassigned[src] & unassigned[dst]
    indeg, outdeg = _jscc._degrees(src, dst, emask, unassigned.shape[0])
    peel = unassigned & ((indeg == 0) | (outdeg == 0))
    return (unassigned & ~peel, jnp.where(peel, vid, ccid)), jnp.any(peel)


def _jtrim(src, dst, live, unassigned, max_iters):
    """``repro.core.scc.trim`` through ``repro.core.reach._fixpoint``,
    keeping the round count that ``trim`` drops."""
    vid = jnp.arange(unassigned.shape[0], dtype=jnp.int32)
    ccid = jnp.full(unassigned.shape, INT32_MAX, jnp.int32)
    (un, cc), rounds = _jreach._fixpoint(
        lambda c: _jtrim_round(c, src, dst, live, vid), (unassigned, ccid),
        max_iters)
    want_un, want_cc = _jscc.trim(src, dst, live, unassigned, vid, ccid,
                                  max_iters)
    assert np.array_equal(np.asarray(un), np.asarray(want_un))
    assert np.array_equal(np.asarray(cc), np.asarray(want_cc))
    return (un, cc), rounds


def _graph(seed, depth=DEPTH, e=128):
    """A chain 0 -> 1 -> ... -> depth (a fixpoint that deep: no other edge
    leaves a chain vertex) in sparse random edges, a few dead slots, and
    a vertex mask with holes off the chain."""
    rng = np.random.default_rng(seed)
    src = rng.integers(depth + 1, NV, e).astype(np.int32)
    dst = rng.integers(0, NV, e).astype(np.int32)
    src[:depth] = np.arange(depth)
    dst[:depth] = np.arange(1, depth + 1)
    live = rng.random(e) < 0.9
    live[:depth] = True
    live[-4:] = False
    mask = rng.random(NV) < 0.9
    mask[:depth + 1] = True
    seeds = rng.random((33, NV)) < 1.5 / NV
    seeds[:, 0] = True
    return src, dst, live, mask, seeds


FORMS = [("reach", False), ("pair", False), ("label", False),
         ("label", True), ("prio", False), ("or", False), ("trim", False)]


def _inputs(form, g):
    """(mask, initial state) of ``form`` on graph ``g``, as torch (CPU)."""
    _, _, _, mask, seeds = g
    m = torch.from_numpy(mask)
    sd = torch.from_numpy(seeds)
    vid = torch.arange(NV, dtype=torch.int32)
    if form == "reach":
        return m, sd[0] & m
    if form == "pair":
        return m, torch.stack([sd[0] & m, sd[1] & m])
    if form == "label":
        return m, torch.where(m, vid, INT32_MAX)
    if form == "prio":
        return m, torch.where(m, fref.prio(vid), fref.PRIO_SENT)
    if form == "or":
        return m, fref.pack_bits(sd & m[None, :])
    return None, (m, torch.full((NV,), INT32_MAX, dtype=torch.int32))


def _jax_fixpoint(form, shortcut, g, cap):
    """The JAX function's (state as the port holds it, rounds)."""
    src, dst, live, mask, seeds = (jnp.asarray(x) for x in g)
    if form == "reach":
        st, n = jreach.forward_reach(src, dst, live, seeds[0], mask, cap)
    elif form == "pair":
        fw, bw, n = jreach.fused_fw_bw_reach(src, dst, live, seeds[0],
                                             seeds[1], mask, cap)
        st = np.stack([fw, bw])
    elif form == "label":
        init = jnp.where(mask, jnp.arange(NV, dtype=jnp.int32), INT32_MAX)
        st, n = jreach.propagate_min_labels(src, dst, live, init, mask, cap,
                                            shortcut=shortcut)
    elif form == "prio":  # the witnesses, which the port's labels map to
        st, n = jreach.propagate_min_prio(src, dst, live, mask, cap)
    elif form == "or":
        st, n = jreach.multi_forward_reach(src, dst, live, seeds, mask, cap)
    else:
        st, n = _jtrim(src, dst, live, mask, cap)
        return tuple(np.asarray(x) for x in st), int(n)
    return np.asarray(st), int(n)


def _as_jax_state(form, st):
    """The port's fixpoint state in the JAX function's terms."""
    if form == "prio":
        return np.asarray(torch.where(st != fref.PRIO_SENT, fref.unprio(st),
                                      NV))
    if form == "or":
        return np.asarray(fref.unpack_bits(st, 33))
    if form == "trim":
        return tuple(np.asarray(x) for x in st)
    return np.asarray(st)


def _equal(a, b):
    if isinstance(a, tuple):
        return all(np.array_equal(x, y) for x, y in zip(a, b))
    return np.array_equal(a, b)


def _run(fn, form, shortcut, g, cap):
    src, dst, live = (torch.from_numpy(x) for x in g[:3])
    mask, init = _inputs(form, g)
    return fn(form, src, dst, live, mask, init, cap, shortcut=shortcut,
              vid=torch.arange(NV, dtype=torch.int32))


@pytest.mark.parametrize("cap", [CAP_SHORT, CAP_LONG])
@pytest.mark.parametrize("form,shortcut", FORMS)
def test_plain_fixpoint_matches_jax(form, shortcut, cap):
    """ref.frontier_fixpoint (the kernel's plain version) and the
    per-round loop == the JAX function: state and rounds; at CAP_SHORT the
    chain is deeper than the cap, which ends the loop unconverged."""
    g = _graph(3)
    want, want_n = _jax_fixpoint(form, shortcut, g, cap)
    for fn in (fref.frontier_fixpoint, treach.round_loop):
        st, n = _run(fn, form, shortcut, g, cap)
        assert n.dtype == torch.int32 and n.dim() == 0
        assert int(n) == want_n, fn
        assert _equal(_as_jax_state(form, st), want), fn


def test_cap_is_hit_by_the_chain():
    """The chain makes every form run past CAP_SHORT (so the cap cases
    above compare unconverged states), and each converges under
    CAP_LONG."""
    g = _graph(3)
    for form, shortcut in FORMS:
        if form == "prio" or shortcut:  # pointer doubling halves the chain
            continue
        assert _jax_fixpoint(form, shortcut, g, CAP_SHORT)[1] == CAP_SHORT
        assert _jax_fixpoint(form, shortcut, g, CAP_LONG)[1] < CAP_LONG


def _stack(form, states):
    if form == "trim":
        return tuple(torch.stack(c) for c in zip(*states))
    return torch.stack(states)


@pytest.mark.parametrize("cap", [CAP_SHORT, CAP_LONG])
@pytest.mark.parametrize("form,shortcut", FORMS)
def test_lanes_of_different_depths_match_solo_jax(form, shortcut, cap):
    """Tenant lanes [T, C] whose chains differ in depth (one lane with no
    chain, one deeper than the cap): every lane's state and rounds equal
    its solo JAX run, through the plain version and the per-round loop."""
    graphs = [_graph(10 + i, depth=d) for i, d in enumerate((0, 5, 20, 60))]
    src, dst, live = (torch.from_numpy(np.stack([g[i] for g in graphs]))
                      for i in range(3))
    ins = [_inputs(form, g) for g in graphs]
    mask = None if form == "trim" else torch.stack([m for m, _ in ins])
    init = _stack(form, [s for _, s in ins])
    want = [_jax_fixpoint(form, shortcut, g, cap) for g in graphs]
    for fn in (fref.frontier_fixpoint, treach.round_loop):
        st, n = fn(form, src, dst, live, mask, init, cap, shortcut=shortcut,
                   vid=torch.arange(NV, dtype=torch.int32))
        assert n.dtype == torch.int32 and n.shape == (len(graphs),)
        assert n.tolist() == [w[1] for w in want], fn
        for t, (w, _) in enumerate(want):
            lane = (tuple(x[t] for x in st) if form == "trim" else st[t])
            assert _equal(_as_jax_state(form, lane), w), (fn, t)
    assert len({w[1] for w in want}) > 1  # the lanes stop apart


@pytest.mark.parametrize("cap", [CAP_SHORT, CAP_LONG])
@pytest.mark.parametrize("form,shortcut", FORMS)
def test_schedule_matches_jax(form, shortcut, cap):
    """The kernel's schedule (listed edges, only changed sources
    sending after the first round) == the JAX function: state and rounds,
    converged and cut by the cap."""
    g = _graph(3)
    want, want_n = _jax_fixpoint(form, shortcut, g, cap)
    st, n = _run(fref.fixpoint_schedule, form, shortcut, g, cap)
    assert n.dtype == torch.int32 and n.dim() == 0 and int(n) == want_n
    assert _equal(_as_jax_state(form, st), want)


@pytest.mark.parametrize("cap", [CAP_SHORT, CAP_LONG])
@pytest.mark.parametrize("form,shortcut", FORMS)
def test_schedule_lanes_match_solo_jax(form, shortcut, cap):
    """The kernel's schedule over tenant lanes whose chains differ in
    depth: every lane's state and rounds equal its solo JAX run."""
    graphs = [_graph(10 + i, depth=d) for i, d in enumerate((0, 5, 20, 60))]
    src, dst, live = (torch.from_numpy(np.stack([g[i] for g in graphs]))
                      for i in range(3))
    ins = [_inputs(form, g) for g in graphs]
    mask = None if form == "trim" else torch.stack([m for m, _ in ins])
    init = _stack(form, [s for _, s in ins])
    want = [_jax_fixpoint(form, shortcut, g, cap) for g in graphs]
    st, n = fref.fixpoint_schedule(form, src, dst, live, mask, init, cap,
                                   shortcut=shortcut,
                                   vid=torch.arange(NV, dtype=torch.int32))
    assert n.tolist() == [w[1] for w in want]
    for t, (w, _) in enumerate(want):
        lane = (tuple(x[t] for x in st) if form == "trim" else st[t])
        assert _equal(_as_jax_state(form, lane), w), t


@pytest.mark.parametrize("shortcut", [False, True])
def test_schedule_scc_matches_plain(shortcut):
    """The scc form over the kernel's schedule == its plain version
    (held to JAX's ``scc_static`` in ``test_torch_step_graph.py``):
    labels and outer rounds, at a cap that cuts the outer loop and past
    it, on one graph and on lanes."""
    g = _graph(6)
    src, dst, live, mask = (torch.from_numpy(x) for x in g[:4])
    lanes = [torch.stack([x, x.roll(7)]) for x in (src, dst, live, mask)]
    for args in ((src, dst, live, mask), lanes):
        for max_outer in (1, NV):
            want = fref.scc_loop(*args, max_outer, CAP_LONG,
                                 shortcut=shortcut)
            got = fref.fixpoint_schedule("scc", *args, None, CAP_LONG,
                                         shortcut=shortcut,
                                         max_outer=max_outer)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


def test_fix_on_cpu_takes_the_per_round_loop(monkeypatch):
    """reach._fix on CPU tensors runs the per-round loop, one counted host
    read a round, and never the kernel's wrapper."""
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached frontier_fixpoint")

    monkeypatch.setattr(fops, "frontier_fixpoint", refuse)
    src, dst, live, mask, seeds = (torch.from_numpy(x) for x in _graph(4))
    before = SYNCS.count
    reached, n = treach.forward_reach(src, dst, live, seeds[0], mask,
                                      CAP_LONG)
    assert SYNCS.count - before == int(n) > 1
    vid = torch.arange(NV, dtype=torch.int32)
    ccid = torch.full((NV,), INT32_MAX, dtype=torch.int32)
    before = SYNCS.count
    trimmed = tscc.trim(src, dst, live, mask, vid, ccid, CAP_LONG)
    (un, cc), n_trim = fref.frontier_fixpoint(
        "trim", src, dst, live, None, (mask, ccid), CAP_LONG, vid=vid)
    assert SYNCS.count - before == int(n_trim) > 1
    assert torch.equal(trimmed[0], un) and torch.equal(trimmed[1], cc)
    want, _ = fref.frontier_fixpoint("reach", src, dst, live, mask,
                                     seeds[0] & mask, CAP_LONG)
    assert torch.equal(reached, want)


def test_wrapper_on_cpu_is_the_plain_version():
    """ops.frontier_fixpoint on CPU tensors is ref.frontier_fixpoint and
    counts no launch."""
    g = _graph(5)
    before = (fops.frontier_min.launches, fops.frontier_min.fixpoint_launches)
    for form, shortcut in FORMS:
        got = _run(fops.frontier_fixpoint, form, shortcut, g, CAP_LONG)
        want = _run(fref.frontier_fixpoint, form, shortcut, g, CAP_LONG)
        assert _equal(_as_jax_state(form, got[0]),
                      _as_jax_state(form, want[0]))
        assert torch.equal(got[1], want[1])
    assert (fops.frontier_min.launches,
            fops.frontier_min.fixpoint_launches) == before
    with pytest.raises(ValueError, match="unknown form"):
        fops.frontier_fixpoint("spin", *(torch.from_numpy(x)
                                         for x in g[:3]), None,
                               torch.zeros(NV, dtype=torch.bool), 3)
