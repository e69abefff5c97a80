"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test decides inside itself whether a card exists and
skips with a reason where there is none.  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerance is exact equality for the SMSCC kernels, which compute integers
and booleans.  Attention holds to 2e-5 in f32 and 3e-2 in bf16 (the JAX
package's own kernel tolerances: the kernel sums in another order and, in
bf16, does not round the scores to bf16 as the plain version does); the
embedding bag to 1e-5 in f32.  Since 3e-2 is the size of a typical
attention output, the bf16 kernel is also held to the f32 answer on the
same bf16-valued inputs at rtol 1e-2, atol 1e-2 x mean |answer|: a key
gained or lost at a band edge moves an output by about |v| / window, above
that limit at the band shapes below.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import edge_table as tet
from repro_torch.core import graph_state as tgs
from repro_torch.core import reach as treach
from repro_torch.core.service import SCCService
from repro_torch.core.sync import SYNCS
from repro_torch.kernels.frontier_expand import ops as fops
from repro_torch.kernels.frontier_expand import ref as fref
from repro_torch.kernels.hash_probe import ops as hops
from repro_torch.kernels.hash_probe import ref as href
from repro_torch.kernels.reach_blockmm import ops as bops
from repro_torch.kernels.reach_blockmm import ref as bref
from repro_torch.kernels.embedding_bag import ops as eops
from repro_torch.kernels.embedding_bag import ref as eref
from repro_torch.kernels.flash_attention import ops as aops
from repro_torch.kernels.flash_attention import ref as aref
from repro_torch.launch import stream

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_frontier_min_kernel(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    for f, e, nv in ((1, 5000, 300), (7, 1000, 64), (3, 0, 10)):
        dst = torch.randint(-1, nv, (e,), device=cuda, generator=g,
                            dtype=torch.int32)
        msg = torch.randint(0, 2 ** 32, (f, e), device=cuda, generator=g)
        msg[torch.rand((f, e), device=cuda, generator=g) < 0.3] = fref.SENTINEL
        got = fops.frontier_min(dst, msg, nv)
        torch.testing.assert_close(got, fref.frontier_min(dst, msg, nv),
                                   rtol=0, atol=0)


def _gather_case(seed, e, nv, rows, mode):
    """Edges with -1 padding and ids past nv in src and dst, a quarter of
    them live; values with the top bit set, SENTINEL words, or packed
    frontier bits."""
    rng = np.random.default_rng(seed)
    src = rng.integers(-1, nv + 3, e).astype(np.int32)
    dst = rng.integers(-1, nv + 3, e).astype(np.int32)
    live = rng.random(e) < 0.25
    if mode == "or":
        val = rng.integers(0, 2 ** 32, (rows, nv), dtype=np.uint64)
        val[rng.random((rows, nv)) < 0.7] = 0
    else:
        val = rng.integers(0, 2 ** 32, (rows, nv), dtype=np.uint64)
        val[rng.random((rows, nv)) < 0.4] = fref.SENTINEL
    return src, dst, live, val.astype(np.uint32).view(np.int32)


# (mode, rows, e, nv): ragged E, F > 1 in min mode, the FW/BW pair, packed
# Q in {1, 31, 32, 33, 64} (W = 1, 1, 1, 2, 2 words), no edges
@pytest.mark.parametrize("mode,rows,e,nv", [
    ("min", 1, 5003, 300), ("min", 3, 1000, 64), ("min", 1, 0, 10),
    ("pair", 2, 4099, 257), ("or", 1, 5003, 300), ("or", 2, 3001, 129),
    ("or", 2, 77, 5)])
def test_frontier_gather_kernel(cuda, mode, rows, e, nv):
    src, dst, live, val = _gather_case(e + nv, e, nv, rows, mode)
    args = [torch.from_numpy(x).to(cuda) for x in (src, dst, live, val)]
    got = fops.frontier_gather(*args, nv, mode=mode)
    assert got.dtype == torch.int32 and got.shape == (rows, nv)
    assert torch.equal(got, fref.frontier_gather(*args, nv, mode))
    args[2] = torch.zeros_like(args[2])  # every edge dead
    dead = fops.frontier_gather(*args, nv, mode=mode)
    assert torch.equal(dead, torch.full_like(dead, 0 if mode == "or" else -1))


@pytest.mark.parametrize("q", [1, 31, 32, 33, 64])
def test_reach_on_card_matches_cpu(cuda, q):
    """Every reach.py sweep on the card against the same sweep on the CPU
    (plain versions): results and round counts, bit for bit."""
    rng = np.random.default_rng(q)
    nv, e = 2000, 6000
    src = rng.integers(0, nv, e).astype(np.int32)
    dst = rng.integers(0, nv, e).astype(np.int32)
    src[::97] = -1  # junk slots, dead as in the edge table
    live = (rng.random(e) < 0.9) & (src >= 0)
    allowed = rng.random(nv) < 0.95
    seeds = rng.random((q, nv)) < 2.0 / nv
    labels = np.where(allowed, np.arange(nv), 2 ** 31 - 1).astype(np.int32)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        s, d, lv, al, sd, lab = (torch.from_numpy(x).to(dev) for x in (
            src, dst, live, allowed, seeds, labels))
        out = [treach.multi_forward_reach(s, d, lv, sd, al, 300),
               treach.forward_reach(s, d, lv, sd[0], al, 300),
               treach.fused_fw_bw_reach(s, d, lv, sd[0], sd[-1], al, 300),
               treach.propagate_min_labels(s, d, lv, lab, al, 300),
               treach.propagate_min_labels(s, d, lv, lab, al, 300,
                                           shortcut=True),
               treach.propagate_min_prio(s, d, lv, al, 300)]
        runs.append([[x.cpu() if isinstance(x, torch.Tensor) else x
                      for x in r] for r in out])
    for card, cpu in zip(*runs):
        for a, b in zip(card, cpu):
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else a == b)


# ------------------------------------------------------- fixpoints ---

FIX_FORMS = [("reach", False), ("pair", False), ("label", False),
             ("label", True), ("prio", False), ("or", False),
             ("trim", False)]


# slot and mask patterns that the edge list's making must get right
EDGE_CASES = ("no live edge", "every slot live", "tombstones",
              "junk and out-of-range ids", "empty mask", "full mask")


def _fix_case(form, seed, nv, e, depth, case=None):
    """One graph of ``form``'s fixpoint on the CPU: a chain 0 -> ... ->
    depth in sparse random edges (none leaves the chain), dead slots (-1
    junk ids but for trim), a mask with holes off the chain; ``case`` (one
    of EDGE_CASES) reshapes the slots or the mask first.  Returns (src,
    dst, live, mask, state)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(depth + 1, nv, e).astype(np.int32)
    dst = rng.integers(0, nv, e).astype(np.int32)
    src[:depth], dst[:depth] = np.arange(depth), np.arange(1, depth + 1)
    live = rng.random(e) < 0.9
    live[:depth] = True
    live[-3:] = False
    if form != "trim":  # junk slots; trim's callers never pass one
        src[-3:] = -1
    mask = rng.random(nv) < 0.9
    mask[:depth + 1] = True
    if case == "no live edge":
        live[:] = False
    elif case == "every slot live":
        live[:] = True
        src[src < 0] = 0
    elif case == "tombstones":  # dead slots that keep their ids
        live = rng.random(e) < 0.4
        live[:depth] = True
        src[src < 0] = 1
    elif case == "junk and out-of-range ids":
        src[::7], dst[::11], src[::13], dst[::17] = -1, -1, nv, nv + 5
        live[::5] = True
    elif case == "empty mask":
        mask[:] = False
    elif case == "full mask":
        mask[:] = True
    seeds = torch.from_numpy(rng.random((40, nv)) < 2.0 / nv)
    seeds[:, 0] = True
    m = torch.from_numpy(mask)
    vid = torch.arange(nv, dtype=torch.int32)
    state = {"reach": lambda: seeds[0] & m,
             "pair": lambda: torch.stack([seeds[0] & m, seeds[1] & m]),
             "label": lambda: torch.where(m, vid, 2 ** 31 - 1),
             "prio": lambda: torch.where(m, fref.prio(vid), fref.PRIO_SENT),
             "or": lambda: fref.pack_bits(seeds & m[None, :]),
             "trim": lambda: (m, torch.full((nv,), 2 ** 31 - 1,
                                            dtype=torch.int32))}[form]()
    return (torch.from_numpy(src), torch.from_numpy(dst),
            torch.from_numpy(live), None if form == "trim" else m, state)


def _fix_stack(cases):
    def stack(xs):
        if xs[0] is None:
            return None
        if isinstance(xs[0], tuple):
            return tuple(torch.stack(c) for c in zip(*xs))
        return torch.stack(xs)
    return [stack(list(c)) for c in zip(*cases)]


def _to(x, dev):
    if isinstance(x, tuple):
        return tuple(_to(y, dev) for y in x)
    return None if x is None else x.to(dev)


def _same(a, b):
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("cap", [7, 5000])
@pytest.mark.parametrize("t_n", [None, 3, 256])
@pytest.mark.parametrize("form,shortcut", FIX_FORMS)
def test_fixpoint_kernel(cuda, form, shortcut, t_n, cap):
    """One launch of the fixpoint kernel == the per-round loop on the card
    (one frontier_gather launch and one read a round) == the plain version
    on CPU copies: state and rounds exactly, for one graph (``t_n`` None)
    and tenant lanes whose chains differ in depth (cap 7 cuts the deep
    ones unconverged)."""
    if t_n is None:
        args = _fix_case(form, 1, 3000, 4000, 400)
    else:
        nv, e = (3000, 4000) if t_n == 3 else (64, 160)
        depths = (0, 40, 400) if t_n == 3 else [i % 60 for i in range(t_n)]
        args = _fix_stack([_fix_case(form, 100 + i, nv, e, d)
                           for i, d in enumerate(depths)])
    vid = torch.arange(args[-1][0].shape[-1] if form == "trim"
                       else args[-1].shape[-1], dtype=torch.int32)
    card = [_to(x, cuda) for x in args]
    kw = dict(shortcut=shortcut, vid=vid.to(cuda))
    before = (fops.frontier_min.fixpoint_launches, SYNCS.count)
    got = fops.frontier_fixpoint(form, *card, cap, **kw)
    assert (fops.frontier_min.fixpoint_launches, SYNCS.count) == (
        before[0] + 1, before[1])
    loop = treach.round_loop(form, *card, cap, **kw)
    plain = fref.frontier_fixpoint(form, *args, cap, shortcut=shortcut,
                                   vid=vid)
    assert got[1].shape == (() if t_n is None else (t_n,))
    for want in (loop, plain):
        assert _same(got[0], want[0]) and _same(got[1], want[1])
    if t_n == 3:  # each lane == its own solo launch
        for t in range(t_n):
            lane = [None if x is None else
                    (tuple(y[t] for y in x) if isinstance(x, tuple)
                     else x[t]) for x in card]
            solo = fops.frontier_fixpoint(form, *lane, cap, **kw)
            assert int(solo[1]) == int(got[1][t])
            assert _same(solo[0], tuple(y[t] for y in got[0])
                         if form == "trim" else got[0][t])


@pytest.mark.parametrize("t_n", [None, 256])
@pytest.mark.parametrize("form,shortcut,case", [
    (f, sc, c) for f, sc in FIX_FORMS
    for c in EDGE_CASES + ("every slot live, cap 3",)
    # trim's callers pass no junk ids (its plain version takes none)
    if not (f == "trim" and c.startswith("junk"))])
def test_fixpoint_edge_list_cases(cuda, form, shortcut, case, t_n):
    """The launch lists its edges in its first round and later rounds
    read only the list, only changed sources sending: held exactly (state
    and rounds) to the plain version on CPU copies and to the schedule's
    plain model where the slots, ids or mask make the list go wrong: no
    live edge, every slot live, tombstones, junk and out-of-range ids
    (trim's callers pass none), an empty and a full mask; one graph and
    256 lanes, every fifth lane's mask empty, so it stops after its first
    round beside lanes that run on; the cap of 3 rounds hit."""
    cap = 3 if case.endswith("cap 3") else 5000
    case = case.replace(", cap 3", "")
    if t_n is None:
        args = _fix_case(form, 7, 3000, 4000, 400, case)
    else:
        args = _fix_stack([_fix_case(
            form, 300 + i, 64, 160, i % 60,
            "empty mask" if i % 5 == 0 and case != "empty mask" else case)
            for i in range(t_n)])
    vid = torch.arange(args[-1][0].shape[-1] if form == "trim"
                       else args[-1].shape[-1], dtype=torch.int32)
    card = [_to(x, cuda) for x in args]
    got = fops.frontier_fixpoint(form, *card, cap, shortcut=shortcut,
                                 vid=vid.to(cuda))
    for fn in (fref.frontier_fixpoint, fref.fixpoint_schedule):
        want = fn(form, *args, cap, shortcut=shortcut, vid=vid)
        assert _same(got[0], want[0]) and _same(got[1], want[1]), fn
    if cap == 3 and form != "trim":
        assert int(got[1].max()) == 3  # the chain runs past the cap


def test_fixpoints_read_nothing_and_replay_in_a_graph(cuda):
    """On the card the sweeps and trim make no host read and one launch
    each; their rounds add up on the device counter; a captured launch
    replays, on inputs rewritten in place, as an eager launch computes."""
    from repro_torch import kernels
    from repro_torch.core import scc as tscc
    src, dst, live, mask, seeds = (
        _to(x, cuda) for x in _fix_case("reach", 3, 3000, 4000, 300))
    vid = torch.arange(3000, dtype=torch.int32, device=cuda)
    big = torch.full((3000,), 2 ** 31 - 1, dtype=torch.int32, device=cuda)
    kernels.reset_launch_counts()
    before = SYNCS.count
    _, n_fw = treach.forward_reach(src, dst, live, seeds, mask, 5000)
    _, n_lab = treach.propagate_min_labels(src, dst, live, vid, mask, 5000,
                                           shortcut=True)
    tscc.trim(src, dst, live, mask, vid, big, 5000)
    assert SYNCS.count == before
    assert fops.frontier_min.fixpoint_launches == 3
    assert fops.frontier_min.launches == 3
    rounds = fops.fixpoint_rounds()
    assert rounds["reach"] == int(n_fw) > 1
    assert rounds["label"] == int(n_lab) and rounds["trim"] > 0

    static = seeds.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        treach.forward_reach(src, dst, live, static, mask, 5000)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, n = treach.forward_reach(src, dst, live, static, mask, 5000)
    for seed_set in (seeds, torch.roll(seeds, 1500)):
        static.copy_(seed_set)
        graph.replay()
        want, want_n = treach.forward_reach(src, dst, live, seed_set, mask,
                                            5000)
        torch.cuda.synchronize()
        assert torch.equal(out, want) and torch.equal(n, want_n)


def test_fixpoint_launch_failure_raises(cuda):
    """A launch the kernel refuses (more lanes than its shared memory
    holds) raises; nothing falls back."""
    t_n = 40000
    src = torch.zeros((t_n, 1), dtype=torch.int32, device=cuda)
    mask = torch.ones((t_n, 1), dtype=torch.bool, device=cuda)
    with pytest.raises(RuntimeError, match="frontier_fixpoint"):
        fops.frontier_fixpoint("reach", src, src, mask, mask, mask, 3)


def test_fixpoint_capture_before_counter_raises(cuda, monkeypatch):
    """A card's first fixpoint launch makes its round counter, so it may
    not be captured: captured, it raises instead of counting nothing."""
    src, dst, live, mask, seeds = (
        _to(x, cuda) for x in _fix_case("reach", 3, 300, 400, 30))
    monkeypatch.setattr(fops, "_rounds_run", {})
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="outside a CUDA graph capture"):
        with torch.cuda.graph(graph):
            treach.forward_reach(src, dst, live, seeds, mask, 50)
    _, n = treach.forward_reach(src, dst, live, seeds, mask, 50)
    assert fops.fixpoint_rounds()["reach"] == int(n)


def test_probe_kernel(cuda):
    rng = np.random.default_rng(0)
    cap, b = 1024, 500
    st = rng.choice([0, 1, 2], cap, p=[0.2, 0.5, 0.3]).astype(np.int8)
    src = rng.integers(-1, 8, cap).astype(np.int32)
    dst = rng.integers(-1, 8, cap).astype(np.int32)
    args = [torch.from_numpy(x).to(cuda) for x in (
        src, dst, st, rng.integers(0, cap, b).astype(np.int32),
        rng.integers(-1, 8, b).astype(np.int32),
        rng.integers(-1, 8, b).astype(np.int32))]
    for max_probes in (1, 64, 2000):
        got = hops.probe(*args, max_probes=max_probes)
        want = href.probe(*args, max_probes=max_probes)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_probe_kernel_small_and_unaligned_tables(cuda):
    """C below 16, and columns 4 or 1 bytes past 16-byte alignment: the
    slot-at-a-time walk."""
    rng = np.random.default_rng(1)
    for cap, shift in ((8, 0), (4, 0), (1024, 1)):
        st = rng.choice([0, 1, 2], cap + 1, p=[0.2, 0.5, 0.3]).astype(np.int8)
        cols = [torch.from_numpy(x).to(cuda)[shift:cap + shift] for x in (
            rng.integers(-1, 8, cap + 1).astype(np.int32),
            rng.integers(-1, 8, cap + 1).astype(np.int32), st)]
        args = cols + [torch.from_numpy(x).to(cuda) for x in (
            rng.integers(0, cap, 300).astype(np.int32),
            rng.integers(-1, 8, 300).astype(np.int32),
            rng.integers(-1, 8, 300).astype(np.int32))]
        for max_probes in (1, 5, 2 * cap):
            got = hops.probe(*args, max_probes=max_probes)
            want = href.probe(*args, max_probes=max_probes)
            assert all(torch.equal(a, b) for a, b in zip(got, want))


def _write_case(cuda, seed, cap, fill, b, *, dup=0.1, enable=0.8,
                negative=False):
    """A table built by the port's insert and remove on the card (LIVE,
    TOMB and EMPTY slots), and b lanes: present, removed and fresh keys,
    ~dup of them repeating an earlier lane, an enable mask; keys from
    [-kr, kr) with ``negative``, else [0, kr)."""
    rng = np.random.default_rng(seed)
    kr = max(4, int(np.sqrt(4 * cap)))
    lo = -kr if negative else 0
    n = int(fill * cap)
    ku, kv = (rng.integers(lo, kr, n).astype(np.int32) for _ in range(2))

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(cuda)

    table, _, _ = tet.insert(tet.empty(cap, cuda), t(ku), t(kv), cap)
    table, _ = tet.remove(table, t(ku[: n // 3]), t(kv[: n // 3]), cap)
    pick = rng.integers(0, n, b)
    old = rng.random(b) < 0.6
    u = np.where(old, ku[pick], rng.integers(lo, kr, b)).astype(np.int32)
    v = np.where(old, kv[pick], rng.integers(lo, kr, b)).astype(np.int32)
    rep = rng.random(b) < dup
    earlier = (rng.random(b) * np.arange(b)).astype(np.int64)
    u, v = np.where(rep, u[earlier], u), np.where(rep, v[earlier], v)
    return table, t(u), t(v), t(rng.random(b) < enable)


def _insert_both(table, u, v, en, max_probes):
    """The insert kernel and its plain version on clones of one table:
    (columns, placed, failed, rounds) of each."""
    en = en & ~tet._dedupe(u, v, en)
    out = []
    for fn in (hops.insert, href.insert):
        cols = [c.clone() for c in table]
        placed, failed, rounds = fn(*cols, u, v, en, max_probes=max_probes)
        out.append((cols, placed, failed, int(rounds)))
    return out


def _assert_same_insert(got, want):
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert got[3] == want[3]


# (cap, fill, b, max_probes, options): duplicates and an enable mask,
# overflow at high load, max_probes 1 and above C, C below 16 (the
# slot-at-a-time walk), no lanes, every lane disabled, negative keys
@pytest.mark.parametrize("cap,fill,b,max_probes,opts", [
    (4096, 0.4, 2000, 64, {}), (1024, 0.9, 600, 8, {}),
    (1024, 0.5, 300, 1, {}), (256, 0.7, 300, 600, {}),
    (8, 0.5, 12, 20, {}), (1024, 0.5, 0, 8, {}),
    (1024, 0.5, 500, 16, {"enable": 0.0}),
    (1024, 0.6, 500, 16, {"negative": True})])
def test_insert_kernel(cuda, cap, fill, b, max_probes, opts):
    table, u, v, en = _write_case(cuda, cap + b, cap, fill, b, **opts)
    got, want = _insert_both(table, u, v, en, max_probes)
    _assert_same_insert(got, want)
    if fill >= 0.9:
        assert bool(got[2].any()), "the high-load case failed no lane"


@pytest.mark.parametrize("cap,fill,b,max_probes,opts", [
    (4096, 0.4, 2000, 64, {"dup": 0.3}), (1024, 0.9, 600, 8, {}),
    (1024, 0.5, 300, 1, {}), (256, 0.7, 300, 600, {}),
    (8, 0.5, 12, 20, {}), (1024, 0.5, 0, 8, {}),
    (1024, 0.5, 500, 16, {"enable": 0.0}),
    (1024, 0.6, 500, 16, {"negative": True})])
def test_remove_kernel(cuda, cap, fill, b, max_probes, opts):
    table, u, v, en = _write_case(cuda, cap + b + 1, cap, fill, b, **opts)
    states, flags = [], []
    for fn in (hops.remove, href.remove):
        st = table.state.clone()
        flags.append(fn(table.src, table.dst, st, u, v, en,
                        max_probes=max_probes))
        states.append(st)
    assert torch.equal(states[0], states[1])
    assert torch.equal(flags[0], flags[1])


def test_insert_kernel_lanes_beyond_one_grid(cuda):
    """2^20 lanes, more than the co-resident grid has threads, so each
    thread strides over several lanes in every phase."""
    table, u, v, en = _write_case(cuda, 7, 2 ** 21, 0.3, 2 ** 20, dup=0.05)
    got, want = _insert_both(table, u, v, en, 64)
    _assert_same_insert(got, want)


def test_edge_table_writes_make_no_host_sync(cuda):
    """et.insert, et.remove, et.rehash and et.compact on a CUDA table read
    nothing back to the host, and give the CPU's tables and flags."""
    table, u, v, en = _write_case(cuda, 3, 2 ** 14, 0.5, 3000)
    ops = (lambda t: tet.insert(t, u.to(t.src.device), v.to(t.src.device),
                                32, en.to(t.src.device)),
           lambda t: tet.remove(t, u.to(t.src.device), v.to(t.src.device),
                                32, en.to(t.src.device)),
           lambda t: (tet.rehash(t, 2 ** 15, 32),),
           lambda t: (tet.compact(t, 32),))
    cpu_table = tet.EdgeTable(*(c.cpu() for c in table))
    for op in ops:
        before = SYNCS.count
        got = op(table)
        assert SYNCS.count == before
        want = op(cpu_table)
        for a, b in zip(got[0], want[0]):
            assert torch.equal(a.cpu(), b)
        for a, b in zip(got[1:], want[1:]):
            assert torch.equal(a.cpu(), b)


# ----------------------------------------------------- tenant rows ---


def _lane_rows(cuda, t_n, seed, e, nv, f, mode):
    """T rows of ragged edges (-1 padding, ids past nv, a dead row) and
    values, as in _gather_case."""
    rows = [_gather_case(seed + i, e, nv, f, mode) for i in range(t_n)]
    src, dst, live, val = (np.stack(c) for c in zip(*rows))
    if t_n > 1:
        live[1] = False
    return [torch.from_numpy(x).to(cuda) for x in (src, dst, live, val)]


@pytest.mark.parametrize("t_n", [1, 3, 256])
@pytest.mark.parametrize("mode,f", [("min", 1), ("min", 3), ("pair", 2),
                                    ("or", 2)])
def test_frontier_gather_lanes_kernel(cuda, t_n, mode, f):
    """The tenant-row gather on the card == its plain version, and == one
    single-graph launch per row."""
    e, nv = (301, 37) if t_n == 256 else (3001, 257)
    src, dst, live, val = _lane_rows(cuda, t_n, t_n + f, e, nv, f, mode)
    before = fops.frontier_min.lane_launches
    got = fops.frontier_gather(src, dst, live, val, nv, mode=mode)
    assert fops.frontier_min.lane_launches == before + 1
    assert got.shape == (t_n, f, nv)
    assert torch.equal(got, fref.frontier_gather_lanes(src, dst, live, val,
                                                       nv, mode))
    for t in (0, t_n - 1):
        assert torch.equal(got[t], fops.frontier_gather(
            src[t], dst[t], live[t], val[t], nv, mode=mode))


def _lane_tables(cuda, t_n, cap, b, seed):
    """T rows of _write_case tables and lanes; row 0 filled to ~97%, so
    its inserts fail at a short probe bound while the others' fit."""
    cases = [_write_case(cuda, seed + i, cap, 0.97 if i == 0 else 0.05, b)
             for i in range(t_n)]
    table = tet.EdgeTable(*(torch.stack(c) for c in
                            zip(*(case[0] for case in cases))))
    u, v, en = (torch.stack(c) for c in zip(*(case[1:] for case in cases)))
    return table, u, v, en


@pytest.mark.parametrize("t_n", [1, 3, 256])
def test_hash_probe_lanes_kernels(cuda, t_n):
    """Lookup, insert and remove over [T, C] tables on the card == their
    plain versions; the insert fails lanes in row 0 only."""
    cap, b, mp = (1024, 300, 8) if t_n < 256 else (1024, 64, 8)
    table, u, v, en = _lane_tables(cuda, t_n, cap, b, 11 * t_n)
    base = href.hash_slots(u, v, cap)
    found = hops.probe(*table, base, u, v, max_probes=mp)
    want = href.probe(*table, base, u, v, max_probes=mp)
    assert all(torch.equal(a, w) for a, w in zip(found, want))
    before = hops.insert.lane_launches
    got, want = _insert_both(table, u, v, en, mp)
    assert hops.insert.lane_launches == before + 1
    _assert_same_insert(got, want)
    failed = got[2]
    assert bool(failed[0].any()), "row 0 failed no lane"
    if t_n > 1:
        assert not bool(failed[1:].any()), "a roomy row failed lanes"
    states, flags = [], []
    for fn in (hops.remove, href.remove):
        st = table.state.clone()
        flags.append(fn(table.src, table.dst, st, u, v, en,
                        max_probes=mp))
        states.append(st)
    assert torch.equal(states[0], states[1])
    assert torch.equal(flags[0], flags[1])


def test_lane_step_and_engine_on_card_match_cpu(cuda):
    """The lane-batched scan step and a TenantEngine on the card give the
    CPU's states, acks and repair tiers."""
    from repro_torch.tenancy import TenantEngine

    cfg = tgs.GraphConfig(n_vertices=64, edge_capacity=256, max_probes=16,
                          max_outer=65, max_inner=66,
                          region_vertex_capacity=32,
                          region_edge_buckets=(16, 64))
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        eng = TenantEngine(buckets=(32,), scan_lengths=(1, 4),
                           tenant_batches=(1, 4), device=dev)
        for i in range(5):
            eng.create_tenant(f"t{i}", cfg)
        acks = []
        for w in range(6):
            wave = []
            for i in range(5):
                r = np.random.default_rng(100 * w + i)
                n = 32 * (1 + (i + w) % 4)
                kind = r.choice([0, 0, 0, 1, 2, 3], n).astype(np.int32)
                wave.append((f"t{i}", kind,
                             r.integers(0, 64, n).astype(np.int32),
                             r.integers(0, 64, n).astype(np.int32)))
            res = eng.apply_chunks(wave)
            acks.append([(res[f"t{i}"][0].tolist(), res[f"t{i}"][1])
                         for i in range(5)])
        runs[dev.type] = (acks, [eng.tenant_state(f"t{i}").ccid.cpu()
                                 for i in range(5)],
                          eng.stats()["repair_lane_steps"])
    assert runs["cuda"][0] == runs["cpu"][0]
    assert all(torch.equal(a, b) for a, b in zip(runs["cuda"][1],
                                                 runs["cpu"][1]))
    assert runs["cuda"][2] == runs["cpu"][2]


def test_bool_matmul_kernel(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    for m, k, n in ((1, 1, 1), (65, 33, 130), (256, 256, 256)):
        a = torch.rand((m, k), device=cuda, generator=g) < 0.05
        b = torch.rand((k, n), device=cuda, generator=g) < 0.05
        assert torch.equal(bops.bool_matmul(a, b), bref.bool_matmul(a, b))


# (m, k, n, density): ragged edges and unaligned rows (byte staging), K past
# one 128-deep tile, density 1.0 at K=1024 (counts far above 127 must stay
# exact in s32), the dense tier's R=512 and R=1024
@pytest.mark.parametrize("m,k,n,density", [
    (1, 200, 3, 0.5), (70, 130, 90, 0.3), (100, 48, 16, 0.5),
    (64, 1024, 32, 1.0), (300, 1024, 200, 1.0), (512, 512, 512, 4 / 512),
    (1024, 1024, 1024, 4 / 1024), (512, 512, 512, 1.0)])
def test_bool_matmul_kernel_shapes(cuda, m, k, n, density):
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    a = torch.rand((m, k), device=cuda, generator=g) < density
    b = torch.rand((k, n), device=cuda, generator=g) < density
    assert torch.equal(bops.bool_matmul(a, b), bref.bool_matmul(a, b))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_flash_attention_kernel(cuda, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(0)
    # (b, h, hkv, s, d, causal, window): every head dim the kernel takes,
    # ragged S, GQA, windows that skip whole tiles, non-causal
    for b, h, hkv, s, d, causal, window in (
            (2, 4, 2, 100, 16, True, 0), (1, 2, 2, 130, 8, False, 0),
            (1, 2, 1, 200, 16, True, 4), (1, 4, 2, 333, 120, True, 70),
            (1, 4, 1, 257, 128, False, 50), (2, 8, 2, 1000, 16, True, 0)):
        q = torch.randn(b, s, h, d, device=cuda, generator=g).to(dtype)
        k, v = (torch.randn(b, hkv, s, d, device=cuda, generator=g).to(dtype)
                for _ in range(2))
        q = q.transpose(1, 2)  # a [B,S,H,D] buffer, as the LM hands it over
        got = aops.mha(q, k, v, causal=causal, window=window)
        want = aref.mha(q, k, v, causal=causal, window=window)
        assert got.stride() == q.stride()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def _bf16_margin(q, k, v, causal, window):
    """The bf16 kernel's worst error over its limit (rtol 1e-2, atol 1e-2 x
    mean |answer|) against the f32 plain version on the same values."""
    got = aops.mha(q, k, v, causal=causal, window=window)
    want = aref.mha(q.float(), k.float(), v.float(), causal=causal,
                    window=window)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    atol = 1e-2 * float(want.abs().mean())
    return float(((got.float() - want).abs()
                  / (atol + 1e-2 * want.abs())).max())


def _bf16_qkv(cuda, b, h, hkv, s, d, seed):
    """q, k, v as the LM hands them over: [B,S,H,D] buffers viewed as
    [B,H,S,D]."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(b, s, n, d, device=cuda, generator=g)
            .to(torch.bfloat16).transpose(1, 2) for n in (h, hkv, hkv)]


@pytest.mark.parametrize("d", aops.HEAD_DIMS)
def test_flash_bf16_head_dims(cuda, d):
    for b, h, hkv, s, causal, window in ((2, 4, 2, 300, True, 0),
                                         (1, 2, 1, 150, False, 0)):
        q, k, v = _bf16_qkv(cuda, b, h, hkv, s, d, d)
        assert _bf16_margin(q, k, v, causal, window) <= 1.0


# (b, h, hkv, s, d, causal, window): |v| / window >= 7.7e-3 at each, above
# the limit, so a key gained or lost at the band edge fails the check
@pytest.mark.parametrize("shape", [(1, 4, 2, 333, 120, True, 70),
                                   (1, 4, 1, 257, 128, False, 50),
                                   (1, 2, 1, 200, 16, True, 4),
                                   (2, 40, 8, 1000, 128, True, 129)])
def test_flash_bf16_band(cuda, shape):
    b, h, hkv, s, d, causal, window = shape
    q, k, v = _bf16_qkv(cuda, b, h, hkv, s, d, s)
    assert _bf16_margin(q, k, v, causal, window) <= 1.0


def test_flash_bf16_unaligned_stride_is_copied(cuda):
    """A row stride of D + 1 elements is no multiple of 16 bytes, which TMA
    cannot read: the wrapper copies q to a dense layout, once."""
    b, h, hkv, s, d = 1, 4, 2, 200, 120
    g = torch.Generator(device=cuda).manual_seed(1)
    buf = torch.randn(b, h, s, d + 1, device=cuda, generator=g).to(
        torch.bfloat16)
    q = buf[..., :d]
    _, k, v = _bf16_qkv(cuda, b, h, hkv, s, d, 2)
    before = aops.mha.layout_copies
    assert _bf16_margin(q, k, v, True, 0) <= 1.0
    assert aops.mha.layout_copies == before + 1


def test_embedding_bag_kernel(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    for b, l, v, d in ((37, 50, 1000, 64), (5, 70, 40, 200), (3, 1, 9, 8)):
        table = torch.randn(v, d, device=cuda, generator=g)
        ids = torch.randint(-3, v + 100, (b, l), device=cuda, generator=g,
                            dtype=torch.int32)
        w = torch.rand(b, l, device=cuda, generator=g)
        for mode in ("sum", "mean"):
            for weights in (None, w):
                torch.testing.assert_close(
                    eops.embedding_bag(table, ids, mode=mode,
                                       weights=weights),
                    eref.embedding_bag(table, ids, mode=mode,
                                       weights=weights),
                    rtol=1e-5, atol=1e-5)


# (b, l, v, d, offset): D not a multiple of 4 (4-byte chunks), D past one
# block of 16-byte chunks (column tiles), L past one staging pass, and a
# table whose base sits 4 bytes past 16-byte alignment (4-byte chunks)
@pytest.mark.parametrize("b,l,v,d,offset", [
    (37, 50, 1000, 7, 0), (9, 70, 500, 13, 0), (4, 300, 200, 64, 0),
    (3, 5, 50, 1100, 0), (20, 50, 1000, 64, 1), (6, 1, 30, 256, 0),
    (5, 40, 60, 257, 0)])
def test_embedding_bag_kernel_shapes(cuda, b, l, v, d, offset):
    g = torch.Generator(device=cuda).manual_seed(b * l + d)
    table = torch.randn(v * d + offset, device=cuda, generator=g)[
        offset:].view(v, d)
    assert eops.vector_rows(table) == (d % 4 == 0 and offset == 0)
    ids = torch.randint(-3, v + 100, (b, l), device=cuda, generator=g,
                        dtype=torch.int32)
    w = torch.rand(b, l, device=cuda, generator=g)
    for mode in ("sum", "mean"):
        for weights in (None, w):
            got = eops.embedding_bag(table, ids, mode=mode, weights=weights)
            torch.testing.assert_close(
                got, eref.embedding_bag(table, ids, mode=mode,
                                        weights=weights),
                rtol=1e-5, atol=1e-5)
            # a fixed reduction order: a second call gives the same bits
            assert torch.equal(got, eops.embedding_bag(
                table, ids, mode=mode, weights=weights))


def test_plain_impl_on_cuda_raises(cuda):
    a = torch.zeros((4, 4), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="plain version"):
        bops.bool_matmul(a, a, impl="xla")
    with pytest.raises(ValueError, match="dtype"):
        bops.bool_matmul(a.float(), a)
    q = torch.zeros((1, 2, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="plain version"):
        aops.mha(q, q, q, impl="xla")
    with pytest.raises(ValueError, match="head dim"):
        aops.mha(q[..., :4], q[..., :4], q[..., :4])
    table = torch.zeros((4, 8), device=cuda)
    ids = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="plain version"):
        eops.embedding_bag(table, ids, impl="pallas_interpret")
    with pytest.raises(ValueError, match="not supported"):
        eops.embedding_bag(table, ids, mode="max")


def test_service_on_card_matches_cpu(cuda):
    cfg = tgs.GraphConfig(n_vertices=256, edge_capacity=256, max_probes=32,
                          region_vertex_capacity=64, dense_capacity=16)
    results = []
    for dev in (cuda, torch.device("cpu")):
        svc = SCCService(cfg, state=tgs.all_singletons(cfg, dev),
                         buckets=(64,), proactive_grow=True)
        rep = stream.run_stream(svc, 1024, add_frac=0.8, chunk=256,
                                query_frac=1.0, n_queries=64)
        results.append((rep["accepted"], svc.state.ccid.cpu().tolist(),
                        svc.edge_set()))
    assert results[0] == results[1]


def test_bulk_load_on_card_matches_cpu(cuda):
    """``SCCService.from_edges`` on a load that overflows 4 probes: the
    card's grows, table, labels and counters equal the CPU's."""
    cfg = tgs.GraphConfig(n_vertices=512, edge_capacity=1024, max_probes=4)
    g = torch.Generator().manual_seed(4)
    src = torch.arange(512, dtype=torch.int32).repeat_interleave(2)
    dst = torch.randint(0, 512, (1024,), generator=g, dtype=torch.int32)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        svc = SCCService.from_edges(cfg, src, dst, device=dev,
                                    buckets=(64,))
        st = svc.state
        runs.append(([c.cpu() for c in st.edges], st.ccid.cpu(),
                     svc.cfg, svc.gen, svc.stats()))
    (cols, ccid, c_cfg, gen, stats), want = runs
    for a, b in zip(cols, want[0]):
        assert torch.equal(a, b)
    assert torch.equal(ccid, want[1])
    assert (c_cfg, gen) == want[2:4] and stats["grows"] >= 1
    stats.pop("device"), want[4].pop("device")
    assert stats == want[4]

def test_durable_writer_replica_and_recovery_on_card_match_cpu(cuda,
                                                               tmp_path):
    """A durable writer, one WAL-tailing replica and a crash recovery on
    the card, bit-identical to the same run on the CPU: acks, WAL bytes,
    the replica's and the recovered state."""
    from repro_torch.api import GraphClient
    from repro_torch.ckpt import oplog
    from repro_torch.ckpt.durable import DurableService, wal_dir
    from repro_torch.core.replicas import Replica
    from repro_torch.launch.replica import states_equal

    cfg = tgs.GraphConfig(n_vertices=256, edge_capacity=256, max_probes=32,
                          region_vertex_capacity=64)
    runs = {}
    for dev in (torch.device("cpu"), cuda):
        store = str(tmp_path / dev.type)
        writer = DurableService(cfg, store, state=tgs.all_singletons(cfg, dev),
                                buckets=(64,), proactive_grow=True,
                                snapshot_every=3, segment_bytes=4096,
                                snapshot_keep=10 ** 6, trim_on_snapshot=False)
        rep = Replica(store, auto_tail=False, query_buckets=(8,), device=dev)
        client = GraphClient(writer)
        acks = []
        for step in range(6):
            ops = stream.typed_op_stream(256, 96, step=step, add_frac=0.8,
                                         seed=3)
            acks.append([(r.value, r.gen) for r in client.submit_many(ops)])
            rep.tail_once(max_records=None)
        assert rep.gen == writer.gen
        assert states_equal(rep.service.state, writer.state)
        final = writer.state
        writer.crash()
        if writer._snap_thread is not None:
            writer._snap_thread.join()
        rec = DurableService.open(store, device=dev, snapshot_every=0)
        assert rec.gen == writer.gen and states_equal(rec.state, final)
        rec.close()
        runs[dev.type] = (acks, final, {
            p.rsplit("/", 1)[1]: open(p, "rb").read()
            for _, p in oplog.list_segments(wal_dir(store))})
    assert runs["cpu"][0] == runs["cuda"][0]
    assert states_equal(runs["cpu"][1], runs["cuda"][1])
    assert runs["cpu"][2] == runs["cuda"][2]


# the MoE archs' attention: moonshot-v1-16b-a3b (16 heads, 16 kv heads: no
# grouping) and qwen3-moe-235b-a22b (64 heads on 4 kv heads: 16:1), D 128
@pytest.mark.parametrize("h,hkv", [(16, 16), (64, 4)])
def test_flash_bf16_moe_heads(cuda, h, hkv):
    q, k, v = _bf16_qkv(cuda, 2, h, hkv, 700, 128, h)
    got = aops.mha(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), aref.mha(q, k, v).float(),
                               rtol=3e-2, atol=3e-2)
    assert _bf16_margin(q, k, v, True, 0) <= 1.0
    q32, k32, v32 = (x.float() for x in (q, k, v))
    torch.testing.assert_close(aops.mha(q32, k32, v32),
                               aref.mha(q32, k32, v32), rtol=2e-5, atol=2e-5)


def test_embedding_bag_kernel_mind_profile(cuda):
    """MIND's profile bag as its serving path calls it: 8192 x 64 table,
    512 bags of 8 ids from [-1, 8192), mean."""
    g = torch.Generator(device=cuda).manual_seed(8)
    table = torch.randn(8192, 64, device=cuda, generator=g)
    ids = torch.randint(-1, 8192, (512, 8), device=cuda, generator=g,
                        dtype=torch.int32)
    ids[:4] = -1  # bags with no id
    torch.testing.assert_close(
        eops.embedding_bag(table, ids, mode="mean"),
        eref.embedding_bag(table, ids, mode="mean"), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["moonshot_v1_16b_a3b",
                                  "qwen3_moe_235b_a22b"])
def test_moe_lm_on_card_matches_cpu(cuda, arch):
    """The smoke config in f32 (TF32 off), one set of weights on both
    devices: prefill and teacher-forced decode logits within 2e-4."""
    import importlib

    from repro_torch import carry
    from repro_torch.models import transformer as ttf

    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = mod.smoke_config(attn_impl="flash")
    tree = carry.lm_params_to_numpy(
        ttf.init(cfg, torch.Generator().manual_seed(0), "cpu"))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (3, 20)).astype(np.int32))
    runs, fed = [], []
    for dev in (torch.device("cpu"), cuda):
        params = carry.lm_params_from_numpy(tree, cfg, dev)
        cache, last = ttf.prefill(params, toks.to(dev), cfg, cache_len=24)
        seq = [last.cpu()]
        for i in range(4):
            if dev.type == "cpu":
                fed.append(seq[-1].argmax(-1).to(torch.int32))
            logits, cache = ttf.decode_step(params, cache, fed[i].to(dev),
                                            cfg)
            seq.append(logits.cpu())
        runs.append(torch.stack(seq))
    torch.testing.assert_close(runs[1], runs[0], rtol=2e-4, atol=2e-4)


def test_mind_on_card_matches_cpu(cuda):
    """MIND's smoke config, one set of weights on both devices: interests
    and scores within 1e-5, the profile bag on the kernel."""
    from repro_torch import carry
    from repro_torch.configs import mind as mind_cfg
    from repro_torch.models.recsys import mind

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = mind_cfg.smoke_config()
    tree = carry.mind_params_to_numpy(
        mind.init(cfg, torch.Generator().manual_seed(0), "cpu"))
    rng = np.random.default_rng(0)
    batch = {"behavior": rng.integers(-1, cfg.n_items, (16, cfg.seq_len)),
             "profile": rng.integers(-1, cfg.profile_vocab,
                                     (16, cfg.profile_len)),
             "candidates": rng.integers(0, cfg.n_items, (16, 300))}
    outs = []
    for dev in (torch.device("cpu"), cuda):
        params = carry.mind_params_from_numpy(tree, cfg, dev)
        b = {k: torch.from_numpy(v.astype(np.int32)).to(dev)
             for k, v in batch.items()}
        before = eops.embedding_bag.launches
        u = mind.interests(params, b["behavior"], b["profile"], cfg)
        scores = mind.serve_score(params, b, cfg)
        if dev.type == "cuda":
            assert eops.embedding_bag.launches == before + 2
        outs.append((u.cpu(), scores.cpu()))
    for got, want in zip(outs[1], outs[0]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_baselines_on_card_match_cpu(cuda):
    """The three baselines from one booted state on both devices: states
    and acks equal."""
    from repro_torch import carry
    from repro_torch.configs import smscc
    from repro_torch.core import baselines, dynamic
    from repro_torch.launch import workload

    cfg = smscc.config(n_vertices=512, edge_capacity=2048)
    rng = np.random.default_rng(4)
    src = np.repeat(np.arange(512, dtype=np.int32), 2)
    dst = rng.integers(0, 512, src.shape[0]).astype(np.int32)
    boot = carry.state_to_numpy(dynamic.recompute(
        tgs.from_arrays(cfg, src, dst, device="cpu"), cfg))
    ops = workload.op_stream(512, 48, step=0, add_frac=0.7, seed=4)
    for name in ("sequential_apply", "coarse_apply",
                 "static_per_batch_apply"):
        fn = getattr(baselines, name)
        want_st, want_ok = fn(carry.state_from_numpy(boot, "cpu"), ops, cfg)
        got_st, got_ok = fn(carry.state_from_numpy(boot, cuda), ops, cfg)
        assert torch.equal(got_ok.cpu(), want_ok), name
        want = carry.state_to_numpy(want_st)
        for k, v in carry.state_to_numpy(got_st).items():
            np.testing.assert_array_equal(v, want[k], err_msg=f"{name} {k}")


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_backward_on_card_matches_cpu(cuda, mode, weighted):
    """The kernel inside ``EmbeddingBagFn`` on the card: forward and the
    table and weight gradients within 1e-5 of autograd through the plain
    version on the CPU (padding, ids >= V and repeated ids included)."""
    g = torch.Generator().manual_seed(3)
    v, d, b, l = 300, 64, 40, 8
    table = torch.randn(v, d, generator=g)
    ids = torch.randint(-2, v + 20, (b, l), generator=g, dtype=torch.int32)
    ids[:, -1] = ids[:, 0]  # a repeated id in every bag
    ids[3] = -1             # a bag of padding only
    w = torch.rand(b, l, generator=g)
    grad = torch.randn(b, d, generator=g)
    runs = []
    for dev in (torch.device("cpu"), cuda):
        t = table.to(dev).requires_grad_()
        wt = w.to(dev).requires_grad_() if weighted else None
        before = eops.embedding_bag.launches
        out = eops.embedding_bag(t, ids.to(dev), mode=mode, weights=wt)
        leaves = [t] + ([wt] if weighted else [])
        grads = torch.autograd.grad(out, leaves, grad.to(dev))
        if dev.type == "cuda":
            assert eops.embedding_bag.launches == before + 1
        runs.append([out.detach().cpu()] + [x.cpu() for x in grads])
    for got, want in zip(runs[1], runs[0]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_mind_loss_gradients_on_card_match_cpu(cuda):
    """MIND's smoke loss on both devices from one state: loss within 1e-5,
    every gradient (``profile_embed``'s through the bag kernel) within
    2e-4."""
    from repro_torch import carry
    from repro_torch.configs import mind as mind_cfg
    from repro_torch.data import pipeline
    from repro_torch.models.recsys import mind
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = mind_cfg.smoke_config()
    tree = carry.mind_params_to_numpy(
        mind.init(cfg, torch.Generator().manual_seed(0), "cpu"))
    runs = []
    for dev in (torch.device("cpu"), cuda):
        params = carry.mind_params_from_numpy(tree, cfg, dev)
        batch = pipeline.mind_batch(cfg.n_items, 32, cfg.seq_len,
                                    cfg.profile_vocab, cfg.profile_len,
                                    cfg.n_neg, step=1, device=dev)
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        before = eops.embedding_bag.launches
        loss, _ = mind.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        if dev.type == "cuda":
            assert eops.embedding_bag.launches == before + 1
        runs.append((loss.detach().cpu(), [x.cpu() for x in grads]))
    torch.testing.assert_close(runs[1][0], runs[0][0], rtol=1e-5, atol=1e-5)
    for got, want in zip(runs[1][1], runs[0][1]):
        assert bool(want.ne(0).any())
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


def test_bf16_checkpoint_round_trip_on_card(cuda, tmp_path):
    """A bf16 trainer state saved from the card comes back bit for bit, on
    the card, in bf16."""
    from repro_torch.ckpt import checkpoint
    from repro_torch.configs import qwen3_14b
    from repro_torch.models import transformer as tf
    from repro_torch.optim import optimizer
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(qwen3_14b.smoke_config(), dtype=torch.bfloat16)
    params = tf.init(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    state = {"params": params, "opt": optimizer.init(params), "ef": None,
             "rng": torch.tensor(5)}
    checkpoint.save(str(tmp_path), 5, state)
    got, step = checkpoint.restore(str(tmp_path),
                                   tree_map(torch.zeros_like, state))
    assert step == 5
    for want, back in zip(tree_leaves(state), tree_leaves(got)):
        assert back.device == want.device and back.dtype == want.dtype
        bits = (lambda x: x.view(torch.int16)
                if x.dtype == torch.bfloat16 else x)
        assert torch.equal(bits(back), bits(want))


def test_flash_refuses_a_backward_on_card(cuda):
    """A loss through the flash kernel runs forward on the card (one launch
    a layer) and refuses its backward."""
    from repro_torch.configs import qwen3_14b
    from repro_torch.data import pipeline
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves

    cfg = qwen3_14b.smoke_config(attn_impl="flash")
    params = tf.init(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    batch = pipeline.lm_batch(cfg.vocab, 2, 32, step=0, device=cuda)
    before = aops.mha.launches
    loss, _ = tf.loss_fn(params, batch, cfg)
    assert aops.mha.launches == before + cfg.n_layers
    assert bool(torch.isfinite(loss))
    with pytest.raises(RuntimeError, match="attn_impl='chunked'"):
        torch.autograd.grad(loss, leaves)


def _gnn_smoke_batch(task, cfg, dev):
    from repro_torch.data import pipeline

    if task == "energy":
        b = pipeline.molecule_batch(cfg.n_graphs, 6, 12, cfg.d_feat, step=0,
                                    device=dev)
    else:
        b = pipeline.node_class_graph(60, 240, cfg.d_feat, cfg.n_classes,
                                      seed=0, device=dev)
    return {k: v.to(cfg.dtype) if v.is_floating_point() else v
            for k, v in b.items()}


@pytest.mark.parametrize("task", ["energy", "node_class"])
@pytest.mark.parametrize("arch", ["egnn", "gatedgcn", "nequip", "mace"])
def test_gnn_on_card_matches_cpu(cuda, arch, task):
    """A GNN's smoke config (remat on) from one state on both devices: the
    loss within 1e-5 relative, every gradient leaf and every parameter
    after one Trainer step within rtol 2e-4 / atol 2e-5.  f32 with TF32
    off, except MACE's energy task in f64 (its f32 gradients stand over
    10x the tolerance from its own f64 answer on one device)."""
    from repro_torch import carry, configs
    from repro_torch.optim import optimizer
    from repro_torch.train import trainer
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    mod = configs.get(arch)
    f64 = arch == "mace" and task == "energy"
    cfg = mod.smoke_config(task=task, n_classes=3, remat=True,
                           dtype=torch.float64 if f64 else torch.float32)
    tree = carry.gnn_params_to_numpy(mod.MODULE.init(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    runs = []
    for dev in (torch.device("cpu"), cuda):
        batch = _gnn_smoke_batch(task, cfg, dev)
        t = trainer.Trainer(
            lambda p, b: mod.MODULE.loss_fn(p, b, cfg),
            carry.gnn_params_from_numpy(tree, cfg, dev),
            optimizer.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=1),
            trainer.TrainerConfig(total_steps=1), lambda s: batch)
        loss, _, grads = t.value_and_grad(t.state["params"], batch)
        t.run()
        runs.append((float(loss), [g.cpu() for g in tree_leaves(grads)],
                     [p.detach().cpu()
                      for p in tree_leaves(t.state["params"])]))
    (l_cpu, g_cpu, p_cpu), (l_card, g_card, p_card) = runs
    assert l_card == pytest.approx(l_cpu, rel=1e-5)
    for got, want in zip(g_card + p_card, g_cpu + p_cpu):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


def test_sampler_on_card_matches_cpu(cuda):
    """The CSR build and the sampled block batch, fed the same draws: the
    card's arrays equal the CPU's exactly."""
    from repro_torch.data import pipeline
    from repro_torch.graph import sampler

    g = torch.Generator().manual_seed(0)
    draws, n = [], 64
    for f in (15, 10):
        draws.append(torch.randint(0, sampler.DRAW_HIGH, (n, f),
                                   generator=g))
        n *= f
    feats = torch.randn((3000, 5), generator=g)
    labels = torch.randint(0, 4, (3000,), generator=g, dtype=torch.int32)
    got = []
    for dev in (torch.device("cpu"), cuda):
        csr = sampler.make_synthetic_csr(3000, 25, seed=2, device=dev)
        b = pipeline.sampled_block_batch(csr, feats.to(dev), labels.to(dev),
                                         64, (15, 10), step=1, draws=draws)
        got.append([csr.indptr.cpu(), csr.indices.cpu()] +
                   [b[k].cpu() for k in sorted(b)])
    for a, b in zip(*got):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_launch_train_gnn_on_card(cuda):
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "egnn",
         "--smoke", "--steps", "4", "--device", "cuda"], cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root / "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "done: 4 steps" in out.stdout and "on cuda" in out.stdout


def test_smscc_and_mind_bundles_on_card_equal_direct_calls(cuda):
    """The launch layer's step bundles on the host mesh (one card, 1x1) at
    their configs' shapes: each result equals the port's function called
    directly on the same inputs, the labels a static recompute, and the
    SMSCC and MIND kernels launch."""
    import torch.distributed as dist

    from repro_torch import configs, kernels
    from repro_torch.core import community, dynamic
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps, workload
    from repro_torch.models.recsys import mind
    from repro_torch.tree import tree_leaves, tree_map

    mesh = mesh_lib.make_host_mesh()
    try:
        assert tuple(mesh.shape) == (1, 1)
        smscc = configs.get("smscc")
        shape = smscc.SHAPES["update_1m"]
        cfg = smscc.config(n_vertices=shape["n_vertices"],
                           edge_capacity=shape["edge_capacity"])
        b = steps.build("smscc", "update_1m", mesh)
        state = tgs.all_singletons(cfg, cuda)
        direct = tree_map(torch.clone, state)
        kernels.reset_launch_counts()
        for s in range(2):
            ops = tree_map(lambda x: x.to(cuda), workload.op_stream(
                cfg.n_vertices, shape["batch"], step=s, add_frac=0.7))
            state, ok = b.fn(state, ops)
            direct, want = dynamic.apply_batch(direct, ops, cfg)
            assert torch.equal(ok, want)
        counts = kernels.launch_counts()
        assert counts["frontier_min"] > 0 and counts["hash_probe"] > 0
        for x, y in zip(tree_leaves(state), tree_leaves(direct)):
            assert torch.equal(x, y)
        assert torch.equal(dynamic.recompute(state, cfg).ccid, state.ccid)
        q = steps.build("smscc", "community_query", mesh)
        g = torch.Generator(device=cuda).manual_seed(0)
        u, v = (torch.randint(0, cfg.n_vertices, (4096,), generator=g,
                              device=cuda, dtype=torch.int32)
                for _ in range(2))
        assert torch.equal(q.fn(state, u, v),
                           community.check_scc(state, u, v))

        m = steps.build("mind", "serve_p99", mesh)
        mcfg = configs.get("mind").config(scan_unroll=True)
        params = mind.init(mcfg, torch.Generator(cuda).manual_seed(0), cuda)
        rng = np.random.default_rng(0)
        batch = {k: torch.as_tensor(rng.integers(lo, hi, size),
                                    dtype=torch.int32, device=cuda)
                 for k, lo, hi, size in (
                     ("behavior", -1, mcfg.n_items, (512, mcfg.seq_len)),
                     ("profile", -1, mcfg.profile_vocab,
                      (512, mcfg.profile_len)),
                     ("candidates", 0, mcfg.n_items, (512, 2048)))}
        kernels.reset_launch_counts()
        got = m.fn(params, batch)
        assert kernels.launch_counts()["embedding_bag"] == 1
        assert torch.equal(got, mind.serve_score(params, batch, mcfg))
    finally:
        dist.destroy_process_group()


def test_frontier_step_and_closure_launch_bool_matmul(cuda):
    from repro_torch import kernels
    g = torch.Generator(device=cuda).manual_seed(0)
    n = 200
    adj = torch.rand((n, n), generator=g, device=cuda) < 0.02
    f = torch.rand((n, 8), generator=g, device=cuda) < 0.05
    kernels.reset_launch_counts()
    step = bops.frontier_step(adj, f)
    assert kernels.launch_counts()["bool_matmul"] == 1
    clo = bops.closure(adj)
    assert kernels.launch_counts()["bool_matmul"] == 1 + (n - 1).bit_length()
    assert torch.equal(step.cpu(), bref.frontier_step(adj.cpu(), f.cpu()))
    assert torch.equal(clo.cpu(), bref.closure(adj.cpu()))


# ------------------------------------- the static SCC and the step graph ---

def _scc_case(seed, nv, e, depth):
    """A chain of ``depth`` 2-cycles {2i, 2i+1} (2i+1 -> 2i+2: min labels
    settle one a round), random edges among the other vertices, dead slots
    and inactive vertices off the chain: (src, dst, live, active)."""
    rng = np.random.default_rng(seed)
    chain = [(2 * i, 2 * i + 1) for i in range(depth)] + \
        [(2 * i + 1, 2 * i) for i in range(depth)] + \
        [(2 * i + 1, 2 * i + 2) for i in range(depth - 1)]
    lo = 2 * depth
    src = np.concatenate([np.array([a for a, _ in chain], np.int32),
                          rng.integers(lo, nv, e).astype(np.int32)])
    dst = np.concatenate([np.array([b for _, b in chain], np.int32),
                          rng.integers(lo, nv, e).astype(np.int32)])
    live = rng.random(src.shape[0]) < 0.9
    live[:len(chain)] = True
    active = rng.random(nv) < 0.9
    active[:lo] = True
    return [torch.from_numpy(x) for x in (src, dst, live, active)]


@pytest.mark.parametrize("max_outer", [2, 300])
@pytest.mark.parametrize("t_n", [None, 3, 256])
@pytest.mark.parametrize("shortcut", [False, True])
def test_scc_form_matches_plain(cuda, shortcut, t_n, max_outer):
    """The scc form (the whole static SCC in one launch) == its plain
    version on CPU copies: labels, each lane's outer rounds and the rounds
    by form on the card's counter; one launch, no host read.  Lanes of
    other depths (an empty one among them) each equal their solo run."""
    if t_n is None:
        args = _scc_case(0, 3000, 4000, 40)
    else:
        nv, e = (3000, 4000) if t_n == 3 else (64, 120)
        depths = (0, 5, 40) if t_n == 3 else [i % 25 for i in range(t_n)]
        cases = [_scc_case(200 + i, nv, e, max(d, 1))
                 for i, d in enumerate(depths)]
        e_max = max(c[0].shape[0] for c in cases)
        for c, d in zip(cases, depths):
            if d == 0:
                c[3][:] = False
            pad = e_max - c[0].shape[0]  # dead slots to one row length
            for k in range(3):
                c[k] = torch.cat([c[k], torch.zeros(pad, dtype=c[k].dtype)])
        args = [torch.stack(list(c)) for c in zip(*cases)]
    card = [x.to(cuda) for x in args]
    fops.reset_fixpoint_rounds()
    before = (fops.frontier_min.fixpoint_launches, SYNCS.count)
    got, outer = fops.frontier_fixpoint("scc", *card, None, 500,
                                        shortcut=shortcut,
                                        max_outer=max_outer)
    assert (fops.frontier_min.fixpoint_launches, SYNCS.count) == (
        before[0] + 1, before[1])
    rounds = fops.fixpoint_rounds()
    tally = {}
    want, want_outer = fref.frontier_fixpoint(
        "scc", *args, None, 500, shortcut=shortcut, max_outer=max_outer,
        tally=tally)
    assert torch.equal(got.cpu(), want) and torch.equal(outer.cpu(),
                                                        want_outer)
    assert {k: n for k, n in rounds.items() if n} == \
        {k: n for k, n in tally.items() if n}
    if t_n == 3:
        for t in range(t_n):
            solo, n = fops.frontier_fixpoint(
                "scc", *(x[t] for x in card), None, 500, shortcut=shortcut,
                max_outer=max_outer)
            assert torch.equal(solo, got[t]) and int(n) == int(outer[t])


SCC_CASES = ("one outer round assigns everything", "no live edge",
             "tombstones")


def _scc_edge_case(seed, nv, e, case):
    """(src, dst, live, active) of one scc-form graph on the CPU: a cycle
    through every vertex plus random chords, all active (trim peels
    nothing and the first outer round assigns every vertex); no live
    slot (trim peels every vertex in its first round); or the chained
    2-cycles of ``_scc_case`` with dead slots that keep their ids."""
    if case == "tombstones":
        src, dst, live, active = _scc_case(seed, nv, e, 6)
        rng = np.random.default_rng(seed)
        live = torch.from_numpy(rng.random(src.shape[0]) < 0.5)
        live[:17] = True  # the chain's 6 2-cycles and 5 links
        return [src, dst, live, active]
    rng = np.random.default_rng(seed)
    ring = np.arange(nv, dtype=np.int32)
    src = np.concatenate([ring, rng.integers(0, nv, e).astype(np.int32)])
    dst = np.concatenate([np.roll(ring, -1),
                          rng.integers(0, nv, e).astype(np.int32)])
    live = np.full(src.shape[0], case != "no live edge")
    return [torch.from_numpy(x) for x in (src, dst, live,
                                          np.ones(nv, dtype=bool))]


@pytest.mark.parametrize("t_n", [None, 256])
@pytest.mark.parametrize("case", SCC_CASES)
@pytest.mark.parametrize("shortcut", [False, True])
def test_scc_form_edge_list_cases(cuda, shortcut, case, t_n):
    """The scc form lists the edges afresh in each outer round's trim and
    forward sweep: held exactly (labels, outer rounds, rounds by form) to
    its plain version on CPU copies and to the schedule's plain model
    where one outer round assigns every vertex, where no slot is live,
    and over tombstones; one graph and 256 lanes (every fifth lane with
    no active vertex)."""
    if t_n is None:
        args = _scc_edge_case(5, 2000, 3000, case)
    else:
        cases = [_scc_edge_case(500 + i, 48, 60, case) for i in range(t_n)]
        e_max = max(c[0].shape[0] for c in cases)
        for i, c in enumerate(cases):
            if i % 5 == 0:
                c[3][:] = False
            pad = e_max - c[0].shape[0]  # dead slots to one row length
            for k in range(3):
                c[k] = torch.cat([c[k], torch.zeros(pad, dtype=c[k].dtype)])
        args = [torch.stack(list(c)) for c in zip(*cases)]
    card = [x.to(cuda) for x in args]
    fops.reset_fixpoint_rounds()
    got, outer = fops.frontier_fixpoint("scc", *card, None, 500,
                                        shortcut=shortcut, max_outer=300)
    rounds = fops.fixpoint_rounds()
    tally = {}
    want, want_outer = fref.frontier_fixpoint(
        "scc", *args, None, 500, shortcut=shortcut, max_outer=300,
        tally=tally)
    model = fref.fixpoint_schedule("scc", *args, None, 500,
                                   shortcut=shortcut, max_outer=300)
    for lab, out_n in ((want, want_outer), model):
        assert torch.equal(got.cpu(), lab) and torch.equal(outer.cpu(),
                                                           out_n)
    assert {k: n for k, n in rounds.items() if n} == \
        {k: n for k, n in tally.items() if n}
    if case.startswith("one outer"):
        assert int(outer.max()) == 1
        assert bool((got.cpu() != 2 ** 31 - 1).any())


def _tier_cfg(name):
    import tier_stream
    kw = dict(tier_stream.CONFIG)
    kw["repair_gate"] = name != "gate_off"
    kw["shortcut"] = name == "shortcut"
    return tgs.GraphConfig(**kw)


def _leaves_equal(a, b):
    from repro_torch.tree import tree_leaves
    return all(torch.equal(x.cpu(), y.cpu())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("name", ["tiered", "gate_off", "shortcut"])
def test_step_graph_matches_eager_and_cpu(cuda, name, monkeypatch):
    """The step as a captured graph (captured under sync debug "error",
    so a read back inside it raises) == the eager per-decision step on the
    card == the CPU step, exactly: state, ok, overflow and RepairStats,
    over a stream that takes the skip, the dense tier, both compact
    buckets and the full tier; no host read inside a step; the graph's
    replays count the launches the eager step makes; then the whole
    stream as one super-chunk through the scan entry."""
    import tier_stream
    from repro_torch import kernels
    from repro_torch.core import dynamic, step_graph

    monkeypatch.setattr(step_graph, "SYNC_DEBUG", True)
    step_graph.clear()
    cfg = _tier_cfg(name)
    batches = tier_stream.batches()
    st = {k: tgs.all_singletons(cfg, d) for k, d in
          (("graph", cuda), ("eager", cuda), ("cpu", "cpu"))}
    seen = set()
    launches = {}
    captures = step_graph.captures
    for i, (k, u, v) in enumerate(batches):
        ops = dynamic.make_ops(k, u, v)
        out = {}
        for key, fn in (("graph", dynamic.apply_batch_stats),
                        ("eager", dynamic.apply_batch_stats_eager),
                        ("cpu", dynamic.apply_batch_stats)):
            kernels.reset_launch_counts()
            s0 = SYNCS.count
            out[key] = fn(st[key], ops, cfg)
            if key == "graph":
                assert SYNCS.count == s0, f"step {i}: a host read"
            launches[key] = kernels.launch_counts()
            st[key] = out[key][0]
        assert launches["graph"] == launches["eager"], f"step {i}"
        g = out["graph"]
        for key in ("eager", "cpu"):
            o = out[key]
            assert _leaves_equal(g[0], o[0]), f"{key} step {i}: state"
            assert torch.equal(g[1].cpu(), o[1].cpu())
            assert int(g[2]) == int(o[2])
            assert [int(x) for x in g[3]] == [int(x) for x in o[3]], \
                f"{key} step {i}: {[int(x) for x in g[3]]}"
        rep = g[3]
        seen.add("skip" if int(rep.tier) == dynamic.TIER_SKIP else
                 dynamic.branches(cfg)[int(dynamic.tier_code(
                     cfg, rep.region_vertices, rep.region_edges))])
    assert seen == set(dynamic.branches(cfg)) | (
        {"skip"} if cfg.repair_gate else set())
    assert step_graph.captures == captures + 1
    stacked = dynamic.make_ops(*(np.stack(c) for c in zip(*batches)))
    runs = {key: dynamic.apply_batch_scan(tgs.all_singletons(cfg, d),
                                          stacked, cfg)
            for key, d in (("graph", cuda), ("cpu", "cpu"))}
    assert _leaves_equal(runs["graph"][0], runs["cpu"][0])
    for a, b in zip(runs["graph"][1:3], runs["cpu"][1:3]):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(runs["graph"][3], runs["cpu"][3]):
        assert torch.equal(a.cpu(), b)
    assert _leaves_equal(runs["graph"][0], st["cpu"])


def test_step_graph_never_rewrites_a_held_snapshot(cuda):
    """A reader's committed snapshot stays bit-identical while the service
    runs 4 more super-chunks through the same graph; the super-chunk
    entries the partial replay holds too."""
    import tier_stream
    from repro_torch.core import step_graph

    cfg = _tier_cfg("tiered")
    svc = SCCService(cfg, buckets=(tier_stream.B,), scan_lengths=(1, 4),
                     state=tgs.all_singletons(cfg, cuda))
    batches = tier_stream.batches(seed=5, n_random=16)
    svc._apply_chunk(*(np.concatenate(c) for c in zip(*batches[:4])))
    held = svc.state
    copy = [x.cpu().clone() for x in _flat(held)]
    n = step_graph.captures
    for c in range(4):  # 4 chunks of 4 steps: one super-chunk each
        part = batches[4 + 4 * c:8 + 4 * c]
        svc._apply_chunk(*(np.concatenate(x) for x in zip(*part)))
        assert all(torch.equal(a.cpu(), b)
                   for a, b in zip(_flat(held), copy)), f"chunk {c}"
    assert step_graph.captures == n
    assert svc.stats()["scan_dispatches"] >= 4


def _flat(state):
    from repro_torch.tree import tree_leaves
    return tree_leaves(state)


def test_step_graph_recaptures_on_grow(cuda):
    """A table too small for the stream: the service grows mid-stream
    (a new cfg, so a new capture) and the card stays exactly the CPU's:
    acks, labels and edges."""
    import tier_stream
    from repro_torch.core import step_graph

    cfg = tgs.GraphConfig(**dict(tier_stream.CONFIG, edge_capacity=64,
                                 max_probes=8))
    runs = {}
    n = step_graph.captures
    for dev in (cuda, torch.device("cpu")):
        svc = SCCService(cfg, buckets=(tier_stream.B,), scan_lengths=(1, 4),
                         state=tgs.all_singletons(cfg, dev))
        oks = [svc._apply_chunk(*(np.concatenate(x) for x in zip(*part)))
               for part in (tier_stream.batches(seed=s, n_random=4)[-4:]
                            for s in range(6))]
        runs[dev.type] = (np.concatenate(oks), svc.state.ccid.cpu(),
                          svc.edge_set(), svc.cfg.edge_capacity,
                          svc.stats()["grows"])
    assert runs["cuda"][3] > 64 and runs["cuda"][4] > 0
    assert step_graph.captures >= n + 2
    np.testing.assert_array_equal(runs["cuda"][0], runs["cpu"][0])
    assert torch.equal(runs["cuda"][1], runs["cpu"][1])
    assert runs["cuda"][2:] == runs["cpu"][2:]


def test_step_graph_captures_on_streams_of_its_own(cuda):
    """A capture's streams (the capture's and each branch depth's) are
    never handed out by PyTorch's stream pool, whose 32 streams other code
    shares: a pooled stream already capturing could be asked to capture a
    branch (cudaErrorIllegalState)."""
    import tier_stream
    from repro_torch.core import dynamic, step_graph

    step_graph.clear()
    cfg = _tier_cfg("tiered")
    k, u, v = tier_stream.batches()[0]
    dynamic.apply_batch_stats(tgs.all_singletons(cfg, cuda),
                              dynamic.make_ops(k, u, v), cfg)
    own = {s.cuda_stream for s in step_graph._streams.values()}
    assert len(own) >= 3  # the capture's, depth 0 and 1
    pooled = {torch.cuda.Stream(cuda).cuda_stream for _ in range(64)}
    assert not own & pooled


def test_device_waits_beside_captures_in_another_thread(cuda):
    """A thread captures step graphs (a new cfg each, so a new capture
    each) while this one keeps the card busy and waits for it through
    ``step_graph.synchronize``, as a writer's client waits beside its
    replicas: the card refuses a device-wide wait while any stream
    captures, so every wait must fall between captures.  Every capture
    completes and its step equals the eager step."""
    import threading

    import tier_stream
    from repro_torch.core import dynamic, step_graph

    step_graph.clear()
    k, u, v = tier_stream.batches()[0]
    ops = dynamic.make_ops(k, u, v)
    cfgs = [tgs.GraphConfig(**dict(tier_stream.CONFIG, edge_capacity=c))
            for c in (128, 256, 512, 1024, 2048, 4096)]
    outs, errors = [], []

    def capture():
        try:
            for cfg in cfgs:
                outs.append(dynamic.apply_batch_stats(
                    tgs.all_singletons(cfg, cuda), ops, cfg))
        except Exception as e:  # raised below, on the test's thread
            errors.append(e)

    n = step_graph.captures
    x = torch.zeros(1 << 20, device=cuda)
    waits = 0
    t = threading.Thread(target=capture)
    t.start()
    while t.is_alive():
        x.add_(1)
        step_graph.synchronize(cuda)
        waits += 1
    t.join()
    assert not errors, errors
    assert step_graph.captures == n + len(cfgs) and waits > 0
    for cfg, got in zip(cfgs, outs):
        want = dynamic.apply_batch_stats_eager(
            tgs.all_singletons(cfg, cuda), ops, cfg)
        assert _leaves_equal(got[0], want[0])
        assert torch.equal(got[1].cpu(), want[1].cpu())
        assert int(got[2]) == int(want[2])
        assert [int(a) for a in got[3]] == [int(b) for b in want[3]]


def _lane_waves(seed):
    """tier_stream's built lane wave (its lanes take different branches
    in one step), then a seeded random wave of the same shape."""
    import tier_stream
    k, u, v = tier_stream.lane_wave()
    r = np.random.default_rng(seed)
    kind = r.choice([0, 0, 0, 1, 2, 3, 4], k.shape).astype(np.int32)
    return [(k, u, v), (kind, r.integers(0, 24, k.shape).astype(np.int32),
                        r.integers(0, 24, k.shape).astype(np.int32))]


@pytest.mark.parametrize("lanes", [None, 4])
def test_lane_graph_matches_eager_lane_step(cuda, lanes, monkeypatch):
    """The lane step as a captured graph (captured under sync debug
    "error", so a read back inside it raises; ``lanes`` 4 pads the 3
    lanes with a NOP row) == the eager per-decision lane step on the card
    == the CPU, bit for bit, over two waves whose lanes take different
    branches: state, ok, overflow and per-lane RepairStats; no host read
    inside a dispatch; the replays count the eager step's launches (the
    dense tier's, all rows' of each step that ran it); one capture for
    both waves."""
    import tier_stream
    from repro_torch import kernels
    from repro_torch.core import dynamic, step_graph

    monkeypatch.setattr(step_graph, "SYNC_DEBUG", True)
    step_graph.clear()
    cfg = tgs.GraphConfig(**tier_stream.LANE_CONFIG)
    st = {k: tgs.stack([tgs.all_singletons(cfg, d)] * 3) for k, d in
          (("graph", cuda), ("eager", cuda), ("cpu", "cpu"))}
    n = step_graph.captures
    tiers = set()
    for w, (k, u, v) in enumerate(_lane_waves(7)):
        ops = dynamic.make_ops(k, u, v)
        out, launches = {}, {}
        for key in st:
            kernels.reset_launch_counts()
            s0 = SYNCS.count
            if key == "eager":  # the per-decision lane step, K times
                s, parts = st[key], []
                for j in range(k.shape[1]):
                    s, *o = dynamic.apply_batch_stats_lanes_eager(
                        s, dynamic.OpBatch(*(x[:, j] for x in ops)), cfg)
                    parts.append(o)
                out[key] = (s, torch.stack([p[0] for p in parts], 1),
                            torch.stack([p[1] for p in parts], 1),
                            torch.stack([torch.stack(tuple(p[2]), -1)
                                         for p in parts], 1))
            else:
                s, ok, ovf, rep = dynamic.apply_batch_scan_lanes(
                    st[key], ops, cfg, lanes=lanes if key == "graph"
                    else None)
                out[key] = (s, ok, ovf, torch.stack(tuple(rep), -1))
            if key == "graph":
                assert SYNCS.count == s0, f"wave {w}: a host read"
            launches[key] = kernels.launch_counts()
            st[key] = out[key][0]
        g = out["graph"]
        for key in ("eager", "cpu"):
            assert _leaves_equal(g[0], out[key][0]), f"{key} wave {w}"
            for a, b in zip(g[1:], out[key][1:]):
                assert torch.equal(a.cpu(), b.cpu()), f"{key} wave {w}"
        tier = g[3][..., 0].cpu()
        tiers |= set(tier.reshape(-1).tolist())
        # the dense tier runs lane by lane: the graph's branch over all of
        # its rows, the eager step over the lanes that chose it
        dense = tier == dynamic.TIER_DENSE
        rows = lanes or 3
        mm = [launches[k].pop("bool_matmul") for k in ("graph", "eager")]
        assert mm[0] * int(dense.sum()) == \
            mm[1] * rows * int(dense.any(0).sum()), (w, mm)
        assert launches["graph"] == launches["eager"], f"wave {w}"
    assert step_graph.captures == n + 1
    assert tiers == {dynamic.TIER_DENSE, dynamic.TIER_COMPACT,
                     dynamic.TIER_FULL, dynamic.TIER_SKIP}


def test_tenant_flush_reads_once_and_captures_within_bound(cuda):
    """A TenantEngine on the card: every flush makes one host read (its
    transfer) and nothing inside a dispatch; the lane graphs captured stay
    within the engine's ``compile_bound``; acks, states and repair tiers
    equal the CPU engine's."""
    from repro_torch.core import step_graph
    from repro_torch.tenancy import TenantEngine

    cfg = tgs.GraphConfig(n_vertices=64, edge_capacity=512, max_probes=16,
                          max_outer=65, max_inner=66,
                          region_vertex_capacity=32,
                          region_edge_buckets=(16, 64))
    step_graph.clear()
    n = step_graph.captures
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        eng = TenantEngine(buckets=(32,), scan_lengths=(1, 4),
                           tenant_batches=(1, 4, 8), device=dev)
        for i in range(6):
            eng.create_tenant(f"t{i}", cfg)
        acks, reads = [], []
        for w in range(5):
            wave = []
            for i in range(6 - w % 3):  # 6, 5 and 4 tenants a wave
                r = np.random.default_rng(100 * w + i)
                m = 32 * (1 + (i + w) % 4)
                wave.append((f"t{i}",
                             r.choice([0, 0, 0, 1, 2, 3], m).astype(np.int32),
                             r.integers(0, 64, m).astype(np.int32),
                             r.integers(0, 64, m).astype(np.int32)))
            s0 = SYNCS.count
            res = eng.apply_chunks(wave)
            reads.append(SYNCS.count - s0)
            acks.append({t: (res[t][0].tolist(), res[t][1]) for t in res})
        st = eng.stats()
        runs[dev.type] = (acks, [eng.tenant_state(f"t{i}").ccid.cpu()
                                 for i in range(6)],
                          st["repair_lane_steps"])
        if dev.type == "cuda":
            assert st["solo_replays"] == 0
            assert reads == [1] * 5, reads
            captured = step_graph.captures - n
            assert 0 < captured <= st["compile_bound"], (
                captured, st["compile_bound"])
    assert runs["cuda"][0] == runs["cpu"][0]
    assert all(torch.equal(a, b) for a, b in zip(runs["cuda"][1],
                                                 runs["cpu"][1]))
    assert runs["cuda"][2] == runs["cpu"][2]


def _pool_segments():
    """Reserved segments outside the default pool: graphs' and MemPools'."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return sum(1 for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) != (0, 0))


def test_dropped_graphs_free_their_branch_pools(cuda):
    """Lane graphs captured and dropped (``step_graph.clear``) in this
    thread while another thread captures step graphs: no capture fails
    (a dropped graph's branch pool is freed only under the capture lock,
    since freeing a pool empties it, which the allocator refuses during
    any capture), and once every graph is gone no segment of theirs stays
    reserved."""
    import threading

    import tier_stream
    from repro_torch.core import dynamic, step_graph

    step_graph.clear()
    before = _pool_segments()
    k, u, v = tier_stream.batches()[0]
    ops = dynamic.make_ops(k, u, v)
    cfgs = [tgs.GraphConfig(**dict(tier_stream.CONFIG, edge_capacity=c))
            for c in (128, 256, 512, 1024)]
    lane_ops = dynamic.make_ops(*tier_stream.lane_wave())
    errors = []

    def capture():
        try:
            for cfg in cfgs:
                dynamic.apply_batch_stats(tgs.all_singletons(cfg, cuda), ops,
                                          cfg)
        except Exception as e:  # raised below, on the test's thread
            errors.append(e)

    t = threading.Thread(target=capture)
    t.start()
    drops = 0
    while t.is_alive() or drops < 2:
        cfg = tgs.GraphConfig(**dict(tier_stream.LANE_CONFIG,
                                     max_outer=25 + drops))
        dynamic.apply_batch_scan_lanes(
            tgs.stack([tgs.all_singletons(cfg, cuda)] * 3), lane_ops, cfg)
        step_graph.clear()
        drops += 1
    t.join()
    assert not errors, errors
    step_graph.clear()
    assert _pool_segments() <= before


@pytest.mark.parametrize("arch", ["qwen3_14b", "moonshot_v1_16b_a3b"])
def test_decode_graph_matches_eager_loop(cuda, arch):
    """``serve_lm`` on the card through the captured decode step (one
    capture, one replay a token) gives the eager loop's greedy tokens,
    over steps that run past the cache's end; its device time comes
    from CUDA events around the replays."""
    import importlib

    from repro_torch.launch import serve

    cfg = importlib.import_module(f"repro_torch.configs.{arch}") \
        .smoke_config()
    kw = dict(batch=2, prompt_len=12, cache_len=16, device="cuda", seed=3)
    n = serve.decode_captures
    graph = serve.serve_lm(cfg, 70, decode="graph", **kw)
    eager = serve.serve_lm(cfg, 70, decode="eager", **kw)
    assert serve.decode_captures == n + 1
    assert graph["decode"] == "graph" and eager["decode"] == "eager"
    assert graph["tokens"] == eager["tokens"]
    assert graph["logits_finite"]
    assert graph["device_s_per_decode_step"] > 0
    assert eager["device_s_per_decode_step"] is None


def test_decode_capture_beside_a_waiting_thread(cuda):
    """Decode graphs captured while another thread keeps the card busy
    and waits for it through ``step_graph.synchronize``: every wait falls
    between captures (the card refuses a device-wide wait during one),
    and every run's tokens equal the eager loop's."""
    import threading

    from repro_torch.configs import qwen3_14b
    from repro_torch.core import step_graph
    from repro_torch.launch import serve

    cfg = qwen3_14b.smoke_config()
    kw = dict(batch=2, prompt_len=12, cache_len=32, device="cuda")
    outs, errors = [], []

    def capture():
        try:
            for seed in range(4):
                outs.append(serve.serve_lm(cfg, 8, decode="graph", seed=seed,
                                           **kw)["tokens"])
        except Exception as e:  # raised below, on the test's thread
            errors.append(e)

    x = torch.zeros(1 << 20, device=cuda)
    waits = 0
    t = threading.Thread(target=capture)
    t.start()
    while t.is_alive():
        x.add_(1)
        step_graph.synchronize(cuda)
        waits += 1
    t.join()
    assert not errors, errors
    assert waits > 0 and len(outs) == 4
    for seed, got in enumerate(outs):
        assert got == serve.serve_lm(cfg, 8, decode="eager", seed=seed,
                                     **kw)["tokens"]
