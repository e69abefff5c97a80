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
