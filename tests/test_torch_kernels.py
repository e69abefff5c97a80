"""The port's kernel wrappers, on CPU tensors (their plain versions), held
to the JAX package's kernel wrappers (the edge table's insert and remove
rounds, which the JAX package leaves to XLA, to ``repro.core.edge_table``).

Every input is made from a seeded numpy generator and handed to both
packages as numpy.  Tolerance is exact equality throughout: every value is
an integer or a boolean, and the boolean mat-mul's float32 counts are
exact below 2^24.  The JAX side runs under ``impl="xla"`` and, on tiny
shapes, under ``impl="pallas_interpret"`` (the Pallas kernel interpreted
on the CPU).  The CUDA kernels themselves run only on the card
(tests/test_torch_gpu.py and chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import edge_table as jet
from repro.kernels.frontier_expand import ops as jfops
from repro.kernels.hash_probe import ops as jhops
from repro.kernels.reach_blockmm import ops as jbops
from repro.core import reach as jreach
from repro_torch.core import edge_table as tet
from repro_torch.core import reach as treach
from repro_torch.kernels.frontier_expand import ops as tfops
from repro_torch.kernels.hash_probe import ops as thops
from repro_torch.kernels.reach_blockmm import ops as tbops

SENT = 0xFFFFFFFF
SEEDS = (0, 1, 2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------- frontier_min ---

def _frontier_case(seed, f, e, nv, *, pad=0, all_sent=False):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, nv, e).astype(np.int32)
    dst[e - pad:] = -1 if pad else dst[e - pad:]
    msg = rng.integers(0, 2 ** 32, (f, e), dtype=np.uint64)
    # a third of the lanes blocked, and ties on small values
    msg[rng.random((f, e)) < 0.33] = SENT
    msg[rng.random((f, e)) < 0.2] = rng.integers(0, 4)
    if all_sent:
        msg[:] = SENT
    return dst, msg


def _port_min(dst, msg, nv):
    return tfops.frontier_min(_t(dst), _t(msg.astype(np.int64)),
                              nv).numpy()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("f,e,nv", [(1, 300, 64), (4, 257, 129),
                                    (3, 64, 7), (1, 0, 16)])
def test_frontier_min_matches_xla(seed, f, e, nv):
    dst, msg = _frontier_case(seed, f, e, nv)
    want = jfops.frontier_min(jnp.asarray(dst), jnp.asarray(
        msg.astype(np.uint32)), nv, impl="xla")
    np.testing.assert_array_equal(_port_min(dst, msg, nv),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", ["f1", "f_many", "pad", "all_sent"])
def test_frontier_min_matches_pallas_interpret(seed, case):
    f = {"f1": 1, "f_many": 9}.get(case, 2)
    dst, msg = _frontier_case(seed, f, 200, 40,
                              pad=37 if case == "pad" else 0,
                              all_sent=case == "all_sent")
    want = jfops.frontier_min(jnp.asarray(dst), jnp.asarray(
        msg.astype(np.uint32)), 40, impl="pallas_interpret")
    np.testing.assert_array_equal(_port_min(dst, msg, 40),
                                  np.asarray(want).astype(np.int64))


def test_frontier_min_one_dim_message_squeezes():
    dst, msg = _frontier_case(5, 1, 50, 10)
    got = tfops.frontier_min(_t(dst), _t(msg[0].astype(np.int64)), 10)
    assert got.shape == (10,)
    np.testing.assert_array_equal(got.numpy(), _port_min(dst, msg, 10)[0])


# ------------------------------------------- frontier_gather (fused) ---
#
# The fused round against JAX's frontier_min applied to messages built
# exactly as src/repro/core/reach.py builds them.  The port returns uint32
# values as int32 words; ``_u32`` reads them back unsigned.

def _u32(words):
    return words.numpy().view(np.uint32)


def _jmin(dst, msg, nv, impl="xla"):
    return np.asarray(jfops.frontier_min(jnp.asarray(dst), msg, nv,
                                         impl=impl))


def _reach_graph(seed, e, nv):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, nv, e).astype(np.int32)
    dst = rng.integers(0, nv, e).astype(np.int32)
    return rng, src, dst, rng.random(e) < 0.7


def _gather(src, dst, live, val, nv, mode="min"):
    return tfops.frontier_gather(_t(src), _t(dst), _t(live), _t(val), nv,
                                 mode=mode)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("e,nv,impl", [(301, 64, "xla"), (200, 40,
                                       "pallas_interpret")])
def test_gather_boolean_round_matches_jax(seed, e, nv, impl):
    rng, src, dst, live = _reach_graph(seed, e, nv)
    reached = rng.random(nv) < 0.3
    msg = jnp.where(jnp.asarray(reached)[src] & jnp.asarray(live),
                    jreach.ZERO_U32, jreach.SENT)
    got = _gather(src, dst, live, treach._reached_val(_t(reached)), nv)
    np.testing.assert_array_equal(_u32(got), _jmin(dst, msg, nv, impl))


@pytest.mark.parametrize("seed", SEEDS)
def test_gather_fw_bw_pair_matches_jax(seed):
    rng, src, dst, live = _reach_graph(seed, 333, 70)
    reached = rng.random((2, 70)) < 0.2
    jr, jl = jnp.asarray(reached), jnp.asarray(live)
    msg_f = jnp.where(jr[0][src] & jl, jreach.ZERO_U32, jreach.SENT)
    msg_b = jnp.where(jr[1][dst] & jl, jreach.ZERO_U32, jreach.SENT)
    got = _gather(src, dst, live, treach._reached_val(_t(reached)), 70,
                  "pair")
    np.testing.assert_array_equal(_u32(got)[0], _jmin(dst, msg_f, 70))
    np.testing.assert_array_equal(_u32(got)[1], _jmin(src, msg_b, 70))


@pytest.mark.parametrize("seed", SEEDS)
def test_gather_label_round_matches_jax(seed):
    rng, src, dst, live = _reach_graph(seed, 257, 50)
    lab = np.where(rng.random(50) < 0.8, rng.integers(0, 2 ** 31 - 1, 50),
                   2 ** 31 - 1).astype(np.int32)
    allowed = rng.random(50) < 0.8
    msg = jnp.where(jnp.asarray(live) & jnp.asarray(allowed)[src],
                    jnp.asarray(lab)[src].astype(jnp.uint32), jreach.SENT)
    val = torch.where(_t(allowed), _t(lab), tfops.SENT_WORD)
    np.testing.assert_array_equal(_u32(_gather(src, dst, live, val, 50)),
                                  _jmin(dst, msg, 50))


@pytest.mark.parametrize("seed", SEEDS)
def test_gather_priority_round_matches_jax(seed):
    """Priorities use all 32 bits: about half are >= 2^31, whose words are
    negative, so a signed compare anywhere would pick them wrongly."""
    rng, src, dst, live = _reach_graph(seed, 400, 64)
    lab = rng.integers(0, 2 ** 32, 64, dtype=np.uint64).astype(np.uint32)
    active = rng.random(64) < 0.9
    assert (lab >= 2 ** 31).any() and (lab < 2 ** 31).any()
    msg = jnp.where(jnp.asarray(live) & jnp.asarray(active)[src],
                    jnp.asarray(lab)[src], jreach.PRIO_SENT)
    val = torch.where(_t(active), _t(lab.view(np.int32)), tfops.SENT_WORD)
    np.testing.assert_array_equal(_u32(_gather(src, dst, live, val, 64)),
                                  _jmin(dst, msg, 64))


@pytest.mark.parametrize("q", [1, 31, 32, 33, 64])
def test_gather_packed_reachable_round_matches_jax(q):
    rng, src, dst, live = _reach_graph(q, 500, 90)
    reached = rng.random((q, 90)) < 0.1
    msg = jnp.where(jnp.asarray(reached)[:, src] & jnp.asarray(live)[None],
                    jreach.ZERO_U32, jreach.SENT)
    bits = tfops.pack_bits(_t(reached))
    assert bits.shape == (-(-q // 32), 90) and bits.dtype == torch.int32
    np.testing.assert_array_equal(tfops.unpack_bits(bits, q).numpy(),
                                  reached)
    got = tfops.unpack_bits(_gather(src, dst, live, bits, 90, "or"), q)
    np.testing.assert_array_equal(got.numpy(), _jmin(dst, msg, 90) == 0)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", ["junk", "all_dead", "ragged"])
def test_gather_drops_junk_edges_like_jax(seed, case):
    """src and dst hold -1 padding and ids past the end: an edge whose
    src is outside [0, n_src) carries SENTINEL (built here in numpy), and
    JAX's kernel drops a dst outside [0, nv).  (Its ``xla`` oracle would
    wrap a dst of -1 to nv - 1, which JAX's reach never meets: it sends
    SENTINEL from every junk slot.)"""
    rng = np.random.default_rng(seed)
    e, n_src, nv = {"ragged": (1, 9, 9)}.get(case, (229, 31, 23))
    src = rng.integers(-1, n_src + 3, e).astype(np.int32)
    dst = rng.integers(-1, nv + 3, e).astype(np.int32)
    live = rng.random(e) < (0.0 if case == "all_dead" else 0.8)
    val = rng.integers(0, 2 ** 32, (2, n_src), dtype=np.uint64).astype(
        np.uint32)
    ok = live & (src >= 0) & (src < n_src)
    msg = np.where(ok, val[:, np.clip(src, 0, n_src - 1)], SENT).astype(
        np.uint32)
    np.testing.assert_array_equal(
        _u32(_gather(src, dst, live, val.view(np.int32), nv)),
        _jmin(dst, jnp.asarray(msg), nv, "pallas_interpret"))
    bits = tfops.unpack_bits(_gather(src, dst, live, val.view(np.int32),
                                     nv, "or"), 64)
    np.testing.assert_array_equal(
        bits.numpy(), _jmin(dst, jnp.asarray(np.where(
            tfops.unpack_bits(_t(val.view(np.int32)), 64).numpy()[
                :, np.clip(src, 0, n_src - 1)] & ok, 0, SENT).astype(
                    np.uint32)), nv, "pallas_interpret") == 0)


def test_gather_bad_mode_and_pair_shape_raise():
    _, src, dst, live = _reach_graph(0, 10, 5)
    val = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown mode"):
        _gather(src, dst, live, val, 5, "max")
    with pytest.raises(ValueError, match="pair mode"):
        _gather(src, dst, live, val, 5, "pair")


# ---------------------------------------------------------- hash_probe ---

def _probe_case(seed, cap, b, *, tomb_frac=0.3, fill=0.5):
    """A table with LIVE / TOMB / EMPTY slots (TOMB runs make chains that
    continue past deleted slots) and query lanes: half present keys, half
    random keys (some negative), bases anywhere including near the wrap."""
    rng = np.random.default_rng(seed)
    st = np.zeros(cap, np.int8)
    occupied = rng.random(cap) < fill
    st[occupied] = np.where(rng.random(occupied.sum()) < tomb_frac, 2, 1)
    src = rng.integers(-2, 6, cap).astype(np.int32)
    dst = rng.integers(-2, 6, cap).astype(np.int32)
    pick = rng.integers(0, cap, b)
    u = np.where(rng.random(b) < 0.5, src[pick],
                 rng.integers(-3, 6, b)).astype(np.int32)
    v = np.where(rng.random(b) < 0.5, dst[pick],
                 rng.integers(-3, 6, b)).astype(np.int32)
    base = np.where(rng.random(b) < 0.5, pick,
                    cap - 1 - rng.integers(0, 3, b)).astype(np.int32)
    return src, dst, st, base, u, v


def _port_probe(src, dst, st, base, u, v, max_probes):
    found, slot = thops.probe(_t(src), _t(dst), _t(st), _t(base), _t(u),
                              _t(v), max_probes=max_probes)
    return found.numpy(), slot.numpy()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cap,b,max_probes,fill",
                         [(256, 64, 16, 0.5), (256, 64, 300, 0.9),
                          (1024, 37, 64, 0.7), (16, 8, 40, 1.0)])
def test_probe_matches_xla(seed, cap, b, max_probes, fill):
    args = _probe_case(seed, cap, b, fill=fill)
    want = jhops.probe(*map(jnp.asarray, args), max_probes=max_probes,
                       impl="xla")
    got = _port_probe(*args, max_probes)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("max_probes", [8, 70])
def test_probe_matches_pallas_interpret(seed, max_probes):
    # max_probes 70 > C 64: the walk wraps and revisits slots
    args = _probe_case(seed, 64, 16, fill=0.8)
    want = jhops.probe(*map(jnp.asarray, args), max_probes=max_probes,
                       impl="pallas_interpret")
    got = _port_probe(*args, max_probes)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))


# (cap, b, max_probes, fill, case): the insert's and remove's plain
# versions (the rounds the CUDA kernels reproduce) on random tables with
# LIVE / TOMB / EMPTY slots, against repro.core.edge_table
_TABLE_CASES = [(256, 64, 16, 0.5, "mixed"), (256, 80, 1, 0.6, "mixed"),
                (64, 40, 70, 0.8, "mixed"), (16, 20, 5, 0.9, "mixed"),
                (8, 12, 40, 0.5, "mixed"), (128, 0, 8, 0.5, "empty_batch"),
                (128, 50, 8, 0.5, "all_disabled"),
                (128, 60, 8, 0.5, "negative_keys")]
_jinsert = jax.jit(jet.insert, static_argnames="max_probes")
_jremove = jax.jit(jet.remove, static_argnames="max_probes")


def _table_case(seed, cap, b, fill, case):
    src, dst, st, _, u, v = _probe_case(seed, cap, b, fill=fill)
    rng = np.random.default_rng(seed + 100)
    if case == "negative_keys":
        u, v, src, dst = (-np.abs(x) - 1 for x in (u, v, src, dst))
    en = (rng.random(b) < 0.8) & (case != "all_disabled")
    return src, dst, st, u.astype(np.int32), v.astype(np.int32), en


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cap,b,max_probes,fill,case", _TABLE_CASES)
def test_insert_rounds_match_jax(seed, cap, b, max_probes, fill, case):
    src, dst, st, u, v, en = _table_case(seed, cap, b, fill, case)
    if b:
        jt, jins, jfail = _jinsert(
            jet.EdgeTable(*map(jnp.asarray, (src, dst, st))), jnp.asarray(u),
            jnp.asarray(v), max_probes=max_probes, enable=jnp.asarray(en))
    else:  # JAX's dedupe scan refuses zero lanes; zero lanes change nothing
        jt, jins, jfail = (src, dst, st), en, en
    cols = [_t(x).clone() for x in (src, dst, st)]
    ten = _t(en) & ~tet._dedupe(_t(u), _t(v), _t(en))
    placed, failed, rounds = thops.insert(*cols, _t(u), _t(v), ten,
                                          max_probes=max_probes)
    for got, want in zip(cols, jt):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(placed.numpy(), np.asarray(jins))
    np.testing.assert_array_equal(failed.numpy(), np.asarray(jfail))
    assert rounds.dtype == torch.int32 and 0 <= int(rounds) <= max_probes


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cap,b,max_probes,fill,case", _TABLE_CASES)
def test_remove_matches_jax(seed, cap, b, max_probes, fill, case):
    src, dst, st, u, v, en = _table_case(seed, cap, b, fill, case)
    u[b // 2:], v[b // 2:] = u[: b - b // 2], v[: b - b // 2]  # duplicates
    jt, jrem = _jremove(jet.EdgeTable(*map(jnp.asarray, (src, dst, st))),
                        jnp.asarray(u), jnp.asarray(v),
                        max_probes=max_probes, enable=jnp.asarray(en))
    state = _t(st).clone()
    removed = thops.remove(_t(src), _t(dst), state, _t(u), _t(v), _t(en),
                           max_probes=max_probes)
    np.testing.assert_array_equal(state.numpy(), np.asarray(jt.state))
    np.testing.assert_array_equal(removed.numpy(), np.asarray(jrem))


# --------------------------------------------------------- bool_matmul ---

def _bool_case(seed, m, k, n, density):
    rng = np.random.default_rng(seed)
    return rng.random((m, k)) < density, rng.random((k, n)) < density


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("m,k,n,density", [(50, 50, 50, 0.05),
                                           (130, 70, 9, 0.02),
                                           (1, 200, 3, 0.5)])
def test_bool_matmul_matches_xla(seed, m, k, n, density):
    a, b = _bool_case(seed, m, k, n, density)
    want = jbops.bool_matmul(jnp.asarray(a), jnp.asarray(b), impl="xla")
    got = tbops.bool_matmul(_t(a), _t(b))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,k,n", [(40, 70, 24), (3, 33, 130)])
def test_bool_matmul_dense_matches_pallas_interpret(m, k, n):
    """Density 1.0: every count is K (not a multiple of 32, the int8 mma's
    depth), which the card's s32 counts must keep exact too."""
    a, b = _bool_case(0, m, k, n, 1.0)
    want = jbops.bool_matmul(jnp.asarray(a), jnp.asarray(b),
                             impl="pallas_interpret")
    np.testing.assert_array_equal(tbops.bool_matmul(_t(a), _t(b)).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS)
def test_bool_matmul_matches_pallas_interpret(seed):
    a, b = _bool_case(seed, 33, 40, 20, 0.1)
    want = jbops.bool_matmul(jnp.asarray(a), jnp.asarray(b),
                             impl="pallas_interpret")
    np.testing.assert_array_equal(tbops.bool_matmul(_t(a), _t(b)).numpy(),
                                  np.asarray(want))
