"""The port's kernel wrappers, on CPU tensors (their plain versions), held
to the JAX package's kernel wrappers.

Every input is made from a seeded numpy generator and handed to both
packages as numpy.  Tolerance is exact equality throughout: every value is
an integer or a boolean, and the boolean mat-mul's float32 counts are
exact below 2^24.  The JAX side runs under ``impl="xla"`` and, on tiny
shapes, under ``impl="pallas_interpret"`` (the Pallas kernel interpreted
on the CPU).  The CUDA kernels themselves run only on the card
(tests/test_torch_gpu.py and chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.frontier_expand import ops as jfops
from repro.kernels.hash_probe import ops as jhops
from repro.kernels.reach_blockmm import ops as jbops
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
