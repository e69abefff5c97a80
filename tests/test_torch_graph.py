"""The port's graph substrate held to the JAX package's: segment ops,
batching, the CSR build and the fanout sampler, and the GNN data streams.

Inputs come from seeded numpy generators and cross into both packages as
numpy arrays.  Tolerances: exact for integer results (segment ops on ints,
the packer's and the CSR's arrays, the sampler fed JAX's draws, the
streams' integers) and for the streams' floats (the same numpy draws);
1e-6 for float segment ops (sums in another order).  Second derivatives of
the float ops are checked by ``gradgradcheck`` in f64.

The reference samples with ``jax.random.randint``, which torch cannot
reproduce: the port's sampler takes its draws from a ``torch.Generator``
or as tensors, and here it is fed the draws JAX makes from the same key.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import gradcheck, gradgradcheck

from repro.data import pipeline as jpipe
from repro.graph import batching as jbatch
from repro.graph import sampler as jsamp
from repro.graph import segment_ops as jso
from repro_torch.data import pipeline as tpipe
from repro_torch.graph import batching as tbatch
from repro_torch.graph import sampler as tsamp
from repro_torch.graph import segment_ops as tso

FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)
INT32_MAX = int(jnp.iinfo(jnp.int32).max)


def _ids(rng, e, n):
    """Segment ids in [-2, n + 2): some dropped on both sides."""
    return rng.integers(-2, n + 2, e).astype(np.int32)


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------- segment ops ---

@pytest.mark.parametrize("op", ["segment_sum", "segment_max", "segment_min",
                                "segment_mean", "segment_std",
                                "segment_normalize", "segment_softmax"])
@pytest.mark.parametrize("shape", [(40,), (40, 3), (40, 2, 3)])
def test_float_segment_ops_match_jax(op, shape):
    rng = np.random.default_rng(hash((op, shape)) % 2 ** 32)
    n = 7
    data = rng.normal(size=shape).astype(np.float32)
    ids = _ids(rng, shape[0], n)
    if op == "segment_softmax":
        ids = np.clip(ids, -1, n)  # -1 wraps, n reads NaN, as jnp.take
    want = getattr(jso, op)(jnp.asarray(data), jnp.asarray(ids), n)
    got = getattr(tso, op)(torch.from_numpy(data), torch.from_numpy(ids), n)
    np.testing.assert_allclose(got.numpy(), _np(want), **FLOAT_TOL)


@pytest.mark.parametrize("op", ["segment_sum", "segment_max",
                                "segment_min"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_integer_segment_ops_match_jax(op, dtype):
    rng = np.random.default_rng(3)
    n = 9  # more segments than ids reach: empty ones get JAX's fill
    data = rng.integers(-1000, 1000, (30, 2)).astype(dtype)
    ids = _ids(rng, 30, n)
    want = getattr(jso, op)(jnp.asarray(data), jnp.asarray(ids), n)
    got = getattr(tso, op)(torch.from_numpy(data), torch.from_numpy(ids), n)
    assert got.numpy().astype(np.int64).tolist() == \
        _np(want).astype(np.int64).tolist()


def test_scatter_or_coo_spmm_and_degree_match_jax():
    rng = np.random.default_rng(4)
    n, e = 11, 50
    dst_b = rng.random(n) < 0.3
    idx = rng.integers(-3, n + 3, e).astype(np.int32)  # wraps and drops
    src_b = rng.random(e) < 0.5
    want = jso.scatter_or(jnp.asarray(dst_b), jnp.asarray(idx),
                          jnp.asarray(src_b))
    got = tso.scatter_or(torch.from_numpy(dst_b), torch.from_numpy(idx),
                         torch.from_numpy(src_b))
    assert got.tolist() == _np(want).tolist()
    src = rng.integers(-1, n + 1, e).astype(np.int32)
    dst = _ids(rng, e, n)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    val = rng.normal(size=e).astype(np.float32)
    for v in (None, val):
        want = jso.coo_spmm(jnp.asarray(src), jnp.asarray(dst),
                            None if v is None else jnp.asarray(v),
                            jnp.asarray(x), n)
        got = tso.coo_spmm(torch.from_numpy(src), torch.from_numpy(dst),
                           None if v is None else torch.from_numpy(v),
                           torch.from_numpy(x), n)
        np.testing.assert_allclose(got.numpy(), _np(want), **FLOAT_TOL)
    np.testing.assert_array_equal(
        tso.degree(torch.from_numpy(dst), n).numpy(),
        _np(jso.degree(jnp.asarray(dst), n)))


def _grad_cases():
    g = torch.Generator().manual_seed(5)
    ids = torch.arange(24) % 6          # every segment holds 4 rows
    dropped = torch.where(torch.arange(24) % 5 == 0, -1, ids)
    dropped[3] = 9
    return {
        "sum": lambda x: tso.segment_sum(x, dropped, 6),
        "max": lambda x: tso.segment_max(x, ids, 6),
        "min": lambda x: tso.segment_min(x, ids, 6),
        "mean": lambda x: tso.segment_mean(x, dropped, 7),
        "std": lambda x: tso.segment_std(x, ids, 6),
        "softmax": lambda x: tso.segment_softmax(x, ids, 6),
        "normalize": lambda x: tso.segment_normalize(x, dropped, 6),
        "coo_spmm": lambda x: tso.coo_spmm(ids, ids.flip(0), x[:, 0],
                                           x[:6], 6),
    }, torch.randn(24, 3, dtype=torch.float64, generator=g)


@pytest.mark.parametrize("op", ["sum", "max", "min", "mean", "std",
                                "softmax", "normalize", "coo_spmm"])
def test_segment_ops_second_derivative(op):
    fns, x = _grad_cases()
    x.requires_grad_()
    assert gradcheck(fns[op], (x,))
    assert gradgradcheck(fns[op], (x,))


# ------------------------------------------------------------- batching ---

def _packed_equal(got, want):
    for k in ("src", "dst", "edge_mask", "node_mask", "graph_id"):
        g, w = getattr(got, k).numpy(), _np(getattr(want, k))
        assert g.dtype == w.dtype and np.array_equal(g, w), k
    assert (got.n_graphs, got.max_nodes) == (want.n_graphs, want.max_nodes)


@pytest.mark.parametrize("batch,n_nodes,n_edges,seed",
                         [(3, 5, 10, 0), (8, 30, 64, 7)])
def test_pack_dense_batch_matches_jax(batch, n_nodes, n_edges, seed):
    _packed_equal(tbatch.pack_dense_batch(batch, n_nodes, n_edges, seed,
                                          device="cpu"),
                  jbatch.pack_dense_batch(batch, n_nodes, n_edges, seed))


def test_pack_ragged_graphs_matches_jax():
    rng = np.random.default_rng(2)
    sizes = [(3, 4), (6, 9), (1, 0)]
    srcs = [rng.integers(0, n, e).astype(np.int32) for n, e in sizes]
    dsts = [rng.integers(0, n, e).astype(np.int32) for n, e in sizes]
    nodes = [n for n, _ in sizes]
    _packed_equal(tbatch.pack(srcs, dsts, nodes, 6, 9, device="cpu"),
                  jbatch.pack(srcs, dsts, nodes, 6, 9))
    with pytest.raises(ValueError):
        tbatch.pack(srcs, dsts, nodes, 5, 9, device="cpu")


# ------------------------------------------------------------- sampler ---

def _csr_equal(got, want):
    for k in ("indptr", "indices"):
        g, w = getattr(got, k).numpy(), _np(getattr(want, k))
        assert g.dtype == w.dtype == np.int32 and np.array_equal(g, w), k


def test_build_csr_matches_jax():
    rng = np.random.default_rng(6)
    n = 50  # many repeated sources: the sort must be stable
    src = rng.integers(0, n // 3, 400)
    dst = rng.integers(0, n, 400)
    _csr_equal(tsamp.build_csr(src, dst, n, device="cpu"),
               jsamp.build_csr(src, dst, n))
    _csr_equal(tsamp.build_csr(torch.from_numpy(src), torch.from_numpy(dst),
                               n, device="cpu"),
               jsamp.build_csr(src, dst, n))


@pytest.mark.parametrize("n,deg,seed", [(300, 5, 0), (1000, 12, 3)])
def test_make_synthetic_csr_matches_jax(n, deg, seed):
    _csr_equal(tsamp.make_synthetic_csr(n, deg, seed, device="cpu"),
               jsamp.make_synthetic_csr(n, deg, seed))


def _jax_draws(key, n_seeds, fanouts):
    """The draws the reference's sample_blocks makes from ``key``."""
    keys = jax.random.split(key, len(fanouts))
    draws, n = [], n_seeds
    for k, f in zip(keys, fanouts):
        draws.append(torch.from_numpy(np.asarray(
            jax.random.randint(k, (n, f), 0, INT32_MAX)).astype(np.int64)))
        n *= f
    return draws


@pytest.mark.parametrize("fanouts", [(3,), (4, 2), (2, 3, 2)])
def test_sample_blocks_fed_jax_draws_match_jax(fanouts):
    # isolated nodes (no out-edges) self-loop; node n-1 has none
    rng = np.random.default_rng(8)
    n = 60
    src = rng.integers(0, n - 10, 300)
    dst = rng.integers(0, n, 300)
    jcsr = jsamp.build_csr(src, dst, n)
    tcsr = tsamp.build_csr(src, dst, n, device="cpu")
    seeds = rng.integers(0, n, 12).astype(np.int32)
    seeds[:3] = [n - 1, n - 2, 0]
    key = jax.random.PRNGKey(11)
    want, want_in = jsamp.sample_blocks(jcsr, jnp.asarray(seeds),
                                        list(fanouts), key)
    got, got_in = tsamp.sample_blocks(tcsr, torch.from_numpy(seeds),
                                      fanouts,
                                      draws=_jax_draws(key, 12, fanouts))
    assert np.array_equal(got_in.numpy(), _np(want_in))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.n_dst == w.n_dst
        assert g.src.dtype == torch.int32 and g.dst_local.dtype == torch.int32
        assert np.array_equal(g.src.numpy(), _np(w.src))
        assert np.array_equal(g.dst_local.numpy(), _np(w.dst_local))


def test_sample_block_from_a_generator_is_seeded_and_in_range():
    csr = tsamp.make_synthetic_csr(200, 6, 1, device="cpu")
    seeds = torch.arange(0, 200, 7, dtype=torch.int32)
    runs = [tsamp.sample_blocks(csr, seeds, (5, 3),
                                generator=torch.Generator().manual_seed(4))
            for _ in range(2)]
    assert all(torch.equal(a.src, b.src) for a, b in zip(runs[0][0],
                                                         runs[1][0]))
    blk = runs[0][0][-1]  # the seeds' own block
    f = seeds.long().repeat_interleave(5)
    lo = csr.indptr[f].long()
    hi = csr.indptr[f + 1].long()
    nbr = blk.src.long()
    # each draw is a neighbor of its frontier node, or the node itself
    # where it has none
    assert all(int(n) in csr.indices[a:b].tolist() if b > a else n == s
               for n, s, a, b in zip(nbr, f, lo, hi))


# -------------------------------------------------------------- streams ---

def _dict_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = _np(w)
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


@pytest.mark.parametrize("step,seed", [(0, 0), (5, 3)])
def test_molecule_batch_matches_jax(step, seed):
    _dict_equal(tpipe.molecule_batch(4, 7, 12, 5, step, seed=seed,
                                     device="cpu"),
                jpipe.molecule_batch(4, 7, 12, 5, step, seed=seed))


def test_molecule_batch_shards_match_jax():
    info = (jpipe.ShardInfo(1, 2), tpipe.ShardInfo(1, 2))
    _dict_equal(tpipe.molecule_batch(4, 5, 9, 3, 2, info=info[1],
                                     device="cpu"),
                jpipe.molecule_batch(4, 5, 9, 3, 2, info=info[0]))


@pytest.mark.parametrize("seed", [0, 9])
def test_node_class_graph_matches_jax(seed):
    _dict_equal(tpipe.node_class_graph(120, 500, 8, 5, seed=seed,
                                       device="cpu"),
                jpipe.node_class_graph(120, 500, 8, 5, seed=seed))


@pytest.mark.parametrize("step,seed", [(0, 0), (3, 5)])
def test_sampled_block_batch_fed_jax_draws_matches_jax(step, seed):
    rng = np.random.default_rng(10)
    n, d = 400, 6
    csr = (jsamp.make_synthetic_csr(n, 8, 2),
           tsamp.make_synthetic_csr(n, 8, 2, device="cpu"))
    feats = rng.normal(size=(n, d)).astype(np.float32)
    labels = rng.integers(0, 5, n).astype(np.int32)
    fanouts, b = (4, 3), 16
    want = jpipe.sampled_block_batch(csr[0], jnp.asarray(feats),
                                     jnp.asarray(labels), b, fanouts, step,
                                     seed=seed)
    # the reference's key, from the same SeedSequence stream
    srng = np.random.default_rng(np.random.SeedSequence([seed, step, 0]))
    srng.integers(0, n, b)
    key = jax.random.PRNGKey(int(srng.integers(0, 2 ** 31)))
    got = tpipe.sampled_block_batch(csr[1], torch.from_numpy(feats),
                                    torch.from_numpy(labels), b, fanouts,
                                    step, seed=seed,
                                    draws=_jax_draws(key, b, fanouts))
    _dict_equal(got, want)
    own = tpipe.sampled_block_batch(csr[1], torch.from_numpy(feats),
                                    torch.from_numpy(labels), b, fanouts,
                                    step, seed=seed)
    assert {k: v.shape for k, v in own.items()} == \
        {k: v.shape for k, v in got.items()}
    for k in ("src", "dst", "edge_mask", "node_mask", "graph_id", "pos"):
        assert torch.equal(own[k], got[k]), k
