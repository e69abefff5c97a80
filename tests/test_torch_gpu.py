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

from repro_torch.core import graph_state as tgs
from repro_torch.core.service import SCCService
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
