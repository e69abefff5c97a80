"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test decides inside itself whether a card exists and
skips with a reason where there is none.  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerance is exact equality: the kernels compute integers and booleans.
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


def test_plain_impl_on_cuda_raises(cuda):
    a = torch.zeros((4, 4), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="plain version"):
        bops.bool_matmul(a, a, impl="xla")
    with pytest.raises(ValueError, match="dtype"):
        bops.bool_matmul(a.float(), a)


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
