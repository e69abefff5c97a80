"""A seeded SMSCC op stream whose steps take every repair branch.

Shared by ``test_torch_step_graph.py`` (the port against the JAX package
on the CPU) and ``test_torch_gpu.py`` (the step graph against the eager
step and the CPU on the card).  At :data:`NV` = 64 vertices with
``dense_capacity`` 8, ``region_vertex_capacity`` 16 and edge buckets (8,
64), the first steps are built so that, from all singletons, they run in
turn: the dense tier (a 5-cycle), the compact tier's 64-edge bucket (a
10-cycle, then a 9-cycle), its 8-edge bucket (an edge of the 9-cycle
removed: 9 vertices, 8 edges), the full tier (a 30-cycle closed in a
second batch) and the skip (an edge inside a class); seeded random batches
of every op kind follow.
"""
import numpy as np

NV = 64
B = 32
CONFIG = dict(n_vertices=NV, edge_capacity=512, max_probes=64,
              max_outer=NV + 1, max_inner=NV + 2, dense_capacity=8,
              region_vertex_capacity=16, region_edge_buckets=(8, 64))


def _batch(kind, u, v):
    k = np.full(B, 4, np.int32)  # NOP
    uu = np.zeros(B, np.int32)
    vv = np.zeros(B, np.int32)
    k[:len(kind)] = kind
    uu[:len(u)] = u
    vv[:len(v)] = v
    return k, uu, vv


def _ring(ids):
    ids = list(ids)
    return ids, ids[1:] + ids[:1]


def batches(seed: int = 0, n_random: int = 6):
    """[(kind, u, v)] int32 [B] arrays: the built steps, then
    ``n_random`` seeded batches."""
    out = []
    for lo, hi in ((0, 5), (10, 20), (20, 29)):
        u, v = _ring(range(lo, hi))
        out.append(_batch([0] * len(u), u, v))
    out.append(_batch([1], [28], [20]))
    u, v = _ring(range(30, 60))
    out.append(_batch([0] * 15, u[:15], v[:15]))
    out.append(_batch([0] * 15, u[15:], v[15:]))
    out.append(_batch([0], [0], [2]))
    rng = np.random.default_rng(seed)
    for _ in range(n_random):
        kind = rng.choice([0, 1, 2, 3, 4], B, p=[0.55, 0.2, 0.1, 0.1, 0.05])
        u = rng.integers(0, NV, B)
        v = rng.integers(0, NV, B)
        u[rng.random(B) < 0.03] = -1
        out.append((kind.astype(np.int32), u.astype(np.int32),
                    v.astype(np.int32)))
    return out
