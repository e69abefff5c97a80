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

:func:`lane_wave` is the same over tenant lanes: one wave of 3 lanes x 4
steps at :data:`LANE_CONFIG` whose lanes, from all singletons, take
different branches in the same steps (the skip, the dense tier, both
compact buckets and the full tier).  :class:`HostCond` stands in for a
step-graph capture on the CPU, so the steps' device-decided forms run
there too.
"""
import numpy as np

NV = 64
B = 32
CONFIG = dict(n_vertices=NV, edge_capacity=512, max_probes=64,
              max_outer=NV + 1, max_inner=NV + 2, dense_capacity=8,
              region_vertex_capacity=16, region_edge_buckets=(8, 64))


class HostCond:
    """A stand-in for a step-graph capture (``step_graph._Capture``) on
    the CPU: ``cond(pred, body)`` runs ``body`` where ``pred`` holds, as a
    replay of the IF node would."""

    def cond(self, pred, body):
        if bool(pred):
            body()


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


# test_torch_tenancy.py's "tiered" config: dense <= 2, compact <= 20
# vertices in edge buckets (8, 32), full beyond
LANE_CONFIG = dict(n_vertices=24, edge_capacity=64, max_probes=8,
                   max_outer=25, max_inner=26, dense_capacity=2,
                   region_vertex_capacity=20, region_edge_buckets=(8, 32))
LANE_B = 8


def _lane_batch(kind, u, v):
    k = np.full(LANE_B, 4, np.int32)  # NOP
    uu = np.zeros(LANE_B, np.int32)
    vv = np.zeros(LANE_B, np.int32)
    k[:len(kind)] = kind
    uu[:len(u)] = u
    vv[:len(v)] = v
    return k, uu, vv


def _edges(pairs):
    return _lane_batch([0] * len(pairs), [a for a, _ in pairs],
                       [b for _, b in pairs])


def _path(lo, hi):
    return [(i, i + 1) for i in range(lo, hi)]


def lane_wave():
    """(kind, u, v) int32 [3, 4, B]: lane 0 a 5-cycle (compact, bucket 8),
    an edge inside it (skip), a 6-cycle (bucket 8), an edge between two
    singletons (an empty region: dense); lane 1 a path 0..8 (bucket 8),
    closed into a 9-cycle (bucket 32), vertex 3 removed (bucket 8), then
    put back into the cycle (bucket 32); lane 2 a path 0..20 over three
    steps (bucket 8), closed into a 21-cycle (more vertices than the
    compact tier holds: full)."""
    lanes = [
        [_edges(list(zip(*_ring(range(5))))),
         _edges([(0, 2)]), _edges(list(zip(*_ring(range(5, 11))))),
         _edges([(21, 22)])],
        [_edges(_path(0, 8)), _edges([(8, 0)]),
         _lane_batch([3], [3], [0]),
         _lane_batch([2, 0, 0], [3, 2, 3], [0, 3, 4])],
        [_edges(_path(0, 8)), _edges(_path(8, 16)), _edges(_path(16, 20)),
         _edges([(20, 0)])]]
    return tuple(np.stack([np.stack([step[i] for step in lane])
                           for lane in lanes]) for i in range(3))
