"""The paper's synthetic update workload: a copy of
``repro.launch.workload.op_stream`` (same numpy draws, so both packages
see the same stream for one seed).

Every batch is a pure function of (seed, step, shard): restart
determinism (a driver restart re-generates the identical stream),
shard-affinity (each shard seeds with its own (step, shard) pair), and
elasticity come for free.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ShardInfo", "op_stream"]


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    shard: int = 0
    n_shards: int = 1


def _rng(seed: int, step: int, shard: int = 0):
    return np.random.default_rng(
        np.random.SeedSequence([seed, step, shard]))


def op_stream(n_vertices: int, batch: int, step: int, add_frac: float,
              info: ShardInfo = ShardInfo(), seed: int = 0,
              include_vertex_ops: bool = True):
    """Paper workload generator: mixed Add/Remove (V+E) batches.

    add_frac = fraction of insert ops (paper Fig 4: 0.5 / 0.9 / 0.1).
    """
    from repro_torch.core import dynamic
    b_local = batch // info.n_shards
    rng = _rng(seed, step, info.shard)
    is_add = rng.random(b_local) < add_frac
    is_vertex = (rng.random(b_local) < 0.2) if include_vertex_ops \
        else np.zeros(b_local, bool)
    kind = np.where(is_add,
                    np.where(is_vertex, dynamic.ADD_VERTEX,
                             dynamic.ADD_EDGE),
                    np.where(is_vertex, dynamic.REM_VERTEX,
                             dynamic.REM_EDGE))
    u = rng.integers(0, n_vertices, b_local)
    v = rng.integers(0, n_vertices, b_local)
    return dynamic.make_ops(kind, u, v)
