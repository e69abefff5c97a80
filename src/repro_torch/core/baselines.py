"""The paper's §7 baselines, as in ``repro.core.baselines``.

paper                            here
-----                            ----
Sequential (1 thread, no locks)  ``sequential_apply``: one op at a time,
                                  each with its own localized repair -- the
                                  dynamic algorithm without intra-batch
                                  parallelism.
Coarse-grained (one global lock) ``coarse_apply``: one op at a time, every
                                  op followed by a full static recompute --
                                  global mutual exclusion exploits no
                                  locality.
SMSCC (n threads, fine locks)    ``dynamic.apply_batch``: B lanes a step,
                                  one unified localized repair.

The reference scans over one-op slices inside one compiled call; here each
is a host loop over the port's own ``dynamic.apply_batch`` (B = 1) and
``dynamic.recompute``, with the same results bit for bit.  Each returns
(state, ok: bool[B]).
"""
from __future__ import annotations

import torch

from repro_torch.core import dynamic
from repro_torch.core import graph_state as gs


def _slice_ops(ops: dynamic.OpBatch, i: int) -> dynamic.OpBatch:
    return dynamic.OpBatch(kind=ops.kind[i:i + 1], u=ops.u[i:i + 1],
                           v=ops.v[i:i + 1])


def _one_at_a_time(state: gs.GraphState, ops: dynamic.OpBatch,
                   cfg: gs.GraphConfig, recompute: bool):
    oks = []
    for i in range(ops.kind.shape[0]):
        state, ok = dynamic.apply_batch(state, _slice_ops(ops, i), cfg)
        if recompute:
            state = dynamic.recompute(state, cfg)
        oks.append(ok)
    ok = (torch.cat(oks) if oks else
          torch.zeros(0, dtype=torch.bool, device=state.device))
    return state, ok


def sequential_apply(state: gs.GraphState, ops: dynamic.OpBatch,
                     cfg: gs.GraphConfig):
    """Apply ops one at a time (localized repair per op)."""
    return _one_at_a_time(state, ops, cfg, recompute=False)


def coarse_apply(state: gs.GraphState, ops: dynamic.OpBatch,
                 cfg: gs.GraphConfig):
    """Apply ops one at a time with a FULL static recompute per op: the
    structural change through the batch machinery (B = 1), then the
    locality thrown away, as a global lock + from-scratch algorithm
    would."""
    return _one_at_a_time(state, ops, cfg, recompute=True)


def static_per_batch_apply(state: gs.GraphState, ops: dynamic.OpBatch,
                           cfg: gs.GraphConfig):
    """Ablation: the batched structural apply, then a full recompute over
    the localized labels (no locality)."""
    state, ok = dynamic.apply_batch(state, ops, cfg)
    return dynamic.recompute(state, cfg), ok
