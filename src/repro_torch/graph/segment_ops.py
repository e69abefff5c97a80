"""Segment reductions and the embedding bag, as in
``repro.graph.segment_ops``: the functions MIND's serving path and the
embedding bag need (sum and max; the GNN's wait for the GNN slice).

Segment ids outside ``[0, num_segments)`` are dropped, as JAX's
``segment_*`` drop them: they land in a junk segment that is sliced off.

``embedding_bag`` takes both of the reference's forms, ``[B, L]`` bags
padded with -1 and flat ``ids`` + ``offsets``, in every mode.  ``[B, L]``
bags in ``sum`` or ``mean`` mode (weighted or not) go through the
embedding-bag wrapper (``kernels/embedding_bag/ops.py``): the CUDA kernel
for CUDA tensors, its plain version for CPU ones.  The other forms are
plain torch, as the reference computes them with ``jnp.take`` +
``segment_*`` in no Pallas kernel (the kernel refuses ``max``, as the TPU
kernel does); there an id >= V reads a NaN row, as ``jnp.take`` does.  One
departure, the kernel's: an id >= V adds nothing to a ``[B, L]`` sum or
mean bag.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.embedding_bag import ops as bag_ops

MODES = ("sum", "mean", "max")


def _segment_reduce(data, segment_ids, num_segments: int, reduce: str,
                    init: float):
    ids = segment_ids.long()
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    out = torch.full((num_segments + 1,) + tuple(data.shape[1:]), init,
                     dtype=data.dtype, device=data.device)
    idx = ids.view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    out.scatter_reduce_(0, idx, data, reduce=reduce, include_self=True)
    return out[:num_segments]


def segment_sum(data, segment_ids, num_segments: int) -> torch.Tensor:
    return _segment_reduce(data, segment_ids, num_segments, "sum", 0.0)


def segment_max(data, segment_ids, num_segments: int) -> torch.Tensor:
    """An empty segment is -inf (float data), as in JAX."""
    return _segment_reduce(data, segment_ids, num_segments, "amax",
                           float("-inf"))


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  offsets: Optional[torch.Tensor] = None, *,
                  mode: str = "sum",
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather rows of ``table`` [V, D] and reduce them per bag -> [B, D].

    ``ids`` is int[B, L] (fixed-size bags, id < 0 masks), or int[N] flat
    ids with ``offsets`` int[B], the start of each bag (torch EmbeddingBag
    semantics: position n is in bag ``#(offsets <= n) - 1``).  ``mode`` is
    'sum', 'mean' (over the ids >= 0, at least 1) or 'max' (0 for a bag
    with no id); ``weights``, shaped as ``ids``, scale each row.
    """
    if mode not in MODES:
        raise ValueError(mode)
    if offsets is None and mode in bag_ops.ref.MODES:
        return bag_ops.embedding_bag(
            table, ids.to(torch.int32), mode=mode,
            weights=None if weights is None else weights.float())
    valid = ids >= 0
    n_rows = table.shape[0]
    rows = table[ids.clamp(0, n_rows - 1).long()]
    rows = torch.where((ids < n_rows)[..., None], rows, float("nan"))
    if weights is not None:
        rows = rows * weights[..., None]
    if offsets is None:  # [B, L] bags in max mode
        rows = torch.where(valid[..., None], rows, float("-inf"))
        out = rows.max(dim=1).values
        return torch.where(torch.isfinite(out), out, 0.0)
    b = offsets.shape[0]
    pos = torch.arange(ids.shape[0], device=ids.device)
    bag = (pos[:, None] >= offsets[None, :]).sum(1) - 1
    if mode == "max":
        rows = torch.where(valid[:, None], rows, float("-inf"))
        out = segment_max(rows, bag, b)
        return torch.where(torch.isfinite(out), out, 0.0)
    rows = torch.where(valid[:, None], rows, 0.0)
    out = segment_sum(rows, bag, b)
    if mode == "mean":
        cnt = segment_sum(valid.to(table.dtype), bag, b)
        out = out / cnt.clamp_min(1.0)[:, None]
    return out
