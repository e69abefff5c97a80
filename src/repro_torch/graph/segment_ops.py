"""Segment reductions, scatters and the embedding bag, as in
``repro.graph.segment_ops``: the message-passing substrate of the GNNs,
MIND's serving path and the embedding bag.

Segment ids outside ``[0, num_segments)`` are dropped, as JAX's
``segment_*`` drop them: they land in a junk segment that is sliced off.
A gather by segment id (``segment_softmax``, ``coo_spmm``) reads as
``jnp.take`` does: a negative id wraps once, an id past the end reads
NaN.  ``scatter_or`` indexes as ``x.at[i]``: a negative id wraps once, an
id past the end is dropped.  The sums run through ``index_add`` (atomics,
in no fixed order, on the card); every float function has a second
derivative, as force training needs one.

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


def _segment_ids(segment_ids, num_segments: int) -> torch.Tensor:
    """int64 ids with every id outside [0, num_segments) sent to the junk
    segment ``num_segments``."""
    ids = segment_ids.long()
    return torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)


def _extreme(dtype, low: bool):
    """The identity of max (``low``) or min in ``dtype``: what JAX gives
    an empty segment."""
    if dtype == torch.bool:
        return not low
    if dtype.is_floating_point:
        return float("-inf") if low else float("inf")
    info = torch.iinfo(dtype)
    return info.min if low else info.max


def _segment_reduce(data, segment_ids, num_segments: int, reduce: str):
    ids = _segment_ids(segment_ids, num_segments)
    init = _extreme(data.dtype, reduce == "amax")
    out = torch.full((num_segments + 1,) + tuple(data.shape[1:]), init,
                     dtype=data.dtype, device=data.device)
    idx = ids.view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    out = out.scatter_reduce(0, idx, data, reduce=reduce, include_self=True)
    return out[:num_segments]


def segment_sum(data, segment_ids, num_segments: int) -> torch.Tensor:
    ids = _segment_ids(segment_ids, num_segments)
    out = torch.zeros((num_segments + 1,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add(0, ids, data)[:num_segments]


def segment_max(data, segment_ids, num_segments: int) -> torch.Tensor:
    """An empty segment is -inf (float data) or the dtype's least value,
    as in JAX."""
    return _segment_reduce(data, segment_ids, num_segments, "amax")


def segment_min(data, segment_ids, num_segments: int) -> torch.Tensor:
    """An empty segment is +inf (float data) or the dtype's greatest
    value, as in JAX."""
    return _segment_reduce(data, segment_ids, num_segments, "amin")


def _per_row(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """[S] -> [S, 1, ...] broadcasting against ``ndim``-d data."""
    return v.reshape((-1,) + (1,) * (ndim - 1))


def segment_mean(data, segment_ids, num_segments: int, eps: float = 1e-9
                 ) -> torch.Tensor:
    """The mean of each segment; an empty one divides 0 by ``eps``."""
    tot = segment_sum(data, segment_ids, num_segments)
    cnt = segment_sum(torch.ones(data.shape[:1], dtype=data.dtype,
                                 device=data.device),
                      segment_ids, num_segments)
    return tot / _per_row(cnt.clamp_min(eps), data.dim())


def segment_std(data, segment_ids, num_segments: int, eps: float = 1e-5
                ) -> torch.Tensor:
    """Per-segment standard deviation (PNA-style aggregator)."""
    mean = segment_mean(data, segment_ids, num_segments)
    sq = segment_mean(data * data, segment_ids, num_segments)
    var = (sq - mean * mean).clamp_min(0.0)
    return torch.sqrt(var + eps)


def _take(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(x, ids, axis=0)`` for float ``x``: a negative id wraps
    once, an id outside the range reads a NaN row."""
    n = x.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + n, ids)
    ok = (ids >= 0) & (ids < n)
    rows = x[torch.where(ok, ids, 0)] if n else \
        x.new_zeros((ids.shape[0],) + tuple(x.shape[1:]))
    return torch.where(_per_row(ok, rows.dim()), rows, float("nan"))


def segment_softmax(logits, segment_ids, num_segments: int) -> torch.Tensor:
    """Numerically stable softmax within each segment (GAT edge softmax);
    the denominator is floored at 1e-30."""
    seg_max = segment_max(logits, segment_ids, num_segments)
    # an empty segment's -inf max is gathered by no in-range id
    ex = torch.exp(logits - _take(seg_max, segment_ids))
    denom = _take(segment_sum(ex, segment_ids, num_segments), segment_ids)
    return ex / denom.clamp_min(1e-30)


def segment_normalize(data, segment_ids, num_segments: int,
                      eps: float = 1e-9) -> torch.Tensor:
    """L2-normalize each segment's vector sum (capsule squash helper)."""
    s = segment_sum(data, segment_ids, num_segments)
    n = torch.linalg.vector_norm(s, dim=-1, keepdim=True)
    return s / n.clamp_min(eps)


def scatter_or(dst_bool, index, src_bool) -> torch.Tensor:
    """``dst[index] |= src`` for boolean tensors (frontier push), indexed
    as JAX's ``x.at[index]``."""
    n = dst_bool.shape[0]
    ids = index.long()
    ids = torch.where(ids < 0, ids + n, ids)
    return dst_bool | segment_max(src_bool.to(torch.uint8), ids, n).bool()


def coo_spmm(src, dst, edge_val, x, num_nodes: int) -> torch.Tensor:
    """y = A @ x with A given as COO (src -> dst messages):
    y[d] = sum over edges e with dst[e] = d of edge_val[e] * x[src[e]].
    ``edge_val`` is None (unweighted adjacency) or float[E]."""
    msg = _take(x, src)
    if edge_val is not None:
        msg = msg * _per_row(edge_val, x.dim())
    return segment_sum(msg, dst, num_nodes)


def degree(dst, num_nodes: int, dtype=torch.float32) -> torch.Tensor:
    return segment_sum(torch.ones(dst.shape, dtype=dtype, device=dst.device),
                       dst, num_nodes)


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
