"""Plain PyTorch version of the embedding bag, computing what the TPU
kernel ``embedding_bag_counts`` and its wrapper compute: gather, weight,
mask and sum.

It does not follow the JAX package's own oracle
(``repro.graph.segment_ops.embedding_bag``), which gives nan for an id
>= V where the kernel adds nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

MODES = ("sum", "mean")


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not supported by the kernel path")


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, *,
                  mode: str = "sum",
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """table: [V, D]; ids: int[B, L], an id outside [0, V) adds nothing
    (-1 pads) -> f32[B, D] (f64 for an f64 table).  ``mean`` divides by
    the number of ids >= 0, at least 1."""
    check_mode(mode)
    dt = torch.promote_types(table.dtype, torch.float32)  # f32, or f64
    n_rows = table.shape[0]
    valid = (ids >= 0) & (ids < n_rows)
    rows = table.to(dt)[ids.clamp(0, max(n_rows - 1, 0)).long()]
    w = (torch.ones(ids.shape, dtype=dt, device=ids.device)
         if weights is None else weights.to(dt))
    w = torch.where(valid, w, torch.zeros_like(w))
    out = (rows * w[..., None]).sum(dim=1)
    if mode == "mean":
        out = out / (ids >= 0).sum(dim=1, keepdim=True).clamp_min(1).to(dt)
    return out
