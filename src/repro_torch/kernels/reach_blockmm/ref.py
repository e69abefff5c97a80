"""Plain PyTorch version of the boolean-semiring mat-mul."""
from __future__ import annotations

import torch


def bool_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: bool[M,K], b: bool[K,N] -> bool[M,N] over (or, and).  The float32
    counts are exact below 2^24, so the threshold is exact."""
    return (a.float() @ b.float()) > 0.0
