"""Plain PyTorch version of the boolean-semiring mat-mul."""
from __future__ import annotations

import torch


def bool_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: bool[M,K], b: bool[K,N] -> bool[M,N] over (or, and).  The float32
    counts are exact below 2^24, so the threshold is exact."""
    return (a.float() @ b.float()) > 0.0


def frontier_step(adj: torch.Tensor, frontier: torch.Tensor) -> torch.Tensor:
    """F' = (Aᵀ F) ∨ F: one synchronous round of multi-source forward
    reachability; adj[i, j] = edge i -> j, frontier[v, s] = source s
    reached v."""
    return bool_matmul(adj.T, frontier) | frontier


def closure(adj: torch.Tensor) -> torch.Tensor:
    """Reflexive-transitive closure by squaring."""
    n = adj.shape[0]
    r = adj | torch.eye(n, dtype=torch.bool, device=adj.device)
    for _ in range(max(1, (n - 1).bit_length())):
        r = bool_matmul(r, r)
    return r
