"""Plain PyTorch version of the frontier-expansion segment-min.

uint32 messages ride in int64 (torch has no uint32 min or shift), values
in ``[0, 2^32)``; ``SENTINEL`` is the min-semiring identity.
"""
from __future__ import annotations

import torch

SENTINEL = 0xFFFFFFFF


def frontier_min(dst: torch.Tensor, msg: torch.Tensor, nv: int
                 ) -> torch.Tensor:
    """out[f, v] = min(msg[f, e] : dst[e] == v), SENTINEL where no edge
    lands.  dst: int32[E] (entries outside ``[0, nv)`` are dropped, as the
    TPU kernel drops its -1 padding); msg: int64[F, E] -> int64[F, NV]."""
    f, e = msg.shape
    idx = torch.where((dst >= 0) & (dst < nv), dst.long(), nv)
    out = torch.full((f, nv + 1), SENTINEL, dtype=torch.int64,
                     device=msg.device)
    out.scatter_reduce_(1, idx.expand(f, e), msg, reduce="amin")
    return out[:, :nv].contiguous()
