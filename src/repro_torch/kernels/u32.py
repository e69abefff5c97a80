"""uint32 arithmetic on int64 tensors masked to 32 bits (torch has no
uint32 multiply or logical shift), shared by the edge table's hash and the
reachability rounds' priority hash."""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow:
    the product is split at 16 bits so no partial product exceeds 2^48."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & M32
