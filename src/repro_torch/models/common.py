"""Shared model primitives: RMSNorm, RoPE and initialisers, as in
``repro.models.common``.  Initialisers draw from an explicit
``torch.Generator`` (its numbers differ from ``jax.random``'s; tests carry
one set of weights across with ``carry``)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm with a ``1 + weight`` gain, computed in f32 and returned in
    x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + weight.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
         ) -> torch.Tensor:
    """Rotary embedding, angles in f32.  x: [..., S, D] with D even;
    positions: [..., S] broadcasting against x's leading dims."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freq
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense_init(gen: torch.Generator, shape: Sequence[int],
               scale: Optional[float] = None, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Normal(0, 1/fan_in) by default; fan_in is the second-last dim."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / (fan_in ** 0.5)
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return w.mul_(scale).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int],
               dtype=torch.float32, device=None) -> torch.Tensor:
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return w.mul_(shape[-1] ** -0.5).to(dtype)
