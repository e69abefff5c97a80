"""Shared model primitives: RMSNorm, RoPE, initialisers and the plain
MLP, as in ``repro.models.common``.  Initialisers draw from an explicit
``torch.Generator`` (its numbers differ from ``jax.random``'s; tests carry
one set of weights across with ``carry``)."""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.tree import tree_leaves


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


def mlp_init(gen: torch.Generator, sizes: Sequence[int], dtype=torch.float32,
             bias: bool = True, device=None) -> list:
    """Plain MLP params: a list of {'w', 'b'} between consecutive sizes
    (``b`` zeros, or None without ``bias``)."""
    return [{"w": dense_init(gen, (a, b), dtype=dtype, device=device),
             "b": torch.zeros((b,), dtype=dtype, device=device)
             if bias else None}
            for a, b in zip(sizes[:-1], sizes[1:])]


def mlp_apply(layers, x: torch.Tensor, act: Callable = F.silu,
              final_act: Optional[Callable] = None) -> torch.Tensor:
    """``act`` between the layers, ``final_act`` (if any) after the
    last."""
    n = len(layers)
    for i, lyr in enumerate(layers):
        x = x @ lyr["w"]
        if lyr["b"] is not None:
            x = x + lyr["b"]
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def count_params(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))
