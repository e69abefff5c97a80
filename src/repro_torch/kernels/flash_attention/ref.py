"""Plain PyTorch version of blocked attention: the materialised-score
softmax of ``repro.kernels.flash_attention.ref``."""
from __future__ import annotations

import torch


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B,H,S,D]; k,v: [B,Hkv,S,D] (Hkv divides H) -> [B,H,S,D].

    The scores are taken in q's dtype and widened to f32, as the reference's
    einsum does; the f32 score tensor is updated in place, so the peak is
    one [B,H,S,S] f32 tensor beside the product it came from.
    """
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    scale = 1.0 / (d ** 0.5)
    scores = (q @ k.transpose(-1, -2)).float().mul_(scale)
    qi = torch.arange(s, device=q.device)[:, None]
    kj = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= kj
    if window > 0:
        mask &= (qi - kj) < window
    scores.masked_fill_(~mask, float("-inf"))
    p = _softmax_(scores)
    return (p @ v.float()).to(q.dtype)


def _softmax_(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis that keeps a fully masked (all -inf) row
    at 0 instead of nan; overwrites ``x``."""
    m = x.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = x.sub_(m).exp_()  # exp(-inf) = 0: masked scores drop out
    z = e.sum(dim=-1, keepdim=True)
    return e.div_(torch.where(z == 0.0, torch.ones_like(z), z))
