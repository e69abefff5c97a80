"""AdamW + schedules + global-norm clipping on the port's param trees, as
``repro.optim.optimizer``.

The moments m and v are f32 whatever the parameter's dtype, and the update
is computed in f32 and cast to the parameter's dtype: the reference's
formulas, bias correction by ``count`` and weight decay decoupled inside
``lr * (step + wd * p)``.  ``torch.optim.AdamW`` is not a stand-in: it
keeps its moments in the parameter's dtype.

Where the reference returns new params and state from a jitted step whose
buffers are donated, ``update`` writes the params and moments in place
under ``torch.no_grad()`` and returns them.  ``count``, the learning rate
and the norm stay 0-d tensors on the params' device, so a step reads
nothing back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # 'cosine' | 'linear' | 'const'
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    m: Any                # f32 tree shaped as the params
    v: Any                # f32 tree shaped as the params
    count: torch.Tensor   # int32[], updates taken


def init(params) -> OptState:
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)
    device = tree_leaves(params)[0].device
    return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                    count=torch.zeros((), dtype=torch.int32, device=device))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """f32[] learning rate at ``step``: linear warm-up, then cosine or
    linear decay to ``min_lr_frac`` of ``lr`` at ``total_steps``."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * \
            0.5 * (1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_frac) * frac
    else:
        decay = 1.0
    return cfg.lr * warm * decay


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so their global norm is at most ``max_norm``, in their
    own dtypes, the norm before scaling)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), norm


@torch.no_grad()
def update(grads, state: OptState, params, cfg: AdamWConfig):
    """One AdamW step after clipping by the global norm: (params, state,
    {'grad_norm', 'lr'}), with the params and the moments written in
    place.  Leaf by leaf, so the f32 temporaries of one leaf are the only
    memory it adds (at qwen3-14b's width the embedding's are 3.1 GB
    each)."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    count = state.count + 1
    lr = schedule(cfg, count)
    b1, b2, wd = cfg.b1, cfg.b2, cfg.weight_decay
    c = count.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, device=c.device), c)
    bc2 = 1 - torch.pow(torch.tensor(b2, device=c.device), c)
    for m, v, g, p in zip(tree_leaves(state.m), tree_leaves(state.v),
                          tree_leaves(grads), tree_leaves(params)):
        g32 = (g * scale).to(g.dtype).float()
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_(((1 - b2) * g32).mul_(g32))
        del g32
        step_ = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        p32 = p.float()
        step_.add_(wd * p32).mul_(lr)
        p.copy_(p32 - step_)
    return params, OptState(state.m, state.v, count), {
        "grad_norm": gnorm, "lr": lr}
