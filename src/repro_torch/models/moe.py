"""Mixture-of-Experts FFN: top-k router + capacity-bounded dispatch, as in
``repro.models.moe``.

The reference has two dispatch strategies: ``einsum`` (GShard one-hot
dispatch and combine tensors [G, Tg, E, C], per group of T / n_groups
tokens) and ``sort`` (argsort slots by expert, one group).  Both compute
one function: each (token, slot) pair takes the next place in its
expert's queue, token-major, per group; a pair whose place is >= C is
dropped; the kept pairs run the SwiGLU expert FFN and come back weighted
by their renormalised router probability.  The port computes that
function by index for both: no [G, Tg, k, E, C] tensor is built (at a
4 x 4096-token prefill of moonshot-v1-16b-a3b it would be ~24 GB a
layer).  Tokens are gathered into an [E, G*C, D] buffer, the experts run
as batched ``torch.matmul``s, and the outputs are scatter-added back in
f32 and cast to x's dtype once.

Router: softmax-then-top-k, probabilities renormalised over the chosen k,
and the Switch load-balancing auxiliary loss, returned as the reference
returns it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.sharding import P, constrain
from repro_torch.models import common

DISPATCHES = ("einsum", "sort")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The reference's fields and defaults.  ``expert_spec`` is the
    reference's [E, G, C, D] constraint, applied here to the index
    dispatch's [E, G*C, D] buffer (E as given, the merged G*C axis on the
    G and C entries' axes).  ``disp_spec`` constrains the reference's
    one-hot [G, Tg, E, C] dispatch tensor, which the port never builds:
    it is accepted and constrains nothing (a declared departure)."""
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int                  # per-expert hidden
    n_shared_experts: int = 0  # DeepSeek/Moonlight-style always-on experts
    capacity_factor: float = 1.25
    dispatch: str = "einsum"   # 'einsum' | 'sort': one function, see above
    n_groups: int = 1          # GShard groups ('einsum' only, as the ref)
    disp_spec: Any = None
    expert_spec: Any = None

    def __post_init__(self):
        if self.dispatch not in DISPATCHES:
            raise ValueError(f"dispatch {self.dispatch!r} is not one of "
                             f"{DISPATCHES}")


Params = Dict[str, Any]


def init(cfg: MoEConfig, gen: torch.Generator, dtype=torch.float32,
         device=None) -> Params:
    """Random weights drawn from ``gen``: router [D, E], w_gate / w_up
    [E, D, F], w_down [E, F, D], and the shared experts' SwiGLU
    ([D, F * n_shared], [F * n_shared, D]) where there are any."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def dense(shape):
        return common.dense_init(gen, shape, dtype=dtype, device=device)

    p = {"router": dense((d, e)), "w_gate": dense((e, d, f)),
         "w_up": dense((e, d, f)), "w_down": dense((e, f, d))}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"w_gate": dense((d, fs)), "w_up": dense((d, fs)),
                       "w_down": dense((fs, d))}
    return p


def _capacity(t: int, cfg: MoEConfig) -> int:
    c = int(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(c, cfg.top_k)


def _router(params: Params, x: torch.Tensor, cfg: MoEConfig):
    """x: [T, D] -> (probs f32[T,E], top idx [T,k], top weight f32[T,k],
    aux loss f32[])."""
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch aux loss: E * mean(frac_tokens_e * frac_prob_e)
    onehot = F.one_hot(top_i, cfg.n_experts).float()
    frac_tok = onehot.sum(1).mean(0)
    frac_prob = probs.mean(0)
    aux = cfg.n_experts * (frac_tok * frac_prob).sum()
    return probs, top_i, top_w, aux


def _expert_ffn(params: Params, xe: torch.Tensor) -> torch.Tensor:
    """xe: [E, N, D] -> [E, N, D] (SwiGLU per expert, batched matmuls)."""
    g = torch.matmul(xe, params["w_gate"])
    u = torch.matmul(xe, params["w_up"])
    return torch.matmul(F.silu(g) * u, params["w_down"])


def _n_groups(t: int, cfg: MoEConfig) -> int:
    """The reference's group count: n_groups for ``einsum`` where it
    divides T, else one; ``sort`` always dispatches one group."""
    if cfg.dispatch == "einsum" and cfg.n_groups > 0 \
            and t % cfg.n_groups == 0:
        return cfg.n_groups
    return 1


def _buffer_spec(spec):
    """The reference's [E, G, C, D] ``expert_spec`` on the [E, G*C, D]
    buffer: the G and C entries' axes name the merged axis, G's first."""
    if spec is None:
        return None
    axes = tuple(a for entry in (spec[1], spec[2]) if entry is not None
                 for a in (entry if isinstance(entry, tuple) else (entry,)))
    merged = axes if len(axes) > 1 else (axes[0] if axes else None)
    return P(spec[0], merged, spec[3])


def _dispatch(params: Params, x: torch.Tensor, cfg: MoEConfig):
    """The routed experts by index.  x: [T, D] -> (y [T, D], aux)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    g = _n_groups(t, cfg)
    tg = t // g
    c = _capacity(tg, cfg)
    _, top_i, top_w, aux = _router(params, x, cfg)
    # each pair's place in its expert's queue, per group, token-major: its
    # rank in a stable sort by expert less the rank of its expert's first
    # pair.  (A cumsum of the one-hot [G, Tg*k, E] along the pairs, a
    # strided axis, took 33 ms a layer of moonshot's 4 x 4096 prefill on
    # an H100: scripts/profile_lm_torch.py.)
    flat_e = top_i.reshape(g, tg * k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    n_pairs = torch.zeros((g, e), dtype=torch.int64, device=x.device)
    n_pairs.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    first = torch.cumsum(n_pairs, dim=1) - n_pairs          # [G, E]
    rank = (torch.arange(tg * k, device=x.device)
            - first.gather(1, flat_e.gather(1, order)))
    pos = torch.empty_like(rank).scatter_(1, order, rank)   # [G, Tg*k]
    keep = (pos < c).reshape(-1)
    group = torch.arange(g, device=x.device)[:, None]
    row = (flat_e * (g * c) + group * c + pos).reshape(-1)  # [E, G, C]
    n_rows = e * g * c
    tok = torch.arange(t, device=x.device).repeat_interleave(k)
    # a dropped pair writes the junk row n_rows, sliced off
    xe = torch.zeros((n_rows + 1, d), dtype=x.dtype, device=x.device)
    xe[torch.where(keep, row, n_rows)] = x[tok]
    spec = _buffer_spec(cfg.expert_spec)
    ye = constrain(_expert_ffn(params, constrain(
        xe[:n_rows].view(e, g * c, d), spec)), spec).view(n_rows, d)
    # the reference weighs in x's dtype; its combine sums in one product.
    # A token's k pairs are rows tok*k .. tok*k+k-1: summed in that order
    # (an index_add_ on the card adds with atomics, in another order each
    # run, so two runs' bf16 outputs could differ)
    w = (top_w.reshape(-1) * keep).to(x.dtype).float()
    contrib = ye[torch.where(keep, row, 0)].float() * w[:, None]
    y = contrib.view(t, k, d).sum(1)
    return y.to(x.dtype), aux


def apply(params: Params, x: torch.Tensor, cfg: MoEConfig):
    """x: [T, D] -> (y [T, D], aux_loss f32[])."""
    y, aux = _dispatch(params, x, cfg)
    if cfg.n_shared_experts:
        sh = params["shared"]
        h = F.silu(x @ sh["w_gate"]) * (x @ sh["w_up"])
        y = y + h @ sh["w_down"]
    return y, aux
