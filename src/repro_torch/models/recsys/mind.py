"""MIND (Li et al., arXiv:1904.08030), as in ``repro.models.recsys.mind``:
behavior-sequence item embeddings -> B2I dynamic capsule routing into
``n_interests`` capsules, fused with the profile features' mean bag (the
embedding-bag kernel on a card, with a gradient) -> label-aware attention
and a sampled-softmax loss (training), or max-over-interests scoring of
candidates and top-k retrieval (serving).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.graph import segment_ops as so
from repro_torch.models import common

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MINDConfig:
    """The reference's fields and defaults; ``n_neg`` and ``pow_p`` are
    training's, and ``scan_unroll`` changes nothing (the routing rounds
    are a Python loop)."""
    name: str = "mind"
    n_items: int = 2 ** 21          # embedding rows
    embed_dim: int = 64
    seq_len: int = 50
    n_interests: int = 4
    capsule_iters: int = 3
    n_neg: int = 1024               # sampled-softmax negatives (training)
    profile_vocab: int = 8192
    profile_len: int = 8
    pow_p: float = 2.0              # label-aware attention (training)
    dtype: Any = torch.float32
    scan_unroll: bool = False


def init(cfg: MINDConfig, gen: torch.Generator, device=None) -> Params:
    """Random weights drawn from ``gen`` on ``device`` (the generator's)."""
    device = device if device is not None else gen.device
    d = cfg.embed_dim
    b_init = torch.randn((cfg.seq_len, cfg.n_interests), generator=gen,
                         dtype=torch.float32, device=device)
    return {
        "item_embed": common.embed_init(gen, (cfg.n_items, d),
                                        dtype=cfg.dtype, device=device),
        "profile_embed": common.embed_init(gen, (cfg.profile_vocab, d),
                                           dtype=cfg.dtype, device=device),
        # shared bilinear map S of B2I routing
        "S": common.dense_init(gen, (d, d), dtype=cfg.dtype, device=device),
        # fixed-at-init routing logit seed (breaks capsule symmetry)
        "b_init": b_init.to(cfg.dtype),
        # fuses the profile vector into each interest
        "proj": common.dense_init(gen, (2 * d, d), dtype=cfg.dtype,
                                  device=device),
    }


def _squash(v: torch.Tensor, dim: int = -1, eps: float = 1e-9
            ) -> torch.Tensor:
    n2 = (v * v).sum(dim=dim, keepdim=True)
    n = torch.sqrt(n2 + eps)
    return (n2 / (1.0 + n2)) * v / n


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] through ``F.embedding``, whose backward sums each row's
    gradients as segments of sorted ids, in parallel.  The backward of
    ``table[ids]`` gives each distinct id to one warp, and the padding
    clamped to row 0 makes one id of about half the behavior ids: at
    train_batch (65536 x 50) that kernel took 2.01 s of a step on an H100,
    this backward 0.03 s (``scripts/profile_train_torch.py --arch mind``,
    with and without ``--gather index``)."""
    return F.embedding(ids.long(), table)


def interests(params: Params, behavior: torch.Tensor, profile: torch.Tensor,
              cfg: MINDConfig) -> torch.Tensor:
    """behavior: int[B, L] (-1 pad); profile: int[B, P] (-1 pad) ->
    [B, K, D] interest capsules."""
    b, l = behavior.shape
    valid = behavior >= 0
    e = _rows(params["item_embed"], behavior.clamp_min(0))
    e = e * valid[..., None].to(cfg.dtype)              # [B, L, D]
    e_s = e @ params["S"]                                # routed votes
    logits = params["b_init"][None].expand(b, l, cfg.n_interests)
    neg = torch.tensor(-1e9, dtype=cfg.dtype, device=e.device)
    u = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(torch.where(valid[..., None], logits, neg),
                          dim=2)                         # over K
        z = torch.einsum("blk,bld->bkd", w, e_s)
        u = _squash(z)                                   # [B, K, D]
        logits = logits + torch.einsum("bkd,bld->blk", u, e_s)
    # fuse the profile bag (the embedding-bag kernel's mean mode)
    pvec = so.embedding_bag(params["profile_embed"], profile, mode="mean")
    pk = pvec[:, None, :].expand(u.shape)
    return torch.tanh(torch.cat([u, pk], -1) @ params["proj"])


def label_aware_user_vec(u: torch.Tensor, target_emb: torch.Tensor,
                         cfg: MINDConfig) -> torch.Tensor:
    """Label-aware attention (training): soft-select the interests u
    [B, K, D] by the target's embedding [B, D] -> [B, D]."""
    att = torch.einsum("bkd,bd->bk", u, target_emb)
    att = torch.softmax(att * cfg.pow_p, dim=-1)
    return torch.einsum("bk,bkd->bd", att, u)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: MINDConfig):
    """batch: behavior [B, L], profile [B, P], target [B], negatives [N]
    -> (sampled-softmax loss, {'ce', 'acc'}); ``acc`` is the share of users
    whose target outscores every negative (argmax == 0, first max wins)."""
    u = interests(params, batch["behavior"], batch["profile"], cfg)
    tgt = _rows(params["item_embed"], batch["target"])
    v = label_aware_user_vec(u, tgt, cfg)                # [B, D]
    neg = _rows(params["item_embed"], batch["negatives"])
    pos_logit = (v * tgt).sum(-1, keepdim=True)          # [B, 1]
    neg_logit = v @ neg.T                                # [B, N]
    logits = torch.cat([pos_logit, neg_logit], -1).float()
    loss = -torch.log_softmax(logits, -1)[:, 0].mean()
    acc = (logits.argmax(-1) == 0).float().mean()
    return loss, {"ce": loss, "acc": acc}


def serve_score(params: Params, batch: Dict[str, torch.Tensor],
                cfg: MINDConfig) -> torch.Tensor:
    """Max-over-interests dot with the candidates.  batch: behavior
    [B, L], profile [B, P], candidates [B, C] (or [1, C] with C ~ 10^6
    for retrieval) -> [B, C]."""
    u = interests(params, batch["behavior"], batch["profile"], cfg)
    cand = params["item_embed"][batch["candidates"].clamp_min(0).long()]
    scores = torch.einsum("bkd,bcd->bkc", u, cand)
    return scores.max(dim=1).values


def retrieve_topk(params: Params, batch: Dict[str, torch.Tensor],
                  cfg: MINDConfig, k: int = 100):
    """(scores [B, k], indices [B, k]) of the k best candidates, highest
    first; equal scores keep the lower index first, as ``lax.top_k``."""
    scores = serve_score(params, batch, cfg)
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]
