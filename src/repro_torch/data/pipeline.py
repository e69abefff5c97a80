"""Deterministic, shard-aware synthetic data streams, as in
``repro.data.pipeline``: the LM and recsys streams (the GNN streams wait
for the GNN slice).

Every source is a pure function of (seed, step, shard) -- no files, no
state -- drawn from numpy's ``SeedSequence([seed, step, shard])``, the
reference's own streams, so a batch holds the reference's integers
exactly.  A checkpoint stores only the step cursor: resuming re-generates
the identical batch sequence.  Batches are int32 tensors on ``device``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.graph_state import DEFAULT_DEVICE


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    shard: int = 0
    n_shards: int = 1


def _rng(seed: int, step: int, shard: int = 0) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, step, shard]))


def _int32(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


def lm_batch(vocab: int, batch: int, seq: int, step: int,
             info: ShardInfo = ShardInfo(), seed: int = 0,
             structured: bool = True, device=DEFAULT_DEVICE):
    """Next-token batch {'tokens', 'labels'}: int32[batch / n_shards, seq].
    ``structured`` makes it learnable: token t+1 is (a*t + c) mod V with
    per-sequence (a, c), 10% noise."""
    b_local = batch // info.n_shards
    rng = _rng(seed, step, info.shard)
    if not structured:
        toks = rng.integers(0, vocab, (b_local, seq + 1))
    else:
        a = rng.integers(1, 8, (b_local, 1))
        c = rng.integers(0, vocab, (b_local, 1))
        t0 = rng.integers(0, vocab, (b_local, 1))
        toks = np.zeros((b_local, seq + 1), np.int64)
        toks[:, :1] = t0
        for i in range(1, seq + 1):
            toks[:, i] = (a[:, 0] * toks[:, i - 1] + c[:, 0]) % vocab
        noise = rng.random((b_local, seq + 1)) < 0.1
        toks = np.where(noise, rng.integers(0, vocab, toks.shape), toks)
    return {"tokens": _int32(toks[:, :-1], device),
            "labels": _int32(toks[:, 1:], device)}


def mind_batch(n_items: int, batch: int, seq_len: int, profile_vocab: int,
               profile_len: int, n_neg: int, step: int,
               info: ShardInfo = ShardInfo(), seed: int = 0,
               device=DEFAULT_DEVICE):
    """Interactions with latent-interest structure: each user draws 2
    interest clusters; behaviors (-1 padded) and target come from them.
    -> {'behavior' [B, seq_len], 'profile' [B, profile_len], 'target' [B],
    'negatives' [n_neg]}, int32."""
    b_local = batch // info.n_shards
    rng = _rng(seed, step, info.shard)
    n_clusters = 64
    cluster_of = (np.arange(n_items) * 2654435761 % n_clusters)
    user_c = rng.integers(0, n_clusters, (b_local, 2))
    items = rng.integers(0, n_items, (b_local, seq_len * 4))
    ok = (cluster_of[items] == user_c[:, :1]) | \
        (cluster_of[items] == user_c[:, 1:2])
    # each row's first seq_len in-cluster items, in order (the reference's
    # per-user loop, written over the whole batch at once)
    behavior = np.full((b_local, seq_len), -1, np.int64)
    rank = np.cumsum(ok, axis=1) - 1
    rows, cols = np.nonzero(ok & (rank < seq_len))
    behavior[rows, rank[rows, cols]] = items[rows, cols]
    empty = ~ok.any(1)
    behavior[empty, 0] = items[empty, 0]
    target = np.where(
        ok.any(1), items[np.arange(b_local), np.argmax(ok, axis=1)],
        items[:, 0])
    return {
        "behavior": _int32(behavior, device),
        "profile": _int32(
            rng.integers(0, profile_vocab, (b_local, profile_len)), device),
        "target": _int32(target, device),
        "negatives": _int32(rng.integers(0, n_items, (n_neg,)), device),
    }
