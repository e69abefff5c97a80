"""Deterministic, shard-aware synthetic data streams, as in
``repro.data.pipeline``: the LM, GNN and recsys streams.

Every source is a pure function of (seed, step, shard) -- no files, no
state -- drawn from numpy's ``SeedSequence([seed, step, shard])``, the
reference's own streams, so a batch holds the reference's integers
exactly (the GNN streams' floats too).  A checkpoint stores only the step
cursor: resuming re-generates the identical batch sequence.  Batches are
tensors on ``device``.  The sampled-block stream feeds the sampler from a
``torch.Generator`` seeded with the reference's PRNG seed, so its
neighbors differ from the reference's (``graph/sampler.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.graph_state import DEFAULT_DEVICE
from repro_torch.graph import batching, sampler


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


# ------------------------------------------------------------------ GNN ---

def _f32(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def molecule_batch(n_graphs: int, n_nodes: int, n_edges: int, d_feat: int,
                   step: int, info: ShardInfo = ShardInfo(), seed: int = 0,
                   device=DEFAULT_DEVICE):
    """Packed random molecules with a learnable energy (0.01 x the sum of
    squared pairwise distances within each graph) and zero forces."""
    g_local = n_graphs // info.n_shards
    rng = _rng(seed, step, info.shard)
    g = batching.pack_dense_batch(g_local, n_nodes, n_edges,
                                  seed=int(rng.integers(0, 2 ** 31)),
                                  device=device)
    n = g_local * n_nodes
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    x = rng.normal(size=(n, d_feat)).astype(np.float32)
    energy = np.zeros(g_local, np.float32)
    pos_r = pos.reshape(g_local, n_nodes, 3)
    for i in range(g_local):
        d = pos_r[i][:, None] - pos_r[i][None, :]
        energy[i] = 0.01 * np.sum(d * d)
    return {
        "src": g.src, "dst": g.dst, "edge_mask": g.edge_mask,
        "node_mask": g.node_mask.float(), "graph_id": g.graph_id,
        "x": _f32(x, device), "pos": _f32(pos, device),
        "energy": _f32(energy, device),
        "forces": torch.zeros((n, 3), dtype=torch.float32, device=device),
    }


def node_class_graph(n_nodes: int, n_edges: int, d_feat: int,
                     n_classes: int, seed: int = 0, device=DEFAULT_DEVICE):
    """A fixed full-batch classification graph (Cora/products stand-in):
    labels from a random linear probe of the features plus noise."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    w = rng.normal(size=(d_feat, n_classes)).astype(np.float32)
    labels = np.argmax(x @ w + 0.5 * rng.normal(size=(n_nodes, n_classes)),
                       axis=1)
    src = rng.integers(0, n_nodes, n_edges)
    dst = rng.integers(0, n_nodes, n_edges)
    return {
        "src": _int32(src, device), "dst": _int32(dst, device),
        "edge_mask": torch.ones((n_edges,), dtype=torch.bool, device=device),
        "node_mask": torch.ones((n_nodes,), dtype=torch.float32,
                                device=device),
        "graph_id": torch.zeros((n_nodes,), dtype=torch.int32,
                                device=device),
        "x": _f32(x, device),
        "pos": _f32(rng.normal(size=(n_nodes, 3)), device),
        "labels": _int32(labels, device),
    }


def sampled_block_batch(csr: sampler.CSRGraph, features: torch.Tensor,
                        labels: torch.Tensor, batch_nodes: int, fanouts,
                        step: int, info: ShardInfo = ShardInfo(),
                        seed: int = 0, draws=None):
    """minibatch_lg: seeds + fanout-sampled blocks flattened to one edge
    list local to the minibatch (GraphSAGE-style), on ``features``'
    device.  The neighbors come from ``draws`` (one int[n, fanout] per
    layer) if given, else from a ``torch.Generator`` seeded with the
    reference's PRNG seed."""
    device = features.device
    n_local = batch_nodes // info.n_shards
    rng = _rng(seed, step, info.shard)
    n_total = features.shape[0]
    seeds = _int32(rng.integers(0, n_total, n_local), device)
    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(0, 2 ** 31)))
    blocks, inputs = sampler.sample_blocks(csr, seeds, list(fanouts),
                                           generator=gen, draws=draws)
    # union node set = all frontier nodes (dups fine); relabel locally
    node_ids = torch.cat([inputs] + [b.src for b in blocks[1:]] + [seeds])
    # one flat edge list over the concatenated node table, widest block
    # first: src at [offset : offset+|src|], dst into the next segment
    srcs, dsts = [], []
    offset = 0
    for b in blocks:
        srcs.append(torch.arange(b.src.shape[0], dtype=torch.int32,
                                 device=device) + offset)
        nxt = offset + b.src.shape[0]
        dsts.append(b.dst_local + nxt)
        offset = nxt
    src = torch.cat(srcs)
    dst = torch.cat(dsts)
    n = node_ids.shape[0]
    ids = node_ids.long()
    return {
        "src": src, "dst": dst,
        "edge_mask": torch.ones(src.shape, dtype=torch.bool, device=device),
        "node_mask": torch.ones((n,), dtype=torch.float32, device=device),
        "graph_id": torch.zeros((n,), dtype=torch.int32, device=device),
        "x": features[ids],
        "pos": torch.zeros((n, 3), dtype=torch.float32, device=device),
        "labels": labels[ids],
    }


# --------------------------------------------------------------- recsys ---

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


# ------------------------------------------------------------ SCC (paper) ---

def op_stream(n_vertices: int, batch: int, step: int, add_frac: float,
              info: ShardInfo = ShardInfo(), seed: int = 0,
              include_vertex_ops: bool = True):
    """Deprecated alias of :func:`repro_torch.launch.workload.op_stream`,
    as the reference keeps one: the same (seed, step, shard) stream."""
    from repro_torch.launch import workload
    return workload.op_stream(
        n_vertices, batch, step, add_frac,
        info=workload.ShardInfo(info.shard, info.n_shards), seed=seed,
        include_vertex_ops=include_vertex_ops)
