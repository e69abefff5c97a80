"""Batched small-graph packing (the ``molecule`` shape: 30 nodes x batch
128), as ``repro.graph.batching``.

Many small graphs are packed into one big disjoint graph so a single
segment-op message-passing pass covers the whole batch.  Shapes are
static: every graph is padded to ``max_nodes`` / ``max_edges``; masks carry
validity.  ``graph_id`` maps nodes to their graph for readout.  The packer
is the reference's numpy code; its arrays go to ``device`` at the end.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.graph_state import DEFAULT_DEVICE


class PackedGraphs(NamedTuple):
    src: torch.Tensor        # int32[B * max_edges]   (global node index)
    dst: torch.Tensor        # int32[B * max_edges]
    edge_mask: torch.Tensor  # bool [B * max_edges]
    node_mask: torch.Tensor  # bool [B * max_nodes]
    graph_id: torch.Tensor   # int32[B * max_nodes]
    n_graphs: int
    max_nodes: int


def pack(srcs, dsts, n_nodes, max_nodes: int, max_edges: int,
         device=DEFAULT_DEVICE) -> PackedGraphs:
    """Host-side packer.  ``srcs/dsts``: list of int arrays per graph."""
    b = len(srcs)
    src = np.zeros((b, max_edges), np.int32)
    dst = np.zeros((b, max_edges), np.int32)
    emask = np.zeros((b, max_edges), bool)
    nmask = np.zeros((b, max_nodes), bool)
    for i, (s, d, n) in enumerate(zip(srcs, dsts, n_nodes)):
        e = len(s)
        if e > max_edges or n > max_nodes:
            raise ValueError(f"graph {i}: {e} edges / {n} nodes exceed "
                             f"{max_edges} / {max_nodes}")
        src[i, :e] = s
        dst[i, :e] = d
        emask[i, :e] = True
        nmask[i, :n] = True
    base = (np.arange(b, dtype=np.int32) * max_nodes)[:, None]
    gid = np.repeat(np.arange(b, dtype=np.int32)[:, None], max_nodes, 1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a.reshape(-1))).to(
            device)

    return PackedGraphs(src=t(src + base), dst=t(dst + base),
                        edge_mask=t(emask), node_mask=t(nmask),
                        graph_id=t(gid), n_graphs=b, max_nodes=max_nodes)


def pack_dense_batch(batch: int, n_nodes: int, n_edges: int, seed: int = 0,
                     device=DEFAULT_DEVICE) -> PackedGraphs:
    """Synthetic molecule batch: ``batch`` random connected digraphs."""
    rng = np.random.default_rng(seed)
    srcs, dsts = [], []
    for _ in range(batch):
        # random spanning chain + extra edges => connected-ish molecule
        perm = rng.permutation(n_nodes)
        chain_s, chain_d = perm[:-1], perm[1:]
        extra = n_edges - (n_nodes - 1)
        es = rng.integers(0, n_nodes, extra)
        ed = rng.integers(0, n_nodes, extra)
        srcs.append(np.concatenate([chain_s, es]).astype(np.int32))
        dsts.append(np.concatenate([chain_d, ed]).astype(np.int32))
    return pack(srcs, dsts, [n_nodes] * batch, n_nodes, n_edges, device)
