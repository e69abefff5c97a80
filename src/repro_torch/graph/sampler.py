"""Fanout neighbor sampler for minibatch GNN training (the minibatch_lg
shape), as ``repro.graph.sampler``.

  * the graph lives in CSR form (``indptr``, ``indices``, int32), built
    once: the edges' numpy draws, then a stable sort by source on the
    graph's device;
  * per minibatch, layer ``l`` samples ``fanout[l]`` neighbors of every
    frontier node with replacement (uniform), in one vectorized gather;
  * isolated nodes self-loop so downstream segment ops stay well-defined.

One departure from the reference, declared: it draws with
``jax.random.randint`` (threefry), which torch cannot reproduce, so the
draws here come from an explicit ``torch.Generator`` or are passed in as
``draws`` (int[n, fanout] in [0, 2^31 - 1) per layer).  The same seed
therefore samples other neighbors; given the same draws, everything after
the draw (``r % max(deg, 1)``, the self-loop, the flattening, the block
order) is the reference's, bit for bit.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.graph_state import DEFAULT_DEVICE

DRAW_HIGH = 2 ** 31 - 1  # jax.random.randint's bound: iinfo(int32).max


class CSRGraph(NamedTuple):
    indptr: torch.Tensor   # int32[N+1]
    indices: torch.Tensor  # int32[E]


class SampledBlock(NamedTuple):
    """One message-passing block: edges from sampled srcs into dst
    frontier."""
    src: torch.Tensor        # int32[n_dst * fanout]  (global node ids)
    dst_local: torch.Tensor  # int32[n_dst * fanout] (position in frontier)
    n_dst: int


def build_csr(src, dst, num_nodes: int, device=DEFAULT_DEVICE) -> CSRGraph:
    """CSR of the outgoing adjacency (``dst`` per ``src``): the edges in a
    stable sort by source, and ``indptr`` from their counts.  ``src`` and
    ``dst`` are numpy arrays or tensors; the sort runs on ``device``."""
    s, d = (torch.from_numpy(np.ascontiguousarray(a, np.int32))
            if isinstance(a, np.ndarray) else a for a in (src, dst))
    s = s.to(device=device, dtype=torch.int32)
    d = d.to(device=device, dtype=torch.int32)
    s, order = torch.sort(s, stable=True)
    indices = d[order]
    del order
    indptr = torch.zeros(num_nodes + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(torch.bincount(s, minlength=num_nodes), 0)
    return CSRGraph(indptr=indptr.to(torch.int32), indices=indices)


def sample_block(csr: CSRGraph, frontier: torch.Tensor, fanout: int,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[torch.Tensor] = None
                 ) -> Tuple[SampledBlock, torch.Tensor]:
    """Sample ``fanout`` neighbors (with replacement) for each frontier
    node, from ``draws`` or else from ``generator``.  Returns the block
    plus the next frontier (= sampled srcs, flattened).  Nodes with zero
    out-degree sample themselves (self-loop)."""
    n = frontier.shape[0]
    f = frontier.long()
    start = csr.indptr[f].long()
    deg = csr.indptr[f + 1].long() - start
    if draws is None:
        r = torch.randint(0, DRAW_HIGH, (n, fanout), generator=generator,
                          device=frontier.device)
    else:
        r = draws.to(frontier.device).long()
    has = deg[:, None] > 0
    # uniform in [0, deg); deg == 0 -> self-loop
    off = torch.where(has, r % deg.clamp_min(1)[:, None], 0)
    n_edges = csr.indices.shape[0]
    if n_edges:
        nbr = csr.indices[(start[:, None] + off).clamp_max(n_edges - 1)]
    else:
        nbr = frontier[:, None].expand(n, fanout)
    src = torch.where(has, nbr, frontier[:, None]).reshape(-1)
    src = src.to(torch.int32)
    dst_local = torch.arange(n, dtype=torch.int32,
                             device=frontier.device).repeat_interleave(
                                 fanout)
    return SampledBlock(src=src, dst_local=dst_local, n_dst=n), src


def sample_blocks(csr: CSRGraph, seeds: torch.Tensor,
                  fanouts: Sequence[int],
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[Sequence[torch.Tensor]] = None
                  ) -> Tuple[List[SampledBlock], torch.Tensor]:
    """Multi-layer fanout sampling (innermost layer first, GraphSAGE
    order); ``draws[l]`` (if given) is layer l's.  Layer l's frontier is
    the flattened neighbor set of layer l-1 (with duplicates).

    Returns (blocks, input_nodes): blocks[0] is applied first (largest
    frontier), input_nodes is the node set whose raw features are
    gathered."""
    blocks = []
    frontier = seeds
    for l, f in enumerate(fanouts):
        blk, frontier = sample_block(
            csr, frontier, f, generator,
            None if draws is None else draws[l])
        blocks.append(blk)
    blocks.reverse()  # apply from the widest layer inward
    return blocks, frontier


def make_synthetic_csr(num_nodes: int, avg_degree: int, seed: int = 0,
                       device=DEFAULT_DEVICE) -> CSRGraph:
    """Deterministic synthetic power-law-ish digraph for benchmarks/tests:
    the reference's numpy draws, self-loops dropped."""
    rng = np.random.default_rng(seed)
    e = num_nodes * avg_degree
    # preferential-attachment flavored: square a uniform to skew hubs
    src = (rng.random(e) ** 2 * num_nodes).astype(np.int64) % num_nodes
    dst = rng.integers(0, num_nodes, e)
    keep = src != dst
    return build_csr(src[keep], dst[keep], num_nodes, device)
