"""NequIP (Batzner et al., arXiv:2101.03164): E(3)-equivariant interatomic
potential -- tensor-product convolutions over l<=2 Cartesian irreps; as
``repro.models.gnn.nequip``.

Per layer: messages are radial-weighted tensor products of neighbor
features with the edge basis Y_l(r̂), summed over all (l_in, l_edge, l_out)
paths, aggregated by scatter-sum, then self-mixed + gated.  Radial weights
come from an MLP on the Bessel basis -- one weight per (path, channel) per
edge.  Energy readout from invariant contractions; forces via -grad.

With ``edge_chunk`` set (and dividing the edge count), the convolution
streams the edges in chunks through ``_ChunkedConv``: its forward keeps no
chunk's graph, its backward re-runs each chunk -- the reference's
``jax.custom_vjp`` -- so only chunk-sized message tensors ever exist.
First-order only, as the reference's: a second derivative raises.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.graph import segment_ops as so
from repro_torch.models import common
from repro_torch.models.gnn import common as gc
from repro_torch.models.gnn import tasks
from repro_torch.tree import tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    d_hidden: int = 32
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    d_feat: int = 16
    task: str = "energy"
    n_classes: int = 2
    n_graphs: int = 1
    avg_degree: float = 8.0
    dtype: object = torch.float32
    scan_unroll: bool = False  # the reference's scan option; no effect here
    edge_ax: object = None     # mesh axes of edge and node rows
    node_ax: object = None
    remat: bool = False        # checkpoint each layer body
    edge_chunk: int = 0        # >0: stream edges in chunks of this size


def _ls(cfg):
    return ["l0", "l1", "l2"][: cfg.l_max + 1]


def _layer_init(gen, cfg: NequIPConfig, device):
    c = cfg.d_hidden
    paths = gc.paths_for(cfg.l_max)

    def dense():
        return common.dense_init(gen, (c, c), dtype=cfg.dtype, device=device)

    return {
        # radial MLP emits one weight per (path, channel)
        "radial": common.mlp_init(gen, [cfg.n_rbf, 32, len(paths) * c],
                                  cfg.dtype, device=device),
        "mix": {l: dense() for l in _ls(cfg)},
        "skip": {l: dense() for l in _ls(cfg)},
        "gate": {l: dense() for l in _ls(cfg) if l != "l0"},
    }


def init(cfg: NequIPConfig, gen: torch.Generator, device=None) -> dict:
    d_out = cfg.n_classes if cfg.task == "node_class" else 1
    n_inv = cfg.d_hidden * (cfg.l_max + 1)
    return {
        "embed": common.dense_init(gen, (cfg.d_feat, cfg.d_hidden),
                                   dtype=cfg.dtype, device=device),
        "layers": gc.stack_layers(
            [_layer_init(gen, cfg, device) for _ in range(cfg.n_layers)]),
        "head": common.mlp_init(gen, [n_inv, cfg.d_hidden, d_out],
                                cfg.dtype, device=device),
    }


def _chunk_messages(p, feats, pos, s_idx, d_idx, m_mask, n,
                    cfg: NequIPConfig):
    """Messages for one edge set, aggregated to nodes ([N, C, ...])."""
    c = cfg.d_hidden
    rel = pos[d_idx] - pos[s_idx]
    r = torch.sqrt((rel * rel).sum(-1) + 1e-12)
    rhat = rel / r[:, None]
    basis = gc.edge_basis(rhat.to(cfg.dtype), cfg.l_max)
    rbf = gc.bessel_basis(r, cfg.n_rbf, cfg.cutoff).to(cfg.dtype)
    paths = gc.paths_for(cfg.l_max)
    w = common.mlp_apply(p["radial"], rbf)  # [E, n_paths*C]
    # zero-length (self-loop / padded) edges carry no message: rhat is
    # singular there and its gradient is chaotic -- masking keeps grads
    # exact and chunk-order independent
    ok = m_mask & (r > 1e-6)
    w = w * ok.to(cfg.dtype)[:, None]
    w = w.reshape(w.shape[0], len(paths), c)
    msg = {}
    gathered = {l: gc.constrain_rows(feats[l][s_idx], cfg.edge_ax)
                for l in _ls(cfg)}                   # [E, C, ...] per l
    for i, (la, lb, lo) in enumerate(paths):
        fa = gathered[f"l{la}"]
        wi = w[:, i]
        # the path's weight scales the feature before the product, which
        # is linear in it: the same message, and (with fixed positions)
        # no [E, C, ...] product kept for the backward
        fa = fa * wi.reshape(wi.shape + (1,) * (fa.dim() - 2))
        out = gc.TP_PATHS[(la, lb, lo)](fa, basis[f"l{lb}"])  # [E, C, ...]
        key = f"l{lo}"
        msg[key] = msg[key] + out if key in msg else out
    agg = {l: so.segment_sum(gc.constrain_rows(msg[l], cfg.edge_ax), d_idx,
                             n) for l in _ls(cfg)}
    return gc.constrain_feats(agg, cfg.node_ax)


class _Chunks(NamedTuple):
    """What ``_ChunkedConv`` needs beside its tensors: the layer's param
    tree (for its structure), the edges split into chunks, N and the
    config."""
    p_like: object
    n_p: int
    src: torch.Tensor   # [n_chunks, chunk]
    dst: torch.Tensor
    mask: torch.Tensor
    n: int
    cfg: NequIPConfig

    def unflatten(self, tensors):
        """(p, feats, pos) from the flat (p leaves, feats by l, pos)."""
        p = tree_unflatten(self.p_like, tensors[:self.n_p])
        ls = _ls(self.cfg)
        feats = dict(zip(ls, tensors[self.n_p:self.n_p + len(ls)]))
        return p, feats, tensors[-1]

    def messages(self, tensors, k):
        p, feats, pos = self.unflatten(tensors)
        agg = _chunk_messages(p, feats, pos, self.src[k], self.dst[k],
                              self.mask[k], self.n, self.cfg)
        return [agg[l] for l in _ls(self.cfg)]


class _ChunkedConv(torch.autograd.Function):
    """agg = Σ_chunks f(chunk).  Forward: the chunks in turn, no graph
    kept.  Backward: each chunk re-run under ``enable_grad`` and its
    ``autograd.grad`` for the params, ``feats`` and ``pos`` summed (the
    cotangent of a sum is the same for every chunk)."""

    @staticmethod
    def forward(ctx, chunks: _Chunks, *tensors):
        acc = chunks.messages(tensors, 0)
        for k in range(1, chunks.src.shape[0]):
            for a, b in zip(acc, chunks.messages(tensors, k)):
                a.add_(b)  # no graph here: the sums in place
        ctx.chunks = chunks
        ctx.save_for_backward(*tensors)
        return tuple(acc)

    @staticmethod
    def backward(ctx, *g):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "nequip's chunked-edge convolution is first-order only, as "
                "the reference's custom_vjp: a gradient of its gradient "
                "(force training) must run unchunked (edge_chunk=0)")
        chunks = ctx.chunks
        saved = ctx.saved_tensors  # once: remat's hooks unpack it once
        needs = ctx.needs_input_grad[1:]
        grads = [None] * len(needs)
        for k in range(chunks.src.shape[0]):
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(need)
                       for t, need in zip(saved, needs)]
                wrt = [x for x, need in zip(ins, needs) if need]
                got = iter(torch.autograd.grad(
                    chunks.messages(ins, k), wrt, grad_outputs=g,
                    allow_unused=True, materialize_grads=True))
            for i, need in enumerate(needs):
                if need:
                    gi = next(got)
                    grads[i] = gi if grads[i] is None else grads[i].add_(gi)
        return (None, *grads)


def conv(p, feats, pos, batch, cfg: NequIPConfig):
    """One tensor-product convolution; returns aggregated messages.

    With ``edge_chunk`` set, e > edge_chunk and e % edge_chunk == 0, edges
    stream through ``_ChunkedConv`` in chunks of ``edge_chunk``."""
    src, dst = batch["src"].long(), batch["dst"].long()
    emask = batch["edge_mask"]
    n = feats["l0"].shape[0]
    e = src.shape[0]
    ck = cfg.edge_chunk
    if ck and e > ck and e % ck == 0:
        leaves = tree_leaves(p)
        chunks = _Chunks(p, len(leaves), src.reshape(-1, ck),
                         dst.reshape(-1, ck), emask.reshape(-1, ck), n, cfg)
        agg = dict(zip(_ls(cfg), _ChunkedConv.apply(
            chunks, *leaves, *(feats[l] for l in _ls(cfg)), pos)))
    else:
        agg = _chunk_messages(p, feats, pos, src, dst, emask, n, cfg)
    scale = cfg.avg_degree ** 0.5
    return gc.constrain_feats({l: v / scale for l, v in agg.items()},
                              cfg.node_ax)


def _forward(params, pos, batch, cfg: NequIPConfig):
    n = batch["x"].shape[0]
    feats = gc.zeros_feats(n, cfg.d_hidden, cfg.l_max, cfg.dtype,
                           batch["x"].device)
    feats["l0"] = batch["x"].to(cfg.dtype) @ params["embed"]

    def body(feats, p):
        m = conv(p, feats, pos, batch, cfg)
        m = gc.linear_mix(p["mix"], m)
        skip = gc.linear_mix(p["skip"], feats)
        feats = gc.gate(gc.add_feats(m, skip), p["gate"])
        feats = gc.norm_feats(feats)
        return gc.constrain_feats(feats, cfg.node_ax)

    return gc.scan_layers(body, feats, params["layers"], cfg.n_layers,
                          cfg.remat)


def node_energy(params, pos, batch, cfg: NequIPConfig):
    feats = _forward(params, pos, batch, cfg)
    inv = gc.invariants(feats)
    e_node = common.mlp_apply(params["head"], inv)[:, 0]
    return tasks.per_graph_sum(e_node, batch["graph_id"],
                               batch["node_mask"], cfg.n_graphs)


def loss_fn(params, batch, cfg: NequIPConfig):
    if cfg.task == "node_class":
        feats = _forward(params, batch["pos"], batch, cfg)
        logits = common.mlp_apply(params["head"], gc.invariants(feats))
        return tasks.classification_loss(logits, batch)
    return tasks.energy_force_loss(
        lambda p, pos, b: node_energy(p, pos, b, cfg),
        params, batch, cfg.n_graphs)
