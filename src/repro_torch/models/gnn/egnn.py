"""EGNN (Satorras et al., arXiv:2102.09844): E(n)-equivariant GNN, as
``repro.models.gnn.egnn``.

Invariant messages from squared distances; positions updated along
relative vectors -- equivariance by construction.  Layers are homogeneous;
their params are stacked on a leading [n_layers] axis, as the reference's
``jax.vmap`` of ``_layer_init`` stacks them.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.graph import segment_ops as so
from repro_torch.models import common
from repro_torch.models.gnn import common as gc
from repro_torch.models.gnn import tasks


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_feat: int = 16
    task: str = "energy"       # 'energy' | 'node_class'
    n_classes: int = 2
    n_graphs: int = 1          # graphs per packed batch (static)
    update_pos: bool = True
    dtype: object = torch.float32
    scan_unroll: bool = False  # the reference's scan option; no effect here
    edge_ax: object = None     # mesh axes of edge and node rows
    node_ax: object = None
    remat: bool = False


def _layer_init(gen, cfg: EGNNConfig, device):
    d = cfg.d_hidden
    return {
        "phi_e": common.mlp_init(gen, [2 * d + 1, d, d], cfg.dtype,
                                 device=device),
        "phi_x": common.mlp_init(gen, [d, d, 1], cfg.dtype, device=device),
        "phi_h": common.mlp_init(gen, [2 * d, d, d], cfg.dtype,
                                 device=device),
    }


def init(cfg: EGNNConfig, gen: torch.Generator, device=None) -> dict:
    d_out = cfg.n_classes if cfg.task == "node_class" else 1
    return {
        "embed": common.dense_init(gen, (cfg.d_feat, cfg.d_hidden),
                                   dtype=cfg.dtype, device=device),
        "layers": gc.stack_layers(
            [_layer_init(gen, cfg, device) for _ in range(cfg.n_layers)]),
        "head": common.mlp_init(gen, [cfg.d_hidden, cfg.d_hidden, d_out],
                                cfg.dtype, device=device),
    }


def _forward(params, pos, batch, cfg: EGNNConfig):
    src, dst = batch["src"].long(), batch["dst"].long()
    emask = batch["edge_mask"].to(cfg.dtype)[:, None]
    n = batch["x"].shape[0]
    h = batch["x"].to(cfg.dtype) @ params["embed"]

    def body(carry, p):
        h, pos = carry
        rel = pos[dst] - pos[src]                       # [E,3]
        d2 = (rel * rel).sum(-1, keepdim=True)
        m = common.mlp_apply(
            p["phi_e"], torch.cat([h[dst], h[src], d2.to(cfg.dtype)], -1),
            final_act=F.silu) * emask
        if cfg.update_pos:
            w = common.mlp_apply(p["phi_x"], m)          # [E,1]
            # +eps inside the sqrt keeps grads finite on zero-length
            # (padded / self-loop) edges
            delta = rel / (torch.sqrt(d2 + 1e-9) + 1.0) * w * emask
            pos = pos + so.segment_mean(delta, dst, n)
        m = gc.constrain_rows(m, cfg.edge_ax)
        agg = so.segment_sum(m, dst, n)
        h = h + common.mlp_apply(p["phi_h"], torch.cat([h, agg], -1))
        return gc.constrain_rows(h, cfg.node_ax), pos

    return gc.scan_layers(body, (h, pos), params["layers"], cfg.n_layers,
                          cfg.remat)


def node_energy(params, pos, batch, cfg: EGNNConfig):
    h, _ = _forward(params, pos, batch, cfg)
    e_node = common.mlp_apply(params["head"], h)[:, 0]
    return tasks.per_graph_sum(e_node, batch["graph_id"],
                               batch["node_mask"], cfg.n_graphs)


def loss_fn(params, batch, cfg: EGNNConfig):
    if cfg.task == "node_class":
        h, _ = _forward(params, batch["pos"], batch, cfg)
        logits = common.mlp_apply(params["head"], h)
        return tasks.classification_loss(logits, batch)
    return tasks.energy_force_loss(
        lambda p, pos, b: node_energy(p, pos, b, cfg),
        params, batch, cfg.n_graphs)
