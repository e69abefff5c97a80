"""GatedGCN (Bresson & Laurent, arXiv:1711.07553 / benchmark config
arXiv:2003.00982): edge-gated message passing, 16 layers, d=70; as
``repro.models.gnn.gatedgcn``.

h_i' = h_i + ReLU(Norm(A h_i + Σ_j η_ij ⊙ B h_j)),
e_ij' = e_ij + ReLU(Norm(ê_ij)),  ê_ij = C e_ij + D h_i + E h_j,
η_ij = σ(ê_ij) / (Σ_j' σ(ê_ij') + ε)   (degree-normalized edge gates).

Masked LayerNorm in place of the benchmark's BatchNorm, as the reference.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.graph import segment_ops as so
from repro_torch.models import common
from repro_torch.models.gnn import common as gc
from repro_torch.models.gnn import tasks


@dataclasses.dataclass(frozen=True)
class GatedGCNConfig:
    name: str = "gatedgcn"
    n_layers: int = 16
    d_hidden: int = 70
    d_feat: int = 16
    task: str = "node_class"
    n_classes: int = 7
    n_graphs: int = 1
    dtype: object = torch.float32
    scan_unroll: bool = False  # the reference's scan option; no effect here
    edge_ax: object = None     # mesh axes of edge and node rows
    node_ax: object = None
    remat: bool = False


def _layer_init(gen, cfg: GatedGCNConfig, device):
    d = cfg.d_hidden
    p = {m: common.dense_init(gen, (d, d), dtype=cfg.dtype, device=device)
         for m in "ABCDE"}
    p["ln_h"] = torch.ones((d,), dtype=cfg.dtype, device=device)
    p["ln_e"] = torch.ones((d,), dtype=cfg.dtype, device=device)
    return p


def init(cfg: GatedGCNConfig, gen: torch.Generator, device=None) -> dict:
    d_out = cfg.n_classes if cfg.task == "node_class" else 1
    return {
        "embed_h": common.dense_init(gen, (cfg.d_feat, cfg.d_hidden),
                                     dtype=cfg.dtype, device=device),
        "embed_e": common.dense_init(gen, (1, cfg.d_hidden),
                                     dtype=cfg.dtype, device=device),
        "layers": gc.stack_layers(
            [_layer_init(gen, cfg, device) for _ in range(cfg.n_layers)]),
        "head": common.mlp_init(gen, [cfg.d_hidden, cfg.d_hidden, d_out],
                                cfg.dtype, device=device),
    }


def _ln(x, w, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * w


def _forward(params, batch, cfg: GatedGCNConfig):
    src, dst = batch["src"].long(), batch["dst"].long()
    emask = batch["edge_mask"].to(cfg.dtype)[:, None]
    n = batch["x"].shape[0]
    h = batch["x"].to(cfg.dtype) @ params["embed_h"]
    e = torch.ones((src.shape[0], 1), dtype=cfg.dtype,
                   device=src.device) @ params["embed_e"]

    def body(carry, p):
        h, e = carry
        e_hat = e @ p["C"] + h[dst] @ p["D"] + h[src] @ p["E"]
        sig = torch.sigmoid(e_hat) * emask
        denom = so.segment_sum(sig, dst, n)[dst] + 1e-6
        eta = sig / denom
        agg = so.segment_sum(eta * (h[src] @ p["B"]) * emask, dst, n)
        h = h + torch.relu(_ln(h @ p["A"] + agg, p["ln_h"]))
        e = e + torch.relu(_ln(e_hat, p["ln_e"]))
        return (gc.constrain_rows(h, cfg.node_ax),
                gc.constrain_rows(e, cfg.edge_ax))

    h, _ = gc.scan_layers(body, (h, e), params["layers"], cfg.n_layers,
                          cfg.remat)
    return h


def node_energy(params, pos, batch, cfg: GatedGCNConfig):
    del pos  # GatedGCN is not geometric; energy from features only
    h = _forward(params, batch, cfg)
    e_node = common.mlp_apply(params["head"], h)[:, 0]
    return tasks.per_graph_sum(e_node, batch["graph_id"],
                               batch["node_mask"], cfg.n_graphs)


def loss_fn(params, batch, cfg: GatedGCNConfig):
    if cfg.task == "node_class":
        logits = common.mlp_apply(params["head"],
                                  _forward(params, batch, cfg))
        return tasks.classification_loss(logits, batch)
    # graph-level energy regression (molecule shape); no force term since
    # the model has no positional pathway -- MSE on energies only.
    e = node_energy(params, batch["pos"], batch, cfg)
    loss = ((e - batch["energy"]) ** 2).mean()
    return loss, {"e_mse": loss}
