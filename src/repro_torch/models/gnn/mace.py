"""MACE (Batatia et al., arXiv:2206.07697): higher-order equivariant
message passing via ACE-style symmetric tensor contractions; as
``repro.models.gnn.mace``.

Per layer:
  1. **A-features**: one radial-weighted tensor-product convolution over
     neighbors (NequIP's, through a config view) -- the order-1 basis.
  2. **B-features**: symmetric products of A with itself up to
     ``correlation`` order (here 3):  B² = Σ paths TP(A, A),
     B³ = Σ paths TP(B², A), each path carrying a learned per-channel
     weight.
  3. Message = Σ_order linear_mix(B^order); update = gate(message + skip).
  4. Per-layer invariant energy readout, summed over layers.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import common
from repro_torch.models.gnn import common as gc
from repro_torch.models.gnn import nequip as nq
from repro_torch.models.gnn import tasks


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128
    l_max: int = 2
    correlation: int = 3
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
    remat: bool = False
    edge_chunk: int = 0


def _ls(cfg):
    return ["l0", "l1", "l2"][: cfg.l_max + 1]


def _layer_init(gen, cfg: MACEConfig, device):
    c = cfg.d_hidden
    npaths = len(gc.paths_for(cfg.l_max))

    def mixes():
        return {l: common.dense_init(gen, (c, c), dtype=cfg.dtype,
                                     device=device) for l in _ls(cfg)}

    return {
        "radial": common.mlp_init(gen, [cfg.n_rbf, 32, npaths * c],
                                  cfg.dtype, device=device),
        # per-path, per-channel weights of the symmetric contractions
        "w2": common.dense_init(gen, (npaths, c), scale=0.3,
                                dtype=cfg.dtype, device=device),
        "w3": common.dense_init(gen, (npaths, c), scale=0.3,
                                dtype=cfg.dtype, device=device),
        "mix1": mixes(),
        "mix2": mixes(),
        "mix3": mixes(),
        "skip": mixes(),
        "gate": {l: common.dense_init(gen, (c, c), dtype=cfg.dtype,
                                      device=device)
                 for l in _ls(cfg) if l != "l0"},
        "readout": common.mlp_init(gen, [c * (cfg.l_max + 1), c, 1],
                                   cfg.dtype, device=device),
    }


def init(cfg: MACEConfig, gen: torch.Generator, device=None) -> dict:
    d_out = cfg.n_classes if cfg.task == "node_class" else 1
    return {
        "embed": common.dense_init(gen, (cfg.d_feat, cfg.d_hidden),
                                   dtype=cfg.dtype, device=device),
        "layers": gc.stack_layers(
            [_layer_init(gen, cfg, device) for _ in range(cfg.n_layers)]),
        "head": common.mlp_init(
            gen, [cfg.d_hidden * (cfg.l_max + 1), cfg.d_hidden, d_out],
            cfg.dtype, device=device),
    }


def _sym_product(a_feats, b_feats, weights, cfg: MACEConfig):
    """Σ_paths w_path ⊙ TP(a, b), node-local (both args [N, C, ...])."""
    out = {l: torch.zeros_like(a_feats[l]) for l in _ls(cfg)}
    for i, (la, lb, lo) in enumerate(gc.paths_for(cfg.l_max)):
        prod = gc.TP_PATHS[(la, lb, lo)](a_feats[f"l{la}"],
                                         b_feats[f"l{lb}"])
        w = weights[i]  # [C]
        out[f"l{lo}"] = out[f"l{lo}"] + prod * w.reshape(
            (1, -1) + (1,) * (prod.dim() - 2))
    return out


def _forward(params, pos, batch, cfg: MACEConfig):
    """Returns (final feats, per-node energy accumulated over layers)."""
    n = batch["x"].shape[0]
    feats = gc.zeros_feats(n, cfg.d_hidden, cfg.l_max, cfg.dtype,
                           batch["x"].device)
    feats["l0"] = batch["x"].to(cfg.dtype) @ params["embed"]
    # reuse the NequIP conv (A-features) with a cfg view
    nq_cfg = nq.NequIPConfig(
        n_layers=cfg.n_layers, d_hidden=cfg.d_hidden, l_max=cfg.l_max,
        n_rbf=cfg.n_rbf, cutoff=cfg.cutoff, d_feat=cfg.d_feat,
        avg_degree=cfg.avg_degree, dtype=cfg.dtype,
        edge_ax=cfg.edge_ax, node_ax=cfg.node_ax,
        edge_chunk=cfg.edge_chunk)

    def body(carry, p):
        feats, e_acc = carry
        a = nq.conv({"radial": p["radial"]}, feats, pos, batch, nq_cfg)
        a = gc.norm_feats(a)
        b2 = _sym_product(a, a, p["w2"], cfg) if cfg.correlation >= 2 \
            else None
        b3 = _sym_product(b2, a, p["w3"], cfg) if cfg.correlation >= 3 \
            else None
        m = gc.linear_mix(p["mix1"], a)
        if b2 is not None:
            m = gc.add_feats(m, gc.linear_mix(p["mix2"], b2))
        if b3 is not None:
            m = gc.add_feats(m, gc.linear_mix(p["mix3"], b3))
        skip = gc.linear_mix(p["skip"], feats)
        feats = gc.norm_feats(gc.gate(gc.add_feats(m, skip), p["gate"]))
        feats = gc.constrain_feats(feats, cfg.node_ax)
        e_layer = common.mlp_apply(p["readout"], gc.invariants(feats))[:, 0]
        return feats, e_acc + e_layer

    e0 = torch.zeros((n,), dtype=cfg.dtype, device=batch["x"].device)
    return gc.scan_layers(body, (feats, e0), params["layers"], cfg.n_layers,
                          cfg.remat)


def node_energy(params, pos, batch, cfg: MACEConfig):
    _, e_node = _forward(params, pos, batch, cfg)
    return tasks.per_graph_sum(e_node, batch["graph_id"],
                               batch["node_mask"], cfg.n_graphs)


def loss_fn(params, batch, cfg: MACEConfig):
    if cfg.task == "node_class":
        feats, _ = _forward(params, batch["pos"], batch, cfg)
        logits = common.mlp_apply(params["head"], gc.invariants(feats))
        return tasks.classification_loss(logits, batch)
    return tasks.energy_force_loss(
        lambda p, pos, b: node_energy(p, pos, b, cfg),
        params, batch, cfg.n_graphs)
