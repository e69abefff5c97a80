"""Shared GNN task heads and losses, as ``repro.models.gnn.tasks``.

  * ``node_class`` -- CE over per-node logits (full_graph_sm /
    minibatch_lg / ogb_products);
  * ``energy``     -- per-graph energy = Σ per-node scalar readout, with
    forces = -∂E/∂pos and a combined MSE (molecule shape).

Batch dict convention (all dense, masked):
  src, dst: int32[E]; edge_mask: bool[E]; node_mask: f32[N];
  x: f32[N, d_feat]; pos: f32[N, 3]; graph_id: int32[N];
  labels: int32[N] (classification) or energy: f32[G], forces: f32[N, 3].
"""
from __future__ import annotations

import torch

from repro_torch.graph import segment_ops as so


def classification_loss(logits, batch):
    labels = batch["labels"].long()
    mask = batch["node_mask"]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.take_along_dim(logp, labels[:, None], dim=-1)[:, 0]
    denom = mask.sum().clamp_min(1)
    loss = (nll * mask).sum() / denom
    acc = ((logits.argmax(-1) == labels) * mask).sum() / denom
    return loss, {"ce": loss, "acc": acc}


def energy_force_loss(energy_fn, params, batch, n_graphs: int,
                      force_weight: float = 1.0):
    """energy_fn(params, pos, batch) -> per-graph energies [G].

    The forces are the gradient of the total energy with respect to a leaf
    copy of ``pos``, kept in the graph (``create_graph``), so the loss's
    gradient with respect to the params is a gradient of a gradient, as
    ``jax.grad`` inside the reference's loss makes it."""
    pos = batch["pos"].detach().requires_grad_()
    e = energy_fn(params, pos, batch)
    forces = -torch.autograd.grad(e.sum(), pos, create_graph=True)[0]
    e_err = ((e - batch["energy"]) ** 2).mean()
    mask = batch["node_mask"][:, None]
    f_err = (((forces - batch["forces"]) * mask) ** 2).sum() / \
        (mask.sum() * 3).clamp_min(1)
    loss = e_err + force_weight * f_err
    return loss, {"e_mse": e_err, "f_mse": f_err}


def per_graph_sum(node_scalar, graph_id, node_mask, n_graphs: int):
    return so.segment_sum(node_scalar * node_mask, graph_id, n_graphs)
