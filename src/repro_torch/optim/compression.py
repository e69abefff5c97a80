"""int8 error-feedback gradient compression, as
``repro.optim.compression``.

Protocol per tensor:  e' = g + err;  q = round(e' / s), s = max|e'| / 127;
transmit (q, s);  err <- e' - q*s.  On one host (``axis_name=None``) the
gradients are quantized and dequantized locally, as the reference does,
so the error-feedback dynamics run end to end.  Over a named axis of the
current mesh (``sharding.use_mesh``) the dequantized gradients are
averaged across that axis's ranks, the reference's ``pmean``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.sharding import current_mesh
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class EFState(NamedTuple):
    err: Any  # f32 tree shaped as the grads


def init(grads_like) -> EFState:
    return EFState(err=tree_map(
        lambda g: torch.zeros_like(g, dtype=torch.float32,
                                   memory_format=torch.contiguous_format),
        grads_like))


def compress(g: torch.Tensor, err: torch.Tensor):
    """(q int8, scale f32[], new err f32)."""
    e = g.float() + err
    scale = torch.clamp(e.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(e / scale), -127, 127).to(torch.int8)
    new_err = e - q.float() * scale
    return q, scale, new_err


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _axis_group(axis_name: str):
    mesh = current_mesh()
    if mesh is None:
        raise ValueError(f"compressed_psum over {axis_name!r}: no mesh is "
                         f"current (sharding.use_mesh)")
    return mesh.get_group(axis_name)


def compressed_psum(grads, ef: EFState, axis_name: Optional[str]):
    """Quantize -> (mean over ``axis_name``) -> dequantize with error
    feedback; returns (grads in their own dtypes, new EFState).  Each
    rank's grads are its own plain tensors, as inside the reference's
    per-replica step."""
    group = None if axis_name is None else _axis_group(axis_name)
    out_g, out_e = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(ef.err)):
        q, s, ne = compress(g, e)
        deq = decompress(q, s)
        if group is not None:
            # SUM then divide: gloo has no AVG
            dist.all_reduce(deq, op=dist.ReduceOp.SUM, group=group)
            deq = deq / dist.get_world_size(group)
        out_g.append(deq.to(g.dtype))
        out_e.append(ne)
    return (tree_unflatten(grads, out_g),
            EFState(err=tree_unflatten(ef.err, out_e)))
