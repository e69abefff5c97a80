"""EmbeddingBag wrapper: the plain version for CPU tensors, the CUDA kernel
(``csrc/embedding_bag.cu``) for CUDA tensors.

Replaces ``repro.kernels.embedding_bag.ops.embedding_bag`` and its TPU
kernel ``embedding_bag_counts``.  The kernel gathers the rows each bag
names instead of sweeping the vocabulary, so nothing is padded.  It reads
rows in 16-byte chunks where D is a multiple of 4 and the table's base is
16-byte aligned, and in 4-byte chunks otherwise (any D, any table view
that is contiguous): an unaligned table takes the scalar path, it is not
refused.

The kernel computes the forward; the gradient (``EmbeddingBagFn``,
``backward``) is plain torch, as the reference's is XLA's own.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag import ref


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("embedding_bag").embedding_bag_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def vector_rows(table: torch.Tensor) -> bool:
    """Whether the kernel reads ``table`` in 16-byte chunks: D a multiple
    of 4 (rows start 16 bytes apart) and a 16-byte-aligned base."""
    return table.shape[1] % 4 == 0 and table.data_ptr() % 16 == 0


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, *,
                  mode: str = "sum", weights: Optional[torch.Tensor] = None,
                  impl: str = "auto") -> torch.Tensor:
    """table: f32[V, D]; ids: int32[B, L], -1 = padding -> f32[B, D].

    out[b] = sum_l w[b,l] * table[ids[b,l]] over ids in [0, V); ``mean``
    divides by max(#ids >= 0, 1); ``max`` is refused, as by the reference.
    Differentiable in ``table`` and ``weights``: on a card the kernel runs
    inside :class:`EmbeddingBagFn`, whose backward is :func:`backward`.
    """
    if ids.device.type == "cpu":
        return ref.embedding_bag(table, ids, mode=mode, weights=weights)
    ref.check_mode(mode)
    _build.require_kernel_impl(impl, "embedding_bag")
    _build.require(table, "table", torch.float32, 2, ids.device)
    _build.require(ids, "ids", torch.int32, 2, ids.device)
    if weights is not None:
        _build.require(weights, "weights", torch.float32, 2, ids.device)
        if weights.shape != ids.shape:
            raise ValueError(f"weights {tuple(weights.shape)} and ids "
                             f"{tuple(ids.shape)} differ")
    return EmbeddingBagFn.apply(table, weights, ids, mode, _launch)


def _launch(table: torch.Tensor, ids: torch.Tensor, mode: str,
            weights: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel on checked CUDA tensors."""
    (b, l), (v, d) = ids.shape, table.shape
    out = torch.empty((b, d), dtype=torch.float32, device=ids.device)
    _build.check(_entry()(
        ids.data_ptr(), None if weights is None else weights.data_ptr(),
        table.data_ptr(), out.data_ptr(), b, l, v, d, int(mode == "mean"),
        int(vector_rows(table)), _build.stream_ptr(out)), "embedding_bag")
    embedding_bag.launches += 1
    return out


embedding_bag.launches = 0


class EmbeddingBagFn(torch.autograd.Function):
    """A bag whose forward is ``forward(table, ids, mode, weights)`` (the
    kernel launch on a card; a test may hand it the plain version) and
    whose backward is :func:`backward`, plain torch: the reference has no
    backward kernel, its gradient is XLA's scatter-add from autodiff of
    ``take`` + ``segment_sum``."""

    @staticmethod
    def forward(ctx, table, weights, ids, mode: str, forward):
        ctx.mode = mode
        ctx.save_for_backward(table, weights, ids)
        return forward(table, ids, mode, weights)

    @staticmethod
    def backward(ctx, grad):
        table, weights, ids = ctx.saved_tensors
        d_table, d_weights = backward(
            table, ids, ctx.mode, weights, grad,
            table_grad=ctx.needs_input_grad[0],
            weights_grad=ctx.needs_input_grad[1])
        return d_table, d_weights, None, None, None


def backward(table: torch.Tensor, ids: torch.Tensor, mode: str,
             weights: Optional[torch.Tensor], grad: torch.Tensor, *,
             table_grad: bool = True, weights_grad: bool = False):
    """(d table, d weights) of the bag for the output gradient ``grad``
    [B, D]: each (bag, id) pair adds grad[b] x its weight (/ the bag's
    count in ``mean``) into table row ids[b, l] (``index_add_``); padding
    and ids >= V go to a junk row, cut off.  d weights[b, l] is row
    ids[b, l] . grad[b] (/ the count), 0 for padding.  A gradient not asked
    for is None."""
    n_rows, d = table.shape
    valid = (ids >= 0) & (ids < n_rows)
    scale = valid.to(grad.dtype)
    if mode == "mean":
        scale = scale / (ids >= 0).sum(1, keepdim=True).clamp_min(1).to(
            grad.dtype)
    d_table = d_weights = None
    if table_grad:
        w = scale if weights is None else scale * weights.to(grad.dtype)
        rows = torch.where(valid, ids.long(), n_rows).reshape(-1)
        d_table = torch.zeros((n_rows + 1, d), dtype=grad.dtype,
                              device=grad.device)
        d_table.index_add_(0, rows, (grad[:, None, :] * w[..., None])
                           .reshape(-1, d))
        d_table = d_table[:n_rows].to(table.dtype)
    if weights_grad:
        safe = torch.where(valid, ids.long(), 0)
        d_weights = ((table[safe].to(grad.dtype) * grad[:, None, :]).sum(-1)
                     * scale).to(weights.dtype)
    return d_table, d_weights
