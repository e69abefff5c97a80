"""Boolean mat-mul wrapper: the plain version for CPU tensors, the CUDA
kernel (``csrc/bool_matmul.cu``) for CUDA tensors.

Replaces ``repro.kernels.reach_blockmm.ops.bool_matmul`` and its TPU
kernel ``bool_matmul_f32``, and the two functions built on it there,
``frontier_step`` and ``closure`` (each product one kernel launch on a
card).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.reach_blockmm import ref


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("bool_matmul").bool_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bool_matmul(a: torch.Tensor, b: torch.Tensor, *, impl: str = "auto"
                ) -> torch.Tensor:
    """Boolean-semiring product of bool[M,K] @ bool[K,N] -> bool[M,N]."""
    if a.device.type == "cpu":
        return ref.bool_matmul(a, b)
    _build.require_kernel_impl(impl, "bool_matmul")
    _build.require(a, "a", torch.bool, 2, a.device)
    _build.require(b, "b", torch.bool, 2, a.device)
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"inner dims differ: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    out = torch.empty((m, n), dtype=torch.bool, device=a.device)
    _build.check(_entry()(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n,
                          k, _build.stream_ptr(out)), "bool_matmul")
    _build.count(bool_matmul, "launches")
    return out


bool_matmul.launches = 0


def frontier_step(adj: torch.Tensor, frontier: torch.Tensor, *,
                  impl: str = "auto") -> torch.Tensor:
    """One synchronous reachability round: F' = (Aᵀ F) ∨ F."""
    return bool_matmul(adj.T.contiguous(), frontier, impl=impl) | frontier


def closure(adj: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """Reflexive-transitive closure by repeated squaring (log2 N
    products)."""
    n = adj.shape[0]
    r = adj | torch.eye(n, dtype=torch.bool, device=adj.device)
    for _ in range(max(1, (n - 1).bit_length())):
        r = bool_matmul(r, r, impl=impl)
    return r
