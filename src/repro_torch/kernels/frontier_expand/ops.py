"""Frontier-expansion wrapper: the plain version for CPU tensors, the CUDA
kernel (``csrc/frontier_min.cu``) for CUDA tensors.

Replaces ``repro.kernels.frontier_expand.ops.frontier_min`` and its TPU
kernel ``segment_min_u32``.  Unlike the TPU wrapper there is no size
ceiling: the scatter kernel reads each message once whatever NV is.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.frontier_expand import ref

SENTINEL = ref.SENTINEL


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("frontier_min").frontier_min_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def frontier_min(dst: torch.Tensor, msg: torch.Tensor, nv: int, *,
                 impl: str = "auto") -> torch.Tensor:
    """Segment-min of per-edge messages into their destination vertices.

    dst: int32[E]; msg: int64[E] or int64[F, E] holding uint32 values.
    Returns int64[NV] / int64[F, NV]: out[v] = min(msg[e] : dst[e] == v),
    SENTINEL where no edge lands; dst outside ``[0, nv)`` is dropped.
    """
    squeeze = msg.dim() == 1
    m2 = msg.unsqueeze(0) if squeeze else msg
    if msg.device.type == "cpu":
        out = ref.frontier_min(dst, m2, nv)
    else:
        _build.require_kernel_impl(impl, "frontier_min")
        dev = msg.device
        _build.require(dst, "dst", torch.int32, 1, dev)
        _build.require(m2, "msg", torch.int64, 2, dev)
        f, e = m2.shape
        if dst.shape[0] != e:
            raise ValueError(f"dst has {dst.shape[0]} edges, msg {e}")
        out = torch.empty((f, nv), dtype=torch.int64, device=dev)
        _build.check(_entry()(dst.data_ptr(), m2.data_ptr(), out.data_ptr(),
                              e, f, nv, _build.stream_ptr(out)),
                     "frontier_min")
        frontier_min.launches += 1
    return out[0] if squeeze else out


frontier_min.launches = 0
