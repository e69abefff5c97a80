"""Hash-probe wrapper: the plain version for CPU tensors, the CUDA kernel
(``csrc/hash_probe.cu``) for CUDA tensors.

Replaces ``repro.kernels.hash_probe.ops.probe`` and its TPU kernel
``probe_sweep``.  The kernel walks each lane's chain, so there is no table
size ceiling (the TPU wrapper stopped at 2^16 slots).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hash_probe import ref


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("hash_probe").hash_probe_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def probe(src, dst, state, base, u, v, *, max_probes: int,
          impl: str = "auto"):
    """Batched open-addressing membership probe.

    src/dst: int32[C], state: int8[C] (0=EMPTY/1=LIVE/2=TOMB), base:
    int32[B] hashed start slots, u/v: int32[B] keys; C a power of two.
    Returns ``(found: bool[B], slot: int32[B])`` with
    ``repro.core.edge_table.lookup`` semantics.
    """
    if u.device.type == "cpu":
        return ref.probe(src, dst, state, base, u, v, max_probes=max_probes)
    _build.require_kernel_impl(impl, "hash_probe")
    dev = u.device
    cap = src.shape[0]
    b = u.shape[0]
    for name, t in (("src", src), ("dst", dst), ("base", base), ("u", u),
                    ("v", v)):
        _build.require(t, name, torch.int32, 1, dev)
    _build.require(state, "state", torch.int8, 1, dev)
    if cap & (cap - 1) or dst.shape[0] != cap or state.shape[0] != cap:
        raise ValueError("table columns must share a power-of-two length")
    if base.shape[0] != b or v.shape[0] != b:
        raise ValueError("base, u and v must share one lane count")
    found = torch.empty(b, dtype=torch.bool, device=dev)
    slot = torch.empty(b, dtype=torch.int32, device=dev)
    _build.check(_entry()(src.data_ptr(), dst.data_ptr(), state.data_ptr(),
                          base.data_ptr(), u.data_ptr(), v.data_ptr(),
                          found.data_ptr(), slot.data_ptr(), b, cap,
                          max_probes, _build.stream_ptr(slot)),
                 "hash_probe")
    probe.launches += 1
    return found, slot


probe.launches = 0
