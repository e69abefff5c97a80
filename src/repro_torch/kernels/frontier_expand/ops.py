"""Frontier-expansion wrappers: the plain version for CPU tensors, the CUDA
kernel (``csrc/frontier_min.cu``) for CUDA tensors.

Replaces ``repro.kernels.frontier_expand.ops.frontier_min`` and its TPU
kernel ``segment_min_u32``.  Two entries launch the one kernel file and
count on ``frontier_min.launches``:

- :func:`frontier_min` is the TPU kernel's own signature (per-edge
  messages, uint32 values carried in int64);
- :func:`frontier_gather` fuses the gather of each edge's message into the
  kernel and holds values in 32-bit words; every round of
  ``core/reach.py`` runs through it.  Given [T, E] edges it is the
  tenant-row form (one launch for T graphs); those launches also count on
  ``frontier_min.lane_launches``.

Unlike the TPU wrapper there is no size ceiling: the scatter reads each
edge once whatever NV is.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.frontier_expand import ref

SENTINEL = ref.SENTINEL
SENT_WORD = ref.SENT_WORD
pack_bits = ref.pack_bits
unpack_bits = ref.unpack_bits
words_to_u32 = ref.words_to_u32
u32_to_words = ref.u32_to_words


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("frontier_min")
    lib.frontier_min_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.frontier_gather_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.frontier_min_launch.restype = ctypes.c_int
    lib.frontier_gather_launch.restype = ctypes.c_int
    return lib


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
        _build.check(_lib().frontier_min_launch(
            dst.data_ptr(), m2.data_ptr(), out.data_ptr(), e, f, nv,
            _build.stream_ptr(out)), "frontier_min")
        frontier_min.launches += 1
    return out[0] if squeeze else out


frontier_min.launches = 0
frontier_min.lane_launches = 0


def frontier_gather(src: torch.Tensor, dst: torch.Tensor, live: torch.Tensor,
                    val: torch.Tensor, nv: int, *, mode: str = "min",
                    impl: str = "auto") -> torch.Tensor:
    """One round of frontier expansion with the message gather fused in.

    src, dst: int32[E]; live: bool[E]; val: int32 words, [n_src] or
    [F, n_src], uint32 values read unsigned.  ``mode``:

    - ``min``: out[f, v] = min{val[f, src[e]] : live[e], dst[e] == v,
      0 <= src[e] < n_src}, SENTINEL (word -1) where nothing lands; dst
      outside ``[0, nv)`` is dropped;
    - ``pair``: val [2, NV]; row 0 as ``min`` along src -> dst, row 1 along
      dst -> src (both sweeps of a fused FW/BW round in one launch);
    - ``or``: val [W, n_src] holds frontiers packed 32 to a word
      (:func:`pack_bits`); out[w, v] = OR of val[w, src[e]] over the same
      edges, which is ``min`` over the unpacked 0 (bit set) / SENTINEL
      messages.

    Returns int32 words shaped like val with n_src replaced by nv.

    Tenant rows: src, dst, live [T, E] holding row-local vertex ids, val
    [T, n_src] or [T, F, n_src]; row t's edges read and write row t of val
    and out only.
    """
    if mode not in ref.MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of "
                         f"{ref.MODES}")
    if src.dim() == 2:
        return _gather_lanes(src, dst, live, val, nv, mode, impl)
    squeeze = val.dim() == 1
    v2 = val.unsqueeze(0) if squeeze else val
    if mode == "pair" and (v2.shape[0] != 2 or v2.shape[1] != nv):
        raise ValueError(f"pair mode takes val [2, {nv}], got "
                         f"{tuple(v2.shape)}")
    if val.device.type == "cpu":
        out = ref.frontier_gather(src, dst, live, v2, nv, mode)
    else:
        _build.require_kernel_impl(impl, "frontier_min")
        dev = val.device
        _build.require(src, "src", torch.int32, 1, dev)
        _build.require(dst, "dst", torch.int32, 1, dev)
        _build.require(live, "live", torch.bool, 1, dev)
        _build.require(v2, "val", torch.int32, 2, dev)
        e = src.shape[0]
        if dst.shape[0] != e or live.shape[0] != e:
            raise ValueError(f"src, dst and live have {e}, {dst.shape[0]} "
                             f"and {live.shape[0]} edges")
        f, n_src = v2.shape
        out = torch.empty((f, nv), dtype=torch.int32, device=dev)
        _build.check(_lib().frontier_gather_launch(
            src.data_ptr(), dst.data_ptr(), live.data_ptr(), v2.data_ptr(),
            out.data_ptr(), 1, e, f, n_src, nv, ref.MODES.index(mode),
            _build.stream_ptr(out)), "frontier_min")
        frontier_min.launches += 1
    return out[0] if squeeze else out


def _gather_lanes(src, dst, live, val, nv, mode, impl):
    squeeze = val.dim() == 2
    v3 = val.unsqueeze(1) if squeeze else val
    t, e = src.shape
    if v3.dim() != 3 or v3.shape[0] != t:
        raise ValueError(f"{t} rows of edges take val [{t}, (F,) n_src], "
                         f"got {tuple(val.shape)}")
    if mode == "pair" and (v3.shape[1] != 2 or v3.shape[2] != nv):
        raise ValueError(f"pair mode takes val [T, 2, {nv}], got "
                         f"{tuple(val.shape)}")
    if val.device.type == "cpu":
        out = ref.frontier_gather_lanes(src, dst, live, v3, nv, mode)
    else:
        _build.require_kernel_impl(impl, "frontier_min")
        dev = val.device
        _build.require(src, "src", torch.int32, 2, dev)
        _build.require(dst, "dst", torch.int32, 2, dev)
        _build.require(live, "live", torch.bool, 2, dev)
        _build.require(v3, "val", torch.int32, 3, dev)
        if dst.shape != src.shape or live.shape != src.shape:
            raise ValueError("src, dst and live must share one [T, E] shape")
        f, n_src = v3.shape[1], v3.shape[2]
        out = torch.empty((t, f, nv), dtype=torch.int32, device=dev)
        _build.check(_lib().frontier_gather_launch(
            src.data_ptr(), dst.data_ptr(), live.data_ptr(), v3.data_ptr(),
            out.data_ptr(), t, e, f, n_src, nv, ref.MODES.index(mode),
            _build.stream_ptr(out)), "frontier_min")
        frontier_min.launches += 1
        frontier_min.lane_launches += 1
    return out[:, 0] if squeeze else out
