"""Edge-table wrappers: the plain versions for CPU tensors, the CUDA kernels
(``csrc/hash_probe.cu``) for CUDA tensors.

Replaces ``repro.kernels.hash_probe.ops.probe`` and its TPU kernel
``probe_sweep``, and runs the claim rounds of ``repro.core.edge_table``'s
insert and remove, which the JAX package leaves to XLA.  The walk reads
each lane's chain only, so there is no table size ceiling (the TPU wrapper
stopped at 2^16 slots).  ``insert`` and ``remove`` are one cooperative
launch each and read nothing back to the host.  Every launch is counted on
its wrapper's ``launches`` (``kernels.launch_counts()`` reports the three
together as ``hash_probe``).

Each entry also takes T tenant tables at once: columns [T, C] in one
allocation and lanes [T, B], lane (t, j) working in row t only, in the
same one launch; those launches count on ``lane_launches`` as well.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hash_probe import ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    fn = getattr(_build.load("hash_probe"), name)
    fn.argtypes = {
        "hash_probe_launch": [_P] * 8 + [_I, _I, _L, _I, _P],
        "hash_insert_launch": [_P] * 10 + [_I, _I, _L, _I, _P],
        "hash_remove_launch": [_P] * 9 + [_I, _I, _L, _I, _P],
    }[name]
    fn.restype = ctypes.c_int
    return fn


def _check_args(src, dst, state, base, u, v, max_probes, enable=None):
    """(device, C, T, B): columns [C] with lanes [B] (T = 1), or columns
    [T, C] with lanes [T, B]."""
    dev = u.device
    nd = src.dim()
    if nd not in (1, 2):
        raise ValueError("table columns are [C] or [T, C]")
    cap = src.shape[-1]
    t = src.shape[0] if nd == 2 else 1
    b = u.shape[-1]
    lanes = (("u", u), ("v", v)) + ((("base", base),) if base is not None
                                    else ())
    for name, x in (("src", src), ("dst", dst)) + lanes:
        _build.require(x, name, torch.int32, nd, dev)
    _build.require(state, "state", torch.int8, nd, dev)
    if enable is not None:
        _build.require(enable, "enable", torch.bool, nd, dev)
        lanes += (("enable", enable),)
    if cap & (cap - 1) or dst.shape != src.shape or \
            state.shape != src.shape:
        raise ValueError("table columns must share a power-of-two length")
    if cap > 2 ** 30 or t * cap > 2 ** 31:
        raise ValueError("table capacity above 2^30 or 2^31 slots in all")
    if any(x.shape != u.shape for _, x in lanes) or \
            (nd == 2 and u.shape[0] != t):
        raise ValueError("base, u, v and enable must share one [T, B] "
                         "lane shape, one row per table")
    if max_probes < 0:
        raise ValueError("max_probes must be >= 0")
    return dev, cap, t, b


def _count(fn, src):
    fn.launches += 1
    if src.dim() == 2:
        fn.lane_launches += 1


def probe(src, dst, state, base, u, v, *, max_probes: int,
          impl: str = "auto"):
    """Batched open-addressing membership probe.

    src/dst: int32[C], state: int8[C] (0=EMPTY/1=LIVE/2=TOMB), base:
    int32[B] hashed start slots, u/v: int32[B] keys; C a power of two.
    Returns ``(found: bool[B], slot: int32[B])`` with
    ``repro.core.edge_table.lookup`` semantics; [T, C] columns take [T, B]
    lanes and give row-local slots.
    """
    if u.device.type == "cpu":
        return ref.probe(src, dst, state, base, u, v, max_probes=max_probes)
    _build.require_kernel_impl(impl, "hash_probe")
    dev, cap, t, b = _check_args(src, dst, state, base, u, v, max_probes)
    found = torch.empty(u.shape, dtype=torch.bool, device=dev)
    slot = torch.empty(u.shape, dtype=torch.int32, device=dev)
    _build.check(_entry("hash_probe_launch")(
        src.data_ptr(), dst.data_ptr(), state.data_ptr(), base.data_ptr(),
        u.data_ptr(), v.data_ptr(), found.data_ptr(), slot.data_ptr(), t,
        b, cap, max_probes, _build.stream_ptr(slot)), "hash_probe")
    _count(probe, src)
    return found, slot


def insert(src, dst, state, u, v, enable, *, max_probes: int,
           impl: str = "auto"):
    """The insert's hash, lookup and claim rounds, writing the winners into
    ``src``, ``dst`` and ``state`` IN PLACE (the caller hands in clones).

    ``enable``: bool[B], already free of intra-batch duplicates.  Returns
    ``(placed: bool[B], failed: bool[B], rounds)`` with
    ``repro.core.edge_table.insert`` semantics; ``rounds`` is a 0-d int32
    tensor on the lanes' device (the rounds run until no lane was
    pending).
    """
    if u.device.type == "cpu":
        return ref.insert(src, dst, state, u, v, enable,
                          max_probes=max_probes)
    _build.require_kernel_impl(impl, "hash_probe")
    dev, cap, t, b = _check_args(src, dst, state, None, u, v, max_probes,
                                 enable)
    placed = torch.empty(u.shape, dtype=torch.bool, device=dev)
    failed = torch.empty(u.shape, dtype=torch.bool, device=dev)
    counts = torch.zeros(max_probes + 2, dtype=torch.int32, device=dev)
    if t * b == 0:
        return placed, failed, counts[-1]
    claims = torch.empty(2 * t * cap, dtype=torch.int32, device=dev)
    _build.check(_entry("hash_insert_launch")(
        src.data_ptr(), dst.data_ptr(), state.data_ptr(), u.data_ptr(),
        v.data_ptr(), enable.data_ptr(), placed.data_ptr(),
        failed.data_ptr(), claims.data_ptr(), counts.data_ptr(), t, b, cap,
        max_probes, _build.stream_ptr(placed)), "hash_insert")
    _count(insert, src)
    return placed, failed, counts[-1]


def remove(src, dst, state, u, v, enable, *, max_probes: int,
           impl: str = "auto"):
    """Remove's hash, lookup, lowest-lane claim of each hit slot and TOMB
    write, writing into ``state`` IN PLACE (the caller hands in a clone).
    Returns ``removed: bool[B]``; of duplicate removals of one key only the
    lowest enabled lane succeeds."""
    if u.device.type == "cpu":
        return ref.remove(src, dst, state, u, v, enable,
                          max_probes=max_probes)
    _build.require_kernel_impl(impl, "hash_probe")
    dev, cap, t, b = _check_args(src, dst, state, None, u, v, max_probes,
                                 enable)
    removed = torch.empty(u.shape, dtype=torch.bool, device=dev)
    if t * b == 0:
        return removed
    slots = torch.empty(u.shape, dtype=torch.int32, device=dev)
    claims = torch.empty(t * cap, dtype=torch.int32, device=dev)
    _build.check(_entry("hash_remove_launch")(
        src.data_ptr(), dst.data_ptr(), state.data_ptr(), u.data_ptr(),
        v.data_ptr(), enable.data_ptr(), removed.data_ptr(),
        slots.data_ptr(), claims.data_ptr(), t, b, cap, max_probes,
        _build.stream_ptr(removed)), "hash_remove")
    _count(remove, src)
    return removed


for _fn in (probe, insert, remove):
    _fn.launches = 0
    _fn.lane_launches = 0
