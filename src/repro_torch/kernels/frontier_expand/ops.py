"""Frontier-expansion wrappers: the plain version for CPU tensors, the CUDA
kernel (``csrc/frontier_min.cu``) for CUDA tensors.

Replaces ``repro.kernels.frontier_expand.ops.frontier_min`` and its TPU
kernel ``segment_min_u32``, and the ``lax.while_loop`` around it in
``repro.core.reach._fixpoint``.  Three entries launch the one kernel file
and count on ``frontier_min.launches``:

- :func:`frontier_min` is the TPU kernel's own signature (per-edge
  messages, uint32 values carried in int64);
- :func:`frontier_gather` fuses the gather of each edge's message into the
  kernel and holds values in 32-bit words; every round of
  ``core/reach.py``'s per-round loop runs through it.  Given [T, E] edges
  it is the tenant-row form (one launch for T graphs); those launches also
  count on ``frontier_min.lane_launches``;
- :func:`frontier_fixpoint` runs every round of one of ``core/reach.py``'s
  sweeps (``ref.FORMS``) in one cooperative launch with no host read; its
  launches also count on ``frontier_min.fixpoint_launches``, and the
  rounds it ran on the card add up by form in a device counter
  (:func:`fixpoint_rounds`).  Its ``scc`` form runs the whole static SCC
  of ``core/scc.py`` (the outer loop, trim and both sweeps) in one launch,
  counted apart too, on ``frontier_min.scc_launches``.

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
    lib.frontier_fixpoint_launch.argtypes = [ctypes.c_void_p] * 17 + [
        ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    for fn in (lib.frontier_min_launch, lib.frontier_gather_launch,
               lib.frontier_fixpoint_launch):
        fn.restype = ctypes.c_int
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
        _build.count(frontier_min, "launches")
    return out[0] if squeeze else out


frontier_min.launches = 0
frontier_min.lane_launches = 0
frontier_min.fixpoint_launches = 0
frontier_min.scc_launches = 0


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
        _build.count(frontier_min, "launches")
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
        _build.count(frontier_min, "launches", "lane_launches")
    return out[:, 0] if squeeze else out


# per form: the rows of its state (F; None: the state's own) and its dtype
_FORM_STATE = {"reach": (1, torch.bool), "pair": (2, torch.bool),
               "label": (1, torch.int32), "prio": (1, torch.int64),
               "or": (None, torch.int32), "trim": (1, torch.bool),
               "scc": (1, torch.bool)}
# device -> int64[len(FORMS)]: rounds the fixpoint launches ran, by form
_rounds_run: dict = {}


def _tally(dev):
    """The device's round counter, made by the first launch on ``dev``.
    That launch must not be captured: a counter made inside a capture
    would be zeroed by every replay, so the capture raises instead."""
    t = _rounds_run.get(dev)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "frontier_fixpoint: the first launch on a card must run "
                "outside a CUDA graph capture (it makes the card's round "
                "counter); run one launch before capturing")
        t = _rounds_run[dev] = torch.zeros(len(ref.FORMS), dtype=torch.int64,
                                           device=dev)
    return t


def fixpoint_rounds() -> dict:
    """Form -> rounds the fixpoint launches ran on the card since the last
    :func:`reset_fixpoint_rounds` (a read of each card's counter; the
    tenant-row form counts a launch's rounds once, however many lanes;
    ``scc`` counts outer rounds, its sweeps' rounds count on their own
    forms)."""
    total = dict.fromkeys(ref.FORMS, 0)
    for t in _rounds_run.values():
        for form, n in zip(ref.FORMS, t.tolist()):
            total[form] += n
    return total


def reset_fixpoint_rounds() -> None:
    for t in _rounds_run.values():
        t.zero_()


def stamp_buffer(dev, records: int = 4096) -> torch.Tensor:
    """A buffer for a fixpoint launch's part stamps (``stamps=`` of
    :func:`frontier_fixpoint`): ``records`` grid barriers."""
    buf = torch.zeros((records + 1, 4), dtype=torch.int64, device=dev)
    buf[1:, 1] = -1  # the first arrival, an atomic min
    return buf


# the barriers' kinds, in the kernel's numbering (its enum Part)
PARTS = {1: "init", 2: "edge", 3: "vertex", 4: "hop", 5: "scc", 6: "compact"}


def fixpoint_parts(buf: torch.Tensor) -> dict:
    """A stamped launch's time by part, in microseconds (%globaltimer):
    per barrier kind, ``pass_us`` from the barrier before it to the last
    block's arrival, ``wait_us`` from that arrival to the grid leaving the
    barrier, ``spread_us`` between the first and the last block's arrival,
    and ``n`` the barriers of that kind; ``grid`` the launch's blocks and
    ``total_us`` its first to its last stamp."""
    b = buf.cpu().tolist()
    grid, n, t0, t1 = b[0]
    parts = {}
    prev = t0
    for kind, first, last, after in b[1:1 + n]:
        p = parts.setdefault(PARTS.get(kind, str(kind)), dict(
            n=0, pass_us=0.0, wait_us=0.0, spread_us=0.0))
        p["n"] += 1
        p["pass_us"] += (last - prev) / 1e3
        p["wait_us"] += (after - last) / 1e3
        p["spread_us"] += (last - first) / 1e3
        prev = after
    return dict(grid=grid, barriers=n, total_us=(t1 - t0) / 1e3,
                parts=parts)


def frontier_fixpoint(form: str, src: torch.Tensor, dst: torch.Tensor,
                      live: torch.Tensor, mask, state, max_iters: int, *,
                      shortcut: bool = False, vid=None, max_outer: int = 0,
                      impl: str = "auto", stamps=None):
    """Every round of the fixpoint ``form`` (``ref.FORMS``) until a round
    changes nothing or ``max_iters`` rounds have run, as JAX's
    ``lax.while_loop`` runs it: ``(state, rounds)``, rounds int32 (0-d,
    or [T] for tenant lanes) on the state's device.

    src, dst: int32[E]; live: bool[E]; mask: bool[NV], the vertices the
    sweep stays inside (None for trim); states as ``ref.round_body``
    takes them: bool[NV] (reach), bool[2, NV] (pair), int32[NV] (label),
    uint32 values in int64 [NV] (prio), int32 words [W, NV] (or),
    (bool[NV], int32[NV]) (trim, with ``vid`` int32[NV]).  Tenant lanes:
    [T, E] edges with row-local ids, a leading [T] on states and masks.
    The input state is not written.

    ``scc``: the static SCC of the subgraph ``mask`` (the active set)
    induces, as ``ref.scc_loop``: at most ``max_outer`` outer rounds of
    trim and the two sweeps (priorities with pointer doubling under
    ``shortcut``, else min labels), each sweep capped at ``max_iters``;
    ``state`` is ignored.  Returns ``(ccid int32[NV], outer rounds)``.

    On the card one cooperative launch runs every round with no host
    read; edges whose ids fall outside ``[0, NV)`` are dropped (the plain
    version's trim takes none).  For measurement only: ``stamps``
    (:func:`stamp_buffer`) takes the launch's part stamps
    (:func:`fixpoint_parts`).
    """
    if form not in ref.FORMS:
        raise ValueError(f"unknown form {form!r}; expected one of "
                         f"{ref.FORMS}")
    first = mask if form == "scc" else (state[0] if form == "trim"
                                        else state)
    if first.device.type == "cpu":
        return ref.frontier_fixpoint(form, src, dst, live, mask, state,
                                     max_iters, shortcut=shortcut, vid=vid,
                                     max_outer=max_outer)
    _build.require_kernel_impl(impl, "frontier_min")
    dev = first.device
    lanes = src.dim() == 2
    nd = 2 if lanes else 1
    _build.require(src, "src", torch.int32, nd, dev)
    _build.require(dst, "dst", torch.int32, nd, dev)
    _build.require(live, "live", torch.bool, nd, dev)
    if dst.shape != src.shape or live.shape != src.shape:
        raise ValueError("src, dst and live must share one shape")
    t = src.shape[0] if lanes else 1
    if form == "scc":
        return _scc_launch(src, dst, live, mask.contiguous(), t, nd,
                           int(max_iters), int(max_outer), shortcut,
                           _probe(stamps))
    f, dtype = _FORM_STATE[form]
    rows = f is None or f > 1
    # the state the launch rewrites in place, as bytes or 32-bit words
    work = first.clone(memory_format=torch.contiguous_format)
    _build.require(work, "state", dtype, nd + rows, dev)
    if lanes and first.shape[0] != t:
        raise ValueError(f"{t} rows of edges take states [{t}, ...], got "
                         f"{tuple(first.shape)}")
    nv = first.shape[-1]
    f = first.shape[-2] if rows else 1
    if form == "pair" and f != 2:
        raise ValueError(f"pair takes a [2, {nv}] state per lane")
    aux = vid_ptr = mask_ptr = 0
    if form == "trim":
        ccid = state[1].clone(memory_format=torch.contiguous_format)
        _build.require(ccid, "ccid", torch.int32, nd, dev)
        _build.require(vid, "vid", torch.int32, 1, dev)
        if ccid.shape != first.shape or vid.shape[0] != nv:
            raise ValueError("trim takes ccid shaped as unassigned and "
                             f"vid [{nv}]")
        aux, vid_ptr = ccid.data_ptr(), vid.data_ptr()
    else:
        mask = mask.contiguous()
        _build.require(mask, "mask", torch.bool, nd, dev)
        if mask.shape != (*first.shape[:-1 - rows], nv):
            raise ValueError(f"mask has shape {tuple(mask.shape)} for a "
                             f"state {tuple(first.shape)}")
        mask_ptr = mask.data_ptr()
    if form == "prio":
        work = ref.u32_to_words(work)
    out = torch.empty(t * f * nv, dtype=torch.int32, device=dev)
    # a round's labels before the hop; trim's out-degrees (out its in-)
    hop = (torch.empty(t * nv, dtype=torch.int32, device=dev)
           if form in ("prio", "trim") or (form == "label" and shortcut)
           else out)
    flags = torch.empty(4 * t + 2, dtype=torch.int32, device=dev)
    rounds = torch.empty(t, dtype=torch.int32, device=dev)
    tally = _tally(dev)
    lists = _edge_lists(t, src.shape[-1], t * f * nv, dev)
    probe = _probe(stamps)
    _build.check(_lib().frontier_fixpoint_launch(
        src.data_ptr(), dst.data_ptr(), live.data_ptr(), mask_ptr,
        work.data_ptr(), aux, vid_ptr, out.data_ptr(), hop.data_ptr(),
        flags.data_ptr(), rounds.data_ptr(), tally.data_ptr(), 0,
        *(x.data_ptr() for x in lists), probe[0], t, src.shape[-1], f, nv,
        ref.FORMS.index(form), int(shortcut), max(int(max_iters), 0), 0,
        *probe[1:], _build.stream_ptr(out)), "frontier_fixpoint")
    _count_fixpoint(lanes)
    if form == "prio":
        work = ref.words_to_u32(work)
    if form == "trim":
        work = (work, ccid)
    return work, rounds if lanes else rounds[0]


def _count_fixpoint(lanes: bool, scc: bool = False) -> None:
    _build.count(frontier_min, "launches", "fixpoint_launches",
                 *(("lane_launches",) if lanes else ()),
                 *(("scc_launches",) if scc else ()))


def _edge_lists(t: int, e: int, words: int, dev) -> tuple:
    """A launch's edge-list scratch: (list int32 [T, E, 2], the listed
    edges, (src, dst) a row, room for every slot; count int32 [T]; last
    uint8 [words], the round each state word last changed in).  Inside a
    step graph's capture these come from the graph's pool, whose blocks
    the launches of one replay share in turn."""
    return (torch.empty((t, e, 2), dtype=torch.int32, device=dev),
            torch.empty(t, dtype=torch.int32, device=dev),
            torch.empty(words, dtype=torch.uint8, device=dev))


def _probe(stamps) -> tuple:
    """The launch's measurement arguments: (stamps pointer, records)."""
    if stamps is None:
        return 0, 0
    return stamps.data_ptr(), stamps.shape[0] - 1


def _scc_launch(src, dst, live, active, t, nd, max_inner, max_outer,
                shortcut, probe=(0, 0)):
    """The scc form's launch: (ccid, outer rounds)."""
    dev = active.device
    _build.require(active, "mask", torch.bool, nd, dev)
    nv = active.shape[-1]
    if (nd == 2 and active.shape[0] != t) or (nv >= ref.SENT_PREIMAGE
                                              and shortcut):
        raise ValueError(f"scc takes a mask [{t}, NV] per row of edges "
                         "(NV below the priority sentinel)"
                         if nd == 2 else "vertex ids must stay below the "
                         "priority sentinel")
    n = t * nv
    un = torch.empty(active.shape, dtype=torch.bool, device=dev)
    ccid = torch.empty(active.shape, dtype=torch.int32, device=dev)
    vid = torch.arange(nv, dtype=torch.int32, device=dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    hop = torch.empty(n, dtype=torch.int32, device=dev)
    flags = torch.empty(4 * t + 2, dtype=torch.int32, device=dev)
    rounds = torch.empty(t, dtype=torch.int32, device=dev)
    work = torch.empty(3 * n + 3 * t + 2, dtype=torch.int32, device=dev)
    tally = _tally(dev)
    lists = _edge_lists(t, src.shape[-1], n, dev)
    _build.check(_lib().frontier_fixpoint_launch(
        src.data_ptr(), dst.data_ptr(), live.data_ptr(), active.data_ptr(),
        un.data_ptr(), ccid.data_ptr(), vid.data_ptr(), out.data_ptr(),
        hop.data_ptr(), flags.data_ptr(), rounds.data_ptr(),
        tally.data_ptr(), work.data_ptr(), *(x.data_ptr() for x in lists),
        probe[0], t, src.shape[-1], 1, nv, ref.FORMS.index("scc"),
        int(shortcut), max(max_inner, 0), max(max_outer, 0), *probe[1:],
        _build.stream_ptr(ccid)), "frontier_fixpoint")
    _count_fixpoint(nd == 2, scc=True)
    return ccid, rounds if nd == 2 else rounds[0]
