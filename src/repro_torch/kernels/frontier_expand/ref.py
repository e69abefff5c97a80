"""Plain PyTorch version of the frontier-expansion segment-min, in its
direct form (per-edge messages) and its gather form (per-vertex values,
the message gathered along each edge).

torch has no uint32 min or shift.  The direct form carries uint32 messages
in int64, values in ``[0, 2^32)``.  The gather form holds uint32 values in
32-bit words (int32 tensors whose bits are read unsigned), the kernel's
carrier; :func:`words_to_u32` and :func:`u32_to_words` convert.
``SENTINEL`` is the min-semiring identity; its word is -1.

The fixpoint form (:func:`frontier_fixpoint`, the plain version of the
kernel's ``frontier_fixpoint_launch``) runs every round of one of the
SMSCC sweeps, :data:`FORMS`, until a round changes nothing or
``max_iters`` rounds have run.  :func:`round_body` is each form's round,
written once: the kernel's plain version runs it over the plain gather,
``core/reach.py``'s per-round loop over the gather's wrapper.
:func:`scc_loop` is the ``scc`` form's outer loop, written once too: the
plain version runs it over the plain fixpoints, ``core/scc.py`` over
``core/reach.py``'s for CPU tensors and DTensors.  :func:`fixpoint_schedule`
is the kernel's own schedule in plain torch (the first round over every
slot, later rounds over the listed edges, only changed sources sending),
which the CPU tests hold to the JAX sweeps exactly.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.u32 import mul32

SENTINEL = 0xFFFFFFFF
SENT_WORD = -1  # SENTINEL's 32-bit word
MODES = ("min", "pair", "or")
INT32_MAX = 2 ** 31 - 1
# the fixpoint forms, in the kernel's order: boolean reachability, the
# fused FW/BW pair, min-label propagation (optionally pointer doubling),
# hashed-priority witnesses, packed Reachable batches, trim's peel, and
# the whole static SCC (its outer loop over trim and the two sweeps)
FORMS = ("reach", "pair", "label", "prio", "or", "trim", "scc")

# Bijective priority hash (odd multiplier mod 2^32) and its inverse: the
# JAX package's hashed priorities, so pointer doubling collapses monotone
# id runs.  Priorities use all 32 bits and are held as uint32 values in
# int64, so torch compares them unsigned; they pass to the kernel as words.
P_MUL = 0x9E3779B1
P_INV = pow(P_MUL, -1, 2 ** 32)
PRIO_SENT = 0xFFFFFFFF
SENT_PREIMAGE = (0xFFFFFFFF * P_INV) % (2 ** 32)


def frontier_min(dst: torch.Tensor, msg: torch.Tensor, nv: int
                 ) -> torch.Tensor:
    """out[f, v] = min(msg[f, e] : dst[e] == v), SENTINEL where no edge
    lands.  dst: int32[E] (entries outside ``[0, nv)`` are dropped, as the
    TPU kernel drops its -1 padding); msg: int64[F, E] -> int64[F, NV]."""
    f, e = msg.shape
    idx = torch.where((dst >= 0) & (dst < nv), dst.long(), nv)
    out = torch.full((f, nv + 1), SENTINEL, dtype=torch.int64,
                     device=msg.device)
    out.scatter_reduce_(1, idx.expand(f, e), msg, reduce="amin")
    return out[:, :nv].contiguous()


def words_to_u32(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> their uint32 values, in int64."""
    return words.long() & SENTINEL


def u32_to_words(x: torch.Tensor) -> torch.Tensor:
    """uint32 values in int64 -> int32 words (two's-complement wrap)."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).int()


def gather_min(src, dst, live, val, nv: int) -> torch.Tensor:
    """out[f, v] = min{val[f, src[e]] : live[e], dst[e] == v, 0 <= src[e]
    < n_src}, SENTINEL where nothing lands: the message of each edge built
    as the JAX package builds it, then :func:`frontier_min`.  val: int32
    words [F, n_src] -> int32 words [F, NV]."""
    n_src = val.shape[1]
    ok = live & (src >= 0) & (src < n_src)
    # a dropped edge reads the SENTINEL column n_src
    padded = torch.cat([words_to_u32(val), torch.full(
        (val.shape[0], 1), SENTINEL, dtype=torch.int64, device=val.device)],
        dim=1)
    msg = padded[:, torch.where(ok, src, n_src).long()]
    return u32_to_words(frontier_min(dst, msg, nv))


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """bool[Q, N] -> int32 words [ceil(Q / 32), N]: bit q of word w is row
    32 w + q."""
    q, n = mask.shape
    w = -(-q // 32)
    rows = torch.zeros((w * 32, n), dtype=torch.int64, device=mask.device)
    rows[:q] = mask
    weight = torch.ones(32, dtype=torch.int64, device=mask.device) << \
        torch.arange(32, device=mask.device)
    return u32_to_words((rows.view(w, 32, n) * weight[:, None]).sum(1))


def unpack_bits(words: torch.Tensor, q: int) -> torch.Tensor:
    """int32 words [W, N] -> bool[q, N], the inverse of :func:`pack_bits`."""
    w, n = words.shape
    shift = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, None, :] >> shift[:, None]) & 1
    return bits.reshape(w * 32, n)[:q].bool()


def frontier_gather(src, dst, live, val, nv: int, mode: str = "min"
                    ) -> torch.Tensor:
    """The gather form, by mode (see ``ops.frontier_gather``): ``min`` is
    :func:`gather_min`; ``pair`` takes row 0 along src -> dst and row 1
    along dst -> src; ``or`` unpacks each bit of val into a frontier of
    0 (reached) / SENTINEL messages, takes their segment-min and packs
    ``incoming == 0`` back."""
    if mode == "min":
        return gather_min(src, dst, live, val, nv)
    if mode == "pair":
        return torch.cat([gather_min(src, dst, live, val[:1], nv),
                          gather_min(dst, src, live, val[1:], nv)])
    if mode == "or":
        reached = unpack_bits(val, 32 * val.shape[0])
        inc = gather_min(src, dst, live, reached.int() - 1, nv)
        return pack_bits(inc == 0)
    raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


def frontier_gather_lanes(src, dst, live, val, nv: int, mode: str = "min"
                          ) -> torch.Tensor:
    """The gather form over T tenant rows: src, dst, live [T, E] with
    row-local vertex ids, val int32 words [T, F, n_src] -> [T, F, nv].
    Edge e of row t reads val[t, :, src[t, e]] and writes out[t, :,
    dst[t, e]]: the rows become one graph of T x n_src vertices with row
    offsets added (an edge whose ids fall outside its row is dropped
    first), through :func:`frontier_gather`."""
    t, e = src.shape
    f, n_src = val.shape[1], val.shape[2]
    row = torch.arange(t, dtype=torch.int32, device=src.device)[:, None]
    keep = live & (src >= 0) & (src < n_src) & (dst >= 0) & (dst < nv)
    fsrc = torch.where(keep, src + row * n_src, -1).reshape(-1)
    fdst = torch.where(keep, dst + row * nv, -1).reshape(-1)
    flat = val.permute(1, 0, 2).reshape(f, t * n_src)
    out = frontier_gather(fsrc, fdst, keep.reshape(-1), flat, t * nv, mode)
    return out.reshape(f, t, nv).permute(1, 0, 2).contiguous()


def gather(src, dst, live, val, nv: int, mode: str = "min") -> torch.Tensor:
    """The gather form with the wrapper's shapes: val [n_src] or [F,
    n_src]; given [T, E] edges, tenant rows with val [T, n_src] or [T, F,
    n_src]."""
    lanes = src.dim() == 2
    squeeze = val.dim() == (2 if lanes else 1)
    v = val.unsqueeze(-2) if squeeze else val
    out = (frontier_gather_lanes if lanes else frontier_gather)(
        src, dst, live, v, nv, mode)
    return out.squeeze(-2) if squeeze else out


def prio(v: torch.Tensor) -> torch.Tensor:
    return mul32(v.long(), P_MUL)


def unprio(p: torch.Tensor) -> torch.Tensor:
    """The inverse hash as int32 with two's-complement wrap, as JAX's
    uint32 -> int32 astype gives it."""
    return u32_to_words(mul32(p, P_INV))


def take(x, idx):
    """``x[idx]``, per tenant row for [T, ...] ``x`` (a gather along the
    last axis)."""
    return x[idx] if x.dim() == 1 else x.gather(-1, idx.long())


def _changed(new, old, lanes: bool):
    """Whether a round changed anything: a scalar, or one flag per tenant
    lane."""
    diff = new != old
    return diff.flatten(1).any(1) if lanes else diff.any()


def _trim_round(src, dst, live, state, vid, lanes: bool):
    unassigned, ccid = state
    emask = (live & take(unassigned, src) & take(unassigned, dst)).int()
    zero = torch.zeros(unassigned.shape, dtype=torch.int32,
                       device=emask.device)
    if lanes:  # each lane counts its own row
        indeg = zero.scatter_add(1, dst.long(), emask)
        outdeg = zero.scatter_add(1, src.long(), emask)
    else:
        indeg = zero.index_add(0, dst, emask)
        outdeg = zero.index_add(0, src, emask)
    peel = unassigned & ((indeg == 0) | (outdeg == 0))
    return (unassigned & ~peel, torch.where(peel, vid, ccid)), peel.any(-1)


def round_body(form: str, src, dst, live, mask, state, *,
               shortcut: bool = False, vid=None,
               gather: Callable = gather):
    """One round of the fixpoint ``form``: (next, changed).  ``mask`` is
    the vertex mask the sweep stays inside (``allowed`` / ``active``,
    bool[NV]); ``gather`` computes the round's segment-min (or OR) with
    :func:`gather`'s signature.  States, as ``core/reach.py`` holds them:

    - ``reach``: bool[NV] reached; ``pair``: bool[2, NV], row 0 forward,
      row 1 backward;
    - ``label``: int32[NV] labels, an incoming word read as a negative
      int32 (a uint32 >= 2^31) clamped to INT32_MAX as JAX's
      ``minimum(incoming, INT32_MAX)`` does; ``shortcut`` adds pointer
      doubling lab[v] <- min(lab[v], lab[lab[v]]);
    - ``prio``: uint32 priorities in int64, then the hop through the
      witness ``unprio(lab[v])``;
    - ``or``: Q frontiers packed 32 to a word, int32[W, NV];
    - ``trim``: (unassigned bool[NV], ccid int32[NV]); a vertex with no
      in- or no out-edge inside the unassigned set is peeled to ``vid``.

    Tenant lanes: edges [T, C] with row-local ids and every state and
    mask with a leading [T]; ``changed`` is then bool[T]."""
    lanes = src.dim() == 2
    if form == "trim":
        return _trim_round(src, dst, live, state, vid, lanes)
    nv = mask.shape[-1]
    if form in ("reach", "pair"):
        inc = gather(src, dst, live, state.int() - 1, nv,
                     mode="pair" if form == "pair" else "min")
        nxt = state | ((inc == 0) & (mask.unsqueeze(-2) if form == "pair"
                                     else mask))
    elif form == "or":
        inc = gather(src, dst, live, state, nv, mode="or")
        # all 32 bits where allowed (word -1), none elsewhere
        nxt = state | (inc & -mask.int().unsqueeze(-2))
    elif form == "label":
        inc = gather(src, dst, live, torch.where(mask, state, SENT_WORD), nv)
        inc = torch.where(inc < 0, INT32_MAX, inc)
        nxt = torch.where(mask, torch.minimum(state, inc), state)
        if shortcut:
            hop = take(nxt, nxt.clamp(0, nv - 1))
            nxt = torch.where(mask & (nxt < INT32_MAX),
                              torch.minimum(nxt, hop), nxt)
    elif form == "prio":
        inc = words_to_u32(gather(
            src, dst, live, u32_to_words(torch.where(mask, state, PRIO_SENT)),
            nv))
        nxt = torch.where(mask, torch.minimum(state, inc), state)
        hop = take(nxt, unprio(nxt).clamp(0, nv - 1))
        nxt = torch.where(mask & (nxt != PRIO_SENT),
                          torch.minimum(nxt, hop), nxt)
    else:
        raise ValueError(f"unknown form {form!r}; expected one of {FORMS}")
    return nxt, _changed(nxt, state, lanes)


def _freeze(active, new, old):
    if isinstance(new, tuple):
        return tuple(_freeze(active, n, o) for n, o in zip(new, old))
    return torch.where(active.view(-1, *([1] * (new.dim() - 1))), new, old)


def fixpoint_loop(body, init, max_iters: int, lanes: bool, read=bool):
    """JAX's ``while changed and rounds < max_iters: state, changed =
    body(state)`` as a host loop, ``read`` bringing each round's flag to
    the host.  Returns (state, rounds): int32, 0-d or [T] for tenant
    lanes.  A lane leaves the loop after its first unchanged round and
    keeps its state from then on (``torch.where(active, new, old)``); the
    loop ends when no lane is active or at ``max_iters``, so each lane's
    state and rounds are its solo run's."""
    first = init[0] if isinstance(init, tuple) else init
    if not lanes:
        state, it, changed = init, 0, True
        while changed and it < max_iters:
            state, ch = body(state)
            changed = read(ch)
            it += 1
        return state, torch.tensor(it, dtype=torch.int32,
                                   device=first.device)
    state = init
    rounds = torch.zeros(first.shape[0], dtype=torch.int32,
                         device=first.device)
    active = torch.ones_like(rounds, dtype=torch.bool)
    for _ in range(max_iters):
        new, ch = body(state)
        state = _freeze(active, new, state)
        rounds = rounds + active.int()
        active = active & ch
        if not read(active.any()):
            break
    return state, rounds


def _tally(tally, form, rounds, on) -> None:
    """tally[form] += the rounds the sweep ran: the most any lane that
    takes part ran (a launch over lanes counts its rounds once)."""
    if tally is not None:
        tally[form] = tally.get(form, 0) + int(
            (rounds * on).max() if rounds.dim() else rounds)


def scc_loop(src, dst, live, active, max_outer: int, max_inner: int, *,
             shortcut: bool = False, fix=None, read=bool, tally=None):
    """The static SCC of the subgraph ``active`` induces, as the JAX
    package's ``scc_static`` runs it: while some vertex is unassigned and
    fewer than ``max_outer`` rounds have run, trim (peeled vertices are
    singleton SCCs), then the forward and backward sweeps from the
    unassigned vertices (min labels; under ``shortcut`` hashed priorities
    with pointer doubling, the label the least member id of each witness
    group), and every vertex whose two sweeps agree takes its label.
    Returns ``(ccid int32[NV], outer rounds)``: labels INT32_MAX outside
    ``active`` and where ``max_outer`` ran out; rounds int32, 0-d, or [T]
    for tenant lanes ([T, C] edges, [T, NV] ``active``), each lane
    counting the rounds it had unassigned vertices at the start of (a
    lane with none passes through a round unchanged).

    ``fix(form, src, dst, live, mask, init, max_iters, shortcut=, vid=)``
    runs one fixpoint (default: the plain version); ``read`` brings the
    loop's flag to the host; ``tally`` (a dict) adds each form's rounds
    as the kernel's counter does, and ``scc`` the outer rounds."""
    fix = fix or frontier_fixpoint
    nv = active.shape[-1]
    dev = active.device
    vid = torch.arange(nv, dtype=torch.int32, device=dev)
    ccid = torch.full(active.shape, INT32_MAX, dtype=torch.int32,
                      device=dev)
    unassigned = active
    outer = torch.zeros(active.shape[:-1], dtype=torch.int32, device=dev)
    if shortcut and nv >= SENT_PREIMAGE:
        raise ValueError("vertex ids must stay below the priority sentinel")
    it = 0
    while it < max_outer and read(unassigned.any()):
        on = unassigned.any(-1)
        outer = outer + on.int()
        (unassigned, ccid), n = fix("trim", src, dst, live, None,
                                    (unassigned, ccid), max_inner, vid=vid)
        _tally(tally, "trim", n, on)
        if shortcut:
            lab0 = torch.where(unassigned, prio(vid), PRIO_SENT)
            wit = []
            for s, d in ((src, dst), (dst, src)):
                lab, n = fix("prio", s, d, live, unassigned, lab0, max_inner)
                _tally(tally, "prio", n, on)
                wit.append(torch.where(lab != PRIO_SENT, unprio(lab), nv))
            fwd, bwd = wit
            done = unassigned & (fwd == bwd) & (fwd < nv)
            # canonical label = min member id of each witness group (one
            # sentinel column per lane: groups never cross lanes)
            grp = torch.where(done, fwd, nv).long()
            min_id = torch.full((*active.shape[:-1], nv + 1), INT32_MAX,
                                dtype=torch.int32, device=dev)
            min_id.scatter_reduce_(-1, grp, torch.where(done, vid, INT32_MAX)
                                   .expand_as(grp), reduce="amin")
            ccid = torch.where(done, take(min_id, fwd.clamp(max=nv)), ccid)
        else:
            init = torch.where(unassigned, vid, INT32_MAX)
            lab = []
            for s, d in ((src, dst), (dst, src)):
                out, n = fix("label", s, d, live, unassigned, init,
                             max_inner)
                _tally(tally, "label", n, on)
                lab.append(out)
            fwd, bwd = lab
            done = unassigned & (fwd == bwd)
            ccid = torch.where(done, fwd, ccid)
        unassigned = unassigned & ~done
        it += 1
    if tally is not None:
        tally["scc"] = tally.get("scc", 0) + it
    return ccid, outer


def frontier_fixpoint(form: str, src, dst, live, mask, state,
                      max_iters: int, *, shortcut: bool = False, vid=None,
                      max_outer: int = 0, tally=None):
    """Every round of the fixpoint ``form`` (:func:`round_body`) until one
    changes nothing or ``max_iters`` have run: (state, rounds).  ``scc``
    is :func:`scc_loop` over these fixpoints, ``mask`` its active set;
    ``tally`` (a dict) adds up rounds by form as the kernel's counter
    does."""
    if form == "scc":
        return scc_loop(src, dst, live, mask, max_outer, max_iters,
                        shortcut=shortcut, tally=tally)
    out = fixpoint_loop(
        lambda s: round_body(form, src, dst, live, mask, s,
                             shortcut=shortcut, vid=vid),
        state, max_iters, src.dim() == 2)
    if tally is not None:
        tally[form] = tally.get(form, 0) + int(out[1].max()
                                               if out[1].dim() else out[1])
    return out


def fixpoint_schedule(form: str, src, dst, live, mask, state,
                      max_iters: int, *, shortcut: bool = False, vid=None,
                      max_outer: int = 0):
    """The fixpoint kernel's schedule in plain torch: (state, rounds) as
    :func:`frontier_fixpoint` returns them.  The first round gathers along
    every live slot whose ids fall in ``[0, NV)`` and lists those whose
    ends both lie inside ``mask`` (trim: inside the unassigned set it
    starts from); every later round gathers along the listed edges only,
    and only a source word that changed in the previous round sends (its
    value replaced by the gather's identity otherwise).  ``scc`` is
    :func:`scc_loop` over this schedule, as the kernel lists the edges of
    each sweep."""
    if form == "scc":
        return scc_loop(src, dst, live, mask, max_outer, max_iters,
                        shortcut=shortcut, fix=fixpoint_schedule)
    first = state[0] if form == "trim" else state
    nv = first.shape[-1]
    inside = first if form == "trim" else mask
    ok = live & (src >= 0) & (src < nv) & (dst >= 0) & (dst < nv)
    listed = ok & take(inside, src.clamp(0, nv - 1)) & take(
        inside, dst.clamp(0, nv - 1))
    ident = 0 if form == "or" else SENT_WORD
    changed = []  # the words the previous round changed; none: all send

    def only_changed(s, d, lv, val, nv_, mode="min"):
        if changed:
            val = torch.where(changed[-1], val, ident)
        return gather(s, d, lv, val, nv_, mode)

    def body(st):
        nxt, ch = round_body(form, src, dst, listed if changed else ok,
                             mask, st, shortcut=shortcut, vid=vid,
                             gather=only_changed)
        # trim's gather is no message: it takes the listed edges alone
        changed.append(nxt[0] != st[0] if form == "trim" else nxt != st)
        return nxt, ch
    return fixpoint_loop(body, state, max_iters, src.dim() == 2)
