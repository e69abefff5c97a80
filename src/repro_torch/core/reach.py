"""Masked multi-source reachability: round-synchronous frontier sweeps.

Mirrors ``repro.core.reach``.  Every round's reduction is one segment-min
of per-edge messages into destination vertices; booleans ride the
min-semiring (reached -> 0, blocked -> SENTINEL).  The JAX package builds
the E-sized message array and then reduces it; here each round hands the
kernel a vertex-sized array of uint32 values in 32-bit words and the
kernel gathers the message of each edge itself
(:func:`repro_torch.kernels.frontier_expand.ops.frontier_gather`).  A
Reachable batch keeps its Q frontiers packed 32 to a word and ORs them
(min over 0 / SENTINEL messages is OR over reached bits), unpacking once
at the end.

Each round is a module-level function ``*_round(..., state) -> (state,
changed)``.  ``_fixpoint`` is Python control flow: each round reads its
``changed`` flag back from the device (one counted host sync per round).
Round counts and the ``max_iters`` cap are exactly those of the JAX while
loop.

Tenant lanes: given edges [T, C] (row-local ids) and masks [T, NV], every
sweep runs T independent graphs at once, one frontier launch a round for
all of them (``jax.vmap`` of the JAX sweep).  ``changed`` is per lane;
``_fixpoint_lanes`` reads once a round whether any lane is still active,
freezes a lane that stopped, and caps every lane at the same
``max_iters``, so each lane's result and round count are its solo ones.
"""
from __future__ import annotations

import torch

from repro_torch.core.sync import SYNCS
from repro_torch.kernels.frontier_expand import ops as frontier
from repro_torch.kernels.u32 import mul32

SENT_WORD = frontier.SENT_WORD  # SENTINEL as a 32-bit word
INT32_MAX = 2 ** 31 - 1


def _fixpoint(body, init, max_iters: int):
    """while changed and iters < cap: state, changed = body(state).
    Returns (state, iters)."""
    state, it = init, 0
    changed = True
    while changed and it < max_iters:
        state, ch = body(state)
        changed = SYNCS.bool(ch)
        it += 1
    return state, it


def _fixpoint_lanes(body, init, max_iters: int):
    """``_fixpoint`` over tenant lanes: ``body`` returns a per-lane
    ``changed`` bool[T].  Returns (state, rounds int32[T] on the device).
    A lane leaves the loop after its first unchanged round and keeps its
    state from then on (``torch.where(active, new, old)``); the loop ends
    when no lane is active or at ``max_iters`` (one host read a round)."""
    state = init
    first = init[0] if isinstance(init, tuple) else init
    rounds = torch.zeros(first.shape[0], dtype=torch.int32,
                         device=first.device)
    active = torch.ones_like(rounds, dtype=torch.bool)
    for _ in range(max_iters):
        new, ch = body(state)
        state = _freeze(active, new, state)
        rounds = rounds + active.int()
        active = active & ch
        if not SYNCS.bool(active.any()):
            break
    return state, rounds


def _freeze(active, new, old):
    if isinstance(new, tuple):
        return tuple(_freeze(active, n, o) for n, o in zip(new, old))
    return torch.where(active.view(-1, *([1] * (new.dim() - 1))), new, old)


def _fix(src):
    """The fixpoint driver for these edges: tenant lanes for [T, C]."""
    return _fixpoint_lanes if src.dim() == 2 else _fixpoint


def _changed(new, old, src):
    """Whether a round changed anything: a scalar, or one flag per tenant
    lane when the edges are [T, C]."""
    diff = new != old
    return diff.any() if src.dim() == 1 else diff.flatten(1).any(1)


def take(x, idx):
    """``x[idx]``, per tenant row for [T, ...] ``x`` (a gather along the
    last axis)."""
    return x[idx] if x.dim() == 1 else x.gather(-1, idx.long())


def _reached_val(mask: torch.Tensor) -> torch.Tensor:
    """0 where ``mask``, SENTINEL elsewhere, as 32-bit words."""
    return mask.int() - 1


def reach_round(src, dst, live, allowed, reached, impl: str = "auto"):
    """One round of :func:`forward_reach`: (next, changed)."""
    incoming = frontier.frontier_gather(src, dst, live, _reached_val(reached),
                                        allowed.shape[-1], impl=impl)
    nxt = reached | ((incoming == 0) & allowed)
    return nxt, _changed(nxt, reached, src)


def forward_reach(src, dst, live, seeds, allowed, max_iters: int,
                  impl: str = "auto"):
    """bool[NV]: vertices reachable from ``seeds`` along live edges,
    staying inside ``allowed``.  Returns (reached, rounds)."""
    return _fix(src)(
        lambda r: reach_round(src, dst, live, allowed, r, impl),
        seeds & allowed, max_iters)


def backward_reach(src, dst, live, seeds, allowed, max_iters: int,
                   impl: str = "auto"):
    """Reachability along reversed edges."""
    return forward_reach(dst, src, live, seeds, allowed, max_iters,
                         impl=impl)


def is_reachable(src, dst, live, u, v, allowed, max_iters: int,
                 impl: str = "auto"):
    """Paper's ``isReachable`` (used by AddEdge step 4): scalar u ~> v?"""
    seeds = torch.zeros_like(allowed)
    seeds[u] = True
    reached, _ = forward_reach(src, dst, live, seeds, allowed, max_iters,
                               impl=impl)
    return reached[v]


def label_round(src, dst, live, allowed, lab, shortcut: bool = False,
                impl: str = "auto"):
    """One round of :func:`propagate_min_labels`: (next, changed).  int32
    labels are their own uint32 words; an incoming word read as a negative
    int32 is a uint32 >= 2^31 and clamps to INT32_MAX, as JAX's
    ``minimum(incoming, INT32_MAX)`` does."""
    nv = lab.shape[-1]
    incoming = frontier.frontier_gather(
        src, dst, live, torch.where(allowed, lab, SENT_WORD), nv, impl=impl)
    incoming = torch.where(incoming < 0, INT32_MAX, incoming)
    nxt = torch.where(allowed, torch.minimum(lab, incoming), lab)
    if shortcut:
        hop = take(nxt, nxt.clamp(0, nv - 1))
        nxt = torch.where(allowed & (nxt < INT32_MAX),
                          torch.minimum(nxt, hop), nxt)
    return nxt, _changed(nxt, lab, src)


def propagate_min_labels(src, dst, live, labels, allowed, max_iters: int,
                         shortcut: bool = False, impl: str = "auto"):
    """Forward min-label propagation to fixpoint (the coloring sweep):
    labels[v] converges to min(labels[u] : u ~> v within allowed).  int32
    labels are non-negative, so they order-embed into the uint32
    messages; the incoming minimum is clamped back to INT32_MAX.
    ``shortcut`` adds pointer doubling lab[v] <- min(lab[v], lab[lab[v]]).
    Returns (labels, rounds)."""
    return _fix(src)(
        lambda lab: label_round(src, dst, live, allowed, lab, shortcut,
                                impl),
        labels, max_iters)


def multi_reach_round(src, dst, live, allowed, bits, impl: str = "auto"):
    """One round of :func:`multi_forward_reach` on packed frontiers
    (int32 words [W, NV]): (next, changed)."""
    incoming = frontier.frontier_gather(src, dst, live, bits,
                                        allowed.shape[0], mode="or",
                                        impl=impl)
    # all 32 bits where allowed (word -1), none elsewhere
    nxt = bits | (incoming & -allowed.int())
    return nxt, (nxt != bits).any()


def multi_forward_reach(src, dst, live, seeds, allowed, max_iters: int,
                        impl: str = "auto"):
    """Batched reachability: seeds/result are bool[Q, NV]; the Q axis is
    the kernel's frontier dimension, packed 32 frontiers to a word for the
    fixpoint and unpacked once at its end."""
    bits, rounds = _fixpoint(
        lambda b: multi_reach_round(src, dst, live, allowed, b, impl),
        frontier.pack_bits(seeds & allowed[None, :]), max_iters)
    return frontier.unpack_bits(bits, seeds.shape[0]), rounds


# Bijective priority hash (odd multiplier mod 2^32) and its inverse: the
# JAX package's hashed priorities, so pointer doubling collapses monotone
# id runs.  Priorities use all 32 bits and are held as uint32 values in
# int64, so torch compares them unsigned; they pass to the kernel as words.
P_MUL = 0x9E3779B1
P_INV = pow(P_MUL, -1, 2 ** 32)
PRIO_SENT = 0xFFFFFFFF
SENT_PREIMAGE = (0xFFFFFFFF * P_INV) % (2 ** 32)


def _prio(v: torch.Tensor) -> torch.Tensor:
    return mul32(v.long(), P_MUL)


def _unprio(p: torch.Tensor) -> torch.Tensor:
    """The inverse hash as int32 with two's-complement wrap, as JAX's
    uint32 -> int32 astype gives it."""
    return frontier.u32_to_words(mul32(p, P_INV))


def prio_round(src, dst, live, active, lab, impl: str = "auto"):
    """One round of :func:`propagate_min_prio` (lab: uint32 in int64):
    (next, changed)."""
    nv = active.shape[-1]
    incoming = frontier.words_to_u32(frontier.frontier_gather(
        src, dst, live,
        frontier.u32_to_words(torch.where(active, lab, PRIO_SENT)), nv,
        impl=impl))
    nxt = torch.where(active, torch.minimum(lab, incoming), lab)
    hop = take(nxt, _unprio(nxt).clamp(0, nv - 1))
    nxt = torch.where(active & (nxt != PRIO_SENT),
                      torch.minimum(nxt, hop), nxt)
    return nxt, _changed(nxt, lab, src)


def propagate_min_prio(src, dst, live, active, max_iters: int,
                       impl: str = "auto"):
    """Witness propagation with pointer doubling under hashed priorities.
    Returns (witness int32[NV], rounds): witness[v] = the vertex of
    minimum hashed priority among {u : u ~> v within active}; nv where
    n/a."""
    nv = active.shape[-1]
    if nv >= SENT_PREIMAGE:
        raise ValueError("vertex ids must stay below the priority sentinel")
    vid = torch.arange(nv, dtype=torch.int32, device=active.device)
    lab0 = torch.where(active, _prio(vid), PRIO_SENT)
    lab, rounds = _fix(src)(
        lambda lab: prio_round(src, dst, live, active, lab, impl),
        lab0, max_iters)
    witness = torch.where(lab != PRIO_SENT, _unprio(lab), nv)
    return witness, rounds


def fw_bw_round(src, dst, live, allowed, reached, impl: str = "auto"):
    """One round of :func:`fused_fw_bw_reach` on the stacked [2, NV]
    frontier, both directions in one launch: (next, changed)."""
    incoming = frontier.frontier_gather(src, dst, live,
                                        _reached_val(reached),
                                        allowed.shape[-1], mode="pair",
                                        impl=impl)
    nxt = reached | ((incoming == 0) & allowed.unsqueeze(-2))
    return nxt, _changed(nxt, reached, src)


def fused_fw_bw_reach(src, dst, live, seed_f, seed_b, allowed,
                      max_iters: int, impl: str = "auto"):
    """FW(seed_f) and BW(seed_b) in one fixpoint over a stacked [2, NV]
    frontier.  Returns (fw, bw, rounds)."""
    reached, rounds = _fix(src)(
        lambda r: fw_bw_round(src, dst, live, allowed, r, impl),
        torch.stack([seed_f & allowed, seed_b & allowed], dim=-2),
        max_iters)
    return reached[..., 0, :], reached[..., 1, :], rounds
