"""Masked multi-source reachability: round-synchronous frontier sweeps.

Mirrors ``repro.core.reach``.  Every round's reduction is one segment-min
of per-edge messages into destination vertices, routed through
:func:`repro_torch.kernels.frontier_expand.ops.frontier_min`; booleans ride
the min-semiring (reached -> 0, blocked -> SENTINEL).  Messages are uint32
values carried in int64.

``_fixpoint`` is Python control flow: each round reads its ``changed``
flag back from the device (one counted host sync per round).  Round counts
and the ``max_iters`` cap are exactly those of the JAX while loop.
"""
from __future__ import annotations

import torch

from repro_torch.core.edge_table import mul32
from repro_torch.core.sync import SYNCS
from repro_torch.kernels.frontier_expand import ops as frontier

SENT = frontier.SENTINEL
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


def _reached_msg(mask: torch.Tensor) -> torch.Tensor:
    """0 where ``mask``, SENTINEL elsewhere, as int64 messages."""
    return (~mask).long() * SENT


def forward_reach(src, dst, live, seeds, allowed, max_iters: int,
                  impl: str = "auto"):
    """bool[NV]: vertices reachable from ``seeds`` along live edges,
    staying inside ``allowed``.  Returns (reached, rounds)."""
    nv = seeds.shape[0]

    def body(reached):
        incoming = frontier.frontier_min(
            dst, _reached_msg(reached[src] & live), nv, impl=impl)
        nxt = reached | ((incoming == 0) & allowed)
        return nxt, (nxt != reached).any()

    return _fixpoint(body, seeds & allowed, max_iters)


def backward_reach(src, dst, live, seeds, allowed, max_iters: int,
                   impl: str = "auto"):
    """Reachability along reversed edges."""
    return forward_reach(dst, src, live, seeds, allowed, max_iters,
                         impl=impl)


def propagate_min_labels(src, dst, live, labels, allowed, max_iters: int,
                         shortcut: bool = False, impl: str = "auto"):
    """Forward min-label propagation to fixpoint (the coloring sweep):
    labels[v] converges to min(labels[u] : u ~> v within allowed).  int32
    labels are non-negative, so they order-embed into the uint32
    messages; the incoming minimum is clamped back to INT32_MAX.
    ``shortcut`` adds pointer doubling lab[v] <- min(lab[v], lab[lab[v]]).
    Returns (labels, rounds)."""
    nv = labels.shape[0]

    def body(lab):
        msg = torch.where(live & allowed[src], lab[src].long(), SENT)
        incoming = frontier.frontier_min(dst, msg, nv, impl=impl)
        incoming = incoming.clamp(max=INT32_MAX).int()
        nxt = torch.where(allowed, torch.minimum(lab, incoming), lab)
        if shortcut:
            hop = nxt[nxt.clamp(0, nv - 1)]
            nxt = torch.where(allowed & (nxt < INT32_MAX),
                              torch.minimum(nxt, hop), nxt)
        return nxt, (nxt != lab).any()

    return _fixpoint(body, labels, max_iters)


def multi_forward_reach(src, dst, live, seeds, allowed, max_iters: int,
                        impl: str = "auto"):
    """Batched reachability: seeds/result are bool[Q, NV]; the Q axis is
    the kernel's frontier dimension."""
    nv = seeds.shape[1]

    def body(reached):
        msg = _reached_msg(reached[:, src] & live[None, :])
        incoming = frontier.frontier_min(dst, msg, nv, impl=impl)
        nxt = reached | ((incoming == 0) & allowed[None, :])
        return nxt, (nxt != reached).any()

    return _fixpoint(body, seeds & allowed[None, :], max_iters)


# Bijective priority hash (odd multiplier mod 2^32) and its inverse: the
# JAX package's hashed priorities, so pointer doubling collapses monotone
# id runs.
P_MUL = 0x9E3779B1
P_INV = pow(P_MUL, -1, 2 ** 32)
PRIO_SENT = 0xFFFFFFFF
SENT_PREIMAGE = (0xFFFFFFFF * P_INV) % (2 ** 32)


def _prio(v: torch.Tensor) -> torch.Tensor:
    return mul32(v.long(), P_MUL)


def _unprio(p: torch.Tensor) -> torch.Tensor:
    """The inverse hash as int32 with two's-complement wrap, as JAX's
    uint32 -> int32 astype gives it."""
    x = mul32(p, P_INV)
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).int()


def propagate_min_prio(src, dst, live, active, max_iters: int,
                       impl: str = "auto"):
    """Witness propagation with pointer doubling under hashed priorities.
    Returns (witness int32[NV], rounds): witness[v] = the vertex of
    minimum hashed priority among {u : u ~> v within active}; nv where
    n/a."""
    nv = active.shape[0]
    if nv >= SENT_PREIMAGE:
        raise ValueError("vertex ids must stay below the priority sentinel")
    vid = torch.arange(nv, dtype=torch.int32, device=active.device)
    lab0 = torch.where(active, _prio(vid), PRIO_SENT)

    def body(lab):
        msg = torch.where(live & active[src], lab[src], PRIO_SENT)
        incoming = frontier.frontier_min(dst, msg, nv, impl=impl)
        nxt = torch.where(active, torch.minimum(lab, incoming), lab)
        hop = nxt[_unprio(nxt).clamp(0, nv - 1)]
        nxt = torch.where(active & (nxt != PRIO_SENT),
                          torch.minimum(nxt, hop), nxt)
        return nxt, (nxt != lab).any()

    lab, rounds = _fixpoint(body, lab0, max_iters)
    witness = torch.where(lab != PRIO_SENT, _unprio(lab), nv)
    return witness, rounds


def fused_fw_bw_reach(src, dst, live, seed_f, seed_b, allowed,
                      max_iters: int, impl: str = "auto"):
    """FW(seed_f) and BW(seed_b) in one fixpoint over a stacked [2, NV]
    frontier.  Returns (fw, bw, rounds)."""
    nv = allowed.shape[0]

    def body(reached):
        inc_f = frontier.frontier_min(
            dst, _reached_msg(reached[0][src] & live), nv, impl=impl)
        inc_b = frontier.frontier_min(
            src, _reached_msg(reached[1][dst] & live), nv, impl=impl)
        new = torch.stack([inc_f == 0, inc_b == 0])
        nxt = reached | (new & allowed[None, :])
        return nxt, (nxt != reached).any()

    reached, rounds = _fixpoint(
        body, torch.stack([seed_f & allowed, seed_b & allowed]), max_iters)
    return reached[0], reached[1], rounds
