"""Masked multi-source reachability: round-synchronous frontier sweeps.

Mirrors ``repro.core.reach``.  Every round's reduction is one segment-min
of per-edge messages into destination vertices; booleans ride the
min-semiring (reached -> 0, blocked -> SENTINEL).  The JAX package builds
the E-sized message array and then reduces it; here each round hands the
kernel a vertex-sized array of uint32 values in 32-bit words and the
kernel gathers the message of each edge itself.  A Reachable batch keeps
its Q frontiers packed 32 to a word and ORs them (min over 0 / SENTINEL
messages is OR over reached bits), unpacking once at the end.

Each sweep is one fixpoint form of the frontier kernel
(``kernels/frontier_expand/ref.FORMS``), and :func:`_fix` runs it as the
JAX package's ``lax.while_loop`` runs it:

- on plain CUDA tensors, one cooperative launch runs every round on the
  card (:func:`repro_torch.kernels.frontier_expand.ops.frontier_fixpoint`)
  and nothing is read back: the round count stays on the device;
- on CPU tensors (the plain version) and on DTensors over a mesh,
  :func:`round_loop` runs the rounds from Python, each round's body one
  ``frontier_gather`` and reading its ``changed`` flag back (one counted
  host sync a round).  It stays callable on the card as the per-round
  path the kernel is held to.

Round counts and the ``max_iters`` cap are exactly those of the JAX while
loop; every sweep returns them as an int32 tensor on the state's device.

Tenant lanes: given edges [T, C] (row-local ids) and masks [T, NV], every
sweep runs T independent graphs at once (``jax.vmap`` of the JAX sweep).
``changed`` and the rounds are per lane; a lane that stopped is frozen
and every lane is capped at the same ``max_iters``, so each lane's result
and round count are its solo ones.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.sync import SYNCS
from repro_torch.kernels.frontier_expand import ops as frontier
from repro_torch.kernels.frontier_expand import ref as fref
from repro_torch.sharding import constrain, lead

take = fref.take


def _on_card(x) -> bool:
    """A plain (not distributed) CUDA tensor: the fixpoint kernel's."""
    return type(x) is torch.Tensor and x.is_cuda


def round_loop(form: str, src, dst, live, mask, init, max_iters: int, *,
               spec=None, shortcut: bool = False, vid=None,
               impl: str = "auto"):
    """The fixpoint as a host loop: each round is ``fref.round_body`` over
    ``frontier_gather`` (the kernel on the card, the plain gather on the
    CPU) and one counted read of its ``changed`` flag.  ``spec`` pins each
    round's state (``GraphConfig.label_spec``, behind the lane axis for
    lanes).  Returns (state, rounds)."""
    lanes = src.dim() == 2
    if lanes:
        spec = lead(spec)

    def body(state):
        nxt, ch = _round(form, src, dst, live, mask, state, impl, shortcut,
                         vid)
        return constrain(nxt, spec), ch
    return fref.fixpoint_loop(body, constrain(init, spec), max_iters, lanes,
                              read=SYNCS.bool)


def _fix(form: str, src, dst, live, mask, init, max_iters: int, *,
         spec=None, shortcut: bool = False, vid=None, impl: str = "auto"):
    """The fixpoint of ``form`` from ``init``: one kernel launch with no
    host read for plain CUDA tensors, else :func:`round_loop`.  Returns
    (state, rounds)."""
    first = init[0] if isinstance(init, tuple) else init
    if not _on_card(first):
        return round_loop(form, src, dst, live, mask, init, max_iters,
                          spec=spec, shortcut=shortcut, vid=vid, impl=impl)
    # a plain tensor under a mesh of several ranks raises, as a round would
    constrain(first, lead(spec) if src.dim() == 2 else spec)
    return frontier.frontier_fixpoint(form, src, dst, live, mask, init,
                                      max_iters, shortcut=shortcut, vid=vid,
                                      impl=impl)


def _reached_val(mask: torch.Tensor) -> torch.Tensor:
    """0 where ``mask``, SENTINEL elsewhere, as 32-bit words."""
    return mask.int() - 1


def _round(form, src, dst, live, mask, state, impl, shortcut=False,
           vid=None):
    """One round of ``form`` through ``frontier_gather``."""
    return fref.round_body(form, src, dst, live, mask, state,
                           shortcut=shortcut, vid=vid,
                           gather=functools.partial(frontier.frontier_gather,
                                                    impl=impl))


def reach_round(src, dst, live, allowed, reached, impl: str = "auto"):
    """One round of :func:`forward_reach`: (next, changed)."""
    return _round("reach", src, dst, live, allowed, reached, impl)


def forward_reach(src, dst, live, seeds, allowed, max_iters: int,
                  spec=None, impl: str = "auto"):
    """bool[NV]: vertices reachable from ``seeds`` along live edges,
    staying inside ``allowed``.  Returns (reached, rounds).  ``spec``
    optionally pins the frontier's sharding (GraphConfig.label_spec)."""
    return _fix("reach", src, dst, live, allowed, seeds & allowed,
                max_iters, spec=spec, impl=impl)


def backward_reach(src, dst, live, seeds, allowed, max_iters: int,
                   spec=None, impl: str = "auto"):
    """Reachability along reversed edges."""
    return forward_reach(dst, src, live, seeds, allowed, max_iters,
                         spec=spec, impl=impl)


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
    """One round of :func:`propagate_min_labels`: (next, changed)."""
    return _round("label", src, dst, live, allowed, lab, impl, shortcut)


def propagate_min_labels(src, dst, live, labels, allowed, max_iters: int,
                         spec=None, shortcut: bool = False,
                         impl: str = "auto"):
    """Forward min-label propagation to fixpoint (the coloring sweep):
    labels[v] converges to min(labels[u] : u ~> v within allowed).  int32
    labels are non-negative, so they order-embed into the uint32
    messages; the incoming minimum is clamped back to INT32_MAX.
    ``shortcut`` adds pointer doubling lab[v] <- min(lab[v], lab[lab[v]]).
    Returns (labels, rounds)."""
    return _fix("label", src, dst, live, allowed, labels, max_iters,
                spec=spec, shortcut=shortcut, impl=impl)


def multi_reach_round(src, dst, live, allowed, bits, impl: str = "auto"):
    """One round of :func:`multi_forward_reach` on packed frontiers
    (int32 words [W, NV]): (next, changed)."""
    return _round("or", src, dst, live, allowed, bits, impl)


def multi_forward_reach(src, dst, live, seeds, allowed, max_iters: int,
                        impl: str = "auto"):
    """Batched reachability: seeds/result are bool[Q, NV]; the Q axis is
    the kernel's frontier dimension, packed 32 frontiers to a word for the
    fixpoint and unpacked once at its end."""
    bits, rounds = _fix("or", src, dst, live, allowed,
                        frontier.pack_bits(seeds & allowed[None, :]),
                        max_iters, impl=impl)
    return frontier.unpack_bits(bits, seeds.shape[0]), rounds


def propagate_min_prio(src, dst, live, active, max_iters: int,
                       spec=None, impl: str = "auto"):
    """Witness propagation with pointer doubling under hashed priorities.
    Returns (witness int32[NV], rounds): witness[v] = the vertex of
    minimum hashed priority among {u : u ~> v within active}; nv where
    n/a."""
    nv = active.shape[-1]
    if nv >= fref.SENT_PREIMAGE:
        raise ValueError("vertex ids must stay below the priority sentinel")
    vid = torch.arange(nv, dtype=torch.int32, device=active.device)
    lab0 = torch.where(active, fref.prio(vid), fref.PRIO_SENT)
    lab, rounds = _fix("prio", src, dst, live, active, lab0, max_iters,
                       spec=spec, impl=impl)
    witness = torch.where(lab != fref.PRIO_SENT, fref.unprio(lab), nv)
    return witness, rounds


def fw_bw_round(src, dst, live, allowed, reached, impl: str = "auto"):
    """One round of :func:`fused_fw_bw_reach` on the stacked [2, NV]
    frontier, both directions in one launch: (next, changed)."""
    return _round("pair", src, dst, live, allowed, reached, impl)


def fused_fw_bw_reach(src, dst, live, seed_f, seed_b, allowed,
                      max_iters: int, spec=None, impl: str = "auto"):
    """FW(seed_f) and BW(seed_b) in one fixpoint over a stacked [2, NV]
    frontier.  Returns (fw, bw, rounds)."""
    reached, rounds = _fix(
        "pair", src, dst, live, allowed,
        torch.stack([seed_f & allowed, seed_b & allowed], dim=-2),
        max_iters, spec=lead(spec), impl=impl)
    return reached[..., 0, :], reached[..., 1, :], rounds
