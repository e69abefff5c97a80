"""Static parallel SCC (trim -> coloring -> backward sweep) and the two
region tiers of the repair engine.

Mirrors ``repro.core.scc``: ``scc_static`` over the full COO, the compact
sparse region (bounded sub-arrays, O(region) per round) and the dense
region (adjacency closure by boolean squarings through
``reach_blockmm.bool_matmul``).  Labels are canonical: the minimum vertex
id of each SCC, INT32_MAX outside the active set.

JAX drops out-of-range scatters (``mode="drop"``); torch raises on them.
Every such scatter here aims at an explicit junk slot (size n + 1, then
sliced off), and only the junk slot ever receives duplicate indices.

On the card ``scc_static`` (the full tier, the compact tier's pass over
its packed arrays and the recompute) is one launch of the frontier
kernel's ``scc`` form: the JAX package's ``lax.while_loop`` outer loop
and every trim and sweep inside it, with no host read.

Tenant lanes: ``trim``, ``scc_static``, ``compact_region`` and
``scc_compact_region`` also take edges [T, C] with row-local ids and
masks [T, NV] (``jax.vmap`` of the JAX functions).  Every count, cumsum,
scatter and gather then runs along a lane's own row, never across rows,
and ``scc_static`` is one launch for all lanes on the card (on the CPU
its outer loop reads the host once a round for all lanes).  The dense
tier runs lane by lane (``scc_dense_region`` on one row at a time).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import reach
from repro_torch.core.sync import SYNCS
from repro_torch.kernels.frontier_expand import ops as frontier
from repro_torch.kernels.frontier_expand import ref as fref
from repro_torch.kernels.reach_blockmm import ops as reach_blockmm
from repro_torch.sharding import constrain, lead

INT32_MAX = 2 ** 31 - 1


def trim(src, dst, live, unassigned, vid, ccid, max_iters: int):
    """Iteratively peel zero-in/out-degree vertices into singleton SCCs
    (the ``trim`` form of the frontier fixpoint: one launch on the card)."""
    (unassigned, ccid), _ = reach._fix("trim", src, dst, live, None,
                                       (unassigned, ccid), max_iters,
                                       vid=vid)
    return unassigned, ccid


def scc_static(src, dst, live, active, *, max_outer: int, max_inner: int,
               spec=None, shortcut: bool = False, impl: str = "auto"):
    """SCC labels of the subgraph induced by ``active`` over live edges:
    int32[NV], min-member-id label for active vertices, INT32_MAX
    elsewhere.  ``max_outer`` bounds the peel rounds, ``max_inner`` every
    propagation fixpoint; ``spec`` optionally pins the NV-array sharding
    inside the fixpoints (GraphConfig.label_spec).

    On plain CUDA tensors the whole of it, outer loop included, is one
    launch of the frontier kernel's ``scc`` form, with no host read.  On
    CPU tensors (the plain version) and DTensors the outer loop is
    ``kernels/frontier_expand/ref.scc_loop`` over ``core/reach.py``'s
    fixpoints, reading ``unassigned.any()`` back once a round.

    Tenant lanes ([T, C] edges, [T, NV] ``active``): a lane with nothing
    unassigned passes through an outer round unchanged (no vertex to
    peel, seed or label), so each lane takes exactly its solo outer
    rounds, all lanes under the same ``max_outer``."""
    if reach._on_card(active):
        # a plain tensor under a mesh of several ranks raises, as a round
        # would
        constrain(active, lead(spec) if src.dim() == 2 else spec)
        ccid, _ = frontier.frontier_fixpoint(
            "scc", src, dst, live, active, None, max_inner,
            shortcut=shortcut, max_outer=max_outer, impl=impl)
        return ccid

    def fix(form, *args, **kw):
        return reach._fix(form, *args, spec=None if form == "trim" else spec,
                          impl=impl, **kw)
    ccid, _ = fref.scc_loop(src, dst, live, active, max_outer, max_inner,
                            shortcut=shortcut, fix=fix, read=SYNCS.bool)
    return ccid


# ---------------------------------------------------------------------------
# Compact-sparse region tier
# ---------------------------------------------------------------------------

def _enumerate_region(region_mask, capacity: int):
    """Stable (ascending id) enumeration of region members into
    ``capacity`` slots: ``(pos_of int32[NV], ids int32[capacity], valid
    bool[capacity])``; non-members and overflow land in the junk slot."""
    nv = region_mask.shape[-1]
    dev = region_mask.device
    pos_of = torch.cumsum(region_mask.long(), -1) - 1
    pos_of = torch.where(region_mask, pos_of, capacity).clamp(max=capacity)
    vid = torch.arange(nv, dtype=torch.int32, device=dev)
    if region_mask.dim() == 2:  # tenant lanes: each row enumerates its own
        ids = torch.full((region_mask.shape[0], capacity + 1), -1,
                         dtype=torch.int32, device=dev)
        ids.scatter_(1, pos_of, vid.expand_as(pos_of))
    else:
        ids = torch.full((capacity + 1,), -1, dtype=torch.int32, device=dev)
        ids[pos_of] = vid
    ids = ids[..., :capacity]
    return pos_of.int(), ids, ids >= 0


def compact_region(src, dst, live, region_mask, v_capacity: int,
                   e_capacity: int):
    """Pack the region into bounded compact COO arrays: ``(csrc, cdst,
    celive, ids, valid, pos_of, fits)`` as in the JAX package."""
    dev = region_mask.device
    take = reach.take
    lanes = region_mask.dim() == 2
    v_count = region_mask.sum(-1)
    e_in = live & take(region_mask, src) & take(region_mask, dst)
    fits = (v_count <= v_capacity) & (e_in.sum(-1) <= e_capacity)
    pos_of, ids, valid = _enumerate_region(region_mask, v_capacity)
    epos = torch.cumsum(e_in.long(), -1) - 1
    epos = torch.where(e_in, epos, e_capacity).clamp(max=e_capacity)
    cap_src = take(pos_of, src).clamp(max=v_capacity - 1)
    cap_dst = take(pos_of, dst).clamp(max=v_capacity - 1)

    def packed(values, dtype):
        out = torch.zeros((*region_mask.shape[:-1], e_capacity + 1),
                          dtype=dtype, device=dev)
        if lanes:  # kernels take each [T, e_capacity] array contiguous
            out.scatter_(1, epos, values.to(dtype))
            return out[:, :e_capacity].contiguous()
        out[epos] = values
        return out[:e_capacity]

    return (packed(cap_src, torch.int32), packed(cap_dst, torch.int32),
            packed(e_in, torch.bool), ids, valid, pos_of, fits)


def scc_compact_region(src, dst, live, region_mask, v_capacity: int,
                       e_capacity: int, *, max_outer: int, max_inner: int,
                       shortcut: bool = False, impl: str = "auto"):
    """SCC labels of the region via the compact tier: ``(ccid int32[NV],
    fits bool[])``, labels valid where ``region_mask``."""
    nv = region_mask.shape[-1]
    dev = region_mask.device
    csrc, cdst, celive, ids, valid, _, fits = compact_region(
        src, dst, live, region_mask, v_capacity, e_capacity)
    clab = scc_static(csrc, cdst, celive, valid, max_outer=max_outer,
                      max_inner=max_inner, shortcut=shortcut, impl=impl)
    # a slot scc_static left unassigned stays the sentinel globally too
    glab = torch.where(valid & (clab < v_capacity),
                       reach.take(ids, clab.clamp(0, v_capacity - 1)),
                       INT32_MAX)
    at = torch.where(valid, ids, nv).long()
    if region_mask.dim() == 2:
        ccid = torch.full((region_mask.shape[0], nv + 1), INT32_MAX,
                          dtype=torch.int32, device=dev)
        ccid.scatter_(1, at, glab)
    else:
        ccid = torch.full((nv + 1,), INT32_MAX, dtype=torch.int32,
                          device=dev)
        ccid[at] = glab
    return ccid[..., :nv], fits


# ---------------------------------------------------------------------------
# Dense region tier
# ---------------------------------------------------------------------------

def gather_region(src, dst, live, region_mask, capacity: int):
    """Pack up to ``capacity`` region vertices into a dense adjacency:
    (adj bool[R, R], ids int32[R], valid bool[R], fits bool[])."""
    dev = region_mask.device
    fits = region_mask.sum() <= capacity
    pos_of, ids, valid = _enumerate_region(region_mask, capacity)
    e_in = live & region_mask[src] & region_mask[dst]
    r = torch.where(e_in, pos_of[src], capacity).long()
    c = torch.where(e_in, pos_of[dst], capacity).long()
    adj = torch.zeros((capacity + 1, capacity + 1), dtype=torch.bool,
                      device=dev)
    adj.view(-1).index_fill_(0, r * (capacity + 1) + c, True)
    return adj[:capacity, :capacity].contiguous(), ids, valid, fits


def closure_dense(adj, matmul=None):
    """Reflexive-transitive closure via ceil(log2 R) boolean squarings
    through ``matmul`` (default: the ``reach_blockmm`` kernel wrapper)."""
    r = adj.shape[0]
    if matmul is None:
        matmul = reach_blockmm.bool_matmul
    reach_m = adj | torch.eye(r, dtype=torch.bool, device=adj.device)
    for _ in range(max(1, math.ceil(math.log2(max(r, 2))))):
        reach_m = reach_m | matmul(reach_m, reach_m)
    return reach_m


def scc_dense_region(src, dst, live, region_mask, capacity: int,
                     matmul=None):
    """SCC labels of a small region on the dense tier: (ccid int32[NV],
    labels valid where region_mask; fits bool[])."""
    nv = region_mask.shape[0]
    dev = region_mask.device
    adj, ids, valid, fits = gather_region(src, dst, live, region_mask,
                                          capacity)
    clo = closure_dense(adj, matmul)
    both = clo & clo.T & valid[None, :] & valid[:, None]
    big = torch.where(valid, ids, INT32_MAX)
    lab = torch.where(both, big[None, :], INT32_MAX).min(dim=1).values
    ccid = torch.full((nv + 1,), INT32_MAX, dtype=torch.int32, device=dev)
    ccid[torch.where(valid, ids, nv).long()] = lab
    return ccid[:nv], fits
