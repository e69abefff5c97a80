"""SMSCC: batched fully-dynamic SCC maintenance -- the 5-phase step.

Mirrors ``repro.core.dynamic``.  One step applies an op batch in the fixed
linearization ``RemoveVertex -> RemoveEdge -> AddVertex -> AddEdge`` (ties
by lane index) and repairs labels on the affected region only:
``M_del`` (classes a deletion touched) united with ``FW(new heads) ∩
BW(new tails)`` of straddling inserts, through the smallest repair tier
the region fits (dense, compact, full).

Where JAX uses ``lax.cond`` / ``lax.switch`` / ``lax.scan``, the port uses
Python control flow: the repair gate and the tier choice each read one
value back from the device (counted by :data:`repro_torch.core.sync.SYNCS`),
and the scan entry is a loop over steps.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import edge_table as et
from repro_torch.core import graph_state as gs
from repro_torch.core import reach, scc
from repro_torch.core.sync import SYNCS
from repro_torch.kernels.reach_blockmm import ops as reach_blockmm

ADD_EDGE = 0
REM_EDGE = 1
ADD_VERTEX = 2
REM_VERTEX = 3
NOP = 4

TIER_DENSE = gs.TIER_DENSE
TIER_COMPACT = gs.TIER_COMPACT
TIER_FULL = gs.TIER_FULL
TIER_SKIP = gs.TIER_SKIP
TIER_NAMES = gs.TIER_NAMES
RepairStats = gs.RepairStats


class OpBatch(NamedTuple):
    kind: torch.Tensor  # int32[B] (or [K, B] for the scan entry)
    u: torch.Tensor  # int32
    v: torch.Tensor  # int32 (ignored for vertex ops)


def make_ops(kind, u, v) -> OpBatch:
    """An op batch of int32 CPU tensors; steps move it to the state's
    device."""
    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.int32, copy=True))
    return OpBatch(kind=t(kind), u=t(u), v=t(v))


def _junk_set(n: int, idx, mask, device) -> torch.Tensor:
    """bool[n]: True at ``idx`` where ``mask``; other lanes hit slot n,
    which is sliced off (JAX's ``mode="drop"`` scatter)."""
    out = torch.zeros(n + 1, dtype=torch.bool, device=device)
    out[torch.where(mask, idx, n).long()] = True
    return out[:n]


def _first_claim(cand, target, nv, b):
    """Lane wins iff it is the lowest-indexed candidate lane for its
    target vertex."""
    idx = torch.arange(b, dtype=torch.int32, device=cand.device)
    slot = torch.where(cand, target, nv).long()
    claims = torch.full((nv + 1,), b, dtype=torch.int32, device=cand.device)
    claims.scatter_reduce_(0, slot, torch.where(cand, idx, b), reduce="amin")
    return cand & (claims[slot] == idx)


def apply_batch_stats(state: gs.GraphState, ops: OpBatch,
                      cfg: gs.GraphConfig):
    """One batch-atomic SMSCC step with its telemetry (the JAX package's
    ``apply_batch_async``).  Returns ``(new_state, ok: bool[B],
    ovf_delta: int32[], RepairStats)``."""
    nv = cfg.n_vertices
    dev = state.device
    kind, u, v = (t.to(dev) for t in ops)
    b = kind.shape[0]
    vid = torch.arange(nv, dtype=torch.int32, device=dev)
    uc, vc = u.clamp(0, nv - 1), v.clamp(0, nv - 1)

    v_alive = state.v_alive
    ccid = state.ccid
    edges = state.edges
    ok = torch.zeros(b, dtype=torch.bool, device=dev)

    edge_op = (kind == ADD_EDGE) | (kind == REM_EDGE)
    in_range = (u >= 0) & (u < nv) & (~edge_op | ((v >= 0) & (v < nv)))

    # ---- Phase 1: RemoveVertex --------------------------------------------
    cand = (kind == REM_VERTEX) & in_range & v_alive[uc]
    win_remv = _first_claim(cand, u, nv, b)
    ok = ok | win_remv
    killed = _junk_set(nv, u, win_remv, dev)
    # deletion-affected classes: the old class of every killed vertex
    affected_rep = torch.zeros(nv + 1, dtype=torch.bool, device=dev)
    affected_rep[torch.where(killed, ccid.clamp(max=nv), nv).long()] = True
    v_alive = v_alive & ~killed
    edges, _ = et.remove_incident(edges, killed)
    ccid = torch.where(killed, nv, ccid)

    # ---- Phase 2: RemoveEdge ----------------------------------------------
    is_reme = (kind == REM_EDGE) & in_range
    edges, removed = et.remove(edges, u, v, cfg.max_probes,
                               enable=is_reme & v_alive[uc] & v_alive[vc],
                               impl=cfg.sparse_impl)
    ok = ok | removed
    hit = removed & (ccid[uc] == ccid[vc])
    affected_rep[torch.where(hit, ccid[uc].clamp(max=nv), nv).long()] = True

    # ---- Phase 3: AddVertex -----------------------------------------------
    cand = (kind == ADD_VERTEX) & in_range & ~v_alive[uc]
    win_addv = _first_claim(cand, u, nv, b)
    ok = ok | win_addv
    born = _junk_set(nv, u, win_addv, dev)
    v_alive = v_alive | born
    ccid = torch.where(born, vid, ccid)

    # ---- Phase 4: AddEdge -------------------------------------------------
    enable = (kind == ADD_EDGE) & in_range & v_alive[uc] & v_alive[vc]
    edges, inserted, dropped = et.insert(edges, u, v, cfg.max_probes,
                                         enable=enable, impl=cfg.sparse_impl)
    ok = ok | inserted
    ovf = dropped.sum().int()

    # ---- Phase 5: localized repair ----------------------------------------
    src, dst, live = edges.src, edges.dst, edges.state == et.LIVE
    m_del = v_alive & affected_rep[ccid.clamp(max=nv)]
    straddle = inserted & (ccid[uc] != ccid[vc])

    def run_repair():
        seed_f = _junk_set(nv, v, straddle, dev)
        seed_b = _junk_set(nv, u, straddle, dev)
        if cfg.fuse_fwbw:
            fw, bw, _ = reach.fused_fw_bw_reach(
                src, dst, live, seed_f, seed_b, v_alive, cfg.max_inner,
                impl=cfg.sparse_impl)
        else:
            fw, _ = reach.forward_reach(src, dst, live, seed_f, v_alive,
                                        cfg.max_inner, impl=cfg.sparse_impl)
            bw, _ = reach.backward_reach(src, dst, live, seed_b, v_alive,
                                         cfg.max_inner, impl=cfg.sparse_impl)
        region = (m_del | (fw & bw)) & v_alive
        region_v, region_e = SYNCS.ints(
            region.sum(), (live & region[src] & region[dst]).sum())

        # tier dispatch, smallest first, exactly as the nested lax.conds
        e_buckets = tuple(x for x in cfg.region_edge_buckets
                          if x < cfg.edge_capacity)
        vcap = cfg.region_vertex_capacity
        if cfg.dense_capacity > 0 and region_v <= cfg.dense_capacity:
            def matmul(a, bm):
                return reach_blockmm.bool_matmul(
                    a, bm, impl=cfg.dense_matmul_impl)
            lab, _ = scc.scc_dense_region(src, dst, live, region,
                                          cfg.dense_capacity, matmul=matmul)
            tier = TIER_DENSE
        elif (0 < vcap < nv and e_buckets and region_v <= vcap
              and region_e <= e_buckets[-1]):
            bucket = min(sum(region_e > x for x in e_buckets),
                         len(e_buckets) - 1)
            lab, _ = scc.scc_compact_region(
                src, dst, live, region, vcap, e_buckets[bucket],
                max_outer=cfg.max_outer, max_inner=cfg.max_inner,
                shortcut=cfg.shortcut, impl=cfg.sparse_impl)
            tier = TIER_COMPACT
        else:
            lab = scc.scc_static(src, dst, live, region,
                                 max_outer=cfg.max_outer,
                                 max_inner=cfg.max_inner,
                                 shortcut=cfg.shortcut, impl=cfg.sparse_impl)
            tier = TIER_FULL
        return (torch.where(region, lab, ccid),
                RepairStats(tier, region_v, region_e))

    # repair gate: no straddling insert and no deletion-affected member
    # proves the region empty, so skipping is exact
    if not cfg.repair_gate or SYNCS.bool(m_del.any() | straddle.any()):
        ccid, repair = run_repair()
    else:
        repair = gs.repair_skipped()

    ccid = torch.where(v_alive, ccid, nv)
    new_state = gs.recount_ccs(gs.GraphState(
        v_alive=v_alive, ccid=ccid, edges=edges, n_ccs=state.n_ccs,
        gen=state.gen + 1, overflow=state.overflow + ovf))
    return new_state, ok, ovf, repair


def apply_batch(state: gs.GraphState, ops: OpBatch, cfg: gs.GraphConfig):
    """One batch-atomic SMSCC step.  Returns (new_state, ok: bool[B])."""
    new_state, ok, _, _ = apply_batch_stats(state, ops, cfg)
    return new_state, ok


def apply_batch_scan(state: gs.GraphState, ops: OpBatch,
                     cfg: gs.GraphConfig):
    """K stacked same-bucket chunks (``int32[K, B]`` leaves) through the
    step in order.  Returns ``(new_state, ok: bool[K, B], ovf_delta:
    int32[K], RepairStats of K-tuples)``, as K sequential steps."""
    oks, ovfs, reps = [], [], []
    for k in range(ops.kind.shape[0]):
        state, ok, ovf, rep = apply_batch_stats(
            state, OpBatch(ops.kind[k], ops.u[k], ops.v[k]), cfg)
        oks.append(ok)
        ovfs.append(ovf)
        reps.append(rep)
    return (state, torch.stack(oks), torch.stack(ovfs),
            RepairStats(*(tuple(col) for col in zip(*reps))))


def recompute(state: gs.GraphState, cfg: gs.GraphConfig) -> gs.GraphState:
    """Full static SCC of the current graph (bulk-load / oracle path)."""
    src, dst, live = gs.edge_coo(state)
    lab = scc.scc_static(src, dst, live, state.v_alive,
                         max_outer=cfg.max_outer, max_inner=cfg.max_inner,
                         shortcut=cfg.shortcut, impl=cfg.sparse_impl)
    ccid = torch.where(state.v_alive, lab, cfg.n_vertices)
    return gs.recount_ccs(state._replace(ccid=ccid, gen=state.gen + 1))
