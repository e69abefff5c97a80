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

``apply_batch_stats_lanes`` / ``apply_batch_scan_lanes`` are the step over
a leading tenant axis (the JAX package's ``jax.vmap`` of the scan, as its
tenancy engine runs it): states with [T, ...] leaves, op batches [T, B] /
[T, K, B].  Phases 1-4 run once for all lanes (the edge table's kernels
take the lanes as rows); the repair gate and the region sizes come back
as [T] in one read each; the lanes that need a repair are grouped by
(tier, edge bucket) and each group runs its tier over its rows at once.
Every lane's result is its solo step's, bit for bit.
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


def _tier_of(cfg: gs.GraphConfig, region_v: int, region_e: int):
    """(tier, compact edge bucket) of a region of ``region_v`` vertices
    and ``region_e`` live edges: the smallest tier it fits, as the JAX
    step's nested ``lax.cond`` / ``lax.switch`` choose."""
    nv = cfg.n_vertices
    e_buckets = tuple(x for x in cfg.region_edge_buckets
                      if x < cfg.edge_capacity)
    vcap = cfg.region_vertex_capacity
    if cfg.dense_capacity > 0 and region_v <= cfg.dense_capacity:
        return TIER_DENSE, None
    if (0 < vcap < nv and e_buckets and region_v <= vcap
            and region_e <= e_buckets[-1]):
        k = min(sum(region_e > x for x in e_buckets), len(e_buckets) - 1)
        return TIER_COMPACT, e_buckets[k]
    return TIER_FULL, None


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

        tier, bucket = _tier_of(cfg, region_v, region_e)
        if tier == TIER_DENSE:
            def matmul(a, bm):
                return reach_blockmm.bool_matmul(
                    a, bm, impl=cfg.dense_matmul_impl)
            lab, _ = scc.scc_dense_region(src, dst, live, region,
                                          cfg.dense_capacity, matmul=matmul)
        elif tier == TIER_COMPACT:
            lab, _ = scc.scc_compact_region(
                src, dst, live, region, cfg.region_vertex_capacity, bucket,
                max_outer=cfg.max_outer, max_inner=cfg.max_inner,
                shortcut=cfg.shortcut, impl=cfg.sparse_impl)
        else:
            lab = scc.scc_static(src, dst, live, region,
                                 max_outer=cfg.max_outer,
                                 max_inner=cfg.max_inner,
                                 shortcut=cfg.shortcut, impl=cfg.sparse_impl)
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


# ---------------------------------------------------------------------------
# The step over tenant lanes
# ---------------------------------------------------------------------------

def _junk_set_lanes(n: int, idx, mask) -> torch.Tensor:
    """bool[T, n]: per lane, True at ``idx`` where ``mask``."""
    out = torch.zeros((mask.shape[0], n + 1), dtype=torch.bool,
                      device=mask.device)
    out.scatter_(1, torch.where(mask, idx, n).long(), True)
    return out[:, :n]


def _first_claim_lanes(cand, target, nv, b):
    """Per lane: the lowest-indexed candidate op for each target vertex."""
    idx = torch.arange(b, dtype=torch.int32, device=cand.device)
    slot = torch.where(cand, target, nv).long()
    claims = torch.full((cand.shape[0], nv + 1), b, dtype=torch.int32,
                        device=cand.device)
    claims.scatter_reduce_(1, slot, torch.where(cand, idx, b),
                           reduce="amin")
    return cand & (claims.gather(1, slot) == idx)


def _rows(x, idx):
    return x if idx is None else x.index_select(0, idx)


def _repair_lanes(cfg, rows, src, dst, live, v_alive, m_del, straddle, u, v,
                  ccid):
    """Phase 5 for the lanes ``rows`` (host list) of the step: returns
    (ccid [T, NV] with those lanes repaired, {row: RepairStats})."""
    nv = cfg.n_vertices
    dev = ccid.device
    idx = None if len(rows) == ccid.shape[0] else torch.tensor(
        rows, dtype=torch.long, device=dev)
    s_src, s_dst, s_live, s_alive = (_rows(x, idx) for x in
                                     (src, dst, live, v_alive))
    seed_f = _junk_set_lanes(nv, _rows(v, idx), _rows(straddle, idx))
    seed_b = _junk_set_lanes(nv, _rows(u, idx), _rows(straddle, idx))
    if cfg.fuse_fwbw:
        fw, bw, _ = reach.fused_fw_bw_reach(
            s_src, s_dst, s_live, seed_f, seed_b, s_alive, cfg.max_inner,
            impl=cfg.sparse_impl)
    else:
        fw, _ = reach.forward_reach(s_src, s_dst, s_live, seed_f, s_alive,
                                    cfg.max_inner, impl=cfg.sparse_impl)
        bw, _ = reach.backward_reach(s_src, s_dst, s_live, seed_b, s_alive,
                                     cfg.max_inner, impl=cfg.sparse_impl)
    region = (_rows(m_del, idx) | (fw & bw)) & s_alive
    take = reach.take
    region_v, region_e = SYNCS.numpy(torch.stack([
        region.sum(1),
        (s_live & take(region, s_src) & take(region, s_dst)).sum(1)
    ])).tolist()

    groups: dict = {}
    stats = {}
    for j, row in enumerate(rows):
        tier, bucket = _tier_of(cfg, region_v[j], region_e[j])
        groups.setdefault((tier, bucket), []).append(j)
        stats[row] = RepairStats(tier, region_v[j], region_e[j])
    s_ccid = _rows(ccid, idx)
    new = s_ccid.clone()
    for (tier, bucket), pos in groups.items():
        g = None if len(pos) == len(rows) else torch.tensor(
            pos, dtype=torch.long, device=dev)
        g_src, g_dst, g_live, g_region = (_rows(x, g) for x in
                                          (s_src, s_dst, s_live, region))
        if tier == TIER_DENSE:  # lane by lane through bool_matmul
            def matmul(a, bm):
                return reach_blockmm.bool_matmul(
                    a, bm, impl=cfg.dense_matmul_impl)
            lab = torch.stack([scc.scc_dense_region(
                g_src[i], g_dst[i], g_live[i], g_region[i],
                cfg.dense_capacity, matmul=matmul)[0]
                for i in range(g_region.shape[0])])
        elif tier == TIER_COMPACT:
            lab, _ = scc.scc_compact_region(
                g_src, g_dst, g_live, g_region,
                cfg.region_vertex_capacity, bucket,
                max_outer=cfg.max_outer, max_inner=cfg.max_inner,
                shortcut=cfg.shortcut, impl=cfg.sparse_impl)
        else:
            lab = scc.scc_static(g_src, g_dst, g_live, g_region,
                                 max_outer=cfg.max_outer,
                                 max_inner=cfg.max_inner,
                                 shortcut=cfg.shortcut,
                                 impl=cfg.sparse_impl)
        fixed = torch.where(g_region, lab, _rows(s_ccid, g))
        if g is None:
            new = fixed
        else:
            new = new.index_copy(0, g, fixed)
    return (new if idx is None else ccid.index_copy(0, idx, new)), stats


def apply_batch_stats_lanes(states: gs.GraphState, ops: OpBatch,
                            cfg: gs.GraphConfig):
    """One SMSCC step for each of T tenant lanes at once: ``states`` has
    [T, ...] leaves, ``ops`` [T, B] leaves (NOP rows for a lane with
    nothing to do).  Returns ``(new_states, ok bool[T, B], ovf_delta
    int32[T], [RepairStats] * T)``, each lane exactly its
    :func:`apply_batch_stats`."""
    nv = cfg.n_vertices
    dev = states.device
    kind, u, v = (t.to(dev) for t in ops)
    n_lanes, b = kind.shape
    vid = torch.arange(nv, dtype=torch.int32, device=dev)
    uc, vc = u.clamp(0, nv - 1).long(), v.clamp(0, nv - 1).long()

    v_alive = states.v_alive
    ccid = states.ccid
    edges = states.edges
    ok = torch.zeros((n_lanes, b), dtype=torch.bool, device=dev)

    edge_op = (kind == ADD_EDGE) | (kind == REM_EDGE)
    in_range = (u >= 0) & (u < nv) & (~edge_op | ((v >= 0) & (v < nv)))

    # ---- Phase 1: RemoveVertex --------------------------------------------
    cand = (kind == REM_VERTEX) & in_range & v_alive.gather(1, uc)
    win_remv = _first_claim_lanes(cand, u, nv, b)
    ok = ok | win_remv
    killed = _junk_set_lanes(nv, u, win_remv)
    affected_rep = torch.zeros((n_lanes, nv + 1), dtype=torch.bool,
                               device=dev)
    affected_rep.scatter_(
        1, torch.where(killed, ccid.clamp(max=nv), nv).long(), True)
    v_alive = v_alive & ~killed
    edges, _ = et.remove_incident(edges, killed)
    ccid = torch.where(killed, nv, ccid)

    # ---- Phase 2: RemoveEdge ----------------------------------------------
    is_reme = (kind == REM_EDGE) & in_range
    edges, removed = et.remove(
        edges, u, v, cfg.max_probes,
        enable=is_reme & v_alive.gather(1, uc) & v_alive.gather(1, vc),
        impl=cfg.sparse_impl)
    ok = ok | removed
    cu = ccid.gather(1, uc)
    hit = removed & (cu == ccid.gather(1, vc))
    affected_rep.scatter_(1, torch.where(hit, cu.clamp(max=nv), nv).long(),
                          True)

    # ---- Phase 3: AddVertex -----------------------------------------------
    cand = (kind == ADD_VERTEX) & in_range & ~v_alive.gather(1, uc)
    win_addv = _first_claim_lanes(cand, u, nv, b)
    ok = ok | win_addv
    born = _junk_set_lanes(nv, u, win_addv)
    v_alive = v_alive | born
    ccid = torch.where(born, vid, ccid)

    # ---- Phase 4: AddEdge -------------------------------------------------
    enable = (kind == ADD_EDGE) & in_range & v_alive.gather(1, uc) & \
        v_alive.gather(1, vc)
    edges, inserted, dropped = et.insert(edges, u, v, cfg.max_probes,
                                         enable=enable, impl=cfg.sparse_impl)
    ok = ok | inserted
    ovf = dropped.sum(1).int()

    # ---- Phase 5: localized repair, for the lanes that need one -----------
    src, dst, live = edges.src, edges.dst, edges.state == et.LIVE
    m_del = v_alive & affected_rep.gather(1, ccid.clamp(max=nv).long())
    straddle = inserted & (ccid.gather(1, uc) != ccid.gather(1, vc))
    if cfg.repair_gate:
        need = SYNCS.numpy(m_del.any(1) | straddle.any(1))
        rows = need.nonzero()[0].tolist()
    else:
        rows = list(range(n_lanes))
    repair = [gs.repair_skipped()] * n_lanes
    if rows:
        ccid, fixed = _repair_lanes(cfg, rows, src, dst, live, v_alive,
                                    m_del, straddle, u, v, ccid)
        for row, st in fixed.items():
            repair[row] = st

    ccid = torch.where(v_alive, ccid, nv)
    new_states = gs.recount_ccs(gs.GraphState(
        v_alive=v_alive, ccid=ccid, edges=edges, n_ccs=states.n_ccs,
        gen=states.gen + 1, overflow=states.overflow + ovf))
    return new_states, ok, ovf, repair


def apply_batch_scan_lanes(states: gs.GraphState, ops: OpBatch,
                           cfg: gs.GraphConfig):
    """K stacked chunks per lane (``int32[T, K, B]`` leaves) through the
    lane step in order: the JAX package's ``jax.vmap`` of its scan.
    Returns ``(new_states, ok bool[T, K, B], ovf_delta int32[T, K],
    RepairStats of int32[T, K] numpy arrays)``."""
    oks, ovfs, reps = [], [], []
    for k in range(ops.kind.shape[1]):
        states, ok, ovf, rep = apply_batch_stats_lanes(
            states, OpBatch(*(x[:, k].contiguous() for x in ops)), cfg)
        oks.append(ok)
        ovfs.append(ovf)
        reps.append(rep)
    stats = np.asarray([[tuple(r) for r in col] for col in reps],
                       np.int32).reshape(len(reps), -1, 3).transpose(1, 0, 2)
    return (states, torch.stack(oks, 1), torch.stack(ovfs, 1),
            RepairStats(*(stats[..., i] for i in range(3))))
