"""SMSCC: batched fully-dynamic SCC maintenance -- the 5-phase step.

Mirrors ``repro.core.dynamic``.  One step applies an op batch in the fixed
linearization ``RemoveVertex -> RemoveEdge -> AddVertex -> AddEdge`` (ties
by lane index) and repairs labels on the affected region only:
``M_del`` (classes a deletion touched) united with ``FW(new heads) ∩
BW(new tails)`` of straddling inserts, through the smallest repair tier
the region fits (dense, compact, full).

On the card the step runs as the JAX package's compiled step does: one
replay of a CUDA graph captured once per (cfg, bucket, card)
(``core/step_graph.py``), the repair gate's ``lax.cond`` and the tier's
nested ``lax.cond`` / ``lax.switch`` as conditional nodes decided on the
card (:func:`tier_code`), every fixpoint and the static SCC's outer loop
one kernel launch each, and nothing read back inside a step.  The scan
entry replays the graph K times and returns device tensors; the caller
reads a super-chunk's ok, overflow and :class:`RepairStats` back once
(:func:`read_back`).

On CPU tensors (the plain version) and DTensors the same step runs
eagerly, each decision read back to the host (counted by
:data:`repro_torch.core.sync.SYNCS`): the gate, then the region sizes for
the tier choice (:func:`_tier_of`).  :func:`apply_batch_stats_eager` runs
that per-decision step on the card too, as the graph is held to it.

``apply_batch_stats_lanes`` / ``apply_batch_scan_lanes`` are the step over
a leading tenant axis (the JAX package's ``jax.vmap`` of the scan, as its
tenancy engine runs it): states with [T, ...] leaves, op batches [T, B] /
[T, K, B].  Phases 1-4 run once for all lanes (the edge table's kernels
take the lanes as rows).  On the card the lane step is one replay of a
graph captured once per (cfg, bucket, lane count, card), every decision
made on the card as ``jax.vmap`` makes the reference's conds selects:
an IF node on "any lane needs a repair", then one per repair branch on
"any lane chose it", running that tier over all lanes with each region
masked to the lanes that chose it.  Eagerly (CPU tensors, DTensors,
:func:`apply_batch_stats_lanes_eager`) the repair gate and the region
sizes come back as [T] in one read each, and the lanes that need a
repair are grouped by (tier, edge bucket), each group running its tier
over its rows at once.  Every lane's result is its solo step's, bit for
bit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import edge_table as et
from repro_torch.core import graph_state as gs
from repro_torch.core import reach, scc, step_graph
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
INT32_MAX = gs.INT32_MAX


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
    which is sliced off (JAX's ``mode="drop"`` scatter).  The scalar is a
    kernel argument (``index_fill_``), never a host copy, so a graph can
    capture it."""
    out = torch.zeros(n + 1, dtype=torch.bool, device=device)
    out.index_fill_(0, torch.where(mask, idx, n).long(), True)
    return out[:n]


def _first_claim(cand, target, nv, b):
    """Lane wins iff it is the lowest-indexed candidate lane for its
    target vertex."""
    idx = torch.arange(b, dtype=torch.int32, device=cand.device)
    slot = torch.where(cand, target, nv).long()
    claims = torch.full((nv + 1,), b, dtype=torch.int32, device=cand.device)
    claims.scatter_reduce_(0, slot, torch.where(cand, idx, b), reduce="amin")
    return cand & (claims[slot] == idx)


def _edge_buckets(cfg: gs.GraphConfig) -> tuple:
    return tuple(x for x in cfg.region_edge_buckets if x < cfg.edge_capacity)


def _compact_on(cfg: gs.GraphConfig) -> bool:
    return 0 < cfg.region_vertex_capacity < cfg.n_vertices and \
        bool(_edge_buckets(cfg))


def _tier_of(cfg: gs.GraphConfig, region_v: int, region_e: int):
    """(tier, compact edge bucket) of a region of ``region_v`` vertices
    and ``region_e`` live edges: the smallest tier it fits, as the JAX
    step's nested ``lax.cond`` / ``lax.switch`` choose (host ints)."""
    e_buckets = _edge_buckets(cfg)
    vcap = cfg.region_vertex_capacity
    if cfg.dense_capacity > 0 and region_v <= cfg.dense_capacity:
        return TIER_DENSE, None
    if (_compact_on(cfg) and region_v <= vcap
            and region_e <= e_buckets[-1]):
        k = min(sum(region_e > x for x in e_buckets), len(e_buckets) - 1)
        return TIER_COMPACT, e_buckets[k]
    return TIER_FULL, None


def branches(cfg: gs.GraphConfig) -> tuple:
    """The repair branches of ``cfg`` as (tier, compact edge bucket), in
    the order :func:`tier_code` numbers them: dense (where on), compact
    one per edge bucket (where on), full."""
    return ((((TIER_DENSE, None),) if cfg.dense_capacity > 0 else ())
            + (tuple((TIER_COMPACT, b) for b in _edge_buckets(cfg))
               if _compact_on(cfg) else ())
            + ((TIER_FULL, None),))


def tier_code(cfg: gs.GraphConfig, region_v: torch.Tensor,
              region_e: torch.Tensor) -> torch.Tensor:
    """The index into :func:`branches` of the tier :func:`_tier_of`
    picks, computed on the region sizes' device (int32 tensors, any
    shape): the JAX step's ``bucket_idx`` / ``fits_compact`` and the dense
    test, with no read back."""
    br = branches(cfg)
    code = torch.full_like(region_v, len(br) - 1)
    if _compact_on(cfg):
        e_buckets = _edge_buckets(cfg)
        first = 1 if cfg.dense_capacity > 0 else 0
        idx = sum((region_e > x).int() for x in e_buckets).clamp(
            max=len(e_buckets) - 1)
        fits = (region_v <= cfg.region_vertex_capacity) & \
            (region_e <= e_buckets[-1])
        code = torch.where(fits, first + idx, code)
    if cfg.dense_capacity > 0:
        code = torch.where(region_v <= cfg.dense_capacity, 0, code)
    return code.int()


def _phases_1_4(state: gs.GraphState, kind, u, v, cfg: gs.GraphConfig):
    """The structural phases: (v_alive, ccid, edges, ok, ovf, m_del,
    straddle)."""
    nv = cfg.n_vertices
    dev = state.device
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
    affected_rep.index_fill_(
        0, torch.where(killed, ccid.clamp(max=nv), nv).long(), True)
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
    affected_rep.index_fill_(
        0, torch.where(hit, ccid[uc].clamp(max=nv), nv).long(), True)

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

    m_del = v_alive & affected_rep[ccid.clamp(max=nv)]
    straddle = inserted & (ccid[uc] != ccid[vc])
    return v_alive, ccid, edges, ok, ovf, m_del, straddle


def _region(cfg, src, dst, live, v_alive, m_del, straddle, u, v):
    """The affected region and its sizes (int32 scalars on the card)."""
    nv = cfg.n_vertices
    dev = v_alive.device
    seed_f = _junk_set(nv, v, straddle, dev)
    seed_b = _junk_set(nv, u, straddle, dev)
    if cfg.fuse_fwbw:
        fw, bw, _ = reach.fused_fw_bw_reach(
            src, dst, live, seed_f, seed_b, v_alive, cfg.max_inner,
            spec=cfg.label_spec, impl=cfg.sparse_impl)
    else:
        fw, _ = reach.forward_reach(src, dst, live, seed_f, v_alive,
                                    cfg.max_inner, spec=cfg.label_spec,
                                    impl=cfg.sparse_impl)
        bw, _ = reach.backward_reach(src, dst, live, seed_b, v_alive,
                                     cfg.max_inner, spec=cfg.label_spec,
                                     impl=cfg.sparse_impl)
    region = (m_del | (fw & bw)) & v_alive
    return (region, region.sum().int(),
            (live & region[src] & region[dst]).sum().int())


def _tier_labels(cfg, tier, bucket, src, dst, live, region):
    """The region's SCC labels through one repair tier."""
    if tier == TIER_DENSE:
        def matmul(a, bm):
            return reach_blockmm.bool_matmul(a, bm,
                                             impl=cfg.dense_matmul_impl)
        return scc.scc_dense_region(src, dst, live, region,
                                    cfg.dense_capacity, matmul=matmul)[0]
    if tier == TIER_COMPACT:
        return scc.scc_compact_region(
            src, dst, live, region, cfg.region_vertex_capacity, bucket,
            max_outer=cfg.max_outer, max_inner=cfg.max_inner,
            shortcut=cfg.shortcut, impl=cfg.sparse_impl)[0]
    return scc.scc_static(src, dst, live, region, max_outer=cfg.max_outer,
                          max_inner=cfg.max_inner, spec=cfg.label_spec,
                          shortcut=cfg.shortcut, impl=cfg.sparse_impl)


def _skipped(like: torch.Tensor) -> torch.Tensor:
    """A skipped step's stats, int32[3] on ``like``'s device."""
    stats = torch.zeros(3, dtype=torch.int32, device=like.device)
    stats[0].fill_(TIER_SKIP)
    return stats


def _repair(cfg, src, dst, live, v_alive, ccid, m_del, straddle, u, v,
            graph):
    """Phase 5: (ccid, stats int32[3]: tier, region_v, region_e).  With
    ``graph`` (a step-graph capture) every branch is an IF node decided on
    the card (``graph.cond(pred, body)`` runs ``body`` where the bool
    scalar ``pred`` holds); without, each decision is read back to the
    host."""
    def repair():
        region, rv, re = _region(cfg, src, dst, live, v_alive, m_del,
                                 straddle, u, v)
        if graph is None:
            tier, bucket = _tier_of(cfg, *SYNCS.ints(rv, re))
            lab = _tier_labels(cfg, tier, bucket, src, dst, live, region)
            tier_t = torch.full((), tier, dtype=torch.int32,
                                device=ccid.device)
        else:
            code = tier_code(cfg, rv, re)
            # one label buffer every branch writes into (the merge of the
            # JAX branches' outputs)
            lab = torch.full_like(ccid, INT32_MAX)
            tier_t = torch.zeros((), dtype=torch.int32, device=ccid.device)
            for i, (tier, bucket) in enumerate(branches(cfg)):
                def branch(tier=tier, bucket=bucket):
                    lab.copy_(_tier_labels(cfg, tier, bucket, src, dst,
                                           live, region))
                    tier_t.fill_(tier)
                graph.cond(code == i, branch)
        return torch.where(region, lab, ccid), torch.stack([tier_t, rv, re])

    if not cfg.repair_gate:
        return repair()
    # repair gate: no straddling insert and no deletion-affected member
    # proves the region empty, so skipping is exact
    need = m_del.any() | straddle.any()
    if graph is None:
        return repair() if SYNCS.bool(need) else (ccid, _skipped(ccid))
    out_ccid, out_stats = ccid.clone(), _skipped(ccid)

    def gated():
        new_ccid, stats = repair()
        out_ccid.copy_(new_ccid)
        out_stats.copy_(stats)
    graph.cond(need, gated)
    return out_ccid, out_stats


def _step(state: gs.GraphState, ops: OpBatch, cfg: gs.GraphConfig,
          graph=None):
    """One step: ``(new_state, ok bool[B], ovf int32[], stats int32[3])``.
    ``graph``: the step graph being captured, else None (the decisions
    read back)."""
    nv = cfg.n_vertices
    dev = state.device
    kind, u, v = (t.to(dev) for t in ops)
    v_alive, ccid, edges, ok, ovf, m_del, straddle = _phases_1_4(
        state, kind, u, v, cfg)
    src, dst, live = edges.src, edges.dst, edges.state == et.LIVE
    ccid, stats = _repair(cfg, src, dst, live, v_alive, ccid, m_del,
                          straddle, u, v, graph)
    ccid = torch.where(v_alive, ccid, nv)
    new_state = gs.recount_ccs(gs.GraphState(
        v_alive=v_alive, ccid=ccid, edges=edges, n_ccs=state.n_ccs,
        gen=state.gen + 1, overflow=state.overflow + ovf))
    return new_state, ok, ovf, stats


def _stats(stats: torch.Tensor) -> RepairStats:
    """RepairStats of int32 tensors from [..., 3] (tier, region_v,
    region_e)."""
    return RepairStats(*stats.unbind(-1))


def apply_batch_stats(state: gs.GraphState, ops: OpBatch,
                      cfg: gs.GraphConfig):
    """One batch-atomic SMSCC step with its telemetry (the JAX package's
    ``apply_batch_async``).  Returns ``(new_state, ok: bool[B],
    ovf_delta: int32[], RepairStats of int32[] tensors)``, all on the
    state's device; on the card one replay of the step graph, with
    nothing read back."""
    if step_graph.graphable(state):
        new, ok, ovf, stats = step_graph.run(
            state, OpBatch(*(x.unsqueeze(0) for x in ops)), cfg, _step)
        return new, ok[0], ovf[0], _stats(stats[0])
    return apply_batch_stats_eager(state, ops, cfg)


def apply_batch_stats_eager(state: gs.GraphState, ops: OpBatch,
                            cfg: gs.GraphConfig):
    """:func:`apply_batch_stats` run op by op, the gate and the tier read
    back to the host: the plain path of CPU tensors and DTensors, and on
    the card the per-decision step the graph is held to."""
    new, ok, ovf, stats = _step(state, ops, cfg)
    return new, ok, ovf, _stats(stats)


def apply_batch(state: gs.GraphState, ops: OpBatch, cfg: gs.GraphConfig):
    """One batch-atomic SMSCC step.  Returns (new_state, ok: bool[B])."""
    new_state, ok, _, _ = apply_batch_stats(state, ops, cfg)
    return new_state, ok


def apply_batch_scan(state: gs.GraphState, ops: OpBatch,
                     cfg: gs.GraphConfig):
    """K stacked same-bucket chunks (``int32[K, B]`` leaves) through the
    step in order.  Returns ``(new_state, ok: bool[K, B], ovf_delta:
    int32[K], RepairStats of int32[K] tensors)``, as K sequential steps;
    on the card K replays of the step graph and nothing read back."""
    if step_graph.graphable(state):
        new, ok, ovf, stats = step_graph.run(state, ops, cfg, _step)
        return new, ok, ovf, _stats(stats)
    oks, ovfs, reps = [], [], []
    for k in range(ops.kind.shape[0]):
        state, ok, ovf, rep = _step(
            state, OpBatch(ops.kind[k], ops.u[k], ops.v[k]), cfg)
        oks.append(ok)
        ovfs.append(ovf)
        reps.append(rep)
    return (state, torch.stack(oks), torch.stack(ovfs),
            _stats(torch.stack(reps)))


def read_back(ok: torch.Tensor, ovf: torch.Tensor, stats: RepairStats):
    """A super-chunk's (or a step's) outputs on the host in one transfer:
    ``(ok bool, ovf int32, stats int32[..., 3])`` numpy arrays."""
    lead = ovf.shape
    flat = torch.cat([ok.reshape(-1).int(), ovf.reshape(-1).int(),
                      torch.stack(tuple(stats), -1).reshape(-1).int()])
    host = flat.cpu().numpy()
    n_ok, n = ok.numel(), ovf.numel()
    return (host[:n_ok].reshape(ok.shape).astype(bool),
            host[n_ok:n_ok + n].reshape(lead),
            host[n_ok + n:].reshape(*lead, 3))


def recompute(state: gs.GraphState, cfg: gs.GraphConfig) -> gs.GraphState:
    """Full static SCC of the current graph (bulk-load / oracle path)."""
    src, dst, live = gs.edge_coo(state)
    lab = scc.scc_static(src, dst, live, state.v_alive,
                         max_outer=cfg.max_outer, max_inner=cfg.max_inner,
                         spec=cfg.label_spec, shortcut=cfg.shortcut,
                         impl=cfg.sparse_impl)
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


def _region_lanes(cfg, src, dst, live, v_alive, m_del, straddle, u, v):
    """Per lane: the affected region bool[T, NV] and its sizes int32[T]
    (vertices, live edges inside)."""
    nv = cfg.n_vertices
    seed_f = _junk_set_lanes(nv, v, straddle)
    seed_b = _junk_set_lanes(nv, u, straddle)
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
    take = reach.take
    return (region, region.sum(1).int(),
            (live & take(region, src) & take(region, dst)).sum(1).int())


def _tier_labels_lanes(cfg, tier, bucket, src, dst, live, region):
    """Each lane's region labels through one repair tier, all lanes at
    once (the dense tier lane by lane)."""
    if tier == TIER_DENSE:
        def matmul(a, bm):
            return reach_blockmm.bool_matmul(a, bm,
                                             impl=cfg.dense_matmul_impl)
        return torch.stack([scc.scc_dense_region(
            src[i], dst[i], live[i], region[i], cfg.dense_capacity,
            matmul=matmul)[0] for i in range(region.shape[0])])
    if tier == TIER_COMPACT:
        return scc.scc_compact_region(
            src, dst, live, region, cfg.region_vertex_capacity, bucket,
            max_outer=cfg.max_outer, max_inner=cfg.max_inner,
            shortcut=cfg.shortcut, impl=cfg.sparse_impl)[0]
    return scc.scc_static(src, dst, live, region, max_outer=cfg.max_outer,
                          max_inner=cfg.max_inner, shortcut=cfg.shortcut,
                          impl=cfg.sparse_impl)


def _repair_lanes(cfg, src, dst, live, v_alive, m_del, straddle, u, v,
                  ccid, graph):
    """Phase 5 over tenant lanes: (ccid [T, NV], stats int32[T, 3]).

    With ``graph`` (a step-graph capture) everything is decided on the
    card, as the reference's ``jax.vmap`` turns its ``lax.cond`` /
    ``lax.switch`` into selects: one IF node on "any lane needs a repair"
    runs the region over every lane, then one IF node per repair branch
    on "any lane chose it" runs that tier over all lanes, each lane's
    region masked to the lanes that chose it (an empty region ends its
    fixpoints at round 0); a lane that needs no repair keeps its labels
    and reports a skip.  Without, the gate and the region sizes are read
    back once each, and the lanes that need a repair are grouped by
    (tier, edge bucket), each group running its tier over its rows."""
    if graph is not None:
        return _repair_lanes_decided(cfg, src, dst, live, v_alive, m_del,
                                     straddle, u, v, ccid, graph)
    n_lanes = ccid.shape[0]
    if cfg.repair_gate:
        need = SYNCS.numpy(m_del.any(1) | straddle.any(1))
        rows = need.nonzero()[0].tolist()
    else:
        rows = list(range(n_lanes))
    stats = np.zeros((n_lanes, 3), np.int32)
    stats[:, 0] = TIER_SKIP
    if rows:
        dev = ccid.device
        idx = None if len(rows) == n_lanes else torch.tensor(
            rows, dtype=torch.long, device=dev)
        s_src, s_dst, s_live = (_rows(x, idx) for x in (src, dst, live))
        region, rv, re = _region_lanes(
            cfg, s_src, s_dst, s_live,
            *(_rows(x, idx) for x in (v_alive, m_del, straddle, u, v)))
        region_v, region_e = SYNCS.numpy(torch.stack([rv, re])).tolist()
        groups: dict = {}
        for j, row in enumerate(rows):
            tier, bucket = _tier_of(cfg, region_v[j], region_e[j])
            groups.setdefault((tier, bucket), []).append(j)
            stats[row] = (tier, region_v[j], region_e[j])
        s_ccid = _rows(ccid, idx)
        new = s_ccid
        for (tier, bucket), pos in groups.items():
            g = None if len(pos) == len(rows) else torch.tensor(
                pos, dtype=torch.long, device=dev)
            g_region = _rows(region, g)
            lab = _tier_labels_lanes(cfg, tier, bucket,
                                     *(_rows(x, g) for x in
                                       (s_src, s_dst, s_live)), g_region)
            fixed = torch.where(g_region, lab, _rows(s_ccid, g))
            new = fixed if g is None else new.index_copy(0, g, fixed)
        ccid = new if idx is None else ccid.index_copy(0, idx, new)
    return ccid, torch.from_numpy(stats).to(ccid.device)


def _repair_lanes_decided(cfg, src, dst, live, v_alive, m_del, straddle,
                          u, v, ccid, graph):
    """:func:`_repair_lanes` with every decision an IF node of ``graph``
    (``graph.cond(pred, body)`` runs ``body`` where the bool scalar
    ``pred`` holds)."""
    n_lanes = ccid.shape[0]
    out_ccid = ccid.clone()
    out_stats = torch.zeros((n_lanes, 3), dtype=torch.int32,
                            device=ccid.device)
    out_stats[:, 0].fill_(TIER_SKIP)
    if cfg.repair_gate:
        need = m_del.any(1) | straddle.any(1)
    else:
        need = torch.ones(n_lanes, dtype=torch.bool, device=ccid.device)

    def repair():
        # a lane that needs no repair has an empty region (no seed, no
        # deletion-affected vertex): its labels pass through unchanged
        region, rv, re = _region_lanes(cfg, src, dst, live, v_alive, m_del,
                                       straddle, u, v)
        code = torch.where(need, tier_code(cfg, rv, re), -1)
        lab = torch.full_like(ccid, INT32_MAX)
        tier = torch.full_like(code, TIER_SKIP)
        for i, (t, bucket) in enumerate(branches(cfg)):
            chose = code == i
            tier = torch.where(chose, t, tier)

            def branch(chose=chose, t=t, bucket=bucket):
                got = _tier_labels_lanes(cfg, t, bucket, src, dst, live,
                                         region & chose[:, None])
                lab.copy_(torch.where(chose[:, None], got, lab))
            graph.cond(chose.any(), branch)
        out_ccid.copy_(torch.where(region, lab, ccid))
        out_stats.copy_(torch.stack([tier, rv, re], 1))

    if cfg.repair_gate:
        graph.cond(need.any(), repair)
    else:
        repair()
    return out_ccid, out_stats


def _phases_1_4_lanes(states: gs.GraphState, kind, u, v,
                      cfg: gs.GraphConfig):
    """The structural phases over tenant lanes: (v_alive, ccid, edges, ok,
    ovf, m_del, straddle), each with a leading [T] axis."""
    nv = cfg.n_vertices
    dev = states.device
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

    m_del = v_alive & affected_rep.gather(1, ccid.clamp(max=nv).long())
    straddle = inserted & (ccid.gather(1, uc) != ccid.gather(1, vc))
    return v_alive, ccid, edges, ok, ovf, m_del, straddle


def _step_lanes(states: gs.GraphState, ops: OpBatch, cfg: gs.GraphConfig,
                graph=None):
    """One step for each of T lanes: ``(new_states, ok bool[T, B], ovf
    int32[T], stats int32[T, 3])``.  ``graph``: the lane step graph being
    captured, else None (the decisions read back)."""
    nv = cfg.n_vertices
    kind, u, v = (t.to(states.device) for t in ops)
    v_alive, ccid, edges, ok, ovf, m_del, straddle = _phases_1_4_lanes(
        states, kind, u, v, cfg)
    src, dst, live = edges.src, edges.dst, edges.state == et.LIVE
    ccid, stats = _repair_lanes(cfg, src, dst, live, v_alive, m_del,
                                straddle, u, v, ccid, graph)
    ccid = torch.where(v_alive, ccid, nv)
    new_states = gs.recount_ccs(gs.GraphState(
        v_alive=v_alive, ccid=ccid, edges=edges, n_ccs=states.n_ccs,
        gen=states.gen + 1, overflow=states.overflow + ovf))
    return new_states, ok, ovf, stats


def apply_batch_stats_lanes(states: gs.GraphState, ops: OpBatch,
                            cfg: gs.GraphConfig):
    """One SMSCC step for each of T tenant lanes at once: ``states`` has
    [T, ...] leaves, ``ops`` [T, B] leaves (NOP rows for a lane with
    nothing to do).  Returns ``(new_states, ok bool[T, B], ovf_delta
    int32[T], RepairStats of int32[T] tensors)``, each lane exactly its
    :func:`apply_batch_stats`; on the card one replay of the lane step
    graph, with nothing read back."""
    if step_graph.graphable(states):
        new, ok, ovf, stats = step_graph.run(
            states, OpBatch(*(x.unsqueeze(1) for x in ops)), cfg,
            _step_lanes)
        return new, ok[:, 0], ovf[:, 0], _stats(stats[:, 0])
    return apply_batch_stats_lanes_eager(states, ops, cfg)


def apply_batch_stats_lanes_eager(states: gs.GraphState, ops: OpBatch,
                                  cfg: gs.GraphConfig):
    """:func:`apply_batch_stats_lanes` with the gate and the region sizes
    read back to the host: the plain path of CPU tensors and DTensors,
    and on the card the per-decision lane step the graph is held to."""
    new, ok, ovf, stats = _step_lanes(states, ops, cfg)
    return new, ok, ovf, _stats(stats)


def _pad_lanes(ops: OpBatch, lanes: int) -> OpBatch:
    """``ops`` ([T, K, B] leaves) with NOP rows up to ``lanes``."""
    n = ops.kind.shape[0]
    if lanes <= n:
        return ops
    return OpBatch(*(torch.cat([torch.as_tensor(x), torch.full(
        (lanes - n, *x.shape[1:]), fill, dtype=torch.int32,
        device=torch.as_tensor(x).device)]) for x, fill in
        zip(ops, (NOP, 0, 0))))


def apply_batch_scan_lanes(states: gs.GraphState, ops: OpBatch,
                           cfg: gs.GraphConfig, lanes: int | None = None):
    """K stacked chunks per lane (``int32[T, K, B]`` leaves) through the
    lane step in order: the JAX package's ``jax.vmap`` of its scan.
    Returns ``(new_states, ok bool[T, K, B], ovf_delta int32[T, K],
    RepairStats of int32[T, K] tensors)``.  On the card K replays of the
    lane step graph of (cfg, B, ``lanes``, card), the T lanes in its
    first rows and NOP rows after them, and nothing read back; ``lanes``
    (default T) is the dispatch's registered tenant batch, so one graph
    serves every T up to it."""
    if step_graph.graphable(states):
        n = states.v_alive.shape[0]
        new, ok, ovf, stats = step_graph.run(
            states, _pad_lanes(ops, lanes or n), cfg, _step_lanes)
        return new, ok, ovf, _stats(stats)
    oks, ovfs, reps = [], [], []
    for k in range(ops.kind.shape[1]):
        states, ok, ovf, rep = _step_lanes(
            states, OpBatch(*(x[:, k].contiguous() for x in ops)), cfg)
        oks.append(ok)
        ovfs.append(ovf)
        reps.append(rep)
    return (states, torch.stack(oks, 1), torch.stack(ovfs, 1),
            _stats(torch.stack(reps, 1)))
