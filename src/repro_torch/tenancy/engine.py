"""Lane-batched multi-tenant engine: many small graphs, one step for all
(a port of ``repro.tenancy.engine``).

The reference stacks per-tenant ``GraphState`` pytrees along a leading
tenant axis and runs its compiled scan step under ``jax.vmap``.  The port
stacks the tensors the same way (``graph_state.stack``) and runs
:func:`repro_torch.core.dynamic.apply_batch_scan_lanes`: phases 1-4 are
one set of kernel launches for every lane (the edge table's kernels take
the lanes as rows), every fixpoint round is one ``frontier_min`` launch
and one host read for all lanes, and the repair gate, the region sizes
and the tier choice are one read each per step.  T tenants then share
the host syncs that one solo step pays.

Design rules (all load-bearing for the differential oracle test):

* **Same scheduler, same gens.**  Each tenant's chunk is cut by the very
  same :class:`~repro_torch.launch.stream.BucketedScheduler` plan and
  scan-length registry a single-tenant :class:`SCCService` would use, so
  the per-tenant generation trajectory (one bump per plan entry) is
  bit-identical to the oracle's.  Idle tenants are never stepped.
* **Per-lane fault isolation.**  Overflow and ``RepairStats`` outputs
  stay per lane.  A lane that overflows anywhere in its chunk is
  discarded wholesale and the chunk replays *solo* through a throwaway
  ``SCCService`` seeded with the tenant's pre-state and the engine's
  decision knobs -- the oracle's own grow-and-replay code, so growth
  escalation, replay gens and table layout match the single-tenant
  service decision for decision.  Other lanes commit from the shared
  dispatch untouched.
* **Capacity groups.**  A stacked dispatch needs one config, so tenants
  are grouped by their current :class:`GraphConfig`; a grown tenant
  migrates to the group of its new capacity.
* **The tenant-batch registry.**  Dispatches are cut to the registered
  ``tenant_batches`` sizes and entries are keyed ``(tenant_batch,
  scan_len, bucket, cfg)``; the registry asserts the reference's
  ``tenant_batches x scan_lengths x buckets``-per-config bound on every
  insertion.  Nothing compiles in the port, so a dispatch is not padded
  with NOP lanes up to its registered size: the registry keeps the
  reference's dispatch plan and its bound, not its padding.
* **One host transfer per capacity group per flush.**  Every dispatch's
  ``ok`` / overflow outputs and the compaction probe (per-lane
  ``fill_stats``) come back to the host together once the group's rounds
  are issued.
* **Compaction cadence.**  The oracle checks tombstone pressure after
  every chunk; the engine reads the same per-lane counts in that one
  transfer and compacts over-threshold lanes through the throwaway
  service path.

Engine parity with the oracle assumes ``proactive_grow=False`` (the
service default), as in the reference.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import community, dynamic, edge_table as et
from repro_torch.core import graph_state as gs
from repro_torch.core.service import SCCService, _ids_in_range
from repro_torch.core.sync import SYNCS
from repro_torch.launch.stream import BucketedScheduler

__all__ = ["TenantEngine"]


@dataclasses.dataclass
class _Tenant:
    tid: str
    cfg: gs.GraphConfig        # current capacity group key
    lane: int                  # lane index inside the group's stack
    gen: int                   # host-tracked committed generation
    applied_chunks: int = 0
    fallback_chunks: int = 0
    grow_count: int = 0
    replayed_ops: int = 0
    compaction_count: int = 0


class _Group:
    """One capacity class: stacked lanes plus their lane map."""

    def __init__(self, cfg: gs.GraphConfig):
        self.cfg = cfg
        self.states: Optional[gs.GraphState] = None  # leading [L] axis
        self.lanes: List[Optional[str]] = []   # lane -> tid (None = free)

    @property
    def used(self) -> int:
        return sum(1 for t in self.lanes if t is not None)


class _Work:
    """Per-tenant in-flush scratch: piece queue + transfer refs."""

    def __init__(self, tenant: _Tenant, kind, u, v, pieces):
        self.t = tenant
        self.kind, self.u, self.v = kind, u, v
        self.pieces = pieces          # [(slices, np kind/u/v [K, B])]
        self.pos = 0
        self.row = 0                  # row inside the flush's [W] stack
        self.refs = []                # [(slices, xfer index, batch row)]
        self.error: Optional[Exception] = None
        self.ok: Optional[np.ndarray] = None
        self.compacted_solo = False   # fallback path ran _maybe_compact


class TenantEngine:
    """Stacked-lane executor under :class:`MultiTenantService`.

    Holds every tenant's committed state in per-capacity-class stacked
    tensors on ``device`` and applies one chunk per tenant per
    :meth:`apply_chunks` call as rounds of lane-batched dispatches with
    ONE host transfer per capacity group.  Not a public API: the service
    layer owns admission, durability and the typed client surface.
    """

    def __init__(self, *, buckets: Sequence[int] = (64, 256, 1024),
                 scan_lengths: Sequence[int] = (1, 4, 16),
                 tenant_batches: Sequence[int] = (1, 2, 4, 8),
                 grow_factor: int = 2,
                 max_edge_capacity: int | None = None,
                 compact_tomb_frac: float = 0.25,
                 device=gs.DEFAULT_DEVICE):
        self._sched = BucketedScheduler(buckets)
        self._scan_lengths = tuple(sorted({int(s) for s in scan_lengths}
                                          | {1}))
        self._tenant_batches = tuple(sorted({int(t)
                                             for t in tenant_batches}))
        assert self._tenant_batches and all(t > 0
                                            for t in self._tenant_batches)
        self._grow_factor = grow_factor
        self._max_edge_capacity = max_edge_capacity
        self._compact_tomb_frac = compact_tomb_frac
        self._device = torch.device(device)
        self._groups: Dict[gs.GraphConfig, _Group] = {}
        self._tenants: Dict[str, _Tenant] = {}
        # one lock serializes all structural mutation; queries extract
        # committed lanes under it (group states only move at flush end)
        self._lock = threading.RLock()
        self._commit_cv = threading.Condition(self._lock)
        self._compiled: set = set()
        self._query_compiled: set = set()
        self._cfgs_minted: set = set()
        self.flush_count = 0
        self.solo_replays = 0
        self.dispatches = 0
        self.lane_steps = 0
        self.repair_lane_steps = {name: 0 for name in dynamic.TIER_NAMES}
        # counted host syncs spent flushing each capacity class
        self.host_syncs: Dict[int, int] = {}

    @property
    def device(self) -> torch.device:
        return self._device

    # ------------------------------------------------------------ registry

    @property
    def compile_count(self) -> int:
        """Distinct (tenant batch, scan length, bucket, config) dispatch
        entries used so far."""
        return len(self._compiled)

    @property
    def compile_bound(self) -> int:
        """The asserted ceiling: ``tenant_batches x scan_lengths x
        buckets`` per minted capacity class."""
        return (len(self._tenant_batches) * len(self._scan_lengths)
                * len(self._sched.buckets)
                * max(1, len(self._cfgs_minted)))

    def _register_entry(self, tb: int, k: int, b: int,
                        cfg: gs.GraphConfig):
        key = (tb, k, b, cfg)
        if key in self._compiled:
            return
        self._cfgs_minted.add(cfg)
        self._compiled.add(key)
        assert len(self._compiled) <= self.compile_bound, (
            f"per-flush recompilation detected: {len(self._compiled)} "
            f"lane-batched step entries exceed the "
            f"{len(self._tenant_batches)} tenant batches x "
            f"{len(self._scan_lengths)} scan lengths x "
            f"{len(self._sched.buckets)} buckets x "
            f"{len(self._cfgs_minted)} configs bound")

    def _pick_tenant_batch(self, n: int) -> int:
        fits = [t for t in self._tenant_batches if t >= n]
        return fits[0] if fits else self._tenant_batches[-1]

    # ---------------------------------------------------------- tenant CRUD

    def create_tenant(self, tid: str, cfg: gs.GraphConfig,
                      state: gs.GraphState | None = None,
                      gen: int | None = None):
        """Give ``tid`` a lane.  ``state``/``gen`` rehydrate an evicted
        tenant; fresh tenants boot ``gs.empty(cfg)`` at gen 0, exactly a
        fresh ``SCCService(cfg)``."""
        with self._lock:
            assert tid not in self._tenants, f"tenant {tid!r} exists"
            if state is None:
                state = gs.empty(cfg, self._device)
            lane = self._add_lane(cfg, state, tid)
            self._tenants[tid] = _Tenant(
                tid=tid, cfg=cfg, lane=lane,
                gen=SYNCS.ints(state.gen)[0] if gen is None else int(gen))

    def remove_tenant(self, tid: str) -> Tuple[gs.GraphState,
                                               gs.GraphConfig, int]:
        """Extract ``tid``'s lane and compact it out of the stack.
        Returns (state, cfg, gen) so the caller can snapshot or drop."""
        with self._lock:
            t = self._tenants.pop(tid)
            group = self._groups[t.cfg]
            state = gs.lane(group.states, t.lane)
            group.lanes[t.lane] = None
            self._compact_group(group)
            return state, t.cfg, t.gen

    def has_tenant(self, tid: str) -> bool:
        with self._lock:
            return tid in self._tenants

    def tenant_ids(self) -> List[str]:
        with self._lock:
            return list(self._tenants)

    def tenant_state(self, tid: str) -> gs.GraphState:
        """Committed snapshot of one tenant (lane extraction)."""
        with self._lock:
            t = self._tenants[tid]
            return gs.lane(self._groups[t.cfg].states, t.lane)

    def tenant_head(self, tid: str) -> Tuple[gs.GraphState, int]:
        """``(state, gen)`` of one tenant's latest commit, read together."""
        with self._lock:
            return self.tenant_state(tid), self._tenants[tid].gen

    def tenant_cfg(self, tid: str) -> gs.GraphConfig:
        with self._lock:
            return self._tenants[tid].cfg

    def tenant_gen(self, tid: str) -> int:
        with self._lock:
            return self._tenants[tid].gen

    def wait_for_gen(self, tid: str, gen: int,
                     timeout: float | None = None) -> int:
        """Block until ``tid``'s committed generation reaches ``gen``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._commit_cv:
            while tid in self._tenants and self._tenants[tid].gen < gen:
                if deadline is None:
                    self._commit_cv.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._commit_cv.wait(remaining)
            return self._tenants[tid].gen if tid in self._tenants else -1

    def tenant_telemetry(self, tid: str) -> dict:
        with self._lock:
            t = self._tenants[tid]
            return {
                "gen": t.gen,
                "edge_capacity": t.cfg.edge_capacity,
                "applied_chunks": t.applied_chunks,
                "fallback_chunks": t.fallback_chunks,
                "grows": t.grow_count,
                "replayed_ops": t.replayed_ops,
                "compactions": t.compaction_count,
            }

    def occupancy(self) -> dict:
        """Lane-occupancy telemetry per capacity class."""
        with self._lock:
            groups = {g.cfg.edge_capacity: {"lanes": len(g.lanes),
                                            "used": g.used}
                      for g in self._groups.values()}
            lanes = sum(v["lanes"] for v in groups.values())
            used = sum(v["used"] for v in groups.values())
            return {"tenants": len(self._tenants),
                    "lanes": lanes, "used": used,
                    "frac": round(used / lanes, 4) if lanes else 1.0,
                    "by_capacity": groups}

    # ------------------------------------------------------- lane plumbing

    def _add_lane(self, cfg: gs.GraphConfig, state: gs.GraphState,
                  tid: str) -> int:
        group = self._groups.get(cfg)
        if group is None:
            group = self._groups[cfg] = _Group(cfg)
        one = gs.stack([state])
        if group.states is None:
            group.states = one
            group.lanes = [tid]
            return 0
        for i, owner in enumerate(group.lanes):
            if owner is None:
                group.states = gs.set_lanes(group.states, [i], one)
                group.lanes[i] = tid
                return i
        # full: append exactly one lane; groups stay packed so the steady
        # flush runs on ``group.states`` with no gather or scatter
        group.states = gs.concat_lanes(group.states, one)
        group.lanes.append(tid)
        return len(group.lanes) - 1

    def _compact_group(self, group: _Group):
        """Repack live lanes to the front and shrink the stack -- an
        evicted tenant's tensors are released, not just masked."""
        live = [i for i, t in enumerate(group.lanes) if t is not None]
        if not live:
            del self._groups[group.cfg]
            return
        if live == list(range(len(group.lanes))):
            return
        group.states = gs.take_lanes(group.states, live)
        for new_lane, old_lane in enumerate(live):
            self._tenants[group.lanes[old_lane]].lane = new_lane
        group.lanes = [group.lanes[i] for i in live]

    def _move_tenant(self, t: _Tenant, new_cfg: gs.GraphConfig,
                     state: gs.GraphState):
        old = self._groups[t.cfg]
        old.lanes[t.lane] = None
        t.cfg = new_cfg
        t.lane = self._add_lane(new_cfg, state, t.tid)
        self._compact_group(old)

    # --------------------------------------------------------- super-chunks

    def _pack_super_chunks(self, kind, u, v):
        """``BucketedScheduler.super_chunks`` of the chunk -- the plan a
        single-tenant service runs -- as numpy [K, B] leaves (its batches
        are CPU tensors), so cross-tenant stacking costs one
        host-to-device copy per dispatch."""
        return [(slices, *(x.numpy() for x in ops))
                for slices, ops in self._sched.super_chunks(
                    kind, u, v, self._scan_lengths)]

    # -------------------------------------------------------------- updates

    def apply_chunks(self, requests):
        """Apply one chunk per tenant: ``[(tid, kind, u, v), ...]``.

        Returns ``{tid: (ok bool[N], gen int) | Exception}`` -- a failed
        tenant (capacity cap) rolls back all-or-nothing without touching
        any other lane.  A tenant may appear at most once per call.
        """
        out: Dict[str, object] = {}
        with self._lock:
            by_cfg: Dict[gs.GraphConfig, List[_Work]] = {}
            seen = set()
            for tid, kind, u, v in requests:
                assert tid not in seen, f"duplicate chunk for {tid!r}"
                seen.add(tid)
                t = self._tenants[tid]
                kind = np.asarray(kind, np.int32)
                u = np.asarray(u, np.int32)
                v = np.asarray(v, np.int32)
                if kind.shape[0] == 0:
                    out[tid] = (np.zeros(0, bool), t.gen)
                    continue
                w = _Work(t, kind, u, v,
                          self._pack_super_chunks(kind, u, v))
                by_cfg.setdefault(t.cfg, []).append(w)
            for cfg, works in by_cfg.items():
                before = SYNCS.count
                self._apply_cfg_group(cfg, works, out)
                cap = cfg.edge_capacity
                self.host_syncs[cap] = self.host_syncs.get(cap, 0) + \
                    SYNCS.count - before
            self.flush_count += 1
            self._commit_cv.notify_all()
        return out

    def _apply_cfg_group(self, cfg: gs.GraphConfig, works: List[_Work],
                         out: dict):
        # The flush works on ONE [W]-stacked scratch state (`cur`) and
        # moves lanes by whole-batch gather/scatter.  In the steady
        # serving shape -- every lane of the group flushes and fits one
        # registered tenant batch -- `cur` IS `group.states` and a round
        # is exactly one lane-batched dispatch with no data movement.
        group = self._groups[cfg]
        works = sorted(works, key=lambda w: w.t.lane)
        for r, w in enumerate(works):
            w.row = r
        lanes = [w.t.lane for w in works]
        whole = lanes == list(range(len(group.lanes)))
        cur = group.states if whole else gs.take_lanes(group.states, lanes)
        n_rows = len(works)
        xfers: List[tuple] = []       # [(ok [n,K,B], ovf [n,K])]
        # --- rounds of lane-batched dispatches ---------------------------
        while True:
            active = [w for w in works if w.pos < len(w.pieces)]
            if not active:
                break
            shapes: Dict[Tuple[int, int], List[_Work]] = {}
            for w in active:
                k, b = w.pieces[w.pos][1].shape
                shapes.setdefault((k, b), []).append(w)
            for (k, b), ws in shapes.items():
                i = 0
                while i < len(ws):
                    tb = self._pick_tenant_batch(len(ws) - i)
                    cur = self._dispatch(cfg, k, b, tb, ws[i:i + tb],
                                         cur, n_rows, xfers)
                    i += tb
            for w in active:
                w.pos += 1
        # --- the flush's single host transfer (compaction probe too) ----
        live, tomb = et.fill_stats(cur.edges)
        flat = [x.reshape(-1).int() for oks, ovf in xfers
                for x in (oks, ovf)] + [live, tomb]
        host = SYNCS.numpy(torch.cat(flat))
        host_xfers, at = [], 0
        for oks, ovf in xfers:
            n_ok, n_ovf = oks.numel(), ovf.numel()
            host_xfers.append((host[at:at + n_ok].reshape(oks.shape) != 0,
                               host[at + n_ok:at + n_ok + n_ovf]
                               .reshape(ovf.shape)))
            at += n_ok + n_ovf
        live = host[at:at + n_rows]
        tomb = host[at + n_rows:at + 2 * n_rows]
        # --- per-lane commit / solo replay -------------------------------
        fast: List[_Work] = []
        for w in works:
            host_pieces = [(host_xfers[xi][0][r], host_xfers[xi][1][r])
                           for _, xi, r in w.refs]
            total_ovf = sum(int(np.sum(ovf)) for _, ovf in host_pieces)
            if total_ovf == 0:
                ok = np.zeros(w.kind.shape[0], bool)
                steps = 0
                for (slices, _, _), (ok_kb, _) in zip(w.refs,
                                                      host_pieces):
                    for j, sl in enumerate(slices):
                        ok[sl] = ok_kb[j, :sl.stop - sl.start]
                    steps += len(slices)
                w.ok = ok
                w.t.gen += steps
                w.t.applied_chunks += 1
                fast.append(w)
            else:
                self._solo_replay(cfg, w)
        # --- commit fast-path rows back into the stack -------------------
        if fast:
            if whole and len(fast) == n_rows:
                group.states = cur
            else:
                frows = [w.row for w in fast]
                sub = cur if frows == list(range(n_rows)) \
                    else gs.take_lanes(cur, frows)
                group.states = gs.set_lanes(group.states,
                                            [w.t.lane for w in fast], sub)
        # --- oracle-cadence compaction (post-chunk tombstone check) ------
        for w, work_tomb in zip(works, tomb):
            if w.error is not None or w.compacted_solo:
                continue
            if int(work_tomb) > self._compact_tomb_frac * \
                    w.t.cfg.edge_capacity:
                self._compact_tenant(w.t)
        for w in works:
            out[w.t.tid] = w.error if w.error is not None \
                else (w.ok, w.t.gen)

    def _dispatch(self, cfg: gs.GraphConfig, k: int, b: int, tb: int,
                  ws: List[_Work], cur, n_rows: int, xfers: list):
        """One lane-batched scan step over <= tb tenants' current pieces.
        Gathers the participating rows out of the [W]-stacked ``cur``,
        scatters the results back and returns the new ``cur``; a dispatch
        covering every row in order runs on ``cur`` itself."""
        self._register_entry(tb, k, b, cfg)
        rows = [w.row for w in ws]
        full = rows == list(range(n_rows))
        sub = cur if full else gs.take_lanes(cur, rows)
        n = len(ws)
        pk = np.empty((n, k, b), np.int32)
        pu = np.empty((n, k, b), np.int32)
        pv = np.empty((n, k, b), np.int32)
        for i, w in enumerate(ws):
            _, pk[i], pu[i], pv[i] = w.pieces[w.pos]
        ops = dynamic.make_ops(pk, pu, pv)
        new_states, ok, ovf, reps = dynamic.apply_batch_scan_lanes(
            sub, ops, cfg)
        cur = new_states if full else gs.set_lanes(cur, rows, new_states)
        xi = len(xfers)
        xfers.append((ok, ovf))
        for i, w in enumerate(ws):
            w.refs.append((w.pieces[w.pos][0], xi, i))
        self.dispatches += 1
        self.lane_steps += n * k
        for tier in reps.tier.reshape(-1):
            self.repair_lane_steps[dynamic.TIER_NAMES[int(tier)]] += 1
        return cur

    def _shadow_service(self, cfg: gs.GraphConfig,
                        state: gs.GraphState) -> SCCService:
        """The oracle's own code path, seeded with one tenant's lane:
        every non-fast-path decision (growth escalation, replay,
        compaction) is delegated here so it matches a single-tenant
        service decision for decision."""
        return SCCService(cfg, buckets=self._sched.buckets, state=state,
                          grow_factor=self._grow_factor,
                          max_edge_capacity=self._max_edge_capacity,
                          compact_tomb_frac=self._compact_tomb_frac,
                          inflight_window=0,
                          scan_lengths=self._scan_lengths,
                          proactive_grow=False)

    def _solo_replay(self, cfg: gs.GraphConfig, w: _Work):
        """A doomed lane's chunk re-runs alone through grow-and-replay.

        The lane's batched outputs are discarded (its stack slot still
        holds the pre-chunk state, since the fast-path scatter happens
        after); the shadow service replays the WHOLE chunk serially from
        that pre-state, then the grown or compacted result re-enters
        whichever capacity group now matches.
        """
        self.solo_replays += 1
        t = w.t
        pre = gs.lane(self._groups[cfg].states, t.lane)
        svc = self._shadow_service(cfg, pre)
        try:
            ok = svc._apply_chunk(w.kind, w.u, w.v)
        except Exception as e:          # capacity cap: lane unchanged
            t.fallback_chunks += 1
            w.error = e
            return
        t.fallback_chunks += 1
        t.grow_count += svc.grow_count
        t.replayed_ops += svc.replayed_ops
        t.compaction_count += svc.compaction_count
        t.gen = svc.gen
        t.applied_chunks += 1
        w.ok = ok
        w.compacted_solo = True         # shadow ran _maybe_compact
        if svc.cfg != cfg:
            self._move_tenant(t, svc.cfg, svc.state)
        else:
            group = self._groups[cfg]
            group.states = gs.set_lanes(group.states, [t.lane],
                                        gs.stack([svc.state]))

    def _compact_tenant(self, t: _Tenant):
        """Post-chunk tombstone compaction, shadow-service style; a
        compaction that escalates capacity migrates the tenant."""
        group = self._groups[t.cfg]
        svc = self._shadow_service(t.cfg, gs.lane(group.states, t.lane))
        svc._maybe_compact()
        t.compaction_count += svc.compaction_count
        if svc.cfg != t.cfg:
            t.grow_count += svc.grow_count
            self._move_tenant(t, svc.cfg, svc._state)
        elif svc.compaction_count:
            group.states = gs.set_lanes(group.states, [t.lane],
                                        gs.stack([svc._state]))

    # -------------------------------------------------------------- queries

    def same_scc_many(self, items):
        """Cross-tenant SameSCC: ``[(tid, u, v), ...]`` (arrays per
        tenant) -> ``{tid: (bool[n], gen)}`` -- per-tenant batches padded
        to a shared power-of-two Q and answered in one lane-batched gather
        per capacity group and tenant batch, against committed lanes
        only."""
        return self._query_many(items, with_v=True)

    def community_of_many(self, items):
        """Cross-tenant blongsToCommunity: ``[(tid, u), ...]`` ->
        ``{tid: (int32[n], gen)}`` (sentinel ``n_vertices`` for absent or
        out-of-range ids)."""
        return self._query_many([(tid, u, None) for tid, u in items],
                                with_v=False)

    def _query_many(self, items, *, with_v: bool):
        out = {}
        with self._lock:
            by_cfg: Dict[gs.GraphConfig, list] = {}
            for tid, u, v in items:
                t = self._tenants[tid]
                by_cfg.setdefault(t.cfg, []).append(
                    (t, np.asarray(u, np.int64),
                     None if v is None else np.asarray(v, np.int64)))
            for cfg, rows in by_cfg.items():
                group = self._groups[cfg]
                qmax = max(max(r[1].shape[0], 1) for r in rows)
                q = 1 << (qmax - 1).bit_length()
                tb = self._pick_tenant_batch(len(rows))
                self._query_compiled.add(
                    ("same_scc" if with_v else "community_of",
                     tb, q, cfg))
                i = 0
                while i < len(rows):
                    sub = rows[i:i + tb]
                    i += tb
                    states = gs.take_lanes(group.states,
                                           [r[0].lane for r in sub])
                    pu = np.zeros((len(sub), q), np.int32)
                    pv = np.zeros((len(sub), q), np.int32)
                    for r, (t, uu, vv) in enumerate(sub):
                        # clip to int32 range; true range masking below
                        pu[r, :uu.shape[0]] = np.clip(uu, -1,
                                                      cfg.n_vertices)
                        if vv is not None:
                            pv[r, :vv.shape[0]] = np.clip(
                                vv, -1, cfg.n_vertices)
                    tu = torch.from_numpy(pu).to(self._device)
                    if with_v:
                        res = community.check_scc(
                            states, tu, torch.from_numpy(pv).to(
                                self._device)).cpu().numpy()
                    else:
                        res = community.belongs_to_community(
                            states, tu).cpu().numpy()
                    for r, (t, uu, vv) in enumerate(sub):
                        n = uu.shape[0]
                        vals = res[r, :n]
                        if with_v:
                            vals = vals & _ids_in_range(uu, cfg.n_vertices) \
                                & _ids_in_range(vv, cfg.n_vertices)
                        else:
                            vals = vals.copy()
                            vals[~_ids_in_range(uu, cfg.n_vertices)] = \
                                cfg.n_vertices
                        out[t.tid] = (vals, t.gen)
        return out

    # ---------------------------------------------------------------- stats

    def stats(self) -> dict:
        with self._lock:
            return {
                "tenants": len(self._tenants),
                "flushes": self.flush_count,
                "solo_replays": self.solo_replays,
                "compile_count": self.compile_count,
                "compile_bound": self.compile_bound,
                "query_shapes": len(self._query_compiled),
                "occupancy": self.occupancy(),
                "tenant_batches": list(self._tenant_batches),
                "dispatches": self.dispatches,
                "lane_steps": self.lane_steps,
                "repair_lane_steps": dict(self.repair_lane_steps),
                "host_syncs_by_capacity": dict(self.host_syncs),
            }
