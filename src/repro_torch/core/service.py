"""Streaming SCC service: grow-and-replay, bucketed super-chunks and
generation-stamped snapshot queries around the dynamic step.

Mirrors ``repro.core.service.SCCService`` (see its docstring for the
design).  What differs in the port:

* Engine operations are functional -- a step returns new tensors and never
  writes into its input -- so the committed snapshot readers hold is never
  mutated and needs no private double buffer, and an overflowing chunk
  always replays from the offending super-chunk's own input state.
* There is no jit.  On the card a super-chunk of K chunks is K replays of
  the step's CUDA graph, captured once per (cfg, bucket) as the reference
  compiles once per (K, bucket, cfg) (``dynamic.apply_batch_scan``,
  ``core/step_graph.py``); on the CPU it is K eager steps.  Each
  super-chunk's ok, overflow and repair stats are read back in one
  transfer (``dynamic.read_back``), behind the same ``inflight_window`` of
  dispatched super-chunks as in the JAX service; the serial
  grow-and-replay path reads once a step.
* The service runs on ``cuda`` unless ``device`` (or a given ``state``)
  says otherwise.
* The committed generation is mirrored on the host: every step bumps
  ``state.gen`` by exactly one, so the service counts its steps instead of
  reading the device.  ``gen`` (read by routing, the WAL and replicas on
  every request or record) never waits behind queued device work.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import community, dynamic, edge_table as et
from repro_torch.core import graph_state as gs
from repro_torch.core import reach
from repro_torch.core.sync import SYNCS
from repro_torch.fault import errors as fault_errors

_MAX_GROW_ROUNDS = 16
# where the update path reads the card back (``SCCService.host_reads``):
# a super-chunk's or a step's outputs, the compaction test's fill count,
# the grow's fill counts, the replay's failed-lane test, the proactive
# grow's probe and the bulk load's failed and live counts
HOST_READ_SITES = ("read_back", "compact_check", "grow", "replay",
                   "proactive_grow", "load")


class Snapshot(NamedTuple):
    """A query result stamped with the SCC-partition generation it saw."""
    value: np.ndarray
    gen: int


def _ids_in_range(ids, nv: int) -> np.ndarray:
    ids = np.asarray(ids)
    return (ids >= 0) & (ids < nv)


def _ids(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int32)).to(device)


def _reachable_batch(state: gs.GraphState, u, v, max_inner: int,
                     impl: str = "auto") -> torch.Tensor:
    """bool[Q]: u[i] ~> v[i] over live edges (u == v and alive counts)."""
    nv = state.ccid.shape[0]
    q = u.shape[0]
    with trace.span("query.seeds"):
        uu = u.clamp(0, nv - 1).long()
        vv = v.clamp(0, nv - 1).long()
        rows = torch.arange(q, device=u.device)
        src, dst, live = gs.edge_coo(state)
        seeds = torch.zeros((q, nv), dtype=torch.bool, device=u.device)
        seeds[rows, uu] = True
    with trace.span("query.sweep"):
        reached, _ = reach.multi_forward_reach(src, dst, live, seeds,
                                               state.v_alive, max_inner,
                                               impl=impl)
        ok = state.v_alive[uu] & state.v_alive[vv]
        return ok & reached[rows, vv]


def _members_batch(state: gs.GraphState, u) -> torch.Tensor:
    """bool[Q, NV]: row i is the membership mask of u[i]'s SCC."""
    lab = community.belongs_to_community(state, u)
    return state.v_alive[None, :] & (state.ccid[None, :] == lab[:, None])


# Snapshot-query primitives shared by SCCService and QueryBroker: each
# answers against an explicit pinned state, so a broker flush serves a
# whole coalesced batch from one generation.

def same_scc_on(state: gs.GraphState, cfg: gs.GraphConfig, u, v
                ) -> np.ndarray:
    """bool[Q]: SameSCC; out-of-range ids answer False."""
    res = community.check_scc(state, _ids(u, state.device),
                              _ids(v, state.device))
    return res.cpu().numpy() & _ids_in_range(u, cfg.n_vertices) \
        & _ids_in_range(v, cfg.n_vertices)


def reachable_on(state: gs.GraphState, cfg: gs.GraphConfig, u, v
                 ) -> np.ndarray:
    """bool[Q]: u[i] ~> v[i]."""
    res = _reachable_batch(state, _ids(u, state.device),
                           _ids(v, state.device), cfg.max_inner,
                           impl=cfg.sparse_impl)
    with trace.span("query.read_back", wait=True):
        res = res.cpu().numpy()
    return res & _ids_in_range(u, cfg.n_vertices) \
        & _ids_in_range(v, cfg.n_vertices)


def members_on(state: gs.GraphState, cfg: gs.GraphConfig, u) -> np.ndarray:
    """bool[Q, NV]: SCC membership masks; rows of out-of-range ids are
    all-False."""
    res = _members_batch(state, _ids(u, state.device)).cpu().numpy()
    res[~_ids_in_range(u, cfg.n_vertices)] = False
    return res


def community_of_on(state: gs.GraphState, cfg: gs.GraphConfig, u
                    ) -> np.ndarray:
    """int32[Q]: community id; the sentinel ``n_vertices`` for
    out-of-range or dead ids."""
    lab = community.belongs_to_community(
        state, _ids(u, state.device)).cpu().numpy()
    lab[~_ids_in_range(u, cfg.n_vertices)] = cfg.n_vertices
    return lab


def community_sizes_on(state: gs.GraphState, cfg: gs.GraphConfig
                       ) -> np.ndarray:
    """int32[NV]: community-size histogram by representative id."""
    return community.community_sizes(state).cpu().numpy()


class SCCService:
    """Host-side streaming wrapper: grow-and-replay + bucketed scheduling +
    generation-stamped snapshot queries over the dynamic step."""

    def __init__(self, cfg: gs.GraphConfig,
                 buckets: Sequence[int] = (64, 256, 1024),
                 state: gs.GraphState | None = None,
                 grow_factor: int = 2,
                 max_edge_capacity: int | None = None,
                 compact_tomb_frac: float = 0.25,
                 inflight_window: int = 8,
                 scan_lengths: Sequence[int] = (1, 4, 16),
                 proactive_grow: bool = False,
                 device=gs.DEFAULT_DEVICE):
        from repro_torch.launch.stream import BucketedScheduler
        self._cfg = cfg
        self._state = gs.empty(cfg, device) if state is None else state
        self._device = self._state.device
        self._sched = BucketedScheduler(buckets)
        self._grow_factor = grow_factor
        self._max_edge_capacity = max_edge_capacity
        self._compact_tomb_frac = compact_tomb_frac
        # how many dispatched super-chunks may wait before the oldest one's
        # (ok, overflow, repair) outputs are read back (0 = serial path)
        self._inflight_window = inflight_window
        self._scan_lengths = tuple(sorted({int(s) for s in scan_lengths}
                                          | {1}))
        self._proactive_grow = proactive_grow
        # host-side upper bound on the live edge count
        self._live_ub = cfg.edge_capacity
        # host mirror of self._state.gen (one counted read, here only)
        self._gen = SYNCS.ints(self._state.gen)[0]
        # (committed state, its generation), published as one tuple so a
        # reader pins the two coherently without a lock
        self._head = (self._state, self._gen)
        self._apply_lock = threading.RLock()
        self._commit_cv = threading.Condition()
        # idempotent re-submit window: per client session, the last
        # applied (seq, ok, gen)
        self._session_results: collections.OrderedDict = \
            collections.OrderedDict()
        self._session_window = 4096
        self.deduped_resubmits = 0
        self.grow_count = 0
        self.proactive_grows = 0
        self.replayed_ops = 0
        self.compaction_count = 0
        self.pipelined_chunks = 0
        self.fallback_chunks = 0
        self.scanned_chunks = 0
        self.scan_dispatches = 0
        self.repair_tier_steps = {name: 0 for name in dynamic.TIER_NAMES}
        self.repair_region_v_max = 0
        self.repair_region_e_max = 0
        # the keys the bulk load placed after a grow (:meth:`from_edges`)
        self.load_replaced_keys = 0
        # device-to-host reads on the update path, by site
        self.host_reads = {site: 0 for site in HOST_READ_SITES}

    @classmethod
    def from_edges(cls, cfg: gs.GraphConfig, src, dst, **options
                   ) -> "SCCService":
        """A service whose committed state holds every distinct ``(src[i],
        dst[i])`` key, every vertex alive, and its SCC partition: ``cls(cfg,
        state=dynamic.recompute(gs.from_arrays(cfg, src, dst, None,
        device)), **options)``, at the same generation, except that no key
        is lost.  Where keys exhaust the probe bound, the table grows by
        ``grow_factor``, keeping every placed edge (as grow-and-replay does
        for an AddEdge), and the failed keys alone are inserted again; the
        service runs at the grown capacity, and its ``grow_count`` is the
        load's grows.  Raises ``CapacityExhausted`` past
        ``max_edge_capacity`` or after ``_MAX_GROW_ROUNDS`` grows."""
        svc = cls(cfg, **options)
        with trace.span("service.load") as sp:
            svc._load(src, dst, sp)
        return svc

    def _load(self, src, dst, sp):
        dev, nv = self._device, self._cfg.n_vertices
        src = torch.as_tensor(src, dtype=torch.int32).to(dev)
        dst = torch.as_tensor(dst, dtype=torch.int32).to(dev)
        sp.set("edges", int(src.numel()))
        self._state = self._state._replace(
            v_alive=torch.ones(nv, dtype=torch.bool, device=dev))
        for grows in range(_MAX_GROW_ROUNDS + 1):
            table, _, failed = et.insert(
                self._state.edges, src, dst, self._cfg.max_probes,
                impl=self._cfg.sparse_impl)
            self._state = self._state._replace(edges=table)
            self.host_reads["load"] += 1
            n_failed, live = torch.stack(
                [failed.sum(), et.fill_stats(table)[0].long()]).tolist()
            if n_failed == 0:
                break
            if grows == _MAX_GROW_ROUNDS:
                raise fault_errors.CapacityExhausted(
                    f"bulk load: {n_failed} keys still past the probe "
                    f"bound after {grows} grows")
            if grows == 0:  # placed by the rounds that follow
                self.load_replaced_keys = n_failed
            src, dst = src[failed], dst[failed]
            self.grow()
        sp.set("grows", grows)
        sp.set("replaced", self.load_replaced_keys)
        self._state = dynamic.recompute(self._state, self._cfg)
        self._gen += 1  # recompute bumps the state's generation once
        self._live_ub = live
        self._head = (self._state, self._gen)

    # ------------------------------------------------------------ state ---

    @property
    def cfg(self) -> gs.GraphConfig:
        return self._cfg

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def state(self) -> gs.GraphState:
        """Latest committed state (safe to query)."""
        return self._head[0]

    @property
    def gen(self) -> int:
        """The committed generation (a host int; no device read)."""
        return self._head[1]

    @property
    def head(self) -> tuple:
        """``(state, gen)`` of the latest commit, pinned together."""
        return self._head

    def _install(self, state: gs.GraphState, cfg: gs.GraphConfig):
        """Replace working and committed state wholesale (a replica's
        snapshot resync); caller holds ``_apply_lock``."""
        self._state, self._cfg = state, cfg
        self._gen = SYNCS.ints(state.gen)[0]
        self._live_ub = cfg.edge_capacity
        with self._commit_cv:
            self._head = (state, self._gen)
            self._commit_cv.notify_all()

    # ---------------------------------------------------------- updates ---

    def _apply_ops(self, kind, u, v, *, session=None, seq=None):
        """GraphClient entry: apply a chunk and report the commit gen it
        is covered by; ``(session, seq)`` dedups a re-submitted chunk."""
        with trace.span("service.apply"):
            with trace.span("service.lock_wait", wait=True):
                self._apply_lock.acquire()
            try:
                if session is not None:
                    hit = self._session_results.get(session)
                    if hit is not None and hit[0] == seq:
                        self.deduped_resubmits += 1
                        return hit[1], hit[2]
                ok = self._apply_chunk(kind, u, v)
                if session is not None:
                    self._session_results[session] = (seq, ok, self.gen)
                    self._session_results.move_to_end(session)
                    while len(self._session_results) > \
                            self._session_window:
                        self._session_results.popitem(last=False)
                return ok, self.gen
            finally:
                self._apply_lock.release()

    _STAT_ATTRS = ("grow_count", "proactive_grows", "replayed_ops",
                   "compaction_count", "pipelined_chunks",
                   "fallback_chunks", "scanned_chunks", "scan_dispatches",
                   "repair_region_v_max", "repair_region_e_max")

    def _stats_snapshot(self) -> dict:
        snap = {a: getattr(self, a) for a in self._STAT_ATTRS}
        snap["repair_tier_steps"] = dict(self.repair_tier_steps)
        return snap

    def _stats_restore(self, snap: dict):
        for a in self._STAT_ATTRS:
            setattr(self, a, snap[a])
        self.repair_tier_steps = snap["repair_tier_steps"]

    def _apply_chunk(self, kind, u, v) -> np.ndarray:
        """Apply a variable-length op chunk; returns ok: bool[N].  The
        chunk commits whole or not at all."""
        kind = np.asarray(kind, np.int32)
        u = np.asarray(u, np.int32)
        v = np.asarray(v, np.int32)
        with self._apply_lock:
            entry = self._state, self._cfg, self._gen
            entry_stats = self._stats_snapshot()
            try:
                if self._proactive_grow:
                    self._maybe_grow_proactive(kind, u, v)
                base = self._state, self._cfg, self._gen
                ok, replay = None, (0, None, None)
                if self._inflight_window > 0:
                    ok, replay = self._apply_pipelined(kind, u, v)
                if replay is not None:  # overflow (or pipeline off)
                    start, restore, restore_gen = replay
                    self.fallback_chunks += 1
                    if restore is None:  # pipeline off: start from the base
                        start = 0
                        self._state, self._cfg, self._gen = base
                        ok = np.zeros(kind.shape[0], bool)
                    else:  # prefix super-chunks stay applied
                        self._state, self._gen = restore, restore_gen
                    with trace.span("service.replay"):
                        for sl, ops in self._sched.chunks(
                                kind[start:], u[start:], v[start:]):
                            n_real = sl.stop - sl.start
                            ok[start + sl.start:
                               start + sl.start + n_real] = \
                                self._apply_padded(ops)[:n_real]
                else:
                    self.pipelined_chunks += 1
                self._live_ub = min(
                    self._cfg.edge_capacity,
                    self._live_ub + int(np.sum(kind == dynamic.ADD_EDGE)))
                self._maybe_compact()
            except Exception:
                self._state, self._cfg, self._gen = entry
                self._stats_restore(entry_stats)
                raise
            with self._commit_cv:
                self._head = (self._state, self._gen)
                self._commit_cv.notify_all()
        return ok

    def wait_for_gen(self, gen: int, timeout: float | None = None) -> int:
        """Block until the committed generation reaches ``gen``; returns
        the committed generation at wake-up."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._commit_cv:
            while self.gen < gen:
                if deadline is None:
                    self._commit_cv.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._commit_cv.wait(remaining)
            return self.gen

    def _maybe_grow_proactive(self, kind, u, v):
        """Grow ahead of a chunk whose AddEdge lanes cannot all fit
        (heuristic trigger, exact effect; reactive grow-and-replay stays
        the backstop)."""
        adds = kind == dynamic.ADD_EDGE
        n_add_raw = int(np.sum(adds))
        if n_add_raw == 0:
            return
        if self._live_ub + n_add_raw <= self._cfg.edge_capacity:
            return
        self.host_reads["proactive_grow"] += 1
        live = int(et.fill_stats(self._state.edges)[0])
        self._live_ub = live
        n_rem = int(np.sum((kind == dynamic.REM_EDGE)
                           | (kind == dynamic.REM_VERTEX)))
        keys = np.unique(np.stack([u[adds], v[adds]], axis=1), axis=0)
        if live + keys.shape[0] - n_rem <= self._cfg.edge_capacity:
            return
        # confirm by probing the deduped keys (padded to a power of two
        # with -1 keys, as the JAX service does)
        n_keys = keys.shape[0]
        n_pad = 1 << max(0, (n_keys - 1).bit_length())
        ku = np.full(n_pad, -1, np.int32)
        kv = np.full(n_pad, -1, np.int32)
        ku[:n_keys] = keys[:, 0]
        kv[:n_keys] = keys[:, 1]
        found, _ = et.lookup(self._state.edges, _ids(ku, self._device),
                             _ids(kv, self._device), self._cfg.max_probes,
                             impl=self._cfg.sparse_impl)
        self.host_reads["proactive_grow"] += 1
        n_new = int(np.sum(~found.cpu().numpy()[:n_keys]))
        predicted = live + n_new - n_rem
        if predicted <= self._cfg.edge_capacity:
            return
        cap = self._cfg.edge_capacity
        while cap < 2 * predicted:
            cap *= self._grow_factor
        if self._max_edge_capacity:
            while cap > self._max_edge_capacity:
                cap //= self._grow_factor
            if cap <= self._cfg.edge_capacity:
                return
        self.grow(cap)
        self.proactive_grows += 1

    class _InFlight(NamedTuple):
        """One dispatched super-chunk awaiting its deferred read-back."""
        slices: list
        ok: torch.Tensor  # bool[K, B]
        ovf: torch.Tensor  # int32[K]
        rstats: gs.RepairStats  # int32[K] tensors
        entry: gs.GraphState  # input state: the partial-replay anchor
        entry_gen: int
        scanned: bool

    def _apply_pipelined(self, kind, u, v) -> tuple:
        """Run the chunk as super-chunks from the scan-length registry,
        reading each one's (ok, overflow) back only once
        ``inflight_window`` newer ones have been issued (or at drain).

        Returns ``(ok, replay)``: ``replay`` is None when the whole chunk
        applied cleanly (``self._state`` advanced), else ``(start,
        state, gen)``: re-run ops from chunk offset ``start`` on the
        serial grow-and-replay path, from the offending super-chunk's
        input ``state`` at generation ``gen`` (its prefix stays applied).
        """
        state, gen = self._state, self._gen
        ok = np.zeros(kind.shape[0], bool)
        pending: collections.deque = collections.deque()
        repair_rows: list = []
        scanned = 0

        def resolve_oldest():
            nonlocal scanned
            rec = pending.popleft()
            self.host_reads["read_back"] += 1
            with trace.span("service.read_back", wait=True):
                ok_h, ovf_h, stats_h = dynamic.read_back(rec.ok, rec.ovf,
                                                         rec.rstats)
            if np.any(ovf_h):
                return rec
            for sl, row in zip(rec.slices, ok_h):
                ok[sl] = row[: sl.stop - sl.start]
            repair_rows.extend(stats_h.tolist())
            if rec.scanned:
                scanned += len(rec.slices)
            return None

        bad = None
        for slices, ops in self._sched.super_chunks(kind, u, v,
                                                    self._scan_lengths):
            entry, entry_gen = state, gen
            k = len(slices)
            with trace.span("service.dispatch") as sp:
                sp.set("k", k)
                state, ok_dev, ovf, rstats = dynamic.apply_batch_scan(
                    state, ops, self._cfg)
            gen += k  # one generation per step
            if k > 1:
                self.scan_dispatches += 1
            pending.append(self._InFlight(slices, ok_dev, ovf, rstats,
                                          entry, entry_gen, k > 1))
            if len(pending) > self._inflight_window:
                bad = resolve_oldest()
                if bad is not None:
                    break
        while bad is None and pending:
            bad = resolve_oldest()
        for t, rv, re_ in repair_rows:
            self._record_repair(t, rv, re_)
        self.scanned_chunks += scanned
        if bad is not None:
            return ok, (bad.slices[0].start, bad.entry, bad.entry_gen)
        self._state, self._gen = state, gen
        return ok, None

    def _record_repair(self, tier: int, region_v: int, region_e: int):
        self.repair_tier_steps[dynamic.TIER_NAMES[tier]] += 1
        self.repair_region_v_max = max(self.repair_region_v_max, region_v)
        self.repair_region_e_max = max(self.repair_region_e_max, region_e)

    def _apply_padded(self, ops: dynamic.OpBatch, depth: int = 0
                      ) -> np.ndarray:
        if depth > _MAX_GROW_ROUNDS:
            raise fault_errors.CapacityExhausted(
                "grow-and-replay did not converge; "
                "max_edge_capacity too small for workload?")
        self._state, ok_dev, ovf_dev, rstats = dynamic.apply_batch_stats(
            self._state, ops, self._cfg)
        self._gen += 1
        self.host_reads["read_back"] += 1
        with trace.span("service.read_back", wait=True):
            ok, ovf, stats = dynamic.read_back(ok_dev, ovf_dev, rstats)
        self._record_repair(*stats.tolist())
        if int(ovf) == 0:
            return ok
        failed = self._failed_add_lanes(ops, ok)
        if not failed.any():
            return ok
        self.grow()
        idx = np.nonzero(failed)[0]
        self.replayed_ops += len(idx)
        for sl, sub in self._sched.chunks(ops.kind.numpy()[idx],
                                          ops.u.numpy()[idx],
                                          ops.v.numpy()[idx]):
            n_real = sl.stop - sl.start
            ok[idx[sl]] = self._apply_padded(sub, depth + 1)[:n_real]
        return ok

    def _failed_add_lanes(self, ops: dynamic.OpBatch, ok: np.ndarray
                          ) -> np.ndarray:
        """AddEdge lanes the table dropped on probe-bound overflow: in
        range, reported False, both endpoints alive after the step, key
        absent from the post-step table."""
        kind, u, v = (t.numpy() for t in ops)
        nv = self._cfg.n_vertices
        in_range = (u >= 0) & (u < nv) & (v >= 0) & (v < nv)
        cand = (kind == dynamic.ADD_EDGE) & in_range & ~ok
        if not cand.any():
            return cand
        self.host_reads["replay"] += 1
        alive = self._state.v_alive.cpu().numpy()
        cand &= alive[np.clip(u, 0, nv - 1)] & alive[np.clip(v, 0, nv - 1)]
        if not cand.any():
            return cand
        found, _ = et.lookup(self._state.edges, ops.u.to(self._device),
                             ops.v.to(self._device), self._cfg.max_probes,
                             impl=self._cfg.sparse_impl)
        self.host_reads["replay"] += 1
        return cand & ~found.cpu().numpy()

    def grow(self, new_capacity: int | None = None):
        """Rehash the edge table into a larger power-of-two capacity."""
        cap = new_capacity or self._cfg.edge_capacity * self._grow_factor
        with trace.span("service.grow"):
            table, cap = self._rehash_preserving(cap)
        self._state = self._state._replace(edges=table)
        self._cfg = dataclasses.replace(self._cfg, edge_capacity=cap)
        self.grow_count += 1

    def _rehash_preserving(self, cap: int):
        """Rehash into ``cap``, doubling further until every live edge
        survives migration."""
        self.host_reads["grow"] += 1
        live_before = int(et.fill_stats(self._state.edges)[0])
        for _ in range(_MAX_GROW_ROUNDS):
            if self._max_edge_capacity and cap > self._max_edge_capacity:
                raise fault_errors.CapacityExhausted(
                    f"edge table would exceed max_edge_capacity "
                    f"({cap} > {self._max_edge_capacity})")
            table = et.rehash(self._state.edges, cap, self._cfg.max_probes,
                              impl=self._cfg.sparse_impl)
            self.host_reads["grow"] += 1
            live_after = int(et.fill_stats(table)[0])
            if live_after == live_before:
                self._live_ub = live_after
                return table, cap
            cap *= self._grow_factor
        raise fault_errors.CapacityExhausted(
            "table migration kept losing edges; "
            "max_probes too small for workload?")

    def _maybe_compact(self):
        self.host_reads["compact_check"] += 1
        with trace.span("service.compact_check", wait=True):
            tomb = int(et.fill_stats(self._state.edges)[1])
        if tomb > self._compact_tomb_frac * self._cfg.edge_capacity:
            with trace.span("service.compact"):
                table, cap = self._rehash_preserving(
                    self._cfg.edge_capacity)
            self._state = self._state._replace(edges=table)
            self._cfg = dataclasses.replace(self._cfg, edge_capacity=cap)
            self.compaction_count += 1

    # ---------------------------------------------------------- queries ---

    def same_scc(self, u, v) -> Snapshot:
        st, gen = self._head
        return Snapshot(same_scc_on(st, self._cfg, u, v), gen)

    def reachable(self, u, v) -> Snapshot:
        st, gen = self._head
        return Snapshot(reachable_on(st, self._cfg, u, v), gen)

    def scc_members(self, u) -> Snapshot:
        """bool[NV] membership mask of u's SCC."""
        st, gen = self._head
        return Snapshot(members_on(st, self._cfg, [u])[0], gen)

    def community_of(self, u) -> Snapshot:
        st, gen = self._head
        return Snapshot(community_of_on(st, self._cfg, u), gen)

    def community_sizes(self) -> Snapshot:
        st, gen = self._head
        return Snapshot(community_sizes_on(st, self._cfg), gen)

    # ------------------------------------------------------------- misc ---

    def edge_set(self) -> set:
        """Host copy of the live edge set."""
        t = self.state.edges
        live = (t.state == et.LIVE).cpu().numpy()
        return set(zip(t.src.cpu().numpy()[live].tolist(),
                       t.dst.cpu().numpy()[live].tolist()))

    def stats(self) -> dict:
        st = self.state
        live, tomb = et.fill_stats(st.edges)
        return {
            "device": str(self._device),
            "gen": self.gen,
            "n_ccs": int(st.n_ccs),
            "live_edges": int(live),
            "tombstones": int(tomb),
            "edge_capacity": self._cfg.edge_capacity,
            "overflow_total": int(st.overflow),
            "grows": self.grow_count,
            "proactive_grows": self.proactive_grows,
            "replayed_ops": self.replayed_ops,
            "compactions": self.compaction_count,
            "pipelined_chunks": self.pipelined_chunks,
            "fallback_chunks": self.fallback_chunks,
            "scanned_chunks": self.scanned_chunks,
            "scan_dispatches": self.scan_dispatches,
            "repair_dense_steps": self.repair_tier_steps["dense"],
            "repair_compact_steps": self.repair_tier_steps["compact"],
            "repair_full_steps": self.repair_tier_steps["full"],
            "repair_skipped_steps": self.repair_tier_steps["skipped"],
            "repair_region_v_max": self.repair_region_v_max,
            "repair_region_e_max": self.repair_region_e_max,
            "deduped_resubmits": self.deduped_resubmits,
            "load_replaced_keys": self.load_replaced_keys,
            "host_reads": dict(self.host_reads),
        }
