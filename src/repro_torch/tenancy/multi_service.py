"""Multi-tenant serving facade: per-tenant clients over one lane-batched
engine (a port of ``repro.tenancy.multi_service``).

:class:`MultiTenantService` is the tenancy subsystem's public layer.  It
owns a :class:`~repro_torch.tenancy.engine.TenantEngine` (stacked
per-tenant states, lane-batched scan dispatch) behind a
:class:`~repro_torch.tenancy.queue.WorkQueue` (admission, coalescing,
backpressure) and exposes each tenant through the **unchanged typed
API**: :meth:`client` returns a plain :class:`repro_torch.api.GraphClient`
whose service object is a :class:`_TenantSession` -- an
``SCCService``-shaped view of one tenant (``_apply_ops`` routes through
the admission queue; ``state``/``gen``/``wait_for_gen`` read that
tenant's committed lane).  Consistency levels therefore keep their
single-tenant meaning *per tenant*: a READ_YOUR_WRITES token is a floor
on that tenant's generation counter and nothing another tenant does can
advance or stall it.

Durability is per-tenant (``directory`` given): each tenant gets its own
``<directory>/tenants/<tid>`` store in exactly the
:class:`~repro_torch.ckpt.durable.DurableService` layout -- boot snapshot +
write-ahead op log, appended under the flush with the tenant's pre-chunk
generation and rolled back if its lane fails.  That is what makes
**idle-tenant eviction** safe: ``evict`` snapshots the cold tenant,
compacts its lane out of the stacked arrays, and closes its log;
the next touch rehydrates it through ``DurableService.open`` (latest
snapshot + WAL tail, the snapshot's own decision knobs), bit-identical
to a tenant that never left.  A store written here opens in either
package (the WAL bytes and snapshot keys are the JAX package's).  Tenant
states live on ``device`` (the card unless the caller says otherwise).
"""
from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Dict, Optional

from repro_torch.ckpt import checkpoint, oplog
from repro_torch.ckpt.durable import (DurableService, _cfg_meta, snap_dir,
                                      wal_dir)
from repro_torch.core import graph_state as gs
from repro_torch.fault import errors as fault_errors
from repro_torch.tenancy.engine import TenantEngine
from repro_torch.tenancy.queue import TransferBufferPool, WorkQueue

__all__ = ["MultiTenantService", "_TenantSession"]


class _TenantHandle:
    __slots__ = ("tid", "resident", "directory", "wal", "last_used",
                 "evictions", "rehydrations", "wal_faults",
                 "parked_gen", "parked_cfg")

    def __init__(self, tid: str, directory: Optional[str]):
        self.tid = tid
        self.resident = True
        self.directory = directory
        self.wal: Optional[oplog.OpLogWriter] = None
        self.last_used = time.monotonic()
        self.evictions = 0
        self.rehydrations = 0
        self.wal_faults = 0
        self.parked_gen: Optional[int] = None     # while evicted
        self.parked_cfg: Optional[gs.GraphConfig] = None


class _TenantSession:
    """The ``SCCService`` surface of ONE tenant, as seen by
    :class:`repro_torch.api.GraphClient` and
    :class:`repro_torch.core.broker.QueryBroker`
    (which need exactly: ``_apply_ops``, ``state``, ``cfg``, ``gen``,
    ``wait_for_gen``, ``stats``)."""

    def __init__(self, service: "MultiTenantService", tid: str):
        self._mts = service
        self.tid = tid

    def _apply_ops(self, kind, u, v, *, session=None, seq=None):
        return self._mts._apply_ops(self.tid, kind, u, v,
                                    session=session, seq=seq)

    @property
    def cfg(self) -> gs.GraphConfig:
        return self._mts._tenant_cfg(self.tid)

    @property
    def state(self) -> gs.GraphState:
        """The tenant's committed lane (snapshot-consistent: lanes only
        move at flush commit, under the engine lock)."""
        return self._mts._tenant_state(self.tid)

    @property
    def head(self) -> tuple:
        """``(state, gen)`` of the tenant's latest commit, pinned together
        (what the port's broker reads)."""
        return self._mts._tenant_head(self.tid)

    @property
    def gen(self) -> int:
        return self._mts.tenant_gen(self.tid)

    def wait_for_gen(self, gen: int, timeout: float | None = None) -> int:
        return self._mts._engine.wait_for_gen(self.tid, gen,
                                              timeout=timeout)

    def stats(self) -> dict:
        return self._mts.tenant_stats(self.tid)


class MultiTenantService:
    """Many independent graphs, one engine, one admission queue.

    ``cfg`` is the boot config every fresh tenant starts from (its own
    ``SCCService(cfg)`` twin); per-tenant capacity then walks the shared
    growth ladder independently.  The decision knobs
    (``buckets``/``grow_factor``/``max_edge_capacity``/
    ``compact_tomb_frac``) are engine-wide and match the single-tenant
    defaults, which is what the differential oracle test pins.
    """

    def __init__(self, cfg: gs.GraphConfig, *,
                 buckets=(64, 256, 1024),
                 scan_lengths=(1, 4, 16),
                 tenant_batches=(1, 2, 4, 8),
                 grow_factor: int = 2,
                 max_edge_capacity: int | None = None,
                 compact_tomb_frac: float = 0.25,
                 directory: str | None = None,
                 max_pending_ops: int = 8192,
                 coalesce_ops: int = 1024,
                 flush_deadline_s: float = 0.002,
                 idle_evict_s: float | None = None,
                 snapshot_keep: int = 3,
                 wal_sync_every: int = 1,
                 device=gs.DEFAULT_DEVICE):
        self._boot_cfg = cfg
        self._device = device
        self._dir = directory
        self._idle_evict_s = idle_evict_s
        self._snapshot_keep = snapshot_keep
        self._wal_sync_every = wal_sync_every
        self._engine = TenantEngine(
            buckets=buckets, scan_lengths=scan_lengths,
            tenant_batches=tenant_batches, grow_factor=grow_factor,
            max_edge_capacity=max_edge_capacity,
            compact_tomb_frac=compact_tomb_frac, device=device)
        self._queue = WorkQueue(
            self._flush_wave, max_pending_ops=max_pending_ops,
            coalesce_ops=coalesce_ops, flush_deadline_s=flush_deadline_s,
            pool=TransferBufferPool(buckets=tuple(buckets) + (4096,)))
        self._tenants: Dict[str, _TenantHandle] = {}
        self._lock = threading.RLock()
        self._next_tid = 0
        # (tid, session) -> (seq, ok, gen): idempotent-resubmit window.
        self._session_results: Dict[tuple, tuple] = {}

    # ------------------------------------------------------------ tenants

    @property
    def queue(self) -> WorkQueue:
        return self._queue

    @property
    def engine(self) -> TenantEngine:
        return self._engine

    def tenant_ids(self):
        with self._lock:
            return list(self._tenants)

    def create_tenant(self, tid: str | None = None) -> str:
        """Provision a tenant: a fresh empty graph at generation 0 (and,
        under a durable root, its own snapshot+WAL store)."""
        with self._lock:
            if tid is None:
                tid = f"t{self._next_tid}"
                self._next_tid += 1
            assert tid not in self._tenants, f"tenant {tid!r} exists"
            tenant_dir = None
            if self._dir is not None:
                tenant_dir = os.path.join(self._dir, "tenants", tid)
            h = _TenantHandle(tid, tenant_dir)
            state = gs.empty(self._boot_cfg, self._device)
            if tenant_dir is not None:
                os.makedirs(snap_dir(tenant_dir), exist_ok=True)
                os.makedirs(wal_dir(tenant_dir), exist_ok=True)
                checkpoint.save_graph_snapshot(
                    snap_dir(tenant_dir), state,
                    self._snapshot_meta(self._boot_cfg, 0),
                    keep=self._snapshot_keep)
                h.wal = oplog.OpLogWriter(
                    wal_dir(tenant_dir), sync_every=self._wal_sync_every,
                    start_gen=0)
            self._engine.create_tenant(tid, self._boot_cfg, state=state)
            self._tenants[tid] = h
            return tid

    def delete_tenant(self, tid: str):
        """Drop the tenant: lane, handle, and durable store."""
        self._queue.flush()
        with self._lock:
            h = self._tenants.pop(tid)
            if h.resident:
                self._engine.remove_tenant(tid)
            if h.wal is not None:
                h.wal.close()
            if h.directory is not None:
                shutil.rmtree(h.directory, ignore_errors=True)

    def session(self, tid: str) -> _TenantSession:
        with self._lock:
            assert tid in self._tenants, f"unknown tenant {tid!r}"
        return _TenantSession(self, tid)

    def client(self, tid: str, **client_kwargs):
        """A standard typed :class:`repro_torch.api.GraphClient` bound to
        one tenant -- the existing API, unchanged, per tenant."""
        from repro_torch.api import GraphClient
        return GraphClient(self.session(tid), **client_kwargs)

    # ----------------------------------------------------------- eviction

    def _snapshot_meta(self, cfg: gs.GraphConfig, gen: int) -> dict:
        # byte-compatible with DurableService._snapshot_meta so
        # DurableService.open / scratch_replay rehydrate an evicted
        # tenant with the engine's own decision knobs
        return {
            "gen": int(gen),
            "cfg": _cfg_meta(cfg),
            "service": {
                "buckets": list(self._engine._sched.buckets),
                "grow_factor": self._engine._grow_factor,
                "max_edge_capacity": self._engine._max_edge_capacity,
                "compact_tomb_frac": self._engine._compact_tomb_frac,
                "proactive_grow": False,
            },
        }

    def evict(self, tid: str):
        """Park a cold tenant on disk: snapshot its lane, compact it out
        of the stacked arrays, close its WAL.  Requires a durable root
        (otherwise the state would simply be lost)."""
        self._queue.flush()
        with self._lock:
            h = self._tenants[tid]
            if not h.resident:
                return
            assert h.directory is not None, (
                "eviction needs a durable root (directory=...): an "
                "evicted tenant is rebuilt from its snapshot + WAL")
            state, cfg, gen = self._engine.remove_tenant(tid)
            checkpoint.save_graph_snapshot(
                snap_dir(h.directory), state,
                self._snapshot_meta(cfg, gen), keep=self._snapshot_keep)
            h.wal.sync()
            h.wal.close()
            h.wal = None
            oplog.trim(wal_dir(h.directory), gen)
            h.resident = False
            h.parked_gen, h.parked_cfg = gen, cfg
            h.evictions += 1

    def evict_idle(self, max_idle_s: float | None = None) -> list:
        """Evict every resident tenant idle longer than ``max_idle_s``
        (default: the service's ``idle_evict_s`` policy knob)."""
        max_idle_s = self._idle_evict_s if max_idle_s is None \
            else max_idle_s
        if max_idle_s is None or self._dir is None:
            return []
        now = time.monotonic()
        with self._lock:
            cold = [tid for tid, h in self._tenants.items()
                    if h.resident and now - h.last_used > max_idle_s]
        for tid in cold:
            self.evict(tid)
        return cold

    def _ensure_resident(self, h: _TenantHandle):
        """Rehydrate an evicted tenant through the durable recovery path:
        latest snapshot + WAL tail, under the snapshot's own decision
        knobs -- the same replay a crashed single-tenant service runs,
        so the rebuilt lane is bit-identical to one that never left."""
        if h.resident:
            return
        d = DurableService.open(h.directory, inflight_window=0,
                                device=self._device)
        state, cfg, gen = d.state, d.cfg, d.gen
        d.close()
        self._engine.create_tenant(h.tid, cfg, state=state, gen=gen)
        h.wal = oplog.OpLogWriter(wal_dir(h.directory),
                                  sync_every=self._wal_sync_every,
                                  start_gen=gen)
        h.resident = True
        h.parked_gen = h.parked_cfg = None
        h.rehydrations += 1

    # ------------------------------------------------------------ updates

    def _apply_ops(self, tid: str, kind, u, v, *, session=None,
                   seq=None):
        """The per-tenant ``GraphClient`` update entry: admission-queued,
        flushed as part of a cross-tenant wave, acknowledged with the
        tenant's post-chunk generation.  ``(session, seq)`` is the
        client idempotency key (same contract as
        :meth:`repro_torch.core.service.SCCService._apply_ops`): a re-submit
        of a session's last acknowledged chunk returns the recorded ack
        instead of re-queueing it."""
        key = None if session is None else (tid, session)
        with self._lock:
            h = self._tenants[tid]
            h.last_used = time.monotonic()
            self._ensure_resident(h)
            if key is not None:
                hit = self._session_results.get(key)
                if hit is not None and hit[0] == seq:
                    return hit[1], hit[2]
        ok, gen = self._queue.submit(tid, kind, u, v)
        if key is not None:
            with self._lock:
                self._session_results[key] = (seq, ok, gen)
                while len(self._session_results) > 4096:
                    self._session_results.pop(
                        next(iter(self._session_results)))
        return ok, gen

    def _flush_wave(self, requests):
        """WorkQueue callback: write-ahead log every tenant's chunk at
        its pre-chunk generation, apply the wave through the lane-batched
        engine, roll back the WAL record of any lane that failed.

        Faults are a per-lane matter: a tenant whose WAL append fails
        (injected disk fault, full volume, fenced log) is dropped from
        the wave -- its chunk is neither applied nor acknowledged, and
        its submitter gets a typed retryable
        :class:`~repro_torch.fault.errors.Unavailable` chained to the
        cause.
        The other tenants' lanes flush normally; one tenant's bad disk
        never fails a neighbour's write."""
        appended = []
        live = []
        errors: Dict[str, Exception] = {}
        with self._lock:
            for tid, kind, u, v in requests:
                h = self._tenants[tid]
                self._ensure_resident(h)    # evicted with a queued chunk
                h.last_used = time.monotonic()
                if h.wal is not None:
                    try:
                        h.wal.append(self._engine.tenant_gen(tid),
                                     kind, u, v)
                    except (OSError, fault_errors.Fenced) as e:
                        # append rolled itself back: nothing durable,
                        # so nothing may apply -- reject just this lane
                        h.wal_faults += 1
                        err = fault_errors.Unavailable(
                            f"tenant {tid!r} WAL append failed; chunk "
                            f"not applied",
                            retry_after=self._queue._flush_deadline_s
                            or 1e-3)
                        err.__cause__ = e
                        errors[tid] = err
                        continue
                    appended.append(h)
                live.append((tid, kind, u, v))
        results = self._engine.apply_chunks(live) if live else {}
        with self._lock:
            for h in appended:
                if isinstance(results.get(h.tid), Exception):
                    h.wal.rollback_last()
        results.update(errors)
        return results

    def flush(self):
        """Drain the admission queue synchronously."""
        self._queue.flush()

    # ------------------------------------------------------------ queries

    def _tenant_state(self, tid: str) -> gs.GraphState:
        with self._lock:
            self._ensure_resident(self._tenants[tid])
        return self._engine.tenant_state(tid)

    def _tenant_head(self, tid: str) -> tuple:
        with self._lock:
            self._ensure_resident(self._tenants[tid])
        return self._engine.tenant_head(tid)

    def _tenant_cfg(self, tid: str) -> gs.GraphConfig:
        with self._lock:
            h = self._tenants[tid]
            if not h.resident:
                return h.parked_cfg
        return self._engine.tenant_cfg(tid)

    def tenant_gen(self, tid: str) -> int:
        with self._lock:
            h = self._tenants[tid]
            if not h.resident:
                return h.parked_gen
        return self._engine.tenant_gen(tid)

    def same_scc_many(self, items):
        """Cross-tenant lane-batched SameSCC (``[(tid, u, v), ...]``) -- the
        aggregate read path the bench drives; per-tenant reads normally
        go through each tenant's client/broker."""
        with self._lock:
            for tid, _, _ in items:
                self._ensure_resident(self._tenants[tid])
        return self._engine.same_scc_many(items)

    # -------------------------------------------------------------- stats

    def tenant_stats(self, tid: str) -> dict:
        with self._lock:
            h = self._tenants[tid]
            if h.resident:
                tel = self._engine.tenant_telemetry(tid)
            else:
                tel = {"gen": h.parked_gen,
                       "edge_capacity": h.parked_cfg.edge_capacity}
            tel.update(self._queue.latency_quantiles(tid))
            tel["resident"] = h.resident
            tel["evictions"] = h.evictions
            tel["rehydrations"] = h.rehydrations
            tel["wal_faults"] = h.wal_faults
            if h.wal is not None:
                tel["wal"] = h.wal.stats()
            return tel

    def stats(self) -> dict:
        """Aggregate serving telemetry: tenant census, engine registry /
        occupancy, and admission-queue depth/flush/latency counters."""
        with self._lock:
            resident = sum(1 for h in self._tenants.values()
                           if h.resident)
            per_tenant = {tid: self.tenant_stats(tid)
                          for tid in self._tenants}
        return {
            "tenants": {"total": len(per_tenant), "resident": resident,
                        "evicted": len(per_tenant) - resident},
            "engine": self._engine.stats(),
            "queue": self._queue.stats(),
            "per_tenant": per_tenant,
        }

    def close(self):
        self._queue.flush()
        with self._lock:
            for h in self._tenants.values():
                if h.wal is not None:
                    h.wal.sync()
                    h.wal.close()
                    h.wal = None
