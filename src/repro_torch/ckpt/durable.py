"""Durable writer for the streaming SCC service: WAL + async snapshots (a
port of ``repro.ckpt.durable``; its stores open in either package).

``SCCService`` keeps the whole committed history in process memory; a
crash loses every acknowledged generation.  :class:`DurableService` is
the durable writer role of the replication story (docs/SERVICE_API.md
§Durability): every update chunk is appended to a segmented, CRC-framed
write-ahead log (:mod:`repro_torch.ckpt.oplog`) and fsynced *before* it is
applied, and the committed state is checkpointed periodically off the
apply path via :mod:`repro_torch.ckpt.checkpoint` graph snapshots.  Recovery
(:meth:`DurableService.open`) restores the latest intact snapshot and
replays the WAL tail -- and because every growth/compaction decision of
the service is a deterministic function of (state, chunk, decision
knobs), the recovered run is **bit-identical** to the uninterrupted one
at every committed generation: same labels, same table layout, same
generation trajectory.  ``tests/test_torch_durable.py`` holds this
equality, and equality with the JAX package, under truncation at WAL byte
offsets and mid-snapshot crashes.

Protocol per update chunk (all under the service ``_apply_lock``)::

    append(gen_before, chunk) -> fsync batch -> apply -> commit
                                       |          `-- on error: rollback
                                       |              (truncate record)
                                       `-- crash here replays the chunk
                                           on recovery (never acked, so
                                           convergence, not loss)

A fresh service writes a synchronous generation-0 boot snapshot, so
read replicas (:mod:`repro_torch.core.replicas`) can always bootstrap from
a snapshot + tail instead of special-casing an empty store.

A snapshot is taken off the apply path: the committed state's tensors are
never written in place (every engine operation is functional), so the
background thread holds a reference to them and makes the device-to-host
copy itself; the update thread never waits for it.  Every kernel runs on
the device's current stream, which is the default stream for every
thread, so the snapshot's copy queues behind the writer's work in order.

High availability: pass a held :class:`repro_torch.ha.lease.FileLease`
and the service becomes the *leader* role of the failover story -- its
WAL segments are stamped with the lease epoch (the fencing token), a
heartbeat renews the lease off the apply path, and losing it (takeover,
renewal failure, or an epoch fence hit on append) flips the store into
a permanently self-fenced state where updates raise a typed
:class:`~repro_torch.fault.errors.NotLeader` carrying the current leader as a
hint -- reads keep serving the committed state.  Promotion of a replica
into a new ``DurableService`` lives in
:meth:`repro_torch.core.replicas.Replica.promote`.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time

import numpy as np

from repro_torch.ckpt import checkpoint, oplog
from repro_torch.core import graph_state as gs
from repro_torch.core.service import SCCService
from repro_torch.fault import errors as fault_errors

__all__ = ["DurableService", "decision_kwargs", "scratch_replay",
           "wal_dir", "snap_dir", "HEALTHY", "DEGRADED", "FENCED"]

HEALTHY = "healthy"
DEGRADED = "degraded"
FENCED = "fenced"


def wal_dir(directory: str) -> str:
    return os.path.join(directory, "wal")


def snap_dir(directory: str) -> str:
    return os.path.join(directory, "snap")


def _cfg_meta(cfg: gs.GraphConfig) -> dict:
    d = dataclasses.asdict(cfg)
    # label_spec goes last, as the JAX package writes it, so both
    # packages' meta blobs are the same bytes; a mesh is not serialized
    if d.pop("label_spec") is not None:
        raise ValueError("durable snapshots do not serialize label_spec "
                         "meshes")
    d["label_spec"] = None
    d["region_edge_buckets"] = list(cfg.region_edge_buckets)
    return d


def decision_kwargs(meta: dict) -> dict:
    """SCCService kwargs recovery/replicas must reuse from a snapshot's
    meta so replay reproduces the writer's growth/compaction decisions
    (and hence its exact generation trajectory and table layout)."""
    svc = meta["service"]
    return {
        "buckets": tuple(svc["buckets"]),
        "grow_factor": svc["grow_factor"],
        "max_edge_capacity": svc["max_edge_capacity"],
        "compact_tomb_frac": svc["compact_tomb_frac"],
        "proactive_grow": svc["proactive_grow"],
    }


def scratch_replay(directory: str, from_step: int = 0,
                   to_gen: int | None = None,
                   device=gs.DEFAULT_DEVICE) -> SCCService:
    """Independent recovery oracle: replay the FULL WAL on top of the
    snapshot at ``from_step`` (default: the generation-0 boot snapshot)
    through a plain in-memory service.  Comparing this against
    :meth:`DurableService.open` (latest snapshot + tail) checks the two
    recovery paths agree bit-for-bit -- the crash-smoke's ground truth
    when the uninterrupted writer is gone (it was SIGKILLed)."""
    st, cfg, meta, _ = checkpoint.restore_graph_snapshot(
        snap_dir(directory), step=from_step, device=device)
    if st is None:
        raise FileNotFoundError(f"no snapshot {from_step} in {directory!r}")
    svc = SCCService(cfg, state=st, **decision_kwargs(meta))
    for rec in oplog.read_log(wal_dir(directory), from_gen=svc.gen):
        if to_gen is not None and svc.gen >= to_gen:
            break
        if rec.gen_before < svc.gen:
            continue
        if rec.gen_before != svc.gen:
            raise fault_errors.WalGap(
                f"WAL gap at generation {svc.gen}")
        svc._apply_ops(rec.kind, rec.u, rec.v)
    return svc


class DurableService(SCCService):
    """SCCService whose commits survive the process.

    Construct directly for a *fresh* store (boot snapshot is written
    synchronously at the initial generation); use :meth:`open` to
    recover an existing one (or transparently create it).  The state
    lives on ``device`` (or a given ``state``'s device).
    """

    def __init__(self, cfg: gs.GraphConfig, directory: str, *,
                 state: gs.GraphState | None = None,
                 device=gs.DEFAULT_DEVICE,
                 sync_every: int = 1, segment_bytes: int = 4 << 20,
                 snapshot_every: int = 256, snapshot_keep: int = 3,
                 trim_on_snapshot: bool = True,
                 boot_snapshot: bool = True, _defer_wal: bool = False,
                 recover_probe_s: float = 0.05, lease=None,
                 **service_kwargs):
        super().__init__(cfg, state=state, device=device, **service_kwargs)
        self._dir = directory
        self._wal_path = wal_dir(directory)
        self._snap_path = snap_dir(directory)
        os.makedirs(self._wal_path, exist_ok=True)
        os.makedirs(self._snap_path, exist_ok=True)
        self._sync_every = sync_every
        self._segment_bytes = segment_bytes
        self._snapshot_every = int(snapshot_every)
        self._snapshot_keep = snapshot_keep
        self._trim_on_snapshot = trim_on_snapshot
        self._snap_thread: threading.Thread | None = None
        self._last_snap_gen = -1
        self.snapshot_count = 0
        self.replayed_wal_records = 0
        self.restore_s = 0.0  # recovery: snapshot restore, then WAL replay
        self.replay_s = 0.0
        self._wal: oplog.OpLogWriter | None = None
        # leadership (see module docstring): the lease's epoch is the
        # WAL fencing token; once fenced/crashed the store never writes
        # again and updates bounce typed NotLeader with a leader hint
        self._lease = lease
        if lease is not None and not lease.valid:
            raise fault_errors.NotLeader(
                f"cannot open durable writer for {directory!r}: the "
                f"lease is not held", leader=self._leader_hint())
        self._epoch = lease.epoch if lease is not None else 0
        self._fenced = False
        self._fenced_error: BaseException | None = None
        self._crashed = False
        self.notleader_rejects = 0
        # degraded-mode state machine (see `health`): a WAL disk fault
        # flips writes off while reads keep serving the committed state;
        # probes rate-limited by recover_probe_s re-attach when it heals
        self._degraded = False
        self._degraded_error: BaseException | None = None
        self._recover_probe_s = float(recover_probe_s)
        self._last_probe = 0.0
        self.degraded_count = 0
        self.recovered_count = 0
        self.unavailable_rejects = 0
        self.snapshot_failures = 0
        if boot_snapshot and \
                checkpoint.latest_step(self._snap_path) is None:
            self.snapshot_now()
        if not _defer_wal:
            self._attach_wal()
        if lease is not None:
            lease.start_heartbeat()

    # ---------------------------------------------------------- opening ---

    @classmethod
    def open(cls, directory: str, cfg: gs.GraphConfig | None = None, *,
             state: gs.GraphState | None = None, to_gen: int | None = None,
             device=gs.DEFAULT_DEVICE,
             sync_every: int = 1, segment_bytes: int = 4 << 20,
             snapshot_every: int = 256, snapshot_keep: int = 3,
             trim_on_snapshot: bool = True, recover_probe_s: float = 0.05,
             lease=None, **service_kwargs) -> "DurableService":
        """Recover (or create) the durable store at ``directory``.

        Recovery restores the latest intact snapshot onto ``device``,
        reconstructs the service with the snapshot's decision knobs
        (perf-only kwargs -- ``inflight_window``, ``scan_lengths`` -- may
        be passed and differ freely: they never change results or the
        generation trajectory), replays the WAL tail, and reopens the
        log for appending.  ``to_gen`` stops the replay at the first
        committed generation ``>= to_gen`` and leaves the service
        *read-only* (no WAL attached) -- the time-travel hook the
        crash-injection tests use to compare against the uninterrupted
        run at an arbitrary generation.
        """
        t0 = time.perf_counter()
        st, rcfg, meta, _ = checkpoint.restore_graph_snapshot(
            snap_dir(directory), device=device)
        restore_s = time.perf_counter() - t0
        durable_kw = dict(sync_every=sync_every,
                          segment_bytes=segment_bytes,
                          snapshot_every=snapshot_every,
                          snapshot_keep=snapshot_keep,
                          trim_on_snapshot=trim_on_snapshot,
                          recover_probe_s=recover_probe_s, lease=lease)
        if st is None:
            if cfg is None:
                raise FileNotFoundError(
                    f"no snapshot under {directory!r} and no GraphConfig "
                    f"given for a fresh store")
            return cls(cfg, directory, state=state, device=device,
                       **durable_kw, **service_kwargs)
        kwargs = {**service_kwargs, **decision_kwargs(meta)}
        self = cls(rcfg, directory, state=st, boot_snapshot=False,
                   _defer_wal=True, **durable_kw, **kwargs)
        self._last_snap_gen = int(meta["gen"])
        self.restore_s = restore_s
        t0 = time.perf_counter()
        self._replay(to_gen)
        self.replay_s = time.perf_counter() - t0
        if to_gen is None:
            self._attach_wal()
        return self

    def _replay(self, to_gen: int | None):
        """Apply the WAL tail on top of the restored snapshot (the
        ``_wal is None`` guard in ``_apply_chunk`` keeps replay from
        re-logging itself)."""
        for rec in oplog.read_log(self._wal_path, from_gen=self.gen):
            if to_gen is not None and self.gen >= to_gen:
                break
            if rec.gen_before < self.gen:
                continue  # already inside the snapshot
            if rec.gen_before != self.gen:
                raise fault_errors.WalGap(
                    f"WAL gap: record expects generation "
                    f"{rec.gen_before}, store is at {self.gen}")
            self._apply_chunk(rec.kind, rec.u, rec.v)
            self.replayed_wal_records += 1

    def _attach_wal(self):
        oplog.repair_tail(self._wal_path)
        # a failed append whose rollback never reached the sick disk can
        # leave a valid-but-unapplied record behind; it must not shadow
        # the next chunk logged at the same generation (an OSError here
        # fails the recovery probe -- the disk has not healed)
        oplog.drop_unapplied_tail(self._wal_path, self.gen)
        # leaderless stores adopt the directory's newest epoch (epoch
        # continuity across plain restarts); a leased writer stamps its
        # fencing token explicitly -- a stale lease raises Fenced here
        self._wal = oplog.OpLogWriter(
            self._wal_path, segment_bytes=self._segment_bytes,
            sync_every=self._sync_every, start_gen=self.gen,
            epoch=self._lease.epoch if self._lease is not None else None)
        self._epoch = self._wal.epoch

    # ----------------------------------------------------------- updates --

    def _leader_hint(self) -> str | None:
        """Current lease owner, when it is someone else (the NotLeader
        redirect hint clients reroute on)."""
        if self._lease is None:
            return None
        info = self._lease.peek()
        if info is None or info.owner == self._lease.owner:
            return None
        return info.owner

    def _not_leader(self, why: str, cause: BaseException | None = None):
        self.notleader_rejects += 1
        raise fault_errors.NotLeader(
            f"durable store {self._dir!r}: {why}; reroute to the "
            f"current leader and resubmit (idempotent)",
            leader=self._leader_hint(),
            retry_after=self._lease.ttl_s if self._lease is not None
            else self._recover_probe_s) from cause

    def _apply_chunk(self, kind, u, v) -> np.ndarray:
        with self._apply_lock:
            if self._crashed:
                self._not_leader("writer crashed (chaos injection)")
            if self._fenced:
                self._not_leader("fenced by a higher writer epoch",
                                 self._fenced_error)
            if self._lease is not None and not self._lease.valid:
                # self-fence on lease loss: even though the WAL fence
                # would stop the append anyway, refusing here keeps the
                # failure typed as leadership, not as a disk fault
                self._fenced = True
                self._fenced_error = self._lease.lost_reason
                self._not_leader("write lease lost",
                                 self._lease.lost_reason)
            if self._degraded and not self._try_recover():
                self.unavailable_rejects += 1
                raise fault_errors.Unavailable(
                    f"durable store {self._dir!r} is DEGRADED "
                    f"({self._degraded_error}); reads keep serving the "
                    f"committed snapshot, retry the update",
                    retry_after=self._recover_probe_s)
            if self._wal is None:  # recovery replay / read-only travel
                return super()._apply_chunk(kind, u, v)
            kind = np.asarray(kind, np.int32)
            u = np.asarray(u, np.int32)
            v = np.asarray(v, np.int32)
            # write-ahead: the record must be durable before any effect
            # of the chunk can commit; a crash after the append replays
            # an unacknowledged chunk, which converges (never diverges)
            try:
                self._wal.append(self.gen, kind, u, v)
            except fault_errors.Fenced as e:
                # a higher epoch owns the log: nothing was written and
                # nothing may ever be again -- permanent self-fence
                self._fenced = True
                self._fenced_error = e
                self._not_leader("fenced by a higher writer epoch", e)
            except OSError as e:
                # nothing applied: reject this chunk as retryable and
                # flip to DEGRADED (reads unaffected)
                self._enter_degraded(e)
                raise fault_errors.Unavailable(
                    f"WAL append failed ({e}); store DEGRADED",
                    retry_after=self._recover_probe_s) from e
            try:
                ok = super()._apply_chunk(kind, u, v)
            except Exception:
                try:
                    self._wal.rollback_last()
                except OSError as e:  # disk died under the rollback too
                    self._enter_degraded(e)
                raise
            # the chunk is committed and durable past this point: house-
            # keeping failures (rotation, snapshot kick) must degrade the
            # store, never un-ack the chunk -- failing here would make a
            # committed chunk look failed and a client retry double-apply
            try:
                self._wal.maybe_rotate(self.gen)
            except fault_errors.Fenced as e:  # fence landed mid-commit:
                self._fenced = True           # this chunk is durable at
                self._fenced_error = e        # our epoch; the NEXT one
            except OSError as e:              # bounces NotLeader
                self._enter_degraded(e)
            self._maybe_snapshot()
            return ok

    def sync(self):
        """Force-fsync any batched WAL appends (the ``sync_every > 1``
        durability window closes here).  A failed sync degrades the
        store and raises :class:`~repro_torch.fault.errors.Unavailable`."""
        if self._wal is not None:
            with self._apply_lock:
                try:
                    self._wal.sync()
                except OSError as e:
                    self._enter_degraded(e)
                    raise fault_errors.Unavailable(
                        f"WAL fsync failed ({e}); store DEGRADED",
                        retry_after=self._recover_probe_s) from e

    # ----------------------------------------------------- degraded mode --

    @property
    def health(self) -> str:
        """``"healthy"`` (read-write), ``"degraded"`` (read-only: the
        WAL disk is refusing writes; queries keep answering from the
        committed state, updates raise ``Unavailable(retry_after)``
        until a probe re-attaches the log), or ``"fenced"`` (read-only
        forever: leadership moved to a higher epoch -- updates raise
        ``NotLeader`` with the new leader as a hint)."""
        if self._fenced or self._crashed:
            return FENCED
        return DEGRADED if self._degraded else HEALTHY

    @property
    def epoch(self) -> int:
        """The writer epoch stamped on this store's WAL segments."""
        return self._epoch

    @property
    def lease(self):
        return self._lease

    def crash(self):
        """Chaos hook: make this writer behave as if SIGKILLed -- the
        lease heartbeat stops (WITHOUT backdating: failover must wait
        out the TTL, the realistic path), no clean WAL close happens,
        and every later update bounces :class:`~repro_torch.fault.errors.
        NotLeader` the way a connection to a dead process would."""
        self._crashed = True
        if self._lease is not None:
            self._lease.abandon()

    def _enter_degraded(self, e: BaseException):
        """Flip to read-only after a WAL-side OSError (idempotent).  The
        current segment's unacknowledged tail bytes are best-effort
        discarded; ``repair_tail`` at recovery covers the rest."""
        if self._degraded:
            return
        self._degraded = True
        self._degraded_error = e
        self.degraded_count += 1
        self._last_probe = time.monotonic()
        if self._wal is not None:
            self._wal.discard_tail()

    def _try_recover(self, force: bool = False) -> bool:
        """Probe the disk (rate-limited) and re-attach the WAL if it
        heals: repair the torn tail, open a fresh segment -- whose
        header write + fsync IS the probe.  Caller holds _apply_lock."""
        if self._fenced:
            return False  # leadership is gone for good, not a disk blip
        now = time.monotonic()
        if not force and now - self._last_probe < self._recover_probe_s:
            return False
        self._last_probe = now
        old, self._wal = self._wal, None
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
        try:
            self._attach_wal()
        except fault_errors.Fenced as e:
            self._fenced = True
            self._fenced_error = e
            return False
        except OSError:
            return False  # still sick; _wal stays None, _degraded True
        self._degraded = False
        self._degraded_error = None
        self.recovered_count += 1
        return True

    def probe_recovery(self) -> bool:
        """Explicitly probe a DEGRADED store (ignores the rate limit);
        returns True when healthy (recovered or never degraded)."""
        with self._apply_lock:
            if not self._degraded:
                return True
            return self._try_recover(force=True)

    # --------------------------------------------------------- snapshots --

    def _snapshot_meta(self, cfg: gs.GraphConfig, gen: int) -> dict:
        return {
            "gen": int(gen),
            "epoch": int(self._epoch),
            "cfg": _cfg_meta(cfg),
            "service": {
                "buckets": list(self._sched.buckets),
                "grow_factor": self._grow_factor,
                "max_edge_capacity": self._max_edge_capacity,
                "compact_tomb_frac": self._compact_tomb_frac,
                "proactive_grow": self._proactive_grow,
            },
        }

    def _write_snapshot(self, state: gs.GraphState, cfg: gs.GraphConfig,
                        gen: int):
        checkpoint.save_graph_snapshot(
            self._snap_path, state, self._snapshot_meta(cfg, gen),
            keep=self._snapshot_keep)
        self.snapshot_count += 1
        if self._trim_on_snapshot:
            oplog.trim(self._wal_path, gen)

    def _write_snapshot_bg(self, state: gs.GraphState,
                           cfg: gs.GraphConfig, gen: int):
        """Background-thread snapshot wrapper: a failed snapshot is a
        durability *cadence* miss, never a serving failure -- the WAL
        still covers every commit.  Count it and let a later commit
        retry (the snapshot floor is rolled back)."""
        try:
            self._write_snapshot(state, cfg, gen)
        except OSError:
            self.snapshot_failures += 1
            if self._last_snap_gen == gen:
                self._last_snap_gen = -1  # let the next commit re-kick

    def _maybe_snapshot(self):
        """Kick an async snapshot of the committed state every
        ``snapshot_every`` generations (0 disables).  The state's tensors
        are never written in place, so the background thread needs no
        coordination with the update path beyond capturing (state, cfg,
        gen) coherently -- which the caller's ``_apply_lock`` provides."""
        if self._snapshot_every <= 0:
            return
        if self.gen - max(self._last_snap_gen, 0) < self._snapshot_every:
            return
        if self._snap_thread is not None and self._snap_thread.is_alive():
            return  # one snapshot in flight at a time; next commit retries
        (state, gen), cfg = self.head, self._cfg
        self._last_snap_gen = gen
        self._snap_thread = threading.Thread(
            target=self._write_snapshot_bg, args=(state, cfg, gen),
            name="scc-snapshotter", daemon=True)
        self._snap_thread.start()

    def snapshot_now(self) -> int:
        """Synchronously snapshot the committed state; returns its gen."""
        with self._apply_lock:
            (state, gen), cfg = self.head, self._cfg
            self._last_snap_gen = gen
        self._write_snapshot(state, cfg, gen)
        return gen

    def close(self, snapshot: bool = False):
        """Flush + close the WAL (optionally snapshotting first) and wait
        out any in-flight background snapshot."""
        if snapshot:
            self.snapshot_now()
        if self._snap_thread is not None:
            self._snap_thread.join()
            self._snap_thread = None
        if self._wal is not None:
            try:
                self._wal.close()
            except OSError as e:  # final fsync on a sick disk
                self._enter_degraded(e)
            self._wal = None
        if self._lease is not None and not self._crashed:
            self._lease.release()  # graceful handoff: successor takes
            # over on its next poll instead of waiting out a full TTL

    # -------------------------------------------------------------- misc --

    @property
    def directory(self) -> str:
        return self._dir

    def stats(self) -> dict:
        out = super().stats()
        out.update(self._wal.stats() if self._wal is not None
                   else {"wal_appended": 0})
        out.update(snapshots=self.snapshot_count,
                   last_snapshot_gen=self._last_snap_gen,
                   replayed_wal_records=self.replayed_wal_records,
                   restore_s=self.restore_s, replay_s=self.replay_s,
                   health=self.health,
                   epoch=self._epoch,
                   degraded_count=self.degraded_count,
                   recovered_count=self.recovered_count,
                   unavailable_rejects=self.unavailable_rejects,
                   notleader_rejects=self.notleader_rejects,
                   snapshot_failures=self.snapshot_failures)
        if self._lease is not None:
            out.update(self._lease.stats())
        return out
