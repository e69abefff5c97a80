"""Read replicas over the durable WAL: restore a snapshot, tail the log,
serve QueryBroker traffic (a port of ``repro.core.replicas``).

The paper's readers are wait-free against one shared-memory object; the
replication layer scales that read path past one process: a
:class:`Replica` bootstraps from the writer's latest graph snapshot
(written by :class:`repro_torch.ckpt.durable.DurableService` -- a fresh
store always has a boot snapshot), then *tails* the write-ahead log,
applying each record through the standard service update path.  Because
records replay with the writer's own decision knobs (bucket registry,
growth policy -- carried in the snapshot meta), a replica's state is
bit-identical to the writer's at every committed generation it passes
through, so its :class:`repro_torch.core.broker.QueryBroker` serves the
exact same consistency contract: `AT_LEAST(gen)` answers only after the
replica has tailed past ``gen`` (the broker's gen-wait defers early
arrivals), and per-reader generation stamps stay monotone.

:class:`ReplicaSet` fans N replicas behind one broker-shaped facade
(``submit``/``resolve``/``stats``/``stop``): each query batch routes to
a replica that already satisfies its consistency floor when one exists
(freshest-first; round-robin among the qualified), falling back to the
most caught-up replica otherwise -- with staggered tail cycles this
hides replication lag, which is where the replica-count throughput
scaling comes from.  A replica that finds the log trimmed underneath its
cursor (the writer snapshotted and dropped old segments) resyncs from the
newest snapshot and keeps going.

Failure domains (docs/ARCHITECTURE.md §Failure domains): routing only
considers *healthy* replicas -- one whose tail loop died, was
:meth:`Replica.kill`-ed by fault injection, or has missed
``health_misses`` consecutive poll deadlines is quarantined.  A
query in flight on a replica that dies fails over transparently: the
dead broker releases the future with a typed
:class:`~repro_torch.fault.errors.BrokerStopped` and the set resubmits it to
a healthy peer (queries are read-only, so a resubmit is always safe).
With ``supervise=True`` a supervisor thread restarts dead replicas via
snapshot fast-forward -- a fresh :class:`Replica` bootstraps from the
newest snapshot exactly like ``_resync``, so recovery time is one
snapshot restore, not a full log replay.  With no healthy replica at
all, ``submit`` raises :class:`~repro_torch.fault.errors.Unavailable` with
a ``retry_after`` of one poll interval.

On a card every replica holds its own copy of the state, and its tail
thread launches its kernels on the default stream, as the writer's and
the brokers' threads do: one stream keeps the cooperative launches of the
edge table from ever running side by side.  Routing reads each replica's
``gen``, a host int, so it never waits behind queued device work.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Dict, List, Sequence, Tuple

from repro_torch.ckpt import checkpoint, oplog
from repro_torch.ckpt.durable import (DurableService, decision_kwargs,
                                      snap_dir, wal_dir)
from repro_torch.core import graph_state as gs
from repro_torch.core.broker import QueryBroker
from repro_torch.core.service import SCCService
from repro_torch.fault import errors as fault_errors

__all__ = ["Replica", "ReplicaSet"]


class Replica:
    """One read replica: snapshot-restored service + WAL tailer + broker.

    ``auto_tail=False`` (tests) disables the background threads; drive
    the replica manually with :meth:`tail_once` and inline broker
    flushes.  The state lives on ``device``.
    """

    def __init__(self, directory: str, replica_id: int = 0, *,
                 query_buckets: Sequence[int] = (64, 256, 1024),
                 poll_interval: float = 0.002, poll_offset: float = 0.0,
                 max_records_per_poll: int | None = 64,
                 auto_tail: bool = True, health_misses: int = 25,
                 stale_floor_s: float = 2.0, device=gs.DEFAULT_DEVICE,
                 **service_kwargs):
        self._dir = directory
        self._device = device
        self.replica_id = replica_id
        self._poll_interval = poll_interval
        self._poll_offset = poll_offset
        self._max_records = max_records_per_poll
        self._service_kwargs = service_kwargs
        self._health_misses = health_misses
        self._stale_floor_s = stale_floor_s
        self._killed = False
        self._last_tick = time.monotonic()
        st, cfg, meta, _ = checkpoint.restore_graph_snapshot(
            snap_dir(directory), device=device)
        if st is None:
            raise FileNotFoundError(
                f"no graph snapshot under {directory!r} -- replicas "
                f"bootstrap from the writer's boot snapshot")
        # the WRITER's decision knobs: replaying records through the same
        # bucketed update path reproduces its exact gen trajectory
        self._decision_kwargs = decision_kwargs(meta)
        self._svc = SCCService(cfg, state=st,
                               **self._decision_kwargs, **service_kwargs)
        self._tailer = oplog.LogTailer(wal_dir(directory),
                                       from_gen=self._svc.gen)
        self.broker = QueryBroker(self._svc, buckets=query_buckets)
        self.applied_records = 0
        self.apply_failures = 0
        self.resyncs = 0
        self.error: BaseException | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if auto_tail:
            self.broker.start()
            self._thread = threading.Thread(
                target=self._run, name=f"scc-replica-{replica_id}",
                daemon=True)
            self._thread.start()

    # ------------------------------------------------------------ state ---

    @property
    def service(self) -> SCCService:
        return self._svc

    @property
    def gen(self) -> int:
        return self._svc.gen

    def wait_for_gen(self, gen: int, timeout: float | None = None) -> int:
        return self._svc.wait_for_gen(gen, timeout)

    @property
    def healthy(self) -> bool:
        """Routing health: False once the replica was killed, its tail
        loop died on an error, or (with a tail thread) it has missed
        ``health_misses`` consecutive poll deadlines -- the quarantine
        signal.  The miss threshold is floored at ``stale_floor_s`` so a
        one-off long apply does not flap it."""
        if self._killed or self.error is not None:
            return False
        t = self._thread
        if t is None:
            return True  # manual mode: driven explicitly, never stale
        if not t.is_alive():
            return False
        stale = max(self._health_misses * self._poll_interval,
                    self._stale_floor_s)
        return (time.monotonic() - self._last_tick) < stale

    def kill(self):
        """Fault injection: 'crash' this replica abruptly.  The tail
        loop is told to exit (not joined -- the kill point must not wait
        on a mid-apply tick), routing health flips False immediately,
        and the broker releases every parked future with a typed
        :class:`~repro_torch.fault.errors.BrokerStopped` (the ReplicaSet's
        failover signal)."""
        self._killed = True
        self._stop.set()
        self.broker.stop()

    def next_tick_eta(self) -> float:
        """Seconds until this replica's next scheduled WAL pull
        (``inf`` without a tail thread) -- the routing signal for
        requests no replica can answer yet: any replica reaches a
        durable record at its next tick, so the soonest tick wins."""
        if self._thread is None:
            return float("inf")
        now = time.monotonic()
        period = self._poll_interval
        phase = (now - self._poll_offset) / period
        return (int(phase) + 1) * period + self._poll_offset - now

    # ---------------------------------------------------------- tailing ---

    def tail_once(self, max_records: int | None = -1) -> int:
        """Apply newly completed WAL records; returns how many.  The
        default batch cap is the constructor's ``max_records_per_poll``;
        pass ``None`` for an unbounded pull."""
        if max_records == -1:
            max_records = self._max_records
        try:
            records = self._tailer.poll(max_records)
        except (FileNotFoundError, IOError, fault_errors.WalTrimmed,
                fault_errors.WalCorrupt):
            # segments trimmed underneath the cursor (or writer-side
            # corruption): a resync *signal*, never a failure -- jump
            # forward via the newest snapshot (it covers everything a
            # trim dropped; that is the trim precondition)
            self._resync()
            return 0
        n = 0
        for rec in records:
            if rec.gen_before < self._svc.gen:
                continue  # already covered by the snapshot we booted from
            if rec.gen_before > self._svc.gen:
                self._resync()  # gap: our segment window moved on
                return n
            try:
                self._svc._apply_ops(rec.kind, rec.u, rec.v)
            except Exception:
                # the writer hit the same deterministic failure and rolled
                # the record back (all-or-nothing chunks); our cursor now
                # points past truncated bytes -- re-seat it at our gen.
                # A record that keeps failing in place is a real fault.
                self.apply_failures += 1
                if self.apply_failures > 3 + self.applied_records:
                    raise
                self._tailer = oplog.LogTailer(wal_dir(self._dir),
                                               from_gen=self._svc.gen)
                return n
            self.applied_records += 1
            n += 1
        return n

    def _resync(self):
        """Fast-forward from the newest snapshot (only ever forward --
        a snapshot older than our state is ignored)."""
        st, cfg, meta, _ = checkpoint.restore_graph_snapshot(
            snap_dir(self._dir), device=self._device)
        if st is None:
            return
        if int(meta["gen"]) > self._svc.gen:
            with self._svc._apply_lock:
                self._svc._install(st, cfg)
        self._tailer = oplog.LogTailer(wal_dir(self._dir),
                                       from_gen=self._svc.gen)
        self.resyncs += 1

    # -------------------------------------------------------- promotion ---

    def promote(self, lease, **durable_kwargs) -> DurableService:
        """Become the durable writer: the failover half of the HA story.

        ``lease`` must be acquirable (fresh, stale, or already held by
        this caller) -- its post-acquire epoch is the new fencing token.
        The order is what makes the handoff exactly-once:

        1. **take the lease** (epoch bump E = old + 1);
        2. **fence the WAL at E** -- from this instant the old writer's
           next append raises ``Fenced`` with nothing written, while any
           append that completed before it is durable on disk;
        3. **repair + drain the tail to the fenced end** -- every acked
           op (and any durable-but-unacked record, the standard recovery
           convention) is applied to this replica's state;
        4. **open the epoch-E writer** over that state -- a
           :class:`~repro_torch.ckpt.durable.DurableService` sharing this
           replica's committed state, appending epoch-E segments.

        The replica keeps serving reads (its broker never stops) and
        resumes tailing afterwards, now following its own writer's log.
        Raises :class:`~repro_torch.fault.errors.Unavailable` when the lease
        cannot be taken (holder still alive / lost the takeover race).
        """
        if not lease.try_acquire():
            raise fault_errors.Unavailable(
                f"replica {self.replica_id} could not take the write "
                f"lease (holder alive or takeover race lost)",
                retry_after=lease.ttl_s)
        # pause tailing so the drain below owns the tailer exclusively
        resume = self._thread is not None
        if resume:
            self._stop.set()
            self._thread.join()
            self._thread = None
        oplog.write_fence(wal_dir(self._dir), lease.epoch)
        oplog.repair_tail(wal_dir(self._dir))
        for _ in range(100_000):
            before = self._svc.gen
            if self.tail_once(max_records=None) == 0 \
                    and self._svc.gen == before:
                break
        else:
            raise fault_errors.WalGap(
                f"replica {self.replica_id} could not drain the WAL "
                f"tail to the fenced end (no progress)")
        leader = DurableService(
            self._svc.cfg, self._dir, state=self._svc.state,
            boot_snapshot=False, _defer_wal=True, lease=lease,
            **self._decision_kwargs, **durable_kwargs)
        leader._attach_wal()  # opens the first epoch-E segment
        if resume:
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._run, name=f"scc-replica-{self.replica_id}",
                daemon=True)
            self._thread.start()
        return leader

    def _run(self):
        """Pull loop on a wall-clock-aligned grid: ticks land at
        ``k * poll_interval + poll_offset``, so a ReplicaSet can stagger
        its members' pull phases evenly across the period -- the
        freshness wait a reader sees drops from ~period/2 (one replica)
        to ~period/2N (N staggered replicas), which is the lag-hiding
        the replica-scaling bench measures.  Each tick is ONE unbounded
        pull -- the durable prefix as of tick time; records appended
        while it applies wait for the next tick (chasing them would
        degenerate into busy-tailing whenever the writer is active)."""
        period = self._poll_interval
        while not self._stop.is_set():
            # heartbeat stamped at tick START as well as end: a single
            # long apply (a large batch) must read as
            # one slow tick, not health_misses missed polls -- otherwise
            # the supervisor shuts a live replica down mid-apply and the
            # restart replays again, looping the quarantine
            self._last_tick = time.monotonic()
            try:
                self.tail_once(max_records=None)
            except BaseException as e:  # surfaced via stats/stop
                self.error = e
                return
            self._last_tick = time.monotonic()  # health heartbeat
            now = time.monotonic()
            phase = (now - self._poll_offset) / period
            next_tick = (int(phase) + 1) * period + self._poll_offset
            self._stop.wait(max(1e-4, next_tick - now))

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.broker.stop()
        if self.error is not None:
            raise self.error

    def shutdown(self) -> BaseException | None:
        """Quarantine-path stop: like :meth:`stop` but never raises --
        the supervisor tears down an already-failed replica and needs
        the error as a value, not a crash of its own loop."""
        try:
            self.stop()
        except BaseException as e:
            return e
        return None

    def stats(self) -> dict:
        return {f"replica{self.replica_id}_gen": self.gen}


class ReplicaSet:
    """Broker-shaped facade over N replicas with freshness-aware routing.

    Drop-in where a :class:`QueryBroker` is expected (a
    :class:`repro_torch.api.GraphClient` takes it as its ``broker``,
    typically
    with the *writer* service as the update path -- writes go to the
    writer, reads to the replicas, and READ_YOUR_WRITES floors flow
    through ``min_gen`` to a replica that has tailed far enough).
    """

    def __init__(self, directory: str, n: int = 2, *,
                 query_buckets: Sequence[int] = (64, 256, 1024),
                 poll_interval: float = 0.002,
                 auto_tail: bool = True, supervise: bool = False,
                 health_check_s: float | None = None,
                 max_restarts: int = 8,
                 promote_on_writer_loss: bool = False,
                 lease_ttl_s: float = 0.5,
                 writer_kwargs: dict | None = None,
                 device=gs.DEFAULT_DEVICE, **replica_kwargs):
        assert n >= 1
        self._dir = directory
        self._n = n
        self._query_buckets = query_buckets
        self._poll_interval = poll_interval
        self._auto_tail = auto_tail
        self._replica_kwargs = dict(replica_kwargs, device=device)
        self.replicas: List[Replica] = [
            self._spawn_replica(i) for i in range(n)]
        self._rr = itertools.count()
        self._owner: Dict[Future, Tuple[Replica, str, object, object,
                                        int]] = {}
        self._lock = threading.Lock()
        self._stopped = False
        self.routed_fresh = 0
        self.routed_stale = 0
        self.quarantined = 0
        self.restarts = 0
        self.failovers = 0
        self._max_restarts = max_restarts
        self._health_check_s = health_check_s if health_check_s \
            is not None else max(4 * poll_interval, 0.02)
        # writer failover: when the store's write lease goes stale (the
        # leader's heartbeat died), the supervisor promotes the most
        # caught-up healthy replica into a new DurableService leader
        self._promote = bool(promote_on_writer_loss)
        self._lease_ttl_s = float(lease_ttl_s)
        self._writer_kwargs = dict(writer_kwargs or {})
        self._leader: DurableService | None = None
        self.promotions = 0
        self.promote_failures = 0
        self.last_promote_error: BaseException | None = None
        self._sup_stop = threading.Event()
        self._sup_thread: threading.Thread | None = None
        if supervise or self._promote:
            self._sup_thread = threading.Thread(
                target=self._supervise, name="scc-replica-supervisor",
                daemon=True)
            self._sup_thread.start()

    def _spawn_replica(self, i: int) -> Replica:
        return Replica(self._dir, i, query_buckets=self._query_buckets,
                       poll_interval=self._poll_interval,
                       poll_offset=i * self._poll_interval / self._n,
                       auto_tail=self._auto_tail, **self._replica_kwargs)

    # -------------------------------------------------------- supervisor --

    def _supervise(self):
        """Quarantine dead replicas and restart them via snapshot
        fast-forward: a replacement :class:`Replica` bootstraps from the
        newest snapshot (the same forward-only jump as ``_resync``) and
        tails from there -- recovery cost is one snapshot restore."""
        seen: set = set()  # replicas already quarantined (strong refs:
        # an id()-keyed set could alias a collected replica's reuse)
        while not self._sup_stop.wait(self._health_check_s):
            if self._promote and self._leader is None \
                    and not self._stopped:
                self._maybe_promote()
            for i, rep in enumerate(list(self.replicas)):
                if rep.healthy or self._stopped:
                    continue
                if rep not in seen:  # quarantine + teardown once only
                    seen.add(rep)
                    with self._lock:
                        self.quarantined += 1
                    rep.shutdown()  # releases parked waiters, typed
                with self._lock:
                    exhausted = self.restarts >= self._max_restarts
                if exhausted:
                    continue  # stays dead; routing ignores it
                try:
                    fresh = self._spawn_replica(i)
                except Exception:
                    continue  # store unreadable right now; next tick
                with self._lock:
                    raced_stop = self._stopped
                    if not raced_stop:
                        self.replicas[i] = fresh
                        self.restarts += 1
                if raced_stop:  # raced a stop(): tear it down
                    fresh.shutdown()

    def _maybe_promote(self):
        """Writer-failover check: a lease file that exists but has gone
        stale means the leader's heartbeat died -- promote the most
        caught-up healthy replica.  No lease file means the deployment
        never elected a writer; promoting would CREATE a split brain
        instead of healing one, so the supervisor stands down."""
        from repro_torch.ha.lease import FileLease
        lease = FileLease(
            self._dir, owner=f"replicaset-{os.getpid()}",
            ttl_s=self._lease_ttl_s)
        info = lease.peek()
        if info is None or info.age_s < self._lease_ttl_s:
            return  # no HA deployment here, or the writer is alive
        cands = self.healthy_replicas
        if not cands:
            return
        rep = max(cands, key=lambda r: r.gen)
        try:
            leader = rep.promote(lease, **self._writer_kwargs)
        except fault_errors.Unavailable:
            return  # takeover race lost / writer revived: not a failure
        except Exception as e:
            self.promote_failures += 1
            self.last_promote_error = e
            return
        with self._lock:
            self._leader = leader
            self.promotions += 1

    @property
    def leader(self) -> DurableService | None:
        """The writer this set promoted after a failover (None until a
        promotion happened)."""
        return self._leader

    @property
    def healthy_replicas(self) -> List[Replica]:
        return [r for r in self.replicas if r.healthy]

    # ------------------------------------------------- broker interface ---

    def submit(self, kind: str, u, v=None, min_gen: int = 0) -> Future:
        for _attempt in range(self._n + 2):
            if self._stopped:
                raise fault_errors.BrokerStopped("ReplicaSet is stopped")
            healthy = self.healthy_replicas
            if not healthy:
                raise fault_errors.Unavailable(
                    "no healthy replica (all killed/quarantined); "
                    "supervisor restart pending",
                    retry_after=max(self._health_check_s,
                                    self._poll_interval))
            fresh = [r for r in healthy if r.gen >= min_gen]
            if fresh:
                rep = fresh[next(self._rr) % len(fresh)]
            else:
                # nobody fresh yet.  The floor comes from an acked
                # write, so its WAL record is already durable: EVERY
                # tailing replica will cover it at its next pull tick --
                # route to the replica whose tick lands first (staggered
                # sets: ~period/N away), not the currently-most-caught-
                # up one (it pulled most recently, so its next tick is
                # the FURTHEST away).  Without tail threads (manual
                # tests) etas are inf and the key falls back to the most
                # caught-up replica.
                rep = min(healthy,
                          key=lambda r: (r.next_tick_eta(), -r.gen))
            try:
                fut = rep.broker.submit(kind, u, v, min_gen=min_gen)
            except fault_errors.BrokerStopped:
                continue  # replica died between the health check and
                # the submit: pick again among the survivors
            if fresh:
                self.routed_fresh += 1
            else:
                self.routed_stale += 1
            with self._lock:
                self._owner[fut] = (rep, kind, u, v, min_gen)
            return fut
        raise fault_errors.Unavailable(
            "replica routing did not converge (replicas dying faster "
            "than the supervisor restarts them)",
            retry_after=self._health_check_s)

    def resolve(self, fut: Future, min_gen: int = 0,
                timeout: float | None = None):
        """Resolve with transparent failover: when the owning replica
        dies mid-flight (its broker releases the future with a typed
        ``BrokerStopped``), the query -- read-only, hence always safe to
        re-issue -- is resubmitted to a healthy peer.  Bounded attempts;
        ``Unavailable`` surfaces when no peer is left."""
        deadline = None if timeout is None else \
            time.monotonic() + timeout
        attempts = self._n + 2
        for _attempt in range(attempts):
            with self._lock:
                owner = self._owner.pop(fut, None)
            remaining = None if deadline is None else \
                max(0.0, deadline - time.monotonic())
            try:
                if owner is None:
                    return fut.result(timeout=remaining)
                rep = owner[0]
                if rep.broker.dispatching:
                    return fut.result(timeout=remaining)
                return rep.broker.resolve(fut, min_gen=min_gen,
                                          timeout=remaining)
            except fault_errors.BrokerStopped:
                if owner is None:
                    raise  # nothing recorded to replay it from
                if _attempt + 1 == attempts:
                    break  # out of attempts: a resubmit here would be
                    # abandoned (queued forever, its _owner entry leaked)
                self.failovers += 1
                _, kind, u, v, mg = owner
                fut = self.submit(kind, u, v, min_gen=mg)
            except _FutureTimeout:
                raise fault_errors.DeadlineExceeded(
                    f"replica query unresolved after {timeout:.3f}s"
                ) from None
        raise fault_errors.Unavailable(
            "query failover did not converge",
            retry_after=self._health_check_s)

    @property
    def dispatching(self) -> bool:
        return any(r.broker.dispatching for r in self.replicas)

    def stop(self):
        """Stop the supervisor, then every replica.  All parked waiters
        are released with typed errors by the per-replica broker stops
        (``BrokerStopped``); replica tail errors surface afterwards --
        kills injected by a fault plan are expected and not re-raised."""
        with self._lock:
            self._stopped = True
        self._sup_stop.set()
        if self._sup_thread is not None:
            self._sup_thread.join()
            self._sup_thread = None
        errors = []
        for r in self.replicas:
            e = r.shutdown()
            if e is not None:
                errors.append(e)
        if self._leader is not None:
            try:  # the set promoted it, the set closes it (graceful
                self._leader.close()  # handoff: lease mtime backdated)
            except Exception as e:
                errors.append(e)
        if errors:
            raise errors[0]

    def __enter__(self) -> "ReplicaSet":
        return self

    def __exit__(self, *exc):
        self.stop()

    # -------------------------------------------------------- telemetry ---

    @property
    def min_gen(self) -> int:
        reps = self.healthy_replicas or self.replicas
        return min(r.gen for r in reps)

    def wait_all_for_gen(self, gen: int, timeout: float | None = None):
        """Block until every *healthy* replica has tailed to ``gen``
        (test/bench convergence barrier; dead replicas would never get
        there and must not hang the caller)."""
        for r in self.replicas:
            if r.healthy:
                r.wait_for_gen(gen, timeout)
        return self.min_gen

    def stats(self) -> dict:
        out = {"replicas": len(self.replicas),
               "healthy": len(self.healthy_replicas),
               "routed_fresh": self.routed_fresh,
               "routed_stale": self.routed_stale,
               "quarantined": self.quarantined,
               "restarts": self.restarts,
               "failovers": self.failovers,
               "promotions": self.promotions,
               "promote_failures": self.promote_failures,
               "served": sum(r.broker.served for r in self.replicas),
               "flushes": sum(r.broker.flushes for r in self.replicas),
               "gen_waits": sum(r.broker.gen_waits
                                for r in self.replicas)}
        for r in self.replicas:
            out.update(r.stats())
        return out
