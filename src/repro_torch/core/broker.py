"""Thread-safe reader path for the streaming SCC service (a port of
``repro.core.broker``).

The paper's readers (arXiv:1804.01276, and the non-blocking sibling
arXiv:1809.00896) run *concurrently* with a fixed pool of update threads
and are wait-free: a query never blocks an update and always observes a
consistent state.  Our compiled analogue: reader threads hand their point
queries to a :class:`QueryBroker`, which coalesces everything pending into
one padded batched device call per query kind against a single *pinned*
committed snapshot, then distributes the generation-stamped answers.  The
paper's §5.3 community application rides the same path: ``community_of``
(blongsToCommunity) and ``community_sizes`` are broker kinds, not
raw-state helpers.

Consistency contract (see ``docs/SERVICE_API.md``):

* every flush pins ``service.state`` exactly once -- all answers of that
  flush share one generation, and the pinned state is always a fully
  committed snapshot (the service publishes only committed states, and
  no engine operation writes into a state it was given);
* the snapshot is pinned *after* the pending set is collected, so a
  reader that saw generation ``g`` and then submits again can only be
  answered at a generation ``>= g`` (monotone reads per reader);
* **gen-wait hook**: a request may carry ``min_gen`` -- the floor behind
  the client API's ``AT_LEAST`` / ``READ_YOUR_WRITES`` consistency
  levels.  A flush whose pinned generation is below a request's floor
  defers that request (re-queued, ``gen_waits`` telemetry) and answers it
  on a later flush once the service commits past the floor; requests
  whose floor is already covered are never delayed by waiting ones;
* padding lanes target vertex 0 on the snapshot but their results are
  discarded before distribution, so they can never alias a real answer.

Coalesced batches are cut and padded to the broker's own bucket
registry, so query batches come in a few fixed shapes.

This module is the *internal* reader surface: multi-threaded callers
should hold a :class:`repro_torch.api.GraphClient` per session rather than
calling the string-kind ``submit`` directly.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Dict, List, NamedTuple, Sequence, Set

import numpy as np

from repro_torch import trace
from repro_torch.core import service as svc_mod
from repro_torch.fault import errors as fault_errors
from repro_torch.fault.inject import maybe_stall

__all__ = ["QueryBroker"]

_KINDS = ("same_scc", "reachable", "scc_members", "community_of",
          "community_sizes")


class _Req(NamedTuple):
    u: np.ndarray
    v: np.ndarray
    min_gen: int
    fut: Future
    # the tracer's (submit time ns, (span id, trace id) of the submitting
    # span) while it is on, else None
    traced: tuple | None = None


class QueryBroker:
    """Coalesces concurrent reader queries into batched snapshot calls.

    Two operating modes:

    * **dispatcher thread** (``start()`` / ``stop()``, or use the broker
      as a context manager): a background thread drains the pending set
      whenever it is non-empty -- readers just call the blocking wrappers.
    * **inline**: without a dispatcher, blocking wrappers flush the
      pending set themselves (and piggyback on whichever thread got there
      first), which keeps single-threaded callers and tests simple.
    """

    def __init__(self, service, buckets: Sequence[int] = (64, 256, 1024)):
        from repro_torch.launch.stream import BucketedScheduler
        self._svc = service
        self._sched = BucketedScheduler(buckets)
        self._cv = threading.Condition()
        self._pending: Dict[str, List[_Req]] = {k: [] for k in _KINDS}
        self._thread: threading.Thread | None = None
        self._stopping = False
        # telemetry; _waited tracks requests already counted in gen_waits
        # so flush retries do not re-count the same deferred query
        self.flushes = 0
        self.served = 0
        self.max_coalesced = 0
        self.gen_waits = 0
        self._waited: Set[Future] = set()

    # ------------------------------------------------------- submission ---

    def submit(self, kind: str, u, v=None, min_gen: int = 0) -> Future:
        """Queue a query batch; returns a Future resolving to a
        :class:`repro_torch.core.service.Snapshot`.

        ``min_gen`` is the consistency floor: the answer's generation is
        guaranteed ``>= min_gen`` (the request waits for such a commit).
        """
        if kind not in _KINDS:
            raise ValueError(f"unknown query kind {kind!r}")
        u = np.atleast_1d(np.asarray(u, np.int32))
        v = np.zeros_like(u) if v is None \
            else np.atleast_1d(np.asarray(v, np.int32))
        if u.shape != v.shape:
            raise ValueError(f"u{u.shape} and v{v.shape} differ in shape")
        fut: Future = Future()
        traced = (trace.now(), trace.current()) if trace.enabled() \
            else None
        with self._cv:
            if self._stopping:
                raise fault_errors.BrokerStopped("QueryBroker is stopped")
            self._pending[kind].append(_Req(u, v, int(min_gen), fut,
                                            traced))
            self._cv.notify()
        return fut

    def same_scc(self, u, v, min_gen: int = 0) -> svc_mod.Snapshot:
        """Blocking SameSCC through the coalescer."""
        return self.resolve(self.submit("same_scc", u, v, min_gen=min_gen),
                            min_gen=min_gen)

    def reachable(self, u, v, min_gen: int = 0) -> svc_mod.Snapshot:
        """Blocking reachability through the coalescer."""
        return self.resolve(
            self.submit("reachable", u, v, min_gen=min_gen),
            min_gen=min_gen)

    def scc_members(self, u, min_gen: int = 0) -> svc_mod.Snapshot:
        """Blocking membership-mask query; value is bool[Q, NV]."""
        return self.resolve(
            self.submit("scc_members", u, min_gen=min_gen),
            min_gen=min_gen)

    def community_of(self, u, min_gen: int = 0) -> svc_mod.Snapshot:
        """Blocking community-id query; value is int32[Q] (sentinel
        ``n_vertices`` for absent ids)."""
        return self.resolve(
            self.submit("community_of", u, min_gen=min_gen),
            min_gen=min_gen)

    def community_sizes(self, min_gen: int = 0) -> svc_mod.Snapshot:
        """Blocking community-size histogram; value is int32[NV]."""
        return self.resolve(
            self.submit("community_sizes", [0], min_gen=min_gen),
            min_gen=min_gen)

    @property
    def dispatching(self) -> bool:
        """True when a background dispatcher thread is draining queries."""
        t = self._thread
        return t is not None and t.is_alive()

    def resolve(self, fut: Future, min_gen: int = 0,
                timeout: float | None = None) -> svc_mod.Snapshot:
        """Drive ``fut`` to completion and return its Snapshot.

        With a dispatcher running this just waits.  In inline mode some
        thread must drain the queue: flush here, waiting for the service
        to commit past ``min_gen`` first when the request carries a floor
        (a concurrent flush may already have taken the request, in which
        case our flush is a cheap no-op and ``result()`` waits for the
        other one).

        ``timeout`` bounds the whole wait; expiry raises
        :class:`~repro_torch.fault.errors.DeadlineExceeded` (the request stays
        queued -- it is read-only, so a late answer is simply dropped).
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        while not fut.done() and not self.dispatching:
            if deadline is not None and time.monotonic() >= deadline:
                raise fault_errors.DeadlineExceeded(
                    f"query unresolved after {timeout:.3f}s "
                    f"(floor {min_gen}, committed {self._svc.gen})")
            if min_gen:
                # clamp the commit wait to the remaining deadline so a
                # caller-supplied timeout is honored tightly, not
                # overshot by up to a full wait slice
                slice_t = 0.5 if deadline is None else \
                    min(0.5, max(0.0, deadline - time.monotonic()))
                self._svc.wait_for_gen(min_gen, timeout=slice_t)
            served = self.flush()
            if fut.done():
                break
            if served == 0 and (not min_gen or self._svc.gen >= min_gen):
                # nothing here we could serve: either another thread's
                # flush owns our request (its result is imminent), or our
                # own flush re-queued it and a commit raced past the
                # floor between the pin and this check -- wait briefly,
                # then loop so the next flush serves the re-queued case
                # rather than assuming the former (which would hang).
                slice_t = 0.05 if deadline is None else \
                    min(0.05, max(0.0, deadline - time.monotonic()))
                try:
                    return fut.result(timeout=slice_t)
                except _FutureTimeout:
                    continue
        if deadline is not None:
            try:
                return fut.result(
                    timeout=max(0.0, deadline - time.monotonic()))
            except _FutureTimeout:
                raise fault_errors.DeadlineExceeded(
                    f"query unresolved after {timeout:.3f}s "
                    f"(floor {min_gen})") from None
        return fut.result()

    # ---------------------------------------------------------- flushing --

    def flush(self, fail_waiting: bool = False) -> int:
        """Answer everything pending whose consistency floor the pinned
        committed snapshot covers; returns the number of point queries
        served.  Requests still waiting on a commit are re-queued (or
        failed, with ``fail_waiting=True`` -- the stop path)."""
        maybe_stall("broker_flush")
        flush_span = trace.span("broker.flush")
        with self._cv:
            batch = {k: reqs for k, reqs in self._pending.items() if reqs}
            for k in batch:
                self._pending[k] = []
        if not batch:
            return 0
        t_collect = trace.now()
        with flush_span:
            return self._serve(batch, fail_waiting, flush_span, t_collect)

    def _serve(self, batch, fail_waiting, flush_span, t_collect) -> int:
        """Answer the collected ``batch`` (the body of :meth:`flush`)."""
        # Pin AFTER collecting the batch: a reader already answered at gen
        # g resubmits only after its result arrived, hence after the flush
        # that pinned g -- commits are monotone, so this pin sees >= g.
        # cfg may be read mid-grow relative to st, but the only mutable
        # field (edge_capacity) never enters a query: n_vertices/max_inner
        # are fixed for the service's lifetime.
        st, gen = self._svc.head
        cfg = self._svc.cfg
        # gen-wait hook: split off requests whose floor is above the
        # pinned generation; they wait for a later commit without
        # delaying the ready ones.
        waiting: List[tuple] = []  # (kind, request)
        ready = {}
        for kind, reqs in batch.items():
            rd = [r for r in reqs if r.min_gen <= gen]
            waiting.extend((kind, r) for r in reqs if r.min_gen > gen)
            if rd:
                ready[kind] = rd
        if waiting:
            for _, r in waiting:  # count each deferred query once
                if r.fut not in self._waited:
                    self._waited.add(r.fut)
                    self.gen_waits += 1
            if fail_waiting:
                for _, r in waiting:
                    self._waited.discard(r.fut)
                    if not r.fut.done():
                        r.fut.set_exception(fault_errors.BrokerStopped(
                            f"QueryBroker stopped before generation "
                            f"{r.min_gen} committed (at {gen})"))
            else:
                with self._cv:
                    for kind, r in waiting:
                        self._pending[kind].append(r)
                    self._cv.notify()
        if not ready:
            return 0
        for reqs in ready.values():  # leaving the pending system for good
            for r in reqs:
                self._waited.discard(r.fut)
                if r.traced is not None:  # its wait ends at this flush
                    t0, ctx = r.traced
                    parent, tid = ctx if ctx else (0, None)
                    trace.record("broker.queued", t0, t_collect, tid,
                                 parent, wait=True,
                                 attrs={"flush": flush_span.id})
        try:
            served = 0
            for kind, reqs in ready.items():
                served += self._flush_kind(kind, reqs, st, cfg, gen)
        except BaseException as e:
            for reqs in ready.values():
                for r in reqs:
                    if not r.fut.done():
                        r.fut.set_exception(e)
            raise
        self.flushes += 1
        self.served += served
        flush_span.set("requests", sum(len(r) for r in ready.values()))
        flush_span.set("queries", served)
        return served

    def _flush_kind(self, kind, reqs: List[_Req], st, cfg, gen) -> int:
        if kind == "community_sizes":
            # no per-lane ids: one histogram sweep answers every request
            hist = svc_mod.community_sizes_on(st, cfg)
            for r in reqs:
                r.fut.set_result(svc_mod.Snapshot(hist, gen))
            return len(reqs)
        u = np.concatenate([r.u for r in reqs])
        v = np.concatenate([r.v for r in reqs])
        n = u.shape[0]
        self.max_coalesced = max(self.max_coalesced, n)
        if kind == "scc_members":
            out = np.zeros((n, cfg.n_vertices), bool)
        elif kind == "community_of":
            out = np.full(n, cfg.n_vertices, np.int32)
        else:
            out = np.zeros(n, bool)
        for sl, b in self._sched.plan(n):
            pu = np.zeros(b, np.int32)
            pv = np.zeros(b, np.int32)
            k = sl.stop - sl.start
            pu[:k] = u[sl]
            pv[:k] = v[sl]
            if kind == "same_scc":
                out[sl] = svc_mod.same_scc_on(st, cfg, pu, pv)[:k]
            elif kind == "reachable":
                out[sl] = svc_mod.reachable_on(st, cfg, pu, pv)[:k]
            elif kind == "community_of":
                out[sl] = svc_mod.community_of_on(st, cfg, pu)[:k]
            else:
                out[sl] = svc_mod.members_on(st, cfg, pu)[:k]
        pos = 0
        with trace.span("broker.distribute"):
            for r in reqs:
                k = r.u.shape[0]
                r.fut.set_result(svc_mod.Snapshot(out[pos:pos + k], gen))
                pos += k
        return n

    # ------------------------------------------------------- dispatcher ---

    def _min_pending_floor(self) -> int:
        with self._cv:
            floors = [r.min_gen for reqs in self._pending.values()
                      for r in reqs]
        return min(floors) if floors else 0

    def start(self) -> "QueryBroker":
        """Spawn the background dispatcher thread (idempotent)."""
        with self._cv:
            self._stopping = False
            if self._thread is not None and self._thread.is_alive():
                return self
            self._thread = threading.Thread(
                target=self._run, name="scc-query-broker", daemon=True)
            self._thread.start()
        return self

    def stop(self):
        """Drain outstanding queries, then stop the dispatcher.  Requests
        whose consistency floor is still uncommitted are failed rather
        than left waiting for a generation that may never arrive."""
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        # a dispatcher that died on a flush error may leave pending
        # futures behind -- fail them rather than hang their readers
        with self._cv:
            leftovers = [r.fut for reqs in self._pending.values()
                         for r in reqs]
            for k in self._pending:
                self._pending[k] = []
            self._waited.clear()
        for fut in leftovers:
            if not fut.done():
                fut.set_exception(
                    fault_errors.BrokerStopped("QueryBroker stopped"))

    def _run(self):
        while True:
            with self._cv:
                while not self._stopping and \
                        not any(self._pending.values()):
                    self._cv.wait(timeout=0.05)
                if self._stopping and not any(self._pending.values()):
                    return
            try:
                served = self.flush(fail_waiting=self._stopping)
            except BaseException:
                # flush already failed its own collected futures; keep the
                # dispatcher alive so later submitters are not orphaned
                # waiting on a thread that silently died
                continue
            if served == 0 and any(self._pending.values()):
                # everything pending is gen-deferred: block on the next
                # service commit instead of spinning on flush()
                self._svc.wait_for_gen(self._min_pending_floor(),
                                       timeout=0.05)

    def __enter__(self) -> "QueryBroker":
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def stats(self) -> dict:
        return {"flushes": self.flushes, "served": self.served,
                "max_coalesced": self.max_coalesced,
                "gen_waits": self.gen_waits,
                "coalescing": round(self.served / self.flushes, 2)
                if self.flushes else 0.0}
