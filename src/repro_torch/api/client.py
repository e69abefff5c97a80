"""`GraphClient`: the request/response surface of the port (a port of
``repro.api.client``).

The paper's SMSCC is a *linearizable concurrent graph object*: one
abstract object against which a pool of threads issues updates and
wait-free queries, every response justified by some sequential history
(arXiv:1804.01276, §2; the object-interface framing is arXiv:1710.08296).
Internally this repo implements that object as two cooperating halves — the
:class:`repro_torch.core.service.SCCService` update pipeline and the
:class:`repro_torch.core.broker.QueryBroker` reader path — but neither half is
the *object*: callers used to juggle raw ``(kind, u, v)`` arrays for one
and string query kinds for the other.  ``GraphClient`` is the missing
facade:

* **one vocabulary** — every request is a typed op from
  :mod:`repro_torch.api.ops`; homogeneous runs are packed into the compiled
  core's batch shapes by the encoders, so the engine is untouched;
* **one response shape** — every answer is a :class:`Result` carrying the
  generation stamp of the committed snapshot that justified it (the
  API-level rendering of the paper's linearization points);
* **explicit consistency** — reads run under
  :data:`Consistency.LATEST` (any committed generation — the historical
  behaviour), :meth:`Consistency.AT_LEAST` (block until the committed
  generation covers an explicit floor), or
  :data:`Consistency.READ_YOUR_WRITES` (block until the committed
  generation covers the client's last acknowledged update — per-client
  token, maintained automatically).

A ``GraphClient`` instance is a *session*: use one per logical caller
(e.g. one per reader thread).  Many clients may share one service and one
broker — updates serialize on the service's update lock, queries coalesce
in the broker.  Per-client submission order is preserved across the
update/query boundary: updates are acknowledged only after their chunk
commits, and a later read's floor (its consistency level) can never admit
a snapshot older than the session has already observed under
READ_YOUR_WRITES.
"""
from __future__ import annotations

import dataclasses
import itertools
import random
import time
from concurrent.futures import Future
from typing import Any, Iterable, Iterator, List, NamedTuple, Sequence, \
    Tuple

import numpy as np

from repro_torch.api.ops import (CommunityOf, CommunitySizes, Op, QueryOp,
                           SccMembers, UpdateOp, encode_updates)
from repro_torch.fault import errors as fault_errors

__all__ = ["GraphClient", "Result", "Consistency", "AtLeast"]

# process-unique client session ids: the idempotency namespace for
# retried update chunks (the service dedups on (session, seq))
_SESSION_IDS = itertools.count()


# -------------------------------------------------------- consistency ----


@dataclasses.dataclass(frozen=True, slots=True)
class _Level:
    name: str

    def __repr__(self):
        return f"Consistency.{self.name}"


@dataclasses.dataclass(frozen=True, slots=True)
class AtLeast:
    """Read floor: answer only at a committed generation ``>= gen``."""
    gen: int

    def __repr__(self):
        return f"Consistency.AT_LEAST({self.gen})"


class Consistency:
    """The read-consistency levels of the client API.

    ===================  ====================================================
    level                guarantee for the answering snapshot's generation
    ===================  ====================================================
    ``LATEST``           any committed generation (never blocks)
    ``AT_LEAST(g)``      ``gen >= g`` — blocks until such a commit exists
    ``READ_YOUR_WRITES`` ``gen >= `` the client's last acked update
                         generation (its session token) — blocks until the
                         client's own writes are visible
    ===================  ====================================================

    All levels read *committed* snapshots only; stronger levels narrow
    which committed generations may answer, they never expose in-flight
    state.
    """
    LATEST = _Level("LATEST")
    READ_YOUR_WRITES = _Level("READ_YOUR_WRITES")
    AT_LEAST = AtLeast


# ------------------------------------------------------------- result ----


class Result(NamedTuple):
    """One op's response: the value plus its generation stamp.

    ``gen`` is the generation of the committed snapshot the value was
    computed against (queries) or that the op's chunk committed (updates).
    Update values are the acceptance booleans of the paper's method
    contracts; query values are per-op scalars/arrays (see
    :mod:`repro_torch.api.ops` for the table).  (A NamedTuple, not a dataclass:
    results are minted per op on the hot path, and tuple construction is
    what keeps the facade inside its benchmarked overhead bound.)
    """
    op: Op
    value: Any
    gen: int


# ------------------------------------------------------------- client ----


def _runs(ops: Iterable[Op]) -> Iterator[Tuple[str, List[Op]]]:
    """Maximal homogeneous runs: consecutive updates batch into one service
    chunk; consecutive same-kind queries coalesce into one broker request.
    Run boundaries are exactly the client's ordering obligations."""
    run: List[Op] = []
    cat = None
    for op in ops:
        if isinstance(op, UpdateOp):
            c = "update"
        elif isinstance(op, QueryOp):
            c = op.BROKER_KIND
        else:
            raise TypeError(f"not an api op: {op!r}")
        if c != cat and run:
            yield cat, run
            run = []
        cat = c
        run.append(op)
    if run:
        yield cat, run


class GraphClient:
    """Typed client session over one SCCService (+ QueryBroker).

    ``broker=None`` makes the client own a private broker in inline mode
    (flushes happen on the submitting thread — single-threaded callers and
    tests need no dispatcher).  Pass a shared, started broker to coalesce
    queries across many client sessions.  A client instance is not itself
    thread-safe (it carries the per-session read-your-writes token); give
    each thread its own client over the shared service/broker.
    """

    def __init__(self, service, broker=None,
                 consistency=Consistency.LATEST, *,
                 deadline_s: float | None = None, max_retries: int = 8,
                 backoff_base_s: float = 0.005,
                 backoff_cap_s: float = 0.25, rng=None,
                 leader_resolver=None):
        from repro_torch.core.broker import QueryBroker
        self._svc = service
        self._broker = QueryBroker(service) if broker is None else broker
        self._owns_broker = broker is None
        self._consistency = consistency
        # read-your-writes token: floor generation for RYW reads.  Seeded
        # with the creation-time committed gen (already committed, so it
        # never blocks) and advanced to each acked update's commit gen.
        self._token = int(service.gen)
        # failure-domain knobs (docs/SERVICE_API.md §Failure semantics):
        # retryable FaultErrors (Unavailable/QueueFull) are resubmitted
        # with bounded, decorrelated-jittered exponential backoff --
        # each wait draws uniformly from [base, 3*previous_wait],
        # floored by the server's retry_after hint and capped at
        # backoff_cap_s -- inside the per-op deadline (deadline_s=None:
        # no time bound, max_retries still applies).  The jitter
        # de-synchronizes sessions that all saw the same fault (a
        # deterministic schedule retries in lockstep: a thundering herd
        # on a freshly promoted writer); `rng` injects the source so
        # tests stay deterministic.  Updates are idempotent under
        # retry: every chunk carries (session_id, seq) and the service
        # dedups re-submits, so a chunk whose ack was lost is never
        # double-applied through the WAL.
        self._deadline_s = deadline_s
        self._max_retries = int(max_retries)
        self._backoff_base_s = float(backoff_base_s)
        self._backoff_cap_s = float(backoff_cap_s)
        self._rng = random.Random() if rng is None else rng
        # writer-failover reroute: on NotLeader the client swaps its
        # update target for whatever the resolver currently names (e.g.
        # ``lambda: rset.leader or old_writer``) before the next retry
        self._leader_resolver = leader_resolver
        self.session_id = f"gc{next(_SESSION_IDS)}"
        self._seq = 0
        self.retries = 0
        self.reroutes = 0
        self.deadline_failures = 0
        self.updates_submitted = 0
        self.queries_submitted = 0

    # ------------------------------------------------------- properties --

    @property
    def service(self):
        return self._svc

    @property
    def broker(self):
        return self._broker

    @property
    def gen(self) -> int:
        """Latest committed generation of the underlying service."""
        return int(self._svc.gen)

    @property
    def token(self) -> int:
        """The session's read-your-writes floor (last acked update gen)."""
        return self._token

    # -------------------------------------------------------- submission --

    def submit(self, op: Op, consistency=None,
               deadline_s: float | None = None) -> "Future[Result]":
        """Issue one op; resolves to its :class:`Result`.

        Updates are acknowledged synchronously (the returned future is
        already done — the chunk committed, retried under the client's
        retry policy if the store was transiently unavailable).  Queries
        resolve when the broker flushes: immediately on this thread in
        inline mode (with retries + the per-op deadline), or
        asynchronously when a dispatcher is running (the deadline/retry
        policy does not chase an async future; a failure arrives as the
        future's typed exception).
        """
        fut: Future = Future()
        if isinstance(op, UpdateOp):
            fut.set_result(self._apply_updates([op], deadline_s)[0])
            return fut
        if not isinstance(op, QueryOp):
            raise TypeError(f"not an api op: {op!r}")
        min_gen = self._min_gen(consistency)
        self.queries_submitted += 1
        if self._broker.dispatching:
            bfut = self._submit_query_run(op.BROKER_KIND, [op], min_gen)

            def _chain(f):
                try:
                    fut.set_result(self._result_of(op, f.result(), 0))
                except BaseException as e:  # surfaced via fut.result()
                    fut.set_exception(e)
            bfut.add_done_callback(_chain)
            return fut

        def attempt(remaining):
            bfut = self._submit_query_run(op.BROKER_KIND, [op], min_gen)
            return self._broker.resolve(bfut, min_gen=min_gen,
                                        timeout=remaining)
        snap = self._with_retry(
            attempt, self._deadline_s if deadline_s is None
            else deadline_s)
        fut.set_result(self._result_of(op, snap, 0))
        return fut

    def submit_many(self, ops: Sequence[Op], consistency=None,
                    deadline_s: float | None = None) -> List[Result]:
        """Issue a mixed op sequence; returns one :class:`Result` per op,
        in submission order.

        Consecutive updates are packed into one service chunk (one commit,
        one shared stamp); consecutive same-kind queries coalesce into one
        broker request.  Runs execute strictly in order, so generation
        stamps returned to this client are monotone non-decreasing across
        the whole sequence — and under READ_YOUR_WRITES every query stamp
        is ``>=`` the session token at its submission.
        """
        results: List[Result] = []
        eff_deadline = self._deadline_s if deadline_s is None \
            else deadline_s
        for cat, run in _runs(ops):
            if cat == "update":
                results.extend(self._apply_updates(run, eff_deadline))
                continue
            min_gen = self._min_gen(consistency)
            self.queries_submitted += len(run)

            def attempt(remaining, cat=cat, run=run, min_gen=min_gen):
                bfut = self._submit_query_run(cat, run, min_gen)
                return self._broker.resolve(bfut, min_gen=min_gen,
                                            timeout=remaining)
            snap = self._with_retry(attempt, eff_deadline)
            # run-level value decode (one C-level conversion per run, not
            # one isinstance chain + numpy index per op)
            gen = int(snap.gen)
            if cat == "community_sizes":
                hist = np.asarray(snap.value)
                results.extend(Result(op, hist, gen) for op in run)
            elif cat == "scc_members":
                masks = np.asarray(snap.value)
                results.extend(Result(op, masks[i], gen)
                               for i, op in enumerate(run))
            else:  # bool / int lanes
                vals = snap.value.tolist()
                results.extend(Result(op, val, gen)
                               for op, val in zip(run, vals))
        return results

    # ---------------------------------------------------------- internals --

    def _min_gen(self, consistency) -> int:
        c = self._consistency if consistency is None else consistency
        if c is Consistency.LATEST:
            return 0
        if c is Consistency.READ_YOUR_WRITES:
            return self._token
        if isinstance(c, AtLeast):
            return int(c.gen)
        raise TypeError(f"unknown consistency level: {c!r}")

    def _reroute(self, e: fault_errors.FaultError):
        """Swap the update target after a ``NotLeader``: whatever the
        resolver names right now becomes ``self._svc`` (the update
        attempt closures read it at call time, so the very next retry
        lands on the new leader)."""
        if self._leader_resolver is None:
            return
        try:
            new = self._leader_resolver()
        except Exception:
            return  # resolver hiccup: retry against the old target
        if new is not None and new is not self._svc:
            self._svc = new
            self.reroutes += 1

    def _with_retry(self, attempt, deadline_s: float | None):
        """Run ``attempt(remaining_s)`` under the retry policy: retryable
        :class:`~repro_torch.fault.errors.FaultError`\\ s are re-attempted with
        decorrelated-jitter exponential backoff -- each wait draws
        uniformly from ``[base, 3*prev_wait]``, floored by the server's
        ``retry_after`` hint and capped at ``backoff_cap_s`` -- until
        ``max_retries`` attempts or the deadline is spent, whichever
        first.  A :class:`~repro_torch.fault.errors.NotLeader`
        additionally reroutes the session to ``leader_resolver()`` before
        the next attempt.  Deadline exhaustion raises
        :class:`~repro_torch.fault.errors.DeadlineExceeded` (chaining the last
        transient error); retry exhaustion re-raises the last typed
        error itself."""
        deadline = None if deadline_s is None \
            else time.monotonic() + deadline_s
        delay = self._backoff_base_s
        last: BaseException | None = None
        for n in range(self._max_retries + 1):
            remaining = None if deadline is None \
                else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                self.deadline_failures += 1
                raise fault_errors.DeadlineExceeded(
                    f"op deadline {deadline_s}s spent after {n} "
                    f"attempts (last: {last})") from last
            try:
                return attempt(remaining)
            except fault_errors.FaultError as e:
                if not e.retryable or n == self._max_retries:
                    raise
                last = e
                if isinstance(e, fault_errors.NotLeader):
                    self._reroute(e)
                # decorrelated jitter (AWS-style): spread concurrent
                # sessions' retries apart instead of marching them in
                # lockstep into the server that just came back
                delay = min(self._rng.uniform(self._backoff_base_s,
                                              max(self._backoff_base_s,
                                                  delay * 3)),
                            self._backoff_cap_s)
                wait = min(max(delay, e.retry_after or 0.0),
                           self._backoff_cap_s)
                if deadline is not None and \
                        time.monotonic() + wait >= deadline:
                    self.deadline_failures += 1
                    raise fault_errors.DeadlineExceeded(
                        f"op deadline {deadline_s}s cannot cover the "
                        f"next backoff ({wait:.3f}s; last: {e})") from e
                self.retries += 1
                time.sleep(wait)
        raise AssertionError("unreachable")  # loop always raises/returns

    def _apply_updates(self, run: List[Op],
                       deadline_s: float | None = None) -> List[Result]:
        kind, u, v = encode_updates(run)
        # one idempotency key per chunk: a retry re-submits the SAME
        # (session, seq), so a first attempt that committed but lost its
        # ack (fault after the WAL append) is deduped, never re-applied
        self._seq += 1
        seq = self._seq

        def attempt(_remaining):
            return self._svc._apply_ops(kind, u, v,
                                        session=self.session_id, seq=seq)
        ok, gen = self._with_retry(
            attempt, self._deadline_s if deadline_s is None
            else deadline_s)
        self._token = max(self._token, gen)
        self.updates_submitted += len(run)
        return [Result(op, val, gen)
                for op, val in zip(run, np.asarray(ok).tolist())]

    def _submit_query_run(self, kind: str, run: List[Op], min_gen: int):
        if kind == "community_sizes":
            # one histogram per flush answers the whole run
            return self._broker.submit(kind, [0], min_gen=min_gen)
        u = [op.u for op in run]
        if kind in ("scc_members", "community_of"):
            return self._broker.submit(kind, u, min_gen=min_gen)
        return self._broker.submit(kind, u, [op.v for op in run],
                                   min_gen=min_gen)

    @staticmethod
    def _result_of(op: Op, snap, i: int) -> Result:
        if isinstance(op, CommunitySizes):
            value: Any = np.asarray(snap.value)
        elif isinstance(op, SccMembers):
            value = np.asarray(snap.value[i])
        elif isinstance(op, CommunityOf):
            value = int(snap.value[i])
        else:
            value = bool(snap.value[i])
        return Result(op, value, int(snap.gen))

    # ---------------------------------------------------------- telemetry --

    def stats(self) -> dict:
        """One unified telemetry dict: service (pipelined/fallback chunks,
        grows, ``scanned_chunks`` / ``scan_dispatches`` of the super-chunk
        path, ``repair_skipped_steps`` next to the per-tier
        ``repair_{dense,compact,full}_steps``), broker (coalesced
        flushes, gen waits), and session counters."""
        s = dict(self._svc.stats())
        s.update(self._broker.stats())
        s.update(client_updates=self.updates_submitted,
                 client_queries=self.queries_submitted,
                 client_retries=self.retries,
                 client_reroutes=self.reroutes,
                 client_deadline_failures=self.deadline_failures,
                 ryw_token=self._token)
        return s

    # ---------------------------------------------------------- lifecycle --

    def close(self):
        """Stop the private broker (no-op for a shared one)."""
        if self._owns_broker:
            self._broker.stop()

    def __enter__(self) -> "GraphClient":
        return self

    def __exit__(self, *exc):
        self.close()
