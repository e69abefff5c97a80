"""Structured error taxonomy for the serving stack.

Failure-domain hardening needs errors a caller can *dispatch on*: which
failures are safe to retry (and how long to wait), which mean the answer
will never arrive, and which mean the store itself is unhealthy.  Every
serving layer (service, broker, replicas, queue, durable store) raises
these instead of ad-hoc ``RuntimeError``\\ s; ``GraphClient``'s retry loop
keys off :attr:`FaultError.retryable` / :attr:`FaultError.retry_after`.

Taxonomy (see docs/SERVICE_API.md §Failure semantics for the contract
table)::

    FaultError(RuntimeError)          base; retryable=False
    ├── Unavailable                   transient; retryable=True, carries
    │   │                             retry_after (seconds hint)
    │   └── QueueFull                 admission queue rejected the chunk
    │       (repro.tenancy.queue)
    ├── NotLeader                     this node lost write leadership;
    │                                 retryable=True, carries a leader
    │                                 hint -- clients reroute + resubmit
    ├── DeadlineExceeded              the caller's time budget ran out
    ├── BrokerStopped                 query path shut down under the op
    ├── CapacityExhausted             config limit hit (max_edge_capacity,
    │                                 non-converging growth) -- durable
    ├── Fenced                        a higher writer epoch owns the WAL;
    │                                 the stale writer wrote NOTHING
    ├── LeaseLost                     lease renewal found the lease taken
    │                                 over (internal leadership signal)
    ├── WalGap                        log/store continuity violated
    ├── WalTrimmed                    tailer cursor trimmed underneath
    │                                 (internal resync signal)
    └── WalCorrupt                    torn record behind a newer segment

``FaultError`` subclasses :class:`RuntimeError` so pre-existing callers
catching ``RuntimeError`` keep working; "no bare RuntimeError" in tests
and the chaos driver means the *exact* type, never a taxonomy member.
"""
from __future__ import annotations

__all__ = ["FaultError", "Unavailable", "NotLeader", "DeadlineExceeded",
           "BrokerStopped", "CapacityExhausted", "Fenced", "LeaseLost",
           "WalGap", "WalTrimmed", "WalCorrupt"]


class FaultError(RuntimeError):
    """Base of the serving stack's typed errors.

    ``retryable`` -- True when the same request may be re-submitted
    verbatim and can succeed once the transient condition clears.
    ``retry_after`` -- optional server-side hint (seconds) for when a
    retry has a chance; ``GraphClient`` takes the max of this and its
    own exponential backoff.
    """

    retryable: bool = False

    def __init__(self, *args, retry_after: float | None = None):
        super().__init__(*args)
        self.retry_after = retry_after


class Unavailable(FaultError):
    """Transient refusal: the op was NOT applied and may be retried.

    Raised by the durable store while DEGRADED (WAL disk fault -- reads
    keep serving, writes bounce), by a ReplicaSet with no healthy
    replica, and by admission control (:class:`~repro.tenancy.queue.
    QueueFull`)."""

    retryable = True


class NotLeader(FaultError):
    """This node is not (or no longer) the durable writer.

    Raised by a :class:`~repro.ckpt.durable.DurableService` that lost or
    abandoned its lease, got fenced by a higher-epoch writer, or was
    crash-injected out of leadership.  Retryable: the op was NOT applied
    here, and a client that reroutes to the current leader (``leader``
    hint when known, else its ``leader_resolver``) may resubmit the SAME
    ``(session, seq)`` chunk -- the idempotent dedup window makes the
    handoff exactly-once for acked ops."""

    retryable = True

    def __init__(self, *args, leader: str | None = None,
                 retry_after: float | None = None):
        super().__init__(*args, retry_after=retry_after)
        self.leader = leader


class DeadlineExceeded(FaultError):
    """The caller's per-op time budget elapsed (possibly across retries).

    Not retryable by the client loop -- the budget is already spent; the
    *caller* may issue a fresh op with a fresh deadline."""


class BrokerStopped(FaultError):
    """The query path shut down while the request was in flight.

    A parked request (gen-wait) fails with this instead of hanging on a
    generation that will never commit.  ``ReplicaSet`` treats it as a
    failover signal (the request is read-only: resubmitting to a healthy
    peer is always safe)."""


class CapacityExhausted(FaultError):
    """A configured hard limit was hit (``max_edge_capacity``, growth or
    migration that cannot converge).  Deterministic for the same state +
    chunk, hence never retryable."""


class Fenced(FaultError):
    """A higher writer epoch owns this WAL directory.

    Raised by :class:`~repro.ckpt.oplog.OpLogWriter` *before any byte is
    written* when a fence marker or segment with a newer epoch exists:
    the raising writer is stale (a resurrected pre-failover leader) and
    must never append again.  Not retryable on this node -- the durable
    store translates it into :class:`NotLeader` for clients."""


class LeaseLost(FaultError):
    """Lease renewal discovered the lease was taken over (or the lease
    file vanished).  Internal leadership signal: the holder must stop
    acting as the writer; its WAL epoch is already fenced by the
    takeover, so even a race here cannot split the log."""


class WalGap(FaultError):
    """Log continuity violated: a record's ``gen_before`` does not meet
    the store's generation during replay, or a rollback was requested
    with nothing to roll back.  Recovery-stopping corruption."""


class WalTrimmed(FaultError):
    """A tailer's cursor segment vanished (``trim`` raced the tailer).

    Internal signal, not a failure: the owner resyncs from the newest
    snapshot (every trimmed record is covered by one) and keeps going."""


class WalCorrupt(FaultError):
    """A torn/invalid record sits *behind* a newer segment -- the writer
    moved on, so the bytes will never complete.  Tailers resync; the
    writer-side recovery path repairs to the valid prefix."""
