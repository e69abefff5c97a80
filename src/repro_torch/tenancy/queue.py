"""Admission control for the multi-tenant engine: bounded work queue,
cross-tenant coalescing, and host-array transfer pooling (a port of
``repro.tenancy.queue``; the queue is host code and unchanged).

The shape follows the serving front end in SNIPPETS §2 (SHARK-Engine's
``GenerateServiceV1``): a registry of compiled entry points behind a
bounded ``WorkQueue`` plus a ``TransferBufferPool`` so steady-state
submits allocate nothing.  Concretely:

* :class:`TransferBufferPool` -- freelists of bucketed host int32
  triples; ``submit`` copies the caller's (kind, u, v) into a pooled
  buffer and the flush returns it, so a hot submit path performs zero
  numpy allocations.
* :class:`WorkQueue` -- per-tenant FIFO of pending chunks with a global
  op budget.  A submit over budget is rejected immediately with
  :class:`QueueFull` carrying a ``retry_after`` hint (backpressure: the
  caller sheds load, the queue never grows unboundedly).  Admitted
  submits block on their ticket; the first waiter becomes the *flush
  leader*: it waits until either the coalescing budget fills
  (size-triggered) or its deadline lapses (deadline-triggered), then
  drains the queue in **waves** -- one head-of-line chunk per tenant per
  wave -- through the engine callback.  Waves keep the single-tenant
  chunk-boundary semantics (generation and compaction cadence) while
  letting T tenants' chunks share one lane-batched dispatch.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from repro_torch.fault.errors import DeadlineExceeded, Unavailable
from repro_torch.fault.inject import maybe_stall

__all__ = ["QueueFull", "TransferBufferPool", "WorkQueue"]


class QueueFull(Unavailable):
    """Backpressure: the queue's op budget is exhausted.  ``retry_after``
    is the seconds the caller should wait before resubmitting (one flush
    deadline: by then the leader has drained the backlog).  A member of
    the :mod:`repro_torch.fault.errors` taxonomy (``Unavailable``), so the
    ``GraphClient`` retry loop handles it like any transient refusal."""

    def __init__(self, retry_after: float):
        super().__init__(f"work queue full; retry after {retry_after}s",
                         retry_after=retry_after)


class _Buffers:
    __slots__ = ("kind", "u", "v", "cap")

    def __init__(self, cap: int):
        self.cap = cap
        self.kind = np.empty(cap, np.int32)
        self.u = np.empty(cap, np.int32)
        self.v = np.empty(cap, np.int32)


class TransferBufferPool:
    """Bucketed freelists of host (kind, u, v) int32 triples.

    ``acquire(n)`` hands back a buffer of the smallest bucket >= n
    (allocating only on a cold freelist); ``release`` returns it.  An
    oversized request falls through to a one-off exact allocation
    (counted as a miss, never pooled)."""

    def __init__(self, buckets: Sequence[int] = (64, 256, 1024, 4096),
                 per_bucket: int = 16):
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        assert self.buckets and all(b > 0 for b in self.buckets)
        self._per_bucket = per_bucket
        self._free: Dict[int, list] = {b: [] for b in self.buckets}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def acquire(self, n: int) -> _Buffers:
        fits = [b for b in self.buckets if b >= n]
        if not fits:
            with self._lock:
                self.misses += 1
            return _Buffers(n)
        b = fits[0]
        with self._lock:
            free = self._free[b]
            if free:
                self.hits += 1
                return free.pop()
            self.misses += 1
        return _Buffers(b)

    def release(self, buf: _Buffers):
        with self._lock:
            free = self._free.get(buf.cap)
            if free is not None and len(free) < self._per_bucket:
                free.append(buf)

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "pooled": sum(len(f) for f in self._free.values())}


class _Ticket:
    __slots__ = ("tid", "buf", "n", "t_submit", "event", "ok", "gen",
                 "error")

    def __init__(self, tid: str, buf: _Buffers, n: int, t_submit: float):
        self.tid = tid
        self.buf = buf
        self.n = n
        self.t_submit = t_submit
        self.event = threading.Event()
        self.ok = None
        self.gen = None
        self.error: Optional[Exception] = None


class WorkQueue:
    """Bounded, coalescing admission queue in front of an engine apply
    callback (``apply_fn(requests) -> {tid: (ok, gen) | Exception}``).

    * ``max_pending_ops`` -- global op budget; over-budget submits raise
      :class:`QueueFull` (reject-with-retry-after, never block-and-grow).
    * ``coalesce_ops`` -- size trigger: the leader flushes as soon as
      this many ops are queued.
    * ``flush_deadline_s`` -- latency bound: the leader flushes no later
      than this after its own enqueue, however few tenants showed up.
      0 means flush immediately (no coalescing window).

    There is no dispatcher thread: the first blocked submitter *is* the
    dispatcher (leader), so an idle queue costs nothing and shutdown is
    trivial.  ``flush()`` drains synchronously (tests / checkpoints).
    """

    def __init__(self, apply_fn: Callable, *,
                 max_pending_ops: int = 8192,
                 coalesce_ops: int = 1024,
                 flush_deadline_s: float = 0.002,
                 pool: TransferBufferPool | None = None,
                 latency_window: int = 512):
        self._apply_fn = apply_fn
        self._max_pending_ops = max_pending_ops
        self._coalesce_ops = coalesce_ops
        self._flush_deadline_s = flush_deadline_s
        self.pool = pool or TransferBufferPool()
        self._cv = threading.Condition()
        self._pending: "OrderedDict[str, deque]" = OrderedDict()
        self._pending_ops = 0
        self._leader_active = False
        self._latency: Dict[str, deque] = {}
        self._latency_window = latency_window
        self.rejects = 0
        self.flush_causes = {"size": 0, "deadline": 0, "explicit": 0}
        self.waves = 0
        self.depth_max = 0
        self.submitted = 0

    # -------------------------------------------------------------- submit

    def submit(self, tid: str, kind, u, v,
               timeout: float | None = None):
        """Enqueue one chunk for ``tid`` and block for its result:
        ``(ok bool[n], gen int)``.  Raises :class:`QueueFull` under
        backpressure, or the engine's per-tenant error (all-or-nothing:
        a failed chunk left the tenant untouched)."""
        kind = np.asarray(kind, np.int32)
        n = kind.shape[0]
        now = time.perf_counter()
        with self._cv:
            if self._pending_ops + n > self._max_pending_ops:
                self.rejects += 1
                raise QueueFull(retry_after=max(self._flush_deadline_s,
                                                1e-3))
            buf = self.pool.acquire(n)
            buf.kind[:n] = kind
            buf.u[:n] = np.asarray(u, np.int32)
            buf.v[:n] = np.asarray(v, np.int32)
            tk = _Ticket(tid, buf, n, now)
            self._pending.setdefault(tid, deque()).append(tk)
            self._pending_ops += n
            self.submitted += 1
            self.depth_max = max(self.depth_max, self._pending_ops)
            lead = not self._leader_active
            if lead:
                self._leader_active = True
            elif self._pending_ops >= self._coalesce_ops:
                self._cv.notify_all()   # wake the waiting leader early
        if lead:
            self._lead(tk)
        if not tk.event.wait(timeout):
            raise DeadlineExceeded(
                f"chunk for tenant {tid!r} not flushed within {timeout}s"
                f" (result may still land; do not blind-retry)")
        if tk.error is not None:
            raise tk.error
        return tk.ok, tk.gen

    def depth(self) -> int:
        with self._cv:
            return self._pending_ops

    # --------------------------------------------------------------- flush

    def flush(self):
        """Drain everything now (synchronous; used by tests, eviction,
        and checkpointing).  If a leader is mid-flight, wait it out."""
        with self._cv:
            while self._leader_active:
                self._cv.wait(0.01)
            if not self._pending:
                return
            self._leader_active = True
        self._drain("explicit")

    def _lead(self, tk: _Ticket):
        deadline = tk.t_submit + self._flush_deadline_s
        cause = "deadline"
        with self._cv:
            while self._pending_ops < self._coalesce_ops:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            if self._pending_ops >= self._coalesce_ops:
                cause = "size"
        self._drain(cause)

    def _drain(self, cause: str):
        """Leader loop: one head-of-line chunk per tenant per wave, until
        the queue is empty; then hand leadership back."""
        self.flush_causes[cause] += 1
        maybe_stall("queue_wave")
        while True:
            with self._cv:
                wave = []
                for tid, q in list(self._pending.items()):
                    t = q.popleft()
                    wave.append(t)
                    if not q:
                        del self._pending[tid]
                for t in wave:
                    self._pending_ops -= t.n
                if not wave:
                    self._leader_active = False
                    self._cv.notify_all()
                    return
            try:
                results = self._apply_fn(
                    [(t.tid, t.buf.kind[:t.n], t.buf.u[:t.n],
                      t.buf.v[:t.n]) for t in wave])
            except Exception as e:      # engine-level failure: fail wave
                results = {t.tid: e for t in wave}
            t_done = time.perf_counter()
            for t in wave:
                res = results.get(t.tid)
                if isinstance(res, Exception) or res is None:
                    t.error = res or RuntimeError(
                        f"engine returned no result for {t.tid!r}")
                else:
                    t.ok, t.gen = res
                lat = self._latency.setdefault(
                    t.tid, deque(maxlen=self._latency_window))
                lat.append(t_done - t.t_submit)
                self.pool.release(t.buf)
                t.event.set()
            self.waves += 1

    # --------------------------------------------------------------- stats

    def latency_quantiles(self, tid: str) -> dict:
        """p50/p95 submit->resolve latency (seconds) over the sliding
        window, the serving-fairness axis the bench tracks per tenant."""
        lat = self._latency.get(tid)
        if not lat:
            return {"p50_s": None, "p95_s": None, "samples": 0}
        arr = np.asarray(lat)
        return {"p50_s": round(float(np.percentile(arr, 50)), 6),
                "p95_s": round(float(np.percentile(arr, 95)), 6),
                "samples": int(arr.shape[0])}

    def stats(self) -> dict:
        with self._cv:
            return {
                "depth_ops": self._pending_ops,
                "depth_max_ops": self.depth_max,
                "max_pending_ops": self._max_pending_ops,
                "coalesce_ops": self._coalesce_ops,
                "flush_deadline_s": self._flush_deadline_s,
                "submitted": self.submitted,
                "rejects": self.rejects,
                "waves": self.waves,
                "flush_causes": dict(self.flush_causes),
                "pool": self.pool.stats(),
            }
