"""Deterministic, seed-driven fault injection for the serving stack (a
copy of ``repro.fault.inject``).

The fault tests (and the JAX package's chaos driver) arm a
:class:`FaultPlan` -- a pre-computed schedule of fault events derived
from a seed -- and the serving layers consult it at their natural fault
points *while serving* (not just at boot):

* filesystem faults: :func:`fs_open` / :func:`fs_fsync` are the I/O
  entry points of :mod:`repro_torch.ckpt.oplog` and
  :mod:`repro_torch.ckpt.checkpoint`.  An armed :class:`FsFault` makes the
  Nth matching write/fsync/open raise ``EIO``/``ENOSPC``, or *tear*
  the write (a prefix of the bytes lands, then the error) -- the
  mid-record torn-tail case the WAL's CRC framing exists for;
* replica kills: :func:`fire_kills` stops replica tails abruptly once
  the writer passes a scheduled generation (the in-process analogue of
  SIGKILLing a replica process; the multi-process analogue lives in
  ``repro_torch.launch.replica --supervised``);
* stalls: :func:`maybe_stall` injects latency at queue/broker drain
  points to widen race windows.

Determinism: a plan is a pure function of its seed
(:meth:`FaultPlan.generate`), and per-call-site counters make the Nth
matching call fault regardless of wall-clock timing, so a chaos run's
fault *schedule* is reproducible even though thread interleavings are
not.  With no plan armed the hooks are a single global read -- safe to
leave in the production path.
"""
from __future__ import annotations

import contextlib
import dataclasses
import errno as _errno
import os
import threading
import time
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["FsFault", "ReplicaKill", "Stall", "FaultPlan", "install",
           "clear", "injected", "active_plan", "fs_open", "fs_fsync",
           "maybe_stall", "fire_kills"]


# ------------------------------------------------------------- events ----


@dataclasses.dataclass(frozen=True)
class FsFault:
    """Fault the ``[first, first+count)``-th filesystem calls whose path
    contains ``match`` (counted per ``(op, match)`` key).

    ``op`` is one of ``write`` / ``fsync`` / ``open``; ``error`` is
    ``eio`` / ``enospc`` / ``torn`` (torn: a ``tear_frac`` prefix of the
    bytes is written before the EIO -- only meaningful for ``write``).
    """
    op: str
    match: str
    first: int
    count: int = 1
    error: str = "eio"
    tear_frac: float = 0.5


@dataclasses.dataclass(frozen=True)
class ReplicaKill:
    """Abruptly stop replica ``replica_id``'s tail once the writer's
    committed generation reaches ``at_gen``."""
    replica_id: int
    at_gen: int


@dataclasses.dataclass(frozen=True)
class Stall:
    """Sleep ``seconds`` inside the ``[first, first+count)``-th drain
    passes of the injection point named ``match`` (e.g. ``broker_flush``,
    ``queue_wave``)."""
    match: str
    first: int
    count: int = 1
    seconds: float = 0.02


# --------------------------------------------------------------- plan ----


class FaultPlan:
    """A seeded schedule of fault events plus its trigger bookkeeping.

    The event tuples are immutable and comparable (determinism tests
    compare whole plans); the mutable counters live here, guarded by one
    lock, so a single plan can be armed across many threads.
    """

    def __init__(self, fs: Tuple[FsFault, ...] = (),
                 kills: Tuple[ReplicaKill, ...] = (),
                 stalls: Tuple[Stall, ...] = (), seed: int | None = None):
        self.fs = tuple(fs)
        self.kills = tuple(kills)
        self.stalls = tuple(stalls)
        self.seed = seed
        self._lock = threading.Lock()
        self._fs_counts: Dict[Tuple[str, str], int] = {}
        self._stall_counts: Dict[str, int] = {}
        self._fired_kills: set = set()
        self.triggered: List[Tuple[str, str, str]] = []  # (op, error, path)

    def __repr__(self):
        return (f"FaultPlan(seed={self.seed}, fs={self.fs}, "
                f"kills={self.kills}, stalls={self.stalls})")

    @property
    def events(self) -> tuple:
        """The immutable schedule (what determinism tests compare)."""
        return (self.fs, self.kills, self.stalls)

    @classmethod
    def generate(cls, seed: int, profile: str = "mixed", *,
                 replicas: int = 2, horizon_gens: int = 64) -> "FaultPlan":
        """Derive a plan from ``seed``.  Profiles: ``disk-fault`` (WAL
        write/fsync faults only), ``replica-kill`` (tail kills only),
        ``mixed`` (both).  Same seed + profile => identical plan."""
        assert profile in ("disk-fault", "replica-kill", "mixed"), profile
        rng = np.random.default_rng(seed)
        fs: List[FsFault] = []
        kills: List[ReplicaKill] = []
        if profile in ("disk-fault", "mixed"):
            for _ in range(int(rng.integers(1, 3))):
                op = ("write", "fsync")[int(rng.integers(0, 2))]
                error = ("eio", "enospc", "torn")[int(rng.integers(0, 3))]
                if op == "fsync" and error == "torn":
                    error = "eio"  # fsync has no bytes to tear
                fs.append(FsFault(
                    op=op, match="wal",
                    first=int(rng.integers(3, max(4, horizon_gens // 2))),
                    count=int(rng.integers(2, 6)), error=error,
                    tear_frac=float(rng.uniform(0.1, 0.9))))
        if profile in ("replica-kill", "mixed"):
            kills.append(ReplicaKill(
                replica_id=int(rng.integers(0, max(1, replicas))),
                at_gen=int(rng.integers(horizon_gens // 4,
                                        max(2, 3 * horizon_gens // 4)))))
        stalls: List[Stall] = []
        if profile == "mixed":
            stalls.append(Stall(
                match="broker_flush",
                first=int(rng.integers(2, max(3, horizon_gens))),
                count=2, seconds=0.01))
        return cls(fs=fs, kills=kills, stalls=tuple(stalls), seed=seed)

    # ------------------------------------------------------ consultation --

    def check_fs(self, op: str, path: str) -> FsFault | None:
        """Advance the per-``(op, match)`` counters for this call and
        return the fault it lands in, if any."""
        hit = None
        with self._lock:
            seen = set()
            for f in self.fs:
                if f.op != op or f.match not in path:
                    continue
                key = (op, f.match)
                if key not in seen:  # one tick per call per key
                    seen.add(key)
                    self._fs_counts[key] = self._fs_counts.get(key, 0) + 1
                idx = self._fs_counts[key] - 1
                if hit is None and f.first <= idx < f.first + f.count:
                    hit = f
        return hit

    def check_stall(self, match: str) -> Stall | None:
        with self._lock:
            relevant = [s for s in self.stalls if s.match == match]
            if not relevant:
                return None
            self._stall_counts[match] = \
                self._stall_counts.get(match, 0) + 1
            idx = self._stall_counts[match] - 1
            for s in relevant:
                if s.first <= idx < s.first + s.count:
                    return s
        return None


# --------------------------------------------------- global arming -------

_PLAN: FaultPlan | None = None


def install(plan: FaultPlan | None) -> None:
    """Arm ``plan`` process-wide (None disarms)."""
    global _PLAN
    _PLAN = plan


def clear() -> None:
    install(None)


def active_plan() -> FaultPlan | None:
    return _PLAN


@contextlib.contextmanager
def injected(plan: FaultPlan):
    """Arm ``plan`` for the duration of the block."""
    install(plan)
    try:
        yield plan
    finally:
        clear()


# ------------------------------------------------------- fs shims --------


def _raise_fs(fault: FsFault, path: str, op: str):
    plan = _PLAN
    if plan is not None:
        with plan._lock:
            plan.triggered.append((op, fault.error, path))
    eno = _errno.ENOSPC if fault.error == "enospc" else _errno.EIO
    raise OSError(eno, f"injected {fault.error} on {op}", path)


class _FaultyFile:
    """Write-mode file wrapper consulting the armed plan per write.

    Installed unconditionally on write-mode opens so a plan armed
    *after* the file was opened (mid-serving faults) still bites."""

    def __init__(self, f, path: str):
        self._f = f
        self._path = path

    def write(self, data):
        plan = _PLAN
        if plan is not None:
            fault = plan.check_fs("write", self._path)
            if fault is not None:
                if fault.error == "torn" and data:
                    cut = max(0, int(len(data) * fault.tear_frac))
                    self._f.write(data[:cut])
                    self._f.flush()
                _raise_fs(fault, self._path, "write")
        return self._f.write(data)

    def __getattr__(self, name):
        return getattr(self._f, name)

    # dunder lookup bypasses __getattr__, so delegate explicitly
    def __enter__(self):
        self._f.__enter__()
        return self

    def __exit__(self, *exc):
        return self._f.__exit__(*exc)

    def __iter__(self):
        return iter(self._f)


def fs_open(path: str, mode: str = "rb"):
    """``open()`` with fault-plan consultation; write modes come back
    wrapped so every later ``write`` is also a fault point."""
    plan = _PLAN
    if plan is not None:
        fault = plan.check_fs("open", path)
        if fault is not None:
            _raise_fs(fault, path, "open")
    f = open(path, mode)
    if any(c in mode for c in "wxa+"):
        return _FaultyFile(f, path)
    return f


def fs_fsync(f) -> None:
    """``os.fsync`` with fault-plan consultation (accepts a plain file
    or a :class:`_FaultyFile`)."""
    path = str(getattr(f, "_path", None) or getattr(f, "name", ""))
    plan = _PLAN
    if plan is not None:
        fault = plan.check_fs("fsync", path)
        if fault is not None:
            _raise_fs(fault, path, "fsync")
    os.fsync(f.fileno())


# --------------------------------------------------- other injectors -----


def maybe_stall(match: str) -> float:
    """Sleep if the armed plan schedules a stall at this point; returns
    the injected seconds (0.0 when nothing fired)."""
    plan = _PLAN
    if plan is None:
        return 0.0
    s = plan.check_stall(match)
    if s is None:
        return 0.0
    time.sleep(s.seconds)
    return s.seconds


def fire_kills(plan: FaultPlan, replica_set, writer_gen: int) -> list:
    """Fire every not-yet-fired :class:`ReplicaKill` whose generation the
    writer has reached; returns the fired events.  The chaos driver calls
    this between chunks (the plan is gen-scheduled, not time-scheduled,
    so the schedule is reproducible)."""
    fired = []
    for k in plan.kills:
        with plan._lock:
            if k in plan._fired_kills or writer_gen < k.at_gen:
                continue
            plan._fired_kills.add(k)
        reps = replica_set.replicas
        reps[k.replica_id % len(reps)].kill()
        fired.append(k)
    return fired
