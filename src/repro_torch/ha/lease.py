"""File-based write lease: leadership whose fencing token IS the WAL epoch
(a copy of ``repro.ha.lease``).

Without it the durable writer is the one single point of failure:
replicas survive kills, but a dead writer leaves the store read-only
forever.  This module is the coordination half of automatic failover --
a lease file (``<dir>/LEASE``) names the current writer and its
**epoch**, and the epoch doubles as the WAL fencing token
(:mod:`repro_torch.ckpt.oplog`): a promotion bumps the epoch here *first*,
then fences the log at that epoch, so log authority and leadership can
never point at different nodes.

Protocol (single shared filesystem, the paper's shared-memory framing
lifted to processes):

* **fresh acquire** -- publish ``"<epoch> <owner>"`` at epoch 0 via an
  atomic ``O_EXCL``-style link (content is complete before the name
  exists; two racers get exactly one winner);
* **heartbeat renewal** -- the holder re-reads the file (verifying the
  content is still its own) and bumps the mtime; liveness is mtime age
  against ``ttl_s``.  A renewal that finds foreign content raises a
  typed :class:`~repro_torch.fault.errors.LeaseLost`;
* **takeover** -- only once the lease is stale (age > ttl).  The new
  epoch is claimed via an ``O_EXCL`` claim file (unique winner per
  epoch), the observed epoch is re-verified under the claim, and the
  lease is atomically ``os.replace``-d with ``"<epoch+1> <owner>"``.
  Losers see either the claim or the fresh lease and stand down.
  A claim whose owner died mid-takeover goes stale itself (mtime age)
  and is removed by the next claimant;
* **clean release** -- backdates the mtime, so a graceful shutdown hands
  off after one poll instead of a full TTL; :meth:`FileLease.abandon`
  (the crash hook) just stops heartbeating, modelling SIGKILL.

The lease alone is *advisory*: split-brain safety comes from the WAL
fence written at the taken-over epoch -- even a holder that never
notices the takeover has every subsequent append refused with
:class:`~repro_torch.fault.errors.Fenced`, nothing written.
"""
from __future__ import annotations

import os
import threading
import time
from typing import NamedTuple

from repro_torch.fault import errors as fault_errors

__all__ = ["FileLease", "LeaseInfo", "LEASE_NAME"]

LEASE_NAME = "LEASE"


class LeaseInfo(NamedTuple):
    """One observation of the lease file."""
    epoch: int
    owner: str
    age_s: float


class FileLease:
    """One contender's handle on the write lease of a store directory.

    ``try_acquire`` never blocks and never steals a live lease; call it
    again after ``ttl_s`` to attempt a takeover.  A successful acquire
    sets :attr:`epoch` -- pass it to the WAL writer as its fencing
    token.  ``auto-renew`` via :meth:`start_heartbeat`; a failed renewal
    flips :attr:`valid` False and records :attr:`lost_reason`.
    """

    def __init__(self, directory: str, owner: str, *, ttl_s: float = 1.0):
        os.makedirs(directory, exist_ok=True)
        self._dir = directory
        self._path = os.path.join(directory, LEASE_NAME)
        self.owner = str(owner)
        self.ttl_s = float(ttl_s)
        self.epoch = -1            # valid only while held
        self._held = False
        self.lost_reason: BaseException | None = None
        self.takeovers = 0
        self.renewals = 0
        self._hb_stop: threading.Event | None = None
        self._hb_thread: threading.Thread | None = None

    # ------------------------------------------------------------ observe --

    @property
    def path(self) -> str:
        return self._path

    @property
    def held(self) -> bool:
        return self._held

    @property
    def valid(self) -> bool:
        """True while this contender holds the lease and no renewal has
        discovered a takeover."""
        return self._held and self.lost_reason is None

    def peek(self) -> LeaseInfo | None:
        """Read the lease file without touching it (None when absent or
        unreadable)."""
        try:
            with open(self._path) as f:
                txt = f.read()
            mtime = os.path.getmtime(self._path)
        except OSError:
            return None
        parts = txt.split()
        if len(parts) < 2:
            return None
        try:
            epoch = int(parts[0])
        except ValueError:
            return None
        return LeaseInfo(epoch, parts[1], max(0.0, time.time() - mtime))

    # ------------------------------------------------------------ acquire --

    def _publish_fresh(self) -> bool:
        """Atomically create the lease at epoch 0: write the full content
        to a private temp name, then ``os.link`` it into place -- the
        name appears only with complete content, and exactly one of any
        concurrent racers wins the link."""
        tmp = f"{self._path}.tmp_{os.getpid()}_{id(self):x}"
        with open(tmp, "w") as f:
            f.write(f"0 {self.owner}\n")
            f.flush()
            os.fsync(f.fileno())
        try:
            os.link(tmp, self._path)
        except FileExistsError:
            return False
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass
        self.epoch = 0
        return True

    def _takeover(self, seen: LeaseInfo) -> bool:
        """Bump to ``seen.epoch + 1`` iff the lease still looks exactly
        like ``seen`` (stale, same epoch) while we hold the epoch's
        claim file -- the unique-winner guard."""
        new_epoch = seen.epoch + 1
        claim = f"{self._path}.claim_{new_epoch:08d}"
        try:
            fd = os.open(claim, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
        except FileExistsError:
            # a racing claimant owns this epoch -- unless it died mid-
            # takeover: a claim past its own TTL is abandoned, clear it
            # so the next attempt can proceed
            try:
                if time.time() - os.path.getmtime(claim) > self.ttl_s:
                    os.remove(claim)
            except OSError:
                pass
            return False
        try:
            cur = self.peek()
            if cur is None or cur.epoch != seen.epoch \
                    or cur.age_s < self.ttl_s:
                return False  # the lease moved while we claimed
            tmp = f"{self._path}.tmp_{os.getpid()}_{id(self):x}"
            with open(tmp, "w") as f:
                f.write(f"{new_epoch} {self.owner}\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path)
        finally:
            try:
                os.remove(claim)
            except OSError:
                pass
        self.epoch = new_epoch
        self.takeovers += 1
        return True

    def try_acquire(self) -> bool:
        """Acquire the lease if free or stale; never blocks, never steals
        a live lease.  True on success (with :attr:`epoch` set)."""
        if self.valid:
            return True
        info = self.peek()
        if info is None:
            ok = self._publish_fresh()
        elif info.owner == self.owner and info.epoch == self.epoch \
                and self._held:
            ok = True  # still ours (a renewal raced our doubt)
        elif info.age_s < self.ttl_s:
            return False  # holder is alive
        else:
            ok = self._takeover(info)
        if ok:
            self._held = True
            self.lost_reason = None
        return ok

    # -------------------------------------------------------------- renew --

    def renew(self):
        """Heartbeat: verify the lease content is still ours, then bump
        the mtime.  Raises :class:`~repro_torch.fault.errors.LeaseLost` (and
        flips :attr:`valid`) when the lease was taken over."""
        if not self._held:
            raise fault_errors.LeaseLost("lease is not held")
        info = self.peek()
        if info is None or info.epoch != self.epoch \
                or info.owner != self.owner:
            e = fault_errors.LeaseLost(
                f"lease {self._path!r} taken over: now {info}, "
                f"we were epoch {self.epoch} owner {self.owner!r}")
            self.lost_reason = e
            raise e
        os.utime(self._path)
        self.renewals += 1

    def start_heartbeat(self, interval_s: float | None = None):
        """Renew on a background thread every ``interval_s`` (default
        ttl/3).  The thread exits -- flipping :attr:`valid` -- on the
        first failed renewal; the holder checks :attr:`valid` on its
        write path and self-fences."""
        if self._hb_thread is not None and self._hb_thread.is_alive():
            return
        interval = self.ttl_s / 3 if interval_s is None else interval_s
        self._hb_stop = threading.Event()

        def _run(stop=self._hb_stop):
            while not stop.wait(interval):
                try:
                    self.renew()
                except (fault_errors.LeaseLost, OSError) as e:
                    if self.lost_reason is None:
                        self.lost_reason = e
                    return

        self._hb_thread = threading.Thread(
            target=_run, name=f"scc-lease-{self.owner}", daemon=True)
        self._hb_thread.start()

    def _stop_heartbeat(self):
        if self._hb_stop is not None:
            self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join()
            self._hb_thread = None

    # ------------------------------------------------------------ handoff --

    def release(self):
        """Graceful handoff: stop heartbeating and backdate the lease's
        mtime so the next contender takes over on its next poll instead
        of waiting out a full TTL.  The epoch stays on disk -- the
        successor still bumps it, keeping the fence monotone."""
        self._stop_heartbeat()
        if self._held and self.lost_reason is None:
            info = self.peek()
            if info is not None and info.epoch == self.epoch \
                    and info.owner == self.owner:
                try:
                    os.utime(self._path, (0, 0))
                except OSError:
                    pass
        self._held = False

    def abandon(self):
        """Crash simulation (chaos): stop heartbeating WITHOUT touching
        the file -- exactly what SIGKILL leaves behind.  Failover then
        costs one full TTL of staleness, the realistic path."""
        self._stop_heartbeat()
        self._held = False

    def stats(self) -> dict:
        return {"lease_epoch": self.epoch, "lease_held": self._held,
                "lease_valid": self.valid, "lease_owner": self.owner,
                "lease_renewals": self.renewals,
                "lease_takeovers": self.takeovers}
