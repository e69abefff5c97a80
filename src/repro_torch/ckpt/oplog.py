"""Write-ahead typed-op log for the streaming SCC service (a port of
``repro.ckpt.oplog``; the byte format is the same, so a log written by
either package reads in the other).

Durability layer of the paper's on-line mode: every update chunk a
:class:`repro_torch.ckpt.durable.DurableService` commits is first
appended here as ONE record -- the chunk is the service's atomicity unit
(all-or-nothing under ``_apply_lock``), so the log's record granularity
matches the commit granularity exactly and replaying a record prefix
always lands on a committed generation boundary.

Log layout (``<dir>/wal_<seq>.seg``, monotonically increasing ``seq``)::

    segment  := header record*
    header   := MAGIC("SCCWAL02") i64(base_gen) i64(epoch)     (v2)
              | MAGIC("SCCWAL01") i64(base_gen)                (v1, read
                                                  back-compat, epoch 0)
    record   := u32(REC_MAGIC) u32(len(payload)) u32(crc32(payload)) payload
    payload  := i64(gen_before) u32(n_ops)
                i32[n_ops](kind) i32[n_ops](u) i32[n_ops](v)

All integers little-endian.  ``gen_before`` is the committed generation
the chunk was applied on top of; successive records carry strictly
increasing ``gen_before`` (every chunk bumps the generation at least
once), which is what lets recovery seek the replay point for any
snapshot generation by a plain scan.

Writer epochs + fencing (the split-brain guard of the HA story,
docs/ARCHITECTURE.md §Failover):

* every v2 segment header carries the **writer epoch** that stamped it;
  epochs are monotone across the segment sequence (v1 segments read as
  epoch 0, so a pre-epoch log upgrades in place);
* a **fence marker** (``fence_<epoch>``, empty file created ``O_EXCL``)
  declares every lower epoch stale.  :func:`write_fence` and every
  :class:`OpLogWriter` mutation serialize on an advisory ``wal.lock``
  flock, and the writer re-checks :func:`newest_epoch` under that lock
  *before* each append/rotation -- so once a promotion has fenced epoch
  ``e``, a resurrected epoch-``<e`` writer's next append raises a typed
  :class:`~repro_torch.fault.errors.Fenced` with **nothing written**, and any
  append that did complete before the fence is durable and visible to
  the promoter's tail drain (exactly-once across failover);
* the promotion order is therefore: take the lease (epoch bump) ->
  ``write_fence`` -> ``repair_tail`` -> drain the tail -> open the new
  epoch's writer segment.

Crash safety:

* a record is torn iff the file ends mid-record or the CRC mismatches;
  readers treat the first invalid record as end-of-segment (the valid
  prefix is kept -- ``read_segment`` reports whether the tail was clean);
* the writer appends with configurable fsync batching (``sync_every``
  records per fsync; 1 = fsync every commit) and can atomically
  ``rollback_last()`` (truncate) when the in-memory apply of the logged
  chunk fails, so failed chunks never survive into recovery;
* segment rotation closes the current file after ``segment_bytes`` and
  opens ``wal_<seq+1>.seg`` whose header carries the current generation,
  so whole segments can be dropped by :func:`trim` once a snapshot
  covers them;
* :class:`LogTailer` is the replica-side incremental reader: it remembers
  its (segment, offset) cursor, re-polls a torn tail (the writer may
  simply not have finished the record yet), and only advances to the
  next segment once one exists -- a torn record followed by a newer
  segment means real corruption and raises.
"""
from __future__ import annotations

import contextlib
import os
import re
import struct
import zlib
from typing import Iterator, List, NamedTuple, Tuple

import numpy as np

try:
    import fcntl
except ImportError:  # non-POSIX: advisory lock degrades to a no-op
    fcntl = None

from repro_torch.fault import errors as fault_errors
from repro_torch.fault.inject import fs_fsync, fs_open

__all__ = ["OpLogWriter", "LogTailer", "OpRecord", "SegmentHeader",
           "read_segment", "read_log", "list_segments", "repair_tail",
           "drop_unapplied_tail", "trim", "segment_header",
           "segment_base_gen", "parse_segment_header", "write_fence",
           "list_fences", "newest_epoch", "SEG_HEADER_BYTES"]

_SEG_MAGIC_V1 = b"SCCWAL01"
_SEG_MAGIC_V2 = b"SCCWAL02"
_REC_MAGIC = 0xA11C0DE5
_REC_HDR = struct.Struct("<III")          # magic, payload len, crc32
_PAYLOAD_HDR = struct.Struct("<qI")       # gen_before, n_ops
_SEG_HDR_V1 = struct.Struct("<8sq")       # magic, base_gen
_SEG_HDR_V2 = struct.Struct("<8sqq")      # magic, base_gen, epoch
SEG_HEADER_BYTES = _SEG_HDR_V2.size       # what the writer emits today

_SEG_RE = re.compile(r"wal_(\d{8})\.seg")
_FENCE_RE = re.compile(r"fence_(\d{8})")
_LOCK_NAME = "wal.lock"


@contextlib.contextmanager
def _wal_lock(directory: str):
    """Advisory per-directory mutex (flock) serializing writer mutations
    against :func:`write_fence`: the fence check and the bytes it guards
    are atomic with respect to a concurrent promotion.  Deliberately NOT
    routed through the fault-injection shims -- the lock is coordination,
    not data, and an injected EIO here would fail appends the durability
    ledger never sees."""
    if fcntl is None:
        yield
        return
    fd = os.open(os.path.join(directory, _LOCK_NAME),
                 os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)  # close releases the flock


class OpRecord(NamedTuple):
    """One durably logged update chunk."""
    gen_before: int
    kind: np.ndarray  # int32[n]
    u: np.ndarray     # int32[n]
    v: np.ndarray     # int32[n]


def _seg_path(directory: str, seq: int) -> str:
    return os.path.join(directory, f"wal_{seq:08d}.seg")


def list_segments(directory: str) -> List[Tuple[int, str]]:
    """Sorted [(seq, path)] of the directory's segment files."""
    out = []
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        m = _SEG_RE.fullmatch(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(out)


class SegmentHeader(NamedTuple):
    """Parsed segment header: base generation, writer epoch, and the
    header's on-disk size (v1 and v2 differ -- every reader must offset
    records by the *segment's own* header size)."""
    base_gen: int
    epoch: int
    size: int


def parse_segment_header(buf: bytes, path: str = "<buf>") -> SegmentHeader:
    """Decode a segment header (v2, or v1 read as epoch 0); raises a
    typed :class:`~repro_torch.fault.errors.WalCorrupt` on a bad/short magic
    so the replica resync path can dispatch on it."""
    if len(buf) >= _SEG_HDR_V2.size and buf[:8] == _SEG_MAGIC_V2:
        _, base_gen, epoch = _SEG_HDR_V2.unpack_from(buf, 0)
        return SegmentHeader(base_gen, epoch, _SEG_HDR_V2.size)
    if len(buf) >= _SEG_HDR_V1.size and buf[:8] == _SEG_MAGIC_V1:
        _, base_gen = _SEG_HDR_V1.unpack_from(buf, 0)
        return SegmentHeader(base_gen, 0, _SEG_HDR_V1.size)
    raise fault_errors.WalCorrupt(
        f"bad WAL segment header in {path!r}")


def segment_header(path: str) -> SegmentHeader:
    with open(path, "rb") as f:
        buf = f.read(_SEG_HDR_V2.size)
    return parse_segment_header(buf, path)


def segment_base_gen(path: str) -> int:
    return segment_header(path).base_gen


def _fence_path(directory: str, epoch: int) -> str:
    return os.path.join(directory, f"fence_{epoch:08d}")


def list_fences(directory: str) -> List[int]:
    """Sorted epochs with a fence marker in the directory."""
    out = []
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        m = _FENCE_RE.fullmatch(name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def newest_epoch(directory: str) -> int:
    """The directory's current writer epoch: the max over fence markers
    and the newest readable segment header (0 for an empty or pre-epoch
    store).  A writer whose epoch is below this value is stale."""
    top = 0
    fences = list_fences(directory)
    if fences:
        top = fences[-1]
    for _, path in reversed(list_segments(directory)):
        try:
            return max(top, segment_header(path).epoch)
        except (OSError, fault_errors.WalCorrupt):
            continue  # torn header (writer died mid-create): look back
    return top


def write_fence(directory: str, epoch: int) -> str:
    """Durably fence every writer epoch below ``epoch``: create the
    marker ``O_EXCL`` (idempotent if it already exists) under the WAL
    lock, so no stale append can interleave with the fence becoming
    visible -- after this returns, an epoch-``<epoch`` writer's next
    append raises :class:`~repro_torch.fault.errors.Fenced` having written
    nothing, and every append that completed before it is durable on
    disk for the promoter's tail drain."""
    os.makedirs(directory, exist_ok=True)
    path = _fence_path(directory, epoch)
    with _wal_lock(directory):
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return path
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        try:  # make the marker's directory entry itself durable
            dfd = os.open(directory, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass
    return path


def _encode_record(gen_before: int, kind, u, v) -> bytes:
    kind = np.ascontiguousarray(kind, "<i4")
    u = np.ascontiguousarray(u, "<i4")
    v = np.ascontiguousarray(v, "<i4")
    if not (kind.shape == u.shape == v.shape and kind.ndim == 1):
        raise ValueError(f"record columns differ: {kind.shape}, "
                         f"{u.shape}, {v.shape}")
    payload = (_PAYLOAD_HDR.pack(int(gen_before), kind.shape[0])
               + kind.tobytes() + u.tobytes() + v.tobytes())
    return _REC_HDR.pack(_REC_MAGIC, len(payload),
                         zlib.crc32(payload)) + payload


def _decode_payload(payload: bytes) -> OpRecord:
    gen_before, n = _PAYLOAD_HDR.unpack_from(payload, 0)
    arrs = np.frombuffer(payload, "<i4", count=3 * n,
                         offset=_PAYLOAD_HDR.size)
    return OpRecord(gen_before, arrs[:n].copy(), arrs[n:2 * n].copy(),
                    arrs[2 * n:].copy())


def _scan_records(buf: bytes, offset: int
                  ) -> Iterator[Tuple[int, OpRecord]]:
    """Yield (end_offset, record) for every complete valid record from
    ``offset``; stops (without raising) at the first torn/invalid one."""
    n = len(buf)
    while offset + _REC_HDR.size <= n:
        magic, plen, crc = _REC_HDR.unpack_from(buf, offset)
        if magic != _REC_MAGIC:
            return
        end = offset + _REC_HDR.size + plen
        if end > n:
            return
        payload = buf[offset + _REC_HDR.size:end]
        if zlib.crc32(payload) != crc or plen < _PAYLOAD_HDR.size:
            return
        yield end, _decode_payload(payload)
        offset = end


def read_segment(path: str) -> Tuple[List[OpRecord], bool, int]:
    """Read one segment; returns ``(records, clean, valid_end)``.

    ``clean`` is False when the file ends in a torn/invalid record;
    ``valid_end`` is the byte offset of the end of the valid prefix
    (what a tail repair would truncate to)."""
    with open(path, "rb") as f:
        buf = f.read()
    try:
        hdr = parse_segment_header(buf, path)
    except fault_errors.WalCorrupt:
        return [], False, 0
    records = []
    end = hdr.size
    for end, rec in _scan_records(buf, hdr.size):
        records.append(rec)
    return records, end == len(buf), end


def read_log(directory: str, from_gen: int = 0) -> List[OpRecord]:
    """All replayable records with ``gen_before >= from_gen``, in order.

    Stops at the first torn record *of the last segment* (normal crash
    tail).  A torn record in a non-final segment means the suffix of the
    log is unreachable; the records after it are dropped (they were
    never acknowledged as a contiguous history) -- recovery converges to
    the longest valid prefix.
    """
    out: List[OpRecord] = []
    for _, path in list_segments(directory):
        records, clean, _ = read_segment(path)
        out.extend(r for r in records if r.gen_before >= from_gen)
        if not clean:
            break
    return out


def repair_tail(directory: str) -> int:
    """Truncate the final segment to its valid record prefix.

    Recovery MUST call this before opening a new writer segment: readers
    treat a torn record as end-of-log only while it is the last thing in
    the log, so leaving torn bytes behind a newer segment would orphan
    every later record.  Returns the number of bytes dropped."""
    dropped = 0
    while True:
        segs = list_segments(directory)
        if not segs:
            return dropped
        _, path = segs[-1]
        _, clean, valid_end = read_segment(path)
        if clean:
            return dropped
        size = os.path.getsize(path)
        if valid_end <= 0:
            # not even a valid header survived: the segment holds no
            # acknowledged data -- a 0-byte stub would still read as
            # torn and orphan any segment a new writer opens after it
            os.remove(path)
            dropped += size
            continue
        with fs_open(path, "r+b") as f:
            f.truncate(valid_end)
            f.flush()
            fs_fsync(f)
        return dropped + (size - valid_end)


def drop_unapplied_tail(directory: str, gen: int) -> int:
    """Truncate trailing records of the final segment whose
    ``gen_before >= gen`` -- valid on disk but never applied by the
    writer (a failed append whose own best-effort rollback could not
    reach the disk).  The writer calls this on (re)attach with its
    committed generation: every chunk it committed advanced the
    generation past its own ``gen_before``, so a record at or past
    ``gen`` was never acknowledged and would shadow the *different*
    chunk the writer logs next at the same generation.  Returns the
    bytes dropped; raises ``OSError`` when the truncate cannot be made
    durable (the caller's recovery probe must then fail)."""
    segs = list_segments(directory)
    if not segs:
        return 0
    _, path = segs[-1]
    with open(path, "rb") as f:
        buf = f.read()
    try:
        hdr = parse_segment_header(buf, path)
    except fault_errors.WalCorrupt:
        return 0
    cut = None
    prev = hdr.size
    for end, rec in _scan_records(buf, hdr.size):
        if cut is None and rec.gen_before >= gen:
            cut = prev  # gen_before is strictly increasing: everything
            #             from here on is unapplied
        prev = end
    if cut is None:
        return 0
    with fs_open(path, "r+b") as f:
        f.truncate(cut)
        f.flush()
        fs_fsync(f)
    return len(buf) - cut


def trim(directory: str, min_gen: int) -> int:
    """Drop whole segments no longer needed to replay from ``min_gen``:
    segment i may go iff segment i+1 exists and starts at or below
    ``min_gen`` (every record with ``gen_before >= min_gen`` then still
    lives in later segments).  Returns the number of files removed."""
    segs = list_segments(directory)
    removed = 0
    for (_, path), (_, nxt) in zip(segs, segs[1:]):
        if segment_base_gen(nxt) <= min_gen:
            os.remove(path)
            removed += 1
        else:
            break
    return removed


class OpLogWriter:
    """Appender with fsync batching, rotation, tail rollback -- and epoch
    fencing: every segment is stamped with this writer's ``epoch``, and
    every append/rotation re-checks (under the WAL lock) that no higher
    epoch has fenced the directory.  ``epoch=None`` adopts the store's
    current epoch (:func:`newest_epoch`) -- the single-writer default;
    an HA writer passes its lease's fencing token explicitly so a
    resurrected stale leader can never adopt its way past a fence."""

    def __init__(self, directory: str, *, segment_bytes: int = 4 << 20,
                 sync_every: int = 1, start_gen: int = 0,
                 epoch: int | None = None):
        os.makedirs(directory, exist_ok=True)
        self._dir = directory
        self._segment_bytes = int(segment_bytes)
        self._sync_every = max(1, int(sync_every))
        self._unsynced = 0
        self._last_span: Tuple[int, int] | None = None  # (start, end)
        top = newest_epoch(directory)
        if epoch is None:
            epoch = top
        elif epoch < top:
            raise fault_errors.Fenced(
                f"writer epoch {epoch} is stale: {directory!r} is fenced "
                f"at epoch {top}; nothing was written")
        self.epoch = int(epoch)
        segs = list_segments(directory)
        self._seq = segs[-1][0] if segs else 0
        self._f = None
        self._open_segment(self._seq + 1, start_gen)
        self.appended = 0
        self.syncs = 0
        self.rotations = 0
        self.rollbacks = 0

    def _assert_unfenced(self, horizon_seq: int):
        """Raise :class:`~repro_torch.fault.errors.Fenced` if a fence marker or
        a foreign segment at/after ``horizon_seq`` carries a higher epoch.
        Caller holds the WAL lock, so the verdict cannot race a
        concurrent :func:`write_fence`."""
        top = -1
        for name in os.listdir(self._dir):
            m = _FENCE_RE.fullmatch(name)
            if m:
                top = max(top, int(m.group(1)))
                continue
            m = _SEG_RE.fullmatch(name)
            if m and int(m.group(1)) >= horizon_seq:
                try:
                    top = max(top, segment_header(
                        os.path.join(self._dir, name)).epoch)
                except (OSError, fault_errors.WalCorrupt):
                    pass
        if top > self.epoch:
            raise fault_errors.Fenced(
                f"writer epoch {self.epoch} fenced by epoch {top} in "
                f"{self._dir!r}; nothing was written")

    def _open_segment(self, seq: int, base_gen: int):
        if self._f is not None:
            self.sync()
            self._f.close()
            self._f = None
        with _wal_lock(self._dir):
            self._assert_unfenced(seq)
            try:
                self._f = fs_open(_seg_path(self._dir, seq), "xb")
            except FileExistsError as e:
                # another writer created it first: by protocol it fenced
                # us before doing so, or it is a misconfigured twin --
                # either way this writer must not touch the log again
                raise fault_errors.Fenced(
                    f"segment {seq} already exists in {self._dir!r}: "
                    f"another writer owns this log") from e
            self._seq = seq
            self._f.write(_SEG_HDR_V2.pack(_SEG_MAGIC_V2, int(base_gen),
                                           self.epoch))
            self._f.flush()
            fs_fsync(self._f)
        self._pos = _SEG_HDR_V2.size
        self._last_span = None

    @property
    def path(self) -> str:
        return _seg_path(self._dir, self._seq)

    def append(self, gen_before: int, kind, u, v) -> None:
        """Durably append one chunk record (write-ahead: call BEFORE
        applying; fsync per ``sync_every`` appends).

        A failed append rolls its own record's bytes back (best-effort)
        before re-raising: the chunk was never acknowledged, so it must
        not survive on disk -- recovery and replica tails would replay
        it ahead of a *different* chunk later logged at the same
        generation, losing the acked one to the ``gen_before < gen``
        skip.  Earlier records of the same fsync batch are preserved
        (they were acknowledged).

        Raises :class:`~repro_torch.fault.errors.Fenced` -- with nothing
        written -- when a higher epoch owns the directory; the check and
        the write are atomic under the WAL lock, so an append can only
        land entirely before a fence (durable, drained by the promoter)
        or fail entirely after it."""
        rec = _encode_record(gen_before, kind, u, v)
        start = self._pos
        with _wal_lock(self._dir):
            self._assert_unfenced(self._seq + 1)
            try:
                self._f.write(rec)
                self._pos += len(rec)
                self._last_span = (start, self._pos)
                self._unsynced += 1
                if self._unsynced >= self._sync_every:
                    self.sync()
            except OSError:
                self._discard_to(start)
                raise
        self.appended += 1

    def rollback_last(self) -> None:
        """Truncate the last appended record (the apply of its chunk
        failed -- a failed chunk must not survive into recovery)."""
        if self._last_span is None:
            raise fault_errors.WalGap(
                "no record to roll back in this segment")
        start, _ = self._last_span
        self._f.flush()
        self._f.truncate(start)
        self._f.seek(start)
        fs_fsync(self._f)
        self._pos = start
        self._last_span = None
        self._unsynced = 0
        self.rollbacks += 1

    def _discard_to(self, pos: int) -> None:
        """Best-effort truncate to ``pos``; errors are swallowed (the
        store is entering its degraded path; ``drop_unapplied_tail`` at
        re-attach covers whatever could not reach the disk)."""
        try:
            self._f.flush()
            self._f.truncate(pos)
            self._f.seek(pos)
            fs_fsync(self._f)
        except OSError:
            pass
        self._pos = pos
        self._last_span = None
        self._unsynced = 0

    def discard_tail(self) -> None:
        """Best-effort truncate to the last known-good byte boundary --
        the ``DurableService.sync()`` failure path, where every record
        up to ``_pos`` was acknowledged (batched appends) and must
        survive; a failed ``append`` rolls back its own record before
        this can run."""
        self._discard_to(self._pos)

    def maybe_rotate(self, gen: int) -> bool:
        """Rotate to a fresh segment (header stamped ``gen``) once the
        current one exceeds ``segment_bytes``; call between chunks."""
        if self._pos < self._segment_bytes:
            return False
        self._open_segment(self._seq + 1, gen)
        self.rotations += 1
        return True

    def sync(self) -> None:
        if self._unsynced == 0:
            return
        self._f.flush()
        fs_fsync(self._f)
        self._unsynced = 0
        self.syncs += 1

    def close(self) -> None:
        if self._f is not None:
            self.sync()
            self._f.close()
            self._f = None

    def stats(self) -> dict:
        return {"wal_appended": self.appended, "wal_syncs": self.syncs,
                "wal_rotations": self.rotations,
                "wal_rollbacks": self.rollbacks,
                "wal_segment": self._seq, "wal_bytes": self._pos,
                "wal_epoch": self.epoch}


class LogTailer:
    """Replica-side incremental reader: poll for newly completed records.

    Keeps a (segment seq, byte offset) cursor.  A torn record at the
    cursor is *pending*, not corrupt -- the writer may still be flushing
    it -- unless a newer segment already exists, which means the writer
    moved on and the bytes will never complete: that raises
    :class:`~repro_torch.fault.errors.WalCorrupt`.  Segments removed underneath
    the cursor (``trim`` racing a slow tailer) raise
    :class:`~repro_torch.fault.errors.WalTrimmed` -- a resync *signal*, not a
    failure: every trimmed record is covered by a newer snapshot (that is
    the trim precondition), so the owner fast-forwards and keeps going.
    The constructor absorbs the same race itself (segment listed, then
    trimmed before its header is read) by re-listing.
    """

    def __init__(self, directory: str, from_gen: int = 0):
        self._dir = directory
        self._from_gen = int(from_gen)
        for _attempt in range(8):
            segs = list_segments(directory)
            if not segs:
                raise FileNotFoundError(
                    f"no WAL segments in {directory!r}")
            # start at the last segment whose base_gen <= from_gen: every
            # record with gen_before >= from_gen lives at or after it
            start = 0
            try:
                for i, (_, path) in enumerate(segs):
                    try:
                        if segment_base_gen(path) <= self._from_gen:
                            start = i
                    except fault_errors.WalCorrupt:
                        break  # header still being written (or torn):
                        # seek no further; poll() adjudicates pending
                        # vs. corrupt once a cursor sits on it
            except FileNotFoundError:
                continue  # trim raced the listing: re-list, never raise
            break
        else:
            raise fault_errors.WalTrimmed(
                f"segments in {directory!r} kept vanishing while "
                f"seeking generation {from_gen}")
        self._seq = segs[start][0]
        self._offset = 0  # 0 = at segment start, header not yet consumed
        self.polled_records = 0

    @property
    def cursor(self) -> Tuple[int, int]:
        return self._seq, self._offset

    def poll(self, max_records: int | None = None) -> List[OpRecord]:
        """Return records completed since the last poll (possibly [])."""
        out: List[OpRecord] = []
        while max_records is None or len(out) < max_records:
            path = _seg_path(self._dir, self._seq)
            try:
                with open(path, "rb") as f:
                    buf = f.read()
            except FileNotFoundError as e:  # trimmed underneath us
                raise fault_errors.WalTrimmed(
                    f"WAL segment {path!r} was trimmed under the tail "
                    f"cursor; resync from the covering snapshot") from e
            if self._offset == 0:
                # first look at this segment: consume its own header (v1
                # and v2 sizes differ).  A short/bad header is *pending*
                # while this is the newest segment (the writer may be
                # mid-create), corrupt once a newer one exists.
                try:
                    self._offset = parse_segment_header(buf, path).size
                except fault_errors.WalCorrupt:
                    if os.path.exists(_seg_path(self._dir, self._seq + 1)):
                        raise fault_errors.WalCorrupt(
                            f"unreadable WAL segment header in {path!r} "
                            f"but a newer segment exists")
                    break
            for end, rec in _scan_records(buf, self._offset):
                self._offset = end
                if rec.gen_before >= self._from_gen:
                    out.append(rec)
                if max_records is not None and len(out) >= max_records:
                    break
            if max_records is not None and len(out) >= max_records:
                break  # stopped early, not torn: keep the cursor here
            nxt = _seg_path(self._dir, self._seq + 1)
            if not os.path.exists(nxt):
                break
            if self._offset < len(buf):
                raise fault_errors.WalCorrupt(
                    f"WAL segment {path!r} has a torn record at offset "
                    f"{self._offset} but a newer segment exists")
            self._seq += 1
            self._offset = 0
        self.polled_records += len(out)
        return out
