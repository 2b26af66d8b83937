"""Shared extent allocation for multi-process writing (DESIGN.md §8.6).

N independent writer processes commit clusters into ONE container file.  The
commit path is already position-independent (reserve-then-pwritev), so the
only shared state is the allocation frontier plus enough bookkeeping to
survive any writer dying at any point.  That state lives in a **side-car
reservation log** (``<container>.mpwlog``): an append-only record stream,
every append made under an exclusive ``fcntl`` file lock and (by default)
fsynced, so the log is a write-ahead journal of every allocation decision.
State is never stored — it is **replayed** from the log, which makes the
protocol crash-consistent by construction: whatever prefix of the log
survived a crash IS the state.

Record types::

    CREATE   frontier initialised past the container header; carries the
             container's generation id, binding this log to that exact
             file instance
    JOIN     a writer registers; assigned (writer_id, epoch); takes a lease
    LEASE    heartbeat: extends the writer's lease deadline
    RESERVE  allocates [offset, offset+size) + the global commit seq
    COMMIT   the reservation's framed cluster extent is fully on disk
    RELEASE  the writer gives the (uncommitted) reservation back as a hole
    FENCE    the writer's epoch is dead: all its future transactions refuse
    DONE     the writer committed everything and fsynced its data
    SEAL     the coordinator froze the file; no further transaction succeeds

Safety invariants:

* **Extents are disjoint and never reused.**  An abandoned or expired
  reservation becomes a permanent hole — the frontier never rolls back.
  This is what makes fencing safe without kernel-level write fencing: a
  fenced writer's late ``pwrite`` can only land inside its *own* abandoned
  extent, never inside a committed cluster or the footer.
* **Fencing is checked inside the locked transaction.**  A fenced (or
  lease-expired-and-fenced) writer's ``reserve``/``commit`` raises
  :class:`FencedError` before any record is appended, so a stale-epoch
  writer cannot extend the file or mark garbage committed.
* **Replay is pure.**  Every record carries its concrete values (offsets,
  seqs, ids) — replay applies them verbatim and tolerates a torn record at
  the tail (a crash mid-append), which it drops.  The next locked
  transaction *truncates* that torn tail before appending, so a record
  appended after a tear is always visible to every later replay.
* **The log is bound to one container instance.**  CREATE carries the
  generation id the coordinator also stamped into the container header;
  a join or recovery that finds a mismatched (or missing) generation
  refuses the log (:class:`StaleLogError`) instead of replaying state
  that belongs to a previous file at the same path.

Clock note: lease timestamps are ``time.time()`` (wall clock) because they
are written by one process and compared in another — ``time.monotonic()``
deltas are only defined within a single process.  A wall-clock step skews
lease expiry by the step size; that can only fence a live writer early
(safe: fencing never corrupts, see above) or delay fencing a dead one.
"""

from __future__ import annotations

import fcntl
import json
import os
import struct
import threading
import time
import zlib
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

XLOG_SUFFIX = ".mpwlog"
XLOG_MAGIC = b"RJXL"

XREC_CREATE = 1
XREC_JOIN = 2
XREC_LEASE = 3
XREC_RESERVE = 4
XREC_COMMIT = 5
XREC_RELEASE = 6
XREC_FENCE = 7
XREC_DONE = 8
XREC_SEAL = 9

_XREC_HDR = struct.Struct("<4sHHI")  # magic, type, flags, payload_len


class FencedError(RuntimeError):
    """This writer's epoch has been fenced (lease lost, coordinator sealed,
    or an explicit fence): every further reservation/commit is refused."""


class StaleLogError(RuntimeError):
    """The side-car log does not belong to this container instance (its
    generation id disagrees with the container header's), or a CREATE found
    a non-empty log left behind by a previous run at the same path."""


# ---------------------------------------------------------------------------
# record framing


def _pack_record(rtype: int, payload: dict) -> bytes:
    body = json.dumps(payload, separators=(",", ":")).encode()
    crc = zlib.crc32(struct.pack("<HH", rtype, 0) + body)
    return (_XREC_HDR.pack(XLOG_MAGIC, rtype, 0, len(body)) + body
            + struct.pack("<I", crc))


def scan_records(raw: bytes) -> Tuple[List[Tuple[int, dict]], int]:
    """``(records, valid_end)``: every intact ``(rtype, payload)`` plus the
    offset where the intact prefix ends.  A torn or corrupt tail (crash
    mid-append) terminates the scan; ``valid_end < len(raw)`` marks it so
    the next transaction can truncate it before appending — otherwise
    records appended past the tear would be invisible to every replay."""
    records: List[Tuple[int, dict]] = []
    pos = 0
    while pos + _XREC_HDR.size <= len(raw):
        magic, rtype, flags, plen = _XREC_HDR.unpack_from(raw, pos)
        end = pos + _XREC_HDR.size + plen + 4
        if magic != XLOG_MAGIC or end > len(raw):
            break
        body = raw[pos + _XREC_HDR.size : end - 4]
        (crc,) = struct.unpack_from("<I", raw, end - 4)
        if zlib.crc32(struct.pack("<HH", rtype, flags) + body) != crc:
            break
        records.append((rtype, json.loads(body)))
        pos = end
    return records, pos


def iter_records(raw: bytes):
    """Yield ``(rtype, payload_dict)`` for every intact record; a torn or
    corrupt tail terminates iteration silently (crash mid-append)."""
    yield from scan_records(raw)[0]


# ---------------------------------------------------------------------------
# replayed state


@dataclass
class Reservation:
    rid: int
    writer_id: int
    epoch: int
    offset: int
    size: int
    seq: int
    committed: bool = False
    released: bool = False


@dataclass
class WriterInfo:
    writer_id: int
    epoch: int
    pid: int = 0
    lease_interval: float = 5.0
    lease_deadline: float = 0.0
    fenced: bool = False
    done: bool = False

    def expired(self, now: float) -> bool:
        return not self.done and not self.fenced and now > self.lease_deadline


@dataclass
class LogState:
    """The full allocator state, rebuilt by replaying the side-car log."""

    data_start: int = 0
    generation: Optional[str] = None
    next_offset: int = 0
    next_seq: int = 0
    next_rid: int = 0
    next_writer: int = 1
    next_epoch: int = 1
    sealed: bool = False
    seal_info: dict = field(default_factory=dict)
    writers: Dict[int, WriterInfo] = field(default_factory=dict)
    reservations: Dict[int, Reservation] = field(default_factory=dict)

    def live_writers(self, now: float) -> List[WriterInfo]:
        return [w for w in self.writers.values()
                if not w.fenced and not w.done and not w.expired(now)]

    def check_writable(self, writer_id: int, epoch: int) -> None:
        if self.sealed:
            raise FencedError("container already sealed")
        w = self.writers.get(writer_id)
        if w is None or w.epoch != epoch or w.fenced:
            raise FencedError(
                f"writer {writer_id} epoch {epoch} is fenced")
        if w.done:
            # DONE is terminal: it is the participant's half of the footer
            # rendezvous, and the coordinator may seal the moment every
            # writer is done — a post-DONE reservation would race the seal
            raise FencedError(f"writer {writer_id} already reported done")


def replay_log(raw: bytes) -> LogState:
    st = LogState()
    for rtype, d in iter_records(raw):
        _apply_record(st, rtype, d)
    return st


def _apply_record(st: LogState, rtype: int, d: dict) -> None:
    if rtype == XREC_CREATE:
        st.data_start = st.next_offset = d["start"]
        st.next_seq = d.get("seq", 0)
        st.generation = d.get("gen")
    elif rtype == XREC_JOIN:
        w = WriterInfo(d["w"], d["e"], d.get("pid", 0),
                       d.get("li", 5.0), d["t"] + d.get("li", 5.0))
        st.writers[w.writer_id] = w
        st.next_writer = max(st.next_writer, w.writer_id + 1)
        st.next_epoch = max(st.next_epoch, w.epoch + 1)
    elif rtype == XREC_LEASE:
        w = st.writers.get(d["w"])
        if w is not None:
            w.lease_deadline = d["t"] + w.lease_interval
    elif rtype == XREC_RESERVE:
        r = Reservation(d["r"], d["w"], d["e"], d["o"], d["s"], d["q"])
        st.reservations[r.rid] = r
        st.next_offset = max(st.next_offset, r.offset + r.size)
        st.next_seq = max(st.next_seq, r.seq + 1)
        st.next_rid = max(st.next_rid, r.rid + 1)
    elif rtype == XREC_COMMIT:
        r = st.reservations.get(d["r"])
        if r is not None:
            r.committed = True
    elif rtype == XREC_RELEASE:
        r = st.reservations.get(d["r"])
        if r is not None:
            r.released = True
    elif rtype == XREC_FENCE:
        w = st.writers.get(d["w"])
        if w is not None:
            w.fenced = True
    elif rtype == XREC_DONE:
        w = st.writers.get(d["w"])
        if w is not None:
            w.done = True
    elif rtype == XREC_SEAL:
        st.sealed = True
        st.seal_info = d


# ---------------------------------------------------------------------------
# the log itself

# fcntl record locks are per (process, inode): two fds in one process do not
# exclude each other, so in-process concurrency (heartbeat thread vs commit,
# or many writers in one test process) is serialized by a shared per-inode
# threading lock on top of the cross-process file lock.
_PROC_LOCKS: Dict[Tuple[int, int], threading.Lock] = {}
_PROC_LOCKS_GUARD = threading.Lock()


def _proc_lock(st: os.stat_result) -> threading.Lock:
    key = (st.st_dev, st.st_ino)
    with _PROC_LOCKS_GUARD:
        return _PROC_LOCKS.setdefault(key, threading.Lock())


class ExtentLog:
    """Append-only reservation log; every mutation is one locked transaction
    (lock → replay → decide → append → fsync → unlock)."""

    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        self._fsync = fsync
        self._fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o666)
        self._tlock = _proc_lock(os.fstat(self._fd))
        self._closed = False

    @classmethod
    def sidecar_path(cls, container_path: str) -> str:
        return container_path + XLOG_SUFFIX

    @classmethod
    def create(cls, container_path: str, data_start: int, *,
               fsync: bool = True, start_seq: int = 0,
               generation: Optional[str] = None) -> "ExtentLog":
        log = cls(cls.sidecar_path(container_path), fsync=fsync)

        def txn(state: LogState, append):
            if state.data_start != 0 or state.writers or state.sealed:
                # a leftover log from a previous run at the same path must
                # never be adopted: its sealed flag would fence every new
                # join, and its reservations describe a different file
                raise StaleLogError(
                    f"refusing to create over a non-empty side-car log "
                    f"({log.path}): remove the stale log first")
            append(XREC_CREATE, {"start": data_start, "seq": start_seq,
                                 "gen": generation})
        try:
            log.transact(txn)
        except StaleLogError:
            log.close()
            raise
        return log

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            os.close(self._fd)

    def unlink(self) -> None:
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass

    # -- locked transaction core ------------------------------------------

    @contextmanager
    def _locked(self):
        with self._tlock:
            fcntl.lockf(self._fd, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.lockf(self._fd, fcntl.LOCK_UN)

    def _read_all(self) -> bytes:
        size = os.fstat(self._fd).st_size
        return os.pread(self._fd, size, 0) if size else b""

    def transact(self, fn: Callable[[LogState, Callable[[int, dict], None]], object]):
        """Run ``fn(state, append)`` under the cross-process lock.  Records
        queued via ``append`` are written (and fsynced) atomically-enough at
        the end; if ``fn`` raises, nothing is appended."""
        with self._locked():
            raw = self._read_all()
            records, valid_end = scan_records(raw)
            state = LogState()
            for rtype, d in records:
                _apply_record(state, rtype, d)
            queued: List[bytes] = []

            def append(rtype: int, payload: dict) -> None:
                queued.append(_pack_record(rtype, payload))

            out = fn(state, append)
            if queued:
                if valid_end < len(raw):
                    # discard the torn tail (crash mid-append) so the new
                    # records land inside — not after — the replayable
                    # prefix; appending at len(raw) would make them
                    # permanently invisible to iter_records/replay_log
                    os.ftruncate(self._fd, valid_end)
                os.pwrite(self._fd, b"".join(queued), valid_end)
                if self._fsync:
                    os.fsync(self._fd)
            return out

    def snapshot(self) -> LogState:
        """Replay the current log under the lock (read-only)."""
        with self._locked():
            return replay_log(self._read_all())

    # -- protocol operations ----------------------------------------------

    def join(self, lease_interval: float = 5.0, *,
             expect_generation: Optional[str] = None) -> "WriterSession":
        def txn(state: LogState, append):
            if (expect_generation is not None
                    and state.generation != expect_generation):
                # the log next to the container belongs to a different
                # file instance (prior run at the same path): joining it
                # would reserve extents into the wrong file's layout
                raise StaleLogError(
                    f"side-car log generation {state.generation!r} does "
                    f"not match container generation {expect_generation!r}")
            if state.sealed:
                raise FencedError("container already sealed")
            wid, epoch = state.next_writer, state.next_epoch
            append(XREC_JOIN, {"w": wid, "e": epoch, "pid": os.getpid(),
                               "li": lease_interval, "t": time.time()})
            return wid, epoch
        wid, epoch = self.transact(txn)
        return WriterSession(self, wid, epoch, lease_interval)

    def reserve(self, writer_id: int, epoch: int, size: int) -> Reservation:
        def txn(state: LogState, append):
            state.check_writable(writer_id, epoch)
            r = Reservation(state.next_rid, writer_id, epoch,
                            state.next_offset, size, state.next_seq)
            append(XREC_RESERVE, {"r": r.rid, "w": writer_id, "e": epoch,
                                  "o": r.offset, "s": r.size, "q": r.seq})
            return r
        return self.transact(txn)

    def commit(self, writer_id: int, epoch: int, rid: int) -> None:
        def txn(state: LogState, append):
            state.check_writable(writer_id, epoch)
            r = state.reservations.get(rid)
            if r is None or r.writer_id != writer_id:
                raise FencedError(f"reservation {rid} is not writer {writer_id}'s")
            append(XREC_COMMIT, {"r": rid, "w": writer_id})
        self.transact(txn)

    def release(self, writer_id: int, epoch: int, rid: int) -> None:
        def txn(state: LogState, append):
            state.check_writable(writer_id, epoch)
            append(XREC_RELEASE, {"r": rid, "w": writer_id})
        self.transact(txn)

    def heartbeat(self, writer_id: int, epoch: int) -> None:
        def txn(state: LogState, append):
            state.check_writable(writer_id, epoch)
            # wall clock, not monotonic: deadlines cross process boundaries
            append(XREC_LEASE, {"w": writer_id, "t": time.time()})
        self.transact(txn)

    def done(self, writer_id: int, epoch: int) -> None:
        def txn(state: LogState, append):
            state.check_writable(writer_id, epoch)
            append(XREC_DONE, {"w": writer_id})
        self.transact(txn)

    def fence(self, writer_id: int, reason: str = "") -> None:
        def txn(state: LogState, append):
            w = state.writers.get(writer_id)
            if w is not None and not w.fenced:
                append(XREC_FENCE, {"w": writer_id, "reason": reason})
        self.transact(txn)

    def seal(self, info: Optional[dict] = None) -> None:
        def txn(state: LogState, append):
            if not state.sealed:
                append(XREC_SEAL, dict(info or {}))
        self.transact(txn)


@dataclass
class WriterSession:
    """One writer's identity in the shared log: ``(writer_id, epoch)`` plus
    the lease it must keep alive.  All operations raise :class:`FencedError`
    once the writer has been fenced or the log sealed."""

    log: ExtentLog
    writer_id: int
    epoch: int
    lease_interval: float = 5.0

    def reserve(self, size: int) -> Reservation:
        return self.log.reserve(self.writer_id, self.epoch, size)

    def commit(self, rid: int) -> None:
        self.log.commit(self.writer_id, self.epoch, rid)

    def release(self, rid: int) -> None:
        self.log.release(self.writer_id, self.epoch, rid)

    def heartbeat(self) -> None:
        self.log.heartbeat(self.writer_id, self.epoch)

    def done(self) -> None:
        self.log.done(self.writer_id, self.epoch)
