"""Object-store sink: the container's remote transport (DESIGN.md §10).

The paper's parallel-commit protocol (seal without synchronization,
reserve an extent, positioned write) assumes a POSIX file.  This module
maps it onto S3-style object storage instead: an :class:`ObjectStoreSink`
implements the full :class:`~repro_torch.core.container.Sink` contract on top
of an abstract :class:`Transport`, so

* cluster **extents map onto multipart part uploads** — the sink carves
  the file's offset space into fixed-size parts (part index ``k`` covers
  bytes ``[k*part_bytes, (k+1)*part_bytes)``, S3 part number ``k+1``);
  ``pwrite`` buffers into the covering parts and ships each part the
  moment its byte range is fully covered, over a bounded pool of
  parallel connections;
* coalesced reader **preads map onto ranged GETs**, optionally *hedged*:
  if the primary GET has not answered within ``hedge_ms``, a duplicate
  is raced against it and the first success wins (tail-latency cut, at
  the cost of duplicated reads — counted in ``IOStats.hedges`` /
  ``hedge_wins``).

Robustness is the headline.  Every transport operation runs under the
shared :class:`~repro_torch.core.ioengine.Retrier` chokepoint (exponential
backoff + jitter, retryable-errno filter, optional retry-budget
deadline) with an optional **per-attempt deadline** (``deadline_ms`` —
the transport raises ``ETIMEDOUT``, which is retryable).  Part uploads
are **idempotent**: each upload is keyed by ``(part index, CRC32)``, so
a retried or re-driven upload of unchanged bytes is skipped and a
changed part is simply re-uploaded under the same part number (S3
semantics: last upload of a part number wins).  When the multipart
channel degrades — create or part upload still failing after retries —
the sink **falls back to a serial ``put_object``** of the assembled
bytes at close (counted in ``IOStats.degradations``); part buffers are
retained until close precisely so this fallback (and CRC-keyed
re-upload) is always possible.  The memory cost equals the object size,
the same deal :class:`~repro_torch.core.container.MemorySink` makes.

Crash recovery: a writer killed mid-multipart leaves the upload's
completed parts in the store.  :func:`salvage_remote` lists the
interrupted upload, reassembles the contiguous part prefix, runs the
ordinary journal-scan recovery (:func:`~repro_torch.core.recover.recover_container`)
over the bytes in memory, and puts the rebuilt container back as the
final object — the remote analog of salvaging a torn local file.

Everything is hermetic: :class:`FakeTransport` simulates the store
in-process over a shared :class:`ObjectBucket`, with deterministic
fault/latency injection via :class:`~repro_torch.core.faults.FaultSchedule`
(per-op scripted rules + seeded random error rates) and the shared
:class:`~repro_torch.core.container.LatencyModel` (RTT floor + bandwidth
ceiling).  ``open_sink("mem-s3://bucket/file.rntj?rtt_ms=100")`` routes
here; real backends register via :func:`register_transport`.
"""

from __future__ import annotations

import errno
import threading
import time
import zlib
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from concurrent.futures import wait as futures_wait
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qsl

from .container import LatencyModel, Sink
from .faults import FaultSchedule, ProcessKilled, injected_os_error
from .ioengine import Retrier, RetryPolicy


# ---------------------------------------------------------------------------
# Transport interface
# ---------------------------------------------------------------------------


class Transport:
    """S3-style object-store operations, the minimal surface the sink needs.

    Every method takes an optional ``timeout`` (seconds, per attempt):
    implementations should raise ``OSError(ETIMEDOUT)`` when the attempt
    cannot complete in time — retryable, so the :class:`Retrier` drives
    the attempt loop, not the transport.  Errors must be ``OSError``
    with a meaningful errno (``ENOENT`` for missing keys, ``EIO`` for
    backend failures): that is the vocabulary the shared retry policy
    filters on.
    """

    # -- whole objects ------------------------------------------------------

    def put_object(self, key: str, data: bytes,
                   timeout: Optional[float] = None) -> str:
        """Atomically store ``data`` under ``key``; returns an ETag."""
        raise NotImplementedError

    def object_size(self, key: str, timeout: Optional[float] = None) -> int:
        """Size of the object at ``key``; ``OSError(ENOENT)`` if absent."""
        raise NotImplementedError

    def get_range(self, key: str, offset: int, size: int,
                  timeout: Optional[float] = None) -> bytes:
        """Ranged GET: up to ``size`` bytes at ``offset``.  May return a
        *short* (torn) response under failure — callers must length-check
        and retry."""
        raise NotImplementedError

    # -- multipart uploads --------------------------------------------------

    def create_multipart(self, key: str,
                         timeout: Optional[float] = None) -> str:
        """Start a multipart upload; returns the upload id."""
        raise NotImplementedError

    def upload_part(self, key: str, upload_id: str, part_number: int,
                    data: bytes, timeout: Optional[float] = None) -> str:
        """Upload one part (1-based ``part_number``); returns its ETag.
        Re-uploading a part number replaces it (last writer wins)."""
        raise NotImplementedError

    def complete_multipart(self, key: str, upload_id: str,
                           parts: List[Tuple[int, str]],
                           timeout: Optional[float] = None) -> str:
        """Assemble ``parts`` (``(part_number, etag)``, ascending) into the
        final object; returns the object ETag and retires the upload."""
        raise NotImplementedError

    def abort_multipart(self, key: str, upload_id: str,
                        timeout: Optional[float] = None) -> None:
        """Drop an upload and its parts.  Idempotent."""
        raise NotImplementedError

    # -- recovery surface ---------------------------------------------------

    def list_uploads(self, key: str,
                     timeout: Optional[float] = None) -> List[str]:
        """Upload ids still open against ``key``, oldest first."""
        raise NotImplementedError

    def list_parts(self, key: str, upload_id: str,
                   timeout: Optional[float] = None) -> Dict[int, Tuple[int, str]]:
        """``{part_number: (size, etag)}`` for an open upload."""
        raise NotImplementedError

    def read_part(self, key: str, upload_id: str, part_number: int,
                  timeout: Optional[float] = None) -> bytes:
        """Fetch one uploaded part's bytes (salvage path)."""
        raise NotImplementedError

    def close(self) -> None:
        pass


def _etag(data: bytes) -> str:
    return format(zlib.crc32(data) & 0xFFFFFFFF, "08x")


# ---------------------------------------------------------------------------
# In-memory store + fault-injecting fake transport
# ---------------------------------------------------------------------------


class ObjectBucket:
    """The shared store behind :class:`FakeTransport` instances — the
    in-memory analog of the S3 bucket.  Several transports (several
    simulated processes: a writer that gets killed, then a recovery
    process) can point at the same bucket; a transport dying does not
    lose the bucket's state, which is exactly what makes interrupted
    multipart uploads salvageable."""

    def __init__(self, name: str = "") -> None:
        self.name = name
        self.lock = threading.Lock()
        self.objects: Dict[str, bytes] = {}
        # key -> upload_id -> {part_number: bytes}
        self.uploads: Dict[str, Dict[str, Dict[int, bytes]]] = {}
        self._next_upload = 0

    def new_upload_id(self, key: str) -> str:
        with self.lock:
            self._next_upload += 1
            uid = f"upload-{self._next_upload:04d}"
            self.uploads.setdefault(key, {})[uid] = {}
            return uid


_MEM_BUCKETS: Dict[str, ObjectBucket] = {}
_MEM_BUCKETS_LOCK = threading.Lock()


def mem_bucket(name: str) -> ObjectBucket:
    """The process-wide registry behind ``mem-s3://`` URLs: same bucket
    name → same :class:`ObjectBucket`, so a writer and a later reader (or
    recoverer) opened by URL share state like they would share a real
    bucket."""
    with _MEM_BUCKETS_LOCK:
        b = _MEM_BUCKETS.get(name)
        if b is None:
            b = _MEM_BUCKETS[name] = ObjectBucket(name)
        return b


def reset_mem_buckets() -> None:
    """Drop all registered in-memory buckets (test isolation)."""
    with _MEM_BUCKETS_LOCK:
        _MEM_BUCKETS.clear()


class FakeTransport(Transport):
    """Deterministic in-process object store over an :class:`ObjectBucket`.

    Latency: every operation pays an ``rtt_s`` floor (concurrent
    operations overlap their RTTs — that is the point of parallel
    connections) plus a bandwidth charge through the shared
    :class:`LatencyModel` window (concurrent transfers queue — a link is
    a link).  If the operation's service time exceeds the caller's
    per-attempt ``timeout``, the transport sleeps the timeout and raises
    ``ETIMEDOUT`` — retryable.

    Faults: an optional :class:`FaultSchedule` keyed by transport op
    names — ``"put"``, ``"get"``, ``"size"``, ``"create"``, ``"part"``,
    ``"complete"``, ``"abort"``, ``"list"`` — with the same rule
    vocabulary the local :class:`~repro_torch.core.faults.FaultInjectingSink`
    uses.  ``kind="error"`` raises; ``kind="short"`` on ``"get"``
    returns a torn prefix (the sink length-checks and retries), on
    ``"part"`` stores a torn prefix *and* raises (a retry re-uploads the
    full part over it — idempotent re-upload is what makes this safe),
    on ``"put"`` fails atomically (nothing stored); ``kind="latency"``
    adds ``delay_s`` to the service time (feeding both deadline
    enforcement and hedging); ``kind="kill"`` marks the transport dead —
    every subsequent call raises :class:`ProcessKilled`, modeling the
    writing process dying with its connections.  A *fresh* transport
    over the same bucket is the recovery process's view.

    Unlike real S3 there is no minimum part size and part numbers are
    unbounded; nothing here depends on those limits.
    """

    def __init__(
        self,
        bucket: ObjectBucket,
        schedule: Optional[FaultSchedule] = None,
        rtt_s: float = 0.0,
        bw: float = 0.0,
        latency: Optional[LatencyModel] = None,
    ) -> None:
        self.bucket = bucket
        self.schedule = schedule
        self.rtt_s = rtt_s
        self.latency = latency if latency is not None else LatencyModel(bw)

    # -- fault/latency gate -------------------------------------------------

    def _serve(self, op: str, nbytes: int, offset: int = 0,
               timeout: Optional[float] = None):
        """Run the op through kill/fault/latency/deadline handling.
        Returns the matched torn-response rule (kind ``"short"``) for the
        caller to apply, or ``None``."""
        sched = self.schedule
        extra = 0.0
        rule = None
        if sched is not None:
            sched.check_dead()
            rule, _ = sched.decide(op, offset, nbytes)
            if rule is not None:
                if rule.kind == "latency":
                    sched.stats.latencies += 1
                    extra = rule.delay_s
                    rule = None
                elif rule.kind == "kill":
                    sched.note_kill(sched.persisted_bytes)
                    raise ProcessKilled(
                        f"process killed during remote {op!r}")
        done = self.latency.charge(nbytes, floor_s=self.rtt_s) + extra
        now = time.perf_counter()
        if timeout is not None and timeout > 0 and done - now > timeout:
            # the attempt would blow its deadline: burn the timeout (the
            # caller genuinely waited that long) and fail retryably
            time.sleep(timeout)
            if sched is not None:
                sched.stats.errors += 1
            raise injected_os_error(errno.ETIMEDOUT)
        self.latency.settle(done)
        if rule is not None:
            if rule.kind == "short":
                return rule
            if sched is not None:
                sched.stats.errors += 1
            raise injected_os_error(rule.err)
        return None

    # -- whole objects ------------------------------------------------------

    def put_object(self, key: str, data: bytes,
                   timeout: Optional[float] = None) -> str:
        rule = self._serve("put", len(data), timeout=timeout)
        if rule is not None:
            # a torn PUT is atomic at the store: nothing lands
            self.schedule.stats.short_writes += 1
            raise injected_os_error(rule.err)
        blob = bytes(data)
        with self.bucket.lock:
            self.bucket.objects[key] = blob
        if self.schedule is not None:
            self.schedule.advance(len(blob))
        return _etag(blob)

    def object_size(self, key: str, timeout: Optional[float] = None) -> int:
        self._serve("size", 0, timeout=timeout)
        with self.bucket.lock:
            if key not in self.bucket.objects:
                raise injected_os_error(errno.ENOENT)
            return len(self.bucket.objects[key])

    def get_range(self, key: str, offset: int, size: int,
                  timeout: Optional[float] = None) -> bytes:
        rule = self._serve("get", size, offset=offset, timeout=timeout)
        with self.bucket.lock:
            obj = self.bucket.objects.get(key)
            if obj is None:
                raise injected_os_error(errno.ENOENT)
            data = obj[offset:offset + size]
        if rule is not None:
            self.schedule.stats.short_reads += 1
            return data[: int(len(data) * rule.fraction)]
        return data

    # -- multipart ----------------------------------------------------------

    def create_multipart(self, key: str,
                         timeout: Optional[float] = None) -> str:
        self._serve("create", 0, timeout=timeout)
        return self.bucket.new_upload_id(key)

    def upload_part(self, key: str, upload_id: str, part_number: int,
                    data: bytes, timeout: Optional[float] = None) -> str:
        rule = self._serve("part", len(data), timeout=timeout)
        blob = bytes(data)
        with self.bucket.lock:
            parts = self.bucket.uploads.get(key, {}).get(upload_id)
            if parts is None:
                raise injected_os_error(errno.ENOENT)
            if rule is not None:
                # torn part upload: a prefix lands in the store, the call
                # fails — the retry re-uploads the full part over it
                parts[part_number] = blob[: int(len(blob) * rule.fraction)]
            else:
                parts[part_number] = blob
        if rule is not None:
            self.schedule.stats.short_writes += 1
            raise injected_os_error(rule.err)
        if self.schedule is not None:
            self.schedule.advance(len(blob))
        return _etag(blob)

    def complete_multipart(self, key: str, upload_id: str,
                           parts: List[Tuple[int, str]],
                           timeout: Optional[float] = None) -> str:
        self._serve("complete", 0, timeout=timeout)
        with self.bucket.lock:
            stored = self.bucket.uploads.get(key, {}).get(upload_id)
            if stored is None:
                raise injected_os_error(errno.ENOENT)
            chunks = []
            for num, etag in sorted(parts):
                blob = stored.get(num)
                if blob is None or _etag(blob) != etag:
                    raise injected_os_error(errno.EINVAL)
                chunks.append(blob)
            blob = b"".join(chunks)
            self.bucket.objects[key] = blob
            del self.bucket.uploads[key][upload_id]
        return _etag(blob)

    def abort_multipart(self, key: str, upload_id: str,
                        timeout: Optional[float] = None) -> None:
        self._serve("abort", 0, timeout=timeout)
        with self.bucket.lock:
            self.bucket.uploads.get(key, {}).pop(upload_id, None)

    # -- recovery surface ---------------------------------------------------

    def list_uploads(self, key: str,
                     timeout: Optional[float] = None) -> List[str]:
        self._serve("list", 0, timeout=timeout)
        with self.bucket.lock:
            return sorted(self.bucket.uploads.get(key, {}).keys())

    def list_parts(self, key: str, upload_id: str,
                   timeout: Optional[float] = None) -> Dict[int, Tuple[int, str]]:
        self._serve("list", 0, timeout=timeout)
        with self.bucket.lock:
            parts = self.bucket.uploads.get(key, {}).get(upload_id)
            if parts is None:
                raise injected_os_error(errno.ENOENT)
            return {n: (len(b), _etag(b)) for n, b in parts.items()}

    def read_part(self, key: str, upload_id: str, part_number: int,
                  timeout: Optional[float] = None) -> bytes:
        with self.bucket.lock:
            parts = self.bucket.uploads.get(key, {}).get(upload_id)
            blob = None if parts is None else parts.get(part_number)
        if blob is None:
            raise injected_os_error(errno.ENOENT)
        self._serve("get", len(blob), timeout=timeout)
        return blob


# ---------------------------------------------------------------------------
# Options
# ---------------------------------------------------------------------------


# per-logical-op retry budget generous enough for high-RTT transports;
# max_attempts stays the backstop against permanent failures
DEFAULT_REMOTE_RETRY = RetryPolicy(max_attempts=6, backoff_base=0.005,
                                   backoff_cap=0.5)


@dataclass(frozen=True)
class RemoteOptions:
    """Knobs for :class:`ObjectStoreSink` (DESIGN.md §7, ``remote_*``).

    part_bytes            -- fixed multipart part size; the unit extents
                             map onto (8 MiB default)
    parallel_connections  -- bounded transport connection pool; part
                             uploads and hedged GETs share it
    deadline_ms           -- per-attempt transport deadline; 0 = off.
                             A blown deadline is ``ETIMEDOUT`` (retryable)
    hedge_ms              -- hedge a ranged GET after this long with no
                             answer; 0 = off
    retry_policy          -- :class:`RetryPolicy` for every transport op;
                             None = no retries
    multipart             -- start in multipart mode (degrades to a
                             serial put automatically); False = serial
                             put at close, no parts
    """

    part_bytes: int = 8 << 20
    parallel_connections: int = 4
    deadline_ms: float = 0.0
    hedge_ms: float = 0.0
    retry_policy: Optional[RetryPolicy] = field(default=DEFAULT_REMOTE_RETRY)
    multipart: bool = True

    @property
    def timeout_s(self) -> Optional[float]:
        return self.deadline_ms / 1000.0 if self.deadline_ms > 0 else None


# ---------------------------------------------------------------------------
# The sink
# ---------------------------------------------------------------------------


def _add_interval(ivals: List[Tuple[int, int]], lo: int, hi: int) -> None:
    """Merge ``[lo, hi)`` into a sorted disjoint interval list, in place."""
    out: List[Tuple[int, int]] = []
    placed = False
    for s, e in ivals:
        if e < lo or s > hi:
            if not placed and s > hi:
                out.append((lo, hi))
                placed = True
            out.append((s, e))
        else:
            lo, hi = min(lo, s), max(hi, e)
    if not placed:
        out.append((lo, hi))
    out.sort()
    ivals[:] = out


class ObjectStoreSink(Sink):
    """A :class:`Sink` over a :class:`Transport` (module docstring has the
    full story).  Write mode (``create=True``): pwrites buffer into
    fixed-size parts, completed parts upload over the connection pool,
    ``close`` ships the tail and completes the multipart (or degrades to
    one serial put).  Read mode: preads become retried, optionally
    hedged, ranged GETs.

    Part uploads happen *synchronously inside* ``pwrite`` (the caller's
    thread blocks on its part's turn through the pool), so under the
    write-behind engine the admission budget naturally bounds remote
    inflight the same way it bounds local inflight, and upload failures
    surface on the committing thread where the engine's retry/poison
    machinery already looks for them.
    """

    def __init__(self, transport: Transport, key: str,
                 options: Optional[RemoteOptions] = None,
                 create: bool = True) -> None:
        super().__init__()
        self.transport = transport
        self.key = key
        self.options = options or RemoteOptions()
        self.writable = create
        self._timeout = self.options.timeout_s
        self._retrier = Retrier(self.options.retry_policy,
                                on_retry=self._count_retry,
                                on_giveup=self._count_giveup)
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, self.options.parallel_connections),
            thread_name_prefix="remote")
        self._mu = threading.Lock()
        self._closed = False
        if create:
            self._parts: Dict[int, bytearray] = {}
            self._covered: Dict[int, List[Tuple[int, int]]] = {}
            self._uploaded: Dict[int, Tuple[str, int]] = {}  # idx -> (etag, crc)
            self._sent: set = set()      # idx currently fully shipped
            self._hw = 0                 # high-water mark of written bytes
            self._degraded = False
            self._upload_id: Optional[str] = None
            if self.options.multipart:
                try:
                    self._upload_id = self._retrier.call(
                        self.transport.create_multipart, self.key,
                        self._timeout)
                except ProcessKilled:
                    raise
                except OSError:
                    self._note_degraded()
        else:
            self._object_size = self._retrier.call(
                self.transport.object_size, self.key, self._timeout)
            self._end = self._object_size

    # -- write path ---------------------------------------------------------

    def _note_degraded(self) -> None:
        with self._mu:
            if self._degraded:
                return
            self._degraded = True
        self._count_degradation()

    def _part_buf(self, idx: int) -> bytearray:
        buf = self._parts.get(idx)
        if buf is None:
            buf = self._parts[idx] = bytearray(self.options.part_bytes)
            self._covered[idx] = []
        return buf

    def pwrite(self, offset: int, data) -> None:
        if not self.writable:
            raise injected_os_error(errno.EBADF)
        mv = memoryview(data)
        n = len(mv)
        if n == 0:
            return
        pb = self.options.part_bytes
        ready: List[int] = []
        with self._mu:
            pos = 0
            while pos < n:
                at = offset + pos
                idx, off_in = divmod(at, pb)
                take = min(n - pos, pb - off_in)
                buf = self._part_buf(idx)
                buf[off_in:off_in + take] = mv[pos:pos + take]
                _add_interval(self._covered[idx], off_in, off_in + take)
                if (self._covered[idx] == [(0, pb)]
                        and idx not in self._sent):
                    self._sent.add(idx)
                    ready.append(idx)
                pos += take
            self._hw = max(self._hw, offset + n)
        self._count_write(1, n)
        self._ship_parts(ready, pb)

    def _ship_parts(self, idxs: List[int], length: int) -> None:
        """Upload the given parts through the connection pool, blocking
        the calling thread until all land (admission budget = inflight
        bound).  The whole batch is submitted before any result is
        awaited, so one pwrite spanning several parts pays one round
        trip, not one per part.  A failure after retries degrades the
        sink instead of raising: the bytes are still in the buffer and
        the close-time serial put will carry them."""
        if not idxs or self._degraded or self._upload_id is None:
            return
        futs = [(idx, self._pool.submit(self._upload_part_idx, idx, length))
                for idx in idxs]
        killed = None
        for idx, fut in futs:
            try:
                fut.result()
            except ProcessKilled as e:
                killed = e
            except OSError:
                with self._mu:
                    self._sent.discard(idx)
                self._note_degraded()
        if killed is not None:
            raise killed

    def _upload_part_idx(self, idx: int, length: int) -> None:
        with self._mu:
            payload = bytes(self._parts[idx][:length])
        crc = zlib.crc32(payload)
        prev = self._uploaded.get(idx)
        if prev is not None and prev[1] == crc:
            return  # idempotent re-upload: same bytes already stored
        etag = self._retrier.call(
            self.transport.upload_part, self.key, self._upload_id,
            idx + 1, payload, self._timeout)
        self._uploaded[idx] = (etag, crc)

    def _read_local(self, offset: int, size: int) -> bytes:
        """Write-mode reads come from the retained part buffers (holes
        read as zeros, like a sparse file)."""
        pb = self.options.part_bytes
        out = bytearray(size)
        with self._mu:
            pos = 0
            while pos < size:
                at = offset + pos
                idx, off_in = divmod(at, pb)
                take = min(size - pos, pb - off_in)
                buf = self._parts.get(idx)
                if buf is not None:
                    out[pos:pos + take] = buf[off_in:off_in + take]
                pos += take
        return bytes(out)

    def flush(self) -> None:
        """Ship every fully-covered part that has not gone out yet (the
        write-behind engine calls this at barriers)."""
        if not self.writable or self._degraded or self._upload_id is None:
            return
        pb = self.options.part_bytes
        with self._mu:
            ready = [i for i, iv in self._covered.items()
                     if iv == [(0, pb)] and i not in self._sent]
            self._sent.update(ready)
        self._ship_parts(ready, pb)

    def fsync(self) -> None:
        if self.writable:
            self.flush()
        super().fsync()

    # -- read path ----------------------------------------------------------

    def pread(self, offset: int, size: int) -> bytes:
        if self.writable:
            data = self._read_local(offset, size)
            self._count_read(1, len(data))
            return data
        data = self._retrier.call(self._hedged_get, offset, size)
        self._count_read(1, len(data))
        return data

    def _get_once(self, offset: int, size: int) -> bytes:
        data = self.transport.get_range(self.key, offset, size,
                                        timeout=self._timeout)
        want = max(0, min(offset + size, self._object_size) - offset)
        if len(data) < want:
            # torn ranged response — retryable, a fresh GET may be whole
            raise injected_os_error(errno.EIO)
        return data

    def _hedged_get(self, offset: int, size: int) -> bytes:
        hedge_s = self.options.hedge_ms / 1000.0
        if hedge_s <= 0:
            return self._get_once(offset, size)
        primary = self._pool.submit(self._get_once, offset, size)
        try:
            return primary.result(timeout=hedge_s)
        except FutureTimeout:
            pass  # slow tail: race a duplicate against it
        self._count_hedge()
        secondary = self._pool.submit(self._get_once, offset, size)
        pending = {primary, secondary}
        last_exc: Optional[BaseException] = None
        while pending:
            done, pending = futures_wait(pending,
                                         return_when=FIRST_COMPLETED)
            for fut in done:
                exc = fut.exception()
                if exc is None:
                    if fut is secondary:
                        self._count_hedge_win()
                    return fut.result()
                last_exc = exc
        assert last_exc is not None
        raise last_exc

    # -- teardown -----------------------------------------------------------

    @property
    def size(self) -> int:
        if self.writable:
            return max(self._end, self._hw)
        return self._end

    def readable(self) -> bool:
        return True

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            if self.writable:
                self._finalize()
        except ProcessKilled:
            # the simulated process died: leave the interrupted upload in
            # the store for salvage_remote, release local resources
            pass
        finally:
            self._pool.shutdown(wait=True)
            self.transport.close()

    def _finalize(self) -> None:
        total = self.size
        pb = self.options.part_bytes
        nparts = (total + pb - 1) // pb
        if not self._degraded and self._upload_id is not None and nparts > 0:
            try:
                futs = []
                for idx in range(nparts):
                    with self._mu:
                        self._part_buf(idx)  # holes materialize as zeros
                    length = min(pb, total - idx * pb)
                    # CRC keying inside makes this idempotent: untouched
                    # already-shipped parts are skipped, dirtied ones
                    # (journal rewrites, footer over a reserved tail)
                    # re-upload under the same part number — all through
                    # the connection pool so close pays one RTT per
                    # connection, not one per part
                    futs.append(self._pool.submit(
                        self._upload_part_idx, idx, length))
                for fut in futs:
                    fut.result()
                manifest = [(i + 1, self._uploaded[i][0])
                            for i in range(nparts)]
                self._retrier.call(
                    self.transport.complete_multipart, self.key,
                    self._upload_id, manifest, self._timeout)
                return
            except ProcessKilled:
                raise
            except OSError:
                self._note_degraded()
        # serial-put fallback (or multipart was off / empty object)
        blob = self._read_local(0, total)
        self._retrier.call(self.transport.put_object, self.key, blob,
                           self._timeout)
        if self._upload_id is not None:
            try:
                self.transport.abort_multipart(self.key, self._upload_id)
            except (OSError, ProcessKilled):
                pass  # best-effort housekeeping; the object is durable


# ---------------------------------------------------------------------------
# URL routing
# ---------------------------------------------------------------------------

# scheme -> factory(bucket_name, params_dict) -> Transport
_TRANSPORTS: Dict[str, "callable"] = {}
_TRANSPORTS_LOCK = threading.Lock()


def register_transport(scheme: str, factory) -> None:
    """Register ``factory(bucket, params) -> Transport`` for a URL scheme,
    making ``open_sink("<scheme>://bucket/key")`` work.  This is the
    seam where a real S3/GCS client plugs in without this module growing
    a dependency on it."""
    with _TRANSPORTS_LOCK:
        _TRANSPORTS[scheme] = factory


def _mem_s3_factory(bucket: str, params: Dict[str, str]) -> Transport:
    sched = None
    if "error_rate" in params or "seed" in params:
        sched = FaultSchedule(
            seed=int(params.get("seed", "0")),
            error_rate=float(params.get("error_rate", "0")),
            errnos=(errno.EIO, errno.ETIMEDOUT),
            random_ops=("put", "part", "get"),
        )
    return FakeTransport(
        mem_bucket(bucket),
        schedule=sched,
        rtt_s=float(params.get("rtt_ms", "0")) / 1000.0,
        bw=float(params.get("bw_mbps", "0")) * 1e6,
    )


register_transport("mem-s3", _mem_s3_factory)

_OPTION_PARAMS = {
    "part_bytes": ("part_bytes", int),
    "remote_part_bytes": ("part_bytes", int),
    "parallel_connections": ("parallel_connections", int),
    "remote_parallel_connections": ("parallel_connections", int),
    "deadline_ms": ("deadline_ms", float),
    "remote_deadline_ms": ("deadline_ms", float),
    "hedge_ms": ("hedge_ms", float),
    "remote_hedge_ms": ("hedge_ms", float),
    "multipart": ("multipart", lambda v: v not in ("0", "false", "no")),
}


def parse_remote_url(url: str):
    """``scheme://bucket/key?knob=value`` → (scheme, bucket, key,
    options, params).  Option knobs (with or without the ``remote_``
    prefix DESIGN.md §7 uses) land in :class:`RemoteOptions`; everything
    else is passed to the transport factory (``rtt_ms``, ``bw_mbps``,
    ``error_rate``, ``seed`` for ``mem-s3``)."""
    if "://" not in url:
        raise ValueError(f"not a remote URL: {url!r}")
    scheme, rest = url.split("://", 1)
    query = ""
    if "?" in rest:
        rest, query = rest.split("?", 1)
    if "/" not in rest:
        raise ValueError(f"remote URL needs bucket/key: {url!r}")
    bucket, key = rest.split("/", 1)
    if not bucket or not key:
        raise ValueError(f"remote URL needs bucket/key: {url!r}")
    opts = RemoteOptions()
    params: Dict[str, str] = {}
    for k, v in parse_qsl(query, keep_blank_values=True):
        if k in _OPTION_PARAMS:
            name, conv = _OPTION_PARAMS[k]
            opts = replace(opts, **{name: conv(v)})
        else:
            params[k] = v
    return scheme, bucket, key, opts, params


def resolve_transport(url: str):
    """(transport, key, options) for a remote URL, via the scheme
    registry."""
    scheme, bucket, key, opts, params = parse_remote_url(url)
    with _TRANSPORTS_LOCK:
        factory = _TRANSPORTS.get(scheme)
    if factory is None:
        raise ValueError(
            f"no transport registered for scheme {scheme!r} "
            f"(register one with repro_torch.core.remote.register_transport)")
    return factory(bucket, params), key, opts


def open_remote_sink(url: str, create: bool = True) -> ObjectStoreSink:
    """The ``open_sink`` backend for ``scheme://`` paths."""
    transport, key, opts = resolve_transport(url)
    return ObjectStoreSink(transport, key, options=opts, create=create)


# ---------------------------------------------------------------------------
# Recovery
# ---------------------------------------------------------------------------


def salvage_remote(transport: Transport, key: str, dry_run: bool = False,
                   verify_pages: bool = True, force: bool = False):
    """Salvage a remote container: the object-store analog of running
    :func:`~repro_torch.core.recover.recover_container` on a torn local file.

    Two cases:

    * the final object exists (the writer completed or degraded-put, but
      may have died before sealing) — download it, journal-scan + rebuild
      in memory, put the repaired container back;
    * only an interrupted multipart upload exists — list its parts, take
      the contiguous prefix from part 1 (uniform part size inferred from
      part 1; stop at the first gap or short part, which marks the torn
      frontier), reassemble, journal-scan + rebuild, put the result as
      the final object and abort the dangling upload.

    Returns the :class:`~repro_torch.core.recover.RecoveryReport`, with
    ``report.remote`` describing which case ran and what was salvaged.
    ``dry_run`` scans without writing anything back.
    """
    from .faults import memory_sink_from_bytes
    from .recover import RecoveryError, recover_container

    retrier = Retrier(DEFAULT_REMOTE_RETRY)
    remote_info: Dict[str, object] = {"key": key}
    upload_id = None
    try:
        size = retrier.call(transport.object_size, key)
        data = retrier.call(transport.get_range, key, 0, size)
        if len(data) != size:
            raise injected_os_error(errno.EIO)
        remote_info["mode"] = "object"
        remote_info["bytes"] = size
    except OSError as e:
        if e.errno != errno.ENOENT:
            raise
        uploads = retrier.call(transport.list_uploads, key)
        if not uploads:
            raise RecoveryError(
                f"nothing to salvage at {key!r}: no object, no uploads")
        upload_id = uploads[-1]  # latest attempt wins
        listed = retrier.call(transport.list_parts, key, upload_id)
        if 1 not in listed:
            raise RecoveryError(
                f"upload {upload_id!r} has no part 1; nothing contiguous")
        part_size = listed[1][0]
        chunks: List[bytes] = []
        num = 1
        while num in listed:
            blob = retrier.call(transport.read_part, key, upload_id, num)
            chunks.append(blob)
            if len(blob) < part_size:
                break  # short part = torn frontier; keep its prefix, stop
            num += 1
        data = b"".join(chunks)
        remote_info["mode"] = "multipart"
        remote_info["upload_id"] = upload_id
        remote_info["parts_salvaged"] = len(chunks)
        remote_info["bytes"] = len(data)

    ms = memory_sink_from_bytes(data, slack=1 << 16)
    report = recover_container(ms, dry_run=dry_run,
                               verify_pages=verify_pages, force=force)
    report.remote = remote_info
    if not dry_run and (report.rebuilt or remote_info["mode"] == "multipart"):
        blob = bytes(ms.buf[: ms.size])
        retrier.call(transport.put_object, key, blob)
        remote_info["rebuilt_bytes"] = len(blob)
    if upload_id is not None and not dry_run:
        try:
            transport.abort_multipart(key, upload_id)
        except OSError:
            pass
    return report


def salvage_remote_url(url: str, dry_run: bool = False,
                       verify_pages: bool = True, force: bool = False):
    """URL front door for :func:`salvage_remote` — what
    ``recover_container("mem-s3://bucket/key")`` routes to."""
    transport, key, _opts = resolve_transport(url)
    try:
        return salvage_remote(transport, key, dry_run=dry_run,
                              verify_pages=verify_pages, force=force)
    finally:
        transport.close()
