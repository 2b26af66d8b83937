"""Container sinks: where reserved extents of the file live.

The container format provides exactly the operation the paper needs
(§4.2): *reserve a byte extent of known size* (requires synchronization —
done by the writer's critical section) and *write bytes at an offset*
(no synchronization needed; ``pwrite`` is positioned and thread-safe).

Sinks:
  * :class:`FileSink`      — a real file, ``os.pwrite`` + optional fallocate.
  * :class:`AsyncFileSink` — a FileSink advertising native ring submission
    (io_uring via the thin liburing binding, DESIGN.md §6.7).
  * :class:`DevNullSink`   — infinitely fast storage (paper Fig. 2).
  * :class:`ThrottledSink` — bandwidth-limited wrapper to emulate the SSD /
    HDD of Figs. 3–4 on this container (token-bucket on write completion).
  * :class:`MemorySink`    — in-memory file for the TBufferMerger analog.

Every sink additionally speaks **scatter-gather**: ``pwritev(offset,
parts)`` writes a list of buffers contiguously at an offset.  The
:class:`FileSink` maps it onto ``os.pwritev`` (deep vectored submission,
one syscall per ``IOV_MAX`` buffers); the in-memory sinks copy part by
part but account the whole call as ONE ``writev`` — which is what lets
the I/O engine's zero-copy commit skip cluster assembly entirely (see
DESIGN.md §6).
"""

from __future__ import annotations

import errno
import os
import sys
import threading
import time
from typing import Optional

from .stats import IOStats

try:  # the vectored-write batch limit (Linux: usually 1024)
    IOV_MAX = os.sysconf("SC_IOV_MAX")
except (AttributeError, ValueError, OSError):  # pragma: no cover
    IOV_MAX = 1024
if IOV_MAX <= 0:  # pragma: no cover - sysconf may return -1 for "no limit"
    IOV_MAX = 1024


def close_all(closeables) -> None:
    """Close everything; surface the first close error only when not
    already unwinding another exception (never mask the original).

    The ``exc_info`` check runs OUTSIDE any except block — callers use
    this from ``finally``, where it sees the in-flight exception, if any.
    """
    first = None
    for item in closeables:
        try:
            item.close()
        except BaseException as e:
            if first is None:
                first = e
    if first is not None and sys.exc_info()[0] is None:
        raise first


class Sink:
    """Abstract positioned-write sink with an end-of-file cursor."""

    def __init__(self) -> None:
        self.io = IOStats()
        # pwrite/pread run concurrently (parallel producers; the reader's
        # prefetch + decode pools), so the counters need their own lock
        self._stat_lock = threading.Lock()
        self._end = 0

    # The end-of-file cursor.  NOT thread safe: the caller must hold the
    # writer's critical-section lock while reserving (paper §4.2).
    def reserve(self, size: int) -> int:
        off = self._end
        self._end += size
        return off

    @property
    def size(self) -> int:
        return self._end

    def pwrite(self, offset: int, data: bytes) -> None:
        raise NotImplementedError

    def pwritev(self, offset: int, parts) -> None:
        """Write ``parts`` (a sequence of bytes-like buffers) contiguously
        at ``offset`` — the scatter-gather commit primitive.

        The base implementation is the loop fallback: one ``pwrite`` per
        part at its computed offset, so any custom :class:`Sink` subclass
        (including fault-injection test sinks) works unchanged.  Concrete
        sinks override it with a genuinely vectored path and account the
        call under ``IOStats.writev_calls``.
        """
        pos = offset
        for p in parts:
            n = len(p)
            if n:
                self.pwrite(pos, p)
            pos += n

    def pread(self, offset: int, size: int) -> bytes:
        raise NotImplementedError

    def pread_into(self, offset: int, buf) -> int:
        """Read ``len(buf)`` bytes at ``offset`` into a caller-provided
        writable buffer; returns the byte count.

        The allocation-free read primitive the buffer pool wants: the
        merge fast path and the read engine pass pooled buffers here
        instead of taking a fresh ``bytes`` from :meth:`pread` per call.
        The base implementation copies through :meth:`pread` so every
        sink (including test subclasses) works unchanged; ``FileSink``
        overrides it with ``os.preadv``.  A short read raises — the
        caller's buffer may be recycled pool storage, and silently
        leaving a stale tail would corrupt whatever the bytes feed.
        """
        mv = memoryview(buf)
        data = self.pread(offset, len(mv))
        if len(data) != len(mv):
            raise EOFError(
                f"short read at {offset}: {len(data)} of {len(mv)} bytes"
            )
        mv[:] = data
        return len(data)

    def _count_write(self, calls: int, nbytes: int) -> None:
        with self._stat_lock:
            self.io.write_calls += calls
            self.io.bytes_written += nbytes

    def _count_writev(self, calls: int, nbytes: int) -> None:
        with self._stat_lock:
            self.io.writev_calls += calls
            self.io.bytes_written += nbytes

    def _count_read(self, calls: int, nbytes: int) -> None:
        with self._stat_lock:
            self.io.read_calls += calls
            self.io.bytes_read += nbytes

    # retry accounting (incremented by the I/O engine's retry loop, so
    # the counters travel with the sink's IOStats into Writer/ReaderStats)
    def _count_retry(self) -> None:
        with self._stat_lock:
            self.io.retries += 1

    def _count_giveup(self) -> None:
        with self._stat_lock:
            self.io.giveups += 1

    def _count_fsync_failure(self) -> None:
        with self._stat_lock:
            self.io.fsync_failures += 1

    # remote-transport accounting (DESIGN.md §10): hedged ranged reads and
    # multipart→serial-put degradations, counted by ObjectStoreSink
    def _count_hedge(self) -> None:
        with self._stat_lock:
            self.io.hedges += 1

    def _count_hedge_win(self) -> None:
        with self._stat_lock:
            self.io.hedge_wins += 1

    def _count_degradation(self) -> None:
        with self._stat_lock:
            self.io.degradations += 1

    def fallocate(self, offset: int, size: int) -> None:  # opt-1 hook
        with self._stat_lock:
            self.io.fallocate_calls += 1

    def fsync(self) -> None:
        with self._stat_lock:
            self.io.fsync_calls += 1

    def flush(self) -> None:
        """Push any sink-internal buffering toward durable storage without
        the durability barrier of :meth:`fsync`.  Local sinks have no such
        buffering — the base implementation is a no-op; the remote
        :class:`~repro_torch.core.remote.ObjectStoreSink` uploads every
        completed-but-unsent part."""

    def close(self) -> None:
        pass

    def readable(self) -> bool:
        return False


class FileSink(Sink):
    def __init__(self, path: str, create: bool = True):
        super().__init__()
        self.path = path
        flags = os.O_RDWR | (os.O_CREAT | os.O_TRUNC if create else 0)
        self.fd = os.open(path, flags, 0o644)
        if not create:
            self._end = os.fstat(self.fd).st_size

    def pwrite(self, offset: int, data: bytes) -> None:
        view = memoryview(data)
        pos = 0
        calls = 0
        while pos < len(view):
            n = os.pwrite(self.fd, view[pos:], offset + pos)
            pos += n
            calls += 1
        self._count_write(calls, len(view))

    def pwritev(self, offset: int, parts) -> None:
        """Vectored positioned write: ``os.pwritev`` in ``IOV_MAX`` batches.

        Partial writes resume mid-buffer; falls back to the loop path when
        the platform lacks ``os.pwritev`` — or when a subclass overrides
        ``pwrite`` (instrumentation / fault-injection sinks must keep
        seeing every byte).
        """
        if type(self).pwrite is not FileSink.pwrite or not hasattr(os, "pwritev"):
            return super().pwritev(offset, parts)
        bufs = [memoryview(p) for p in parts if len(p)]
        total = sum(len(b) for b in bufs)
        pos = 0
        calls = 0
        i = 0
        while i < len(bufs):
            n = os.pwritev(self.fd, bufs[i : i + IOV_MAX], offset + pos)
            if n <= 0:  # no progress: raising beats spinning forever
                raise IOError(
                    f"pwritev wrote 0 of {total - pos} bytes at "
                    f"{offset + pos} of {self.path}"
                )
            calls += 1
            pos += n
            # advance past fully written buffers; re-slice a partial one
            while i < len(bufs) and n >= len(bufs[i]):
                n -= len(bufs[i])
                i += 1
            if n:
                bufs[i] = bufs[i][n:]
        self._count_writev(calls, total)

    def pread(self, offset: int, size: int) -> bytes:
        # fast path: the kernel returns the whole extent in one call (the
        # overwhelmingly common case) — hand its buffer back with no copy
        chunk = os.pread(self.fd, size, offset)
        if len(chunk) == size:
            self._count_read(1, size)
            return chunk
        if not chunk and size:
            raise EOFError(f"short read at {offset} of {self.path}")
        out = bytearray(chunk)
        calls = 1
        while len(out) < size:
            chunk = os.pread(self.fd, size - len(out), offset + len(out))
            if not chunk:
                raise EOFError(f"short read at {offset}+{len(out)} of {self.path}")
            out += chunk
            calls += 1
        self._count_read(calls, size)
        return bytes(out)

    def pread_into(self, offset: int, buf) -> int:
        """Zero-allocation positioned read via ``os.preadv`` (short reads
        resumed), used by pooled-buffer readers (merge's raw copies)."""
        if type(self).pread is not FileSink.pread or not hasattr(os, "preadv"):
            return super().pread_into(offset, buf)
        mv = memoryview(buf)
        size = len(mv)
        pos = 0
        calls = 0
        while pos < size:
            n = os.preadv(self.fd, [mv[pos:]], offset + pos)
            if n <= 0:
                raise EOFError(f"short read at {offset}+{pos} of {self.path}")
            pos += n
            calls += 1
        self._count_read(calls, size)
        return size

    def fallocate(self, offset: int, size: int) -> None:
        super().fallocate(offset, size)
        if size <= 0:
            return
        try:
            os.posix_fallocate(self.fd, offset, size)
        except OSError as e:  # pragma: no cover - fs dependent
            if e.errno not in (errno.EOPNOTSUPP, errno.EINVAL, errno.ENOSYS):
                raise

    def fsync(self) -> None:
        super().fsync()
        os.fsync(self.fd)

    def close(self) -> None:
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1

    def readable(self) -> bool:
        return True


class AsyncFileSink(FileSink):
    """A :class:`FileSink` that opts into **native ring submission**.

    With write-behind enabled (``WriteOptions.io_inflight_bytes > 0``)
    and ``io_ring`` in auto mode, the I/O engine submits this sink's
    queued extents through an io_uring submission ring when the thin
    ctypes/liburing binding loads (DESIGN.md §6.7) — batched kernel
    submission instead of one completion thread call per write.  On
    platforms without liburing the engine transparently uses its
    emulated ring: same bytes, same accounting, same failure semantics.

    Synchronous operations (header, footer, reads) behave exactly like
    :class:`FileSink` — this class only *advertises* the capability via
    :attr:`native_ring`; a subclass that overrides :meth:`pwrite` or
    :meth:`pwritev` (fault injection, instrumentation) stops advertising
    it, because a kernel ring would bypass the override.
    """

    @property
    def native_ring(self) -> bool:
        return (
            type(self).pwrite is FileSink.pwrite
            and type(self).pwritev is FileSink.pwritev
            and self.fd >= 0
        )


class DevNullSink(Sink):
    """Tracks the file layout but discards bytes — the paper's /dev/null
    configuration isolates the software stack from storage bandwidth."""

    def pwrite(self, offset: int, data: bytes) -> None:
        self._count_write(1, len(data))

    def pwritev(self, offset: int, parts) -> None:
        if type(self).pwrite is not DevNullSink.pwrite:
            return super().pwritev(offset, parts)
        self._count_writev(1, sum(len(p) for p in parts))

    def pread(self, offset: int, size: int) -> bytes:
        raise IOError("DevNullSink is write-only")


class MemorySink(Sink):
    """In-memory file.

    The backing ``bytearray`` grows at :meth:`reserve` time — under the
    writer's critical section, where extent layout is decided — so the
    parallel committers that later ``pwrite``/``pwritev`` those extents
    never serialize on (or race with) a reallocation: in-bounds writes are
    plain disjoint slice assignments with no lock taken.  ``_grow_lock``
    is only acquired on the out-of-bounds fallback path (direct use
    without a prior ``reserve``).
    """

    def __init__(self, capacity: int = 0) -> None:
        super().__init__()
        # a capacity hint preallocates the backing store once (no realloc
        # memmoves during the run — what a benchmark of the commit path
        # wants); without it the buffer doubles geometrically on demand
        self.buf = bytearray(capacity)
        self._grow_lock = threading.Lock()
        self._high_water = 0  # highest unreserved write end (grow path)

    def reserve(self, size: int) -> int:
        off = super().reserve(size)
        self._ensure(off + size)
        return off

    def _ensure(self, end: int) -> None:
        if len(self.buf) < end:
            with self._grow_lock:
                cur = len(self.buf)
                if cur < end:
                    # geometric growth: bytearray's own over-allocation is
                    # too shallow (~1.125x), which turns steady appending
                    # into ~8x the file size in realloc memmoves; doubling
                    # keeps it amortized O(1) per byte.  close() trims the
                    # padding back to the logical size.
                    self.buf.extend(bytes(max(end - cur, cur, 4096)))

    def close(self) -> None:
        # drop the geometric-growth padding: after close, ``buf`` holds
        # exactly the written file (reserved extents + any direct writes)
        with self._grow_lock:
            del self.buf[max(self._end, self._high_water):]

    def _note_unreserved(self, end: int) -> None:
        """Record a write end beyond the reserved extent so close() never
        trims it.  Reserved writes (``end <= _end``, every writer path)
        skip this entirely — the hot path stays lock-free."""
        if end > self._end and end > self._high_water:
            with self._grow_lock:
                if end > self._high_water:
                    self._high_water = end

    def pwrite(self, offset: int, data: bytes) -> None:
        end = offset + len(data)
        if len(self.buf) < end:
            self._ensure(end)
        self._note_unreserved(end)
        self.buf[offset:end] = data
        self._count_write(1, len(data))

    def pwritev(self, offset: int, parts) -> None:
        if type(self).pwrite is not MemorySink.pwrite:
            return super().pwritev(offset, parts)
        total = sum(len(p) for p in parts)
        if len(self.buf) < offset + total:
            self._ensure(offset + total)
        self._note_unreserved(offset + total)
        pos = offset
        for p in parts:
            n = len(p)
            if n:
                self.buf[pos : pos + n] = p
            pos += n
        self._count_writev(1, total)

    def pread(self, offset: int, size: int) -> bytes:
        out = bytes(self.buf[offset : offset + size])
        self._count_read(1, len(out))
        return out

    def pread_into(self, offset: int, buf) -> int:
        if type(self).pread is not MemorySink.pread:
            return super().pread_into(offset, buf)
        mv = memoryview(buf)
        n = len(mv)
        src = memoryview(self.buf)[offset : offset + n]
        if len(src) != n:  # same contract as every other pread_into
            raise EOFError(
                f"short read at {offset}: {len(src)} of {n} bytes"
            )
        mv[:] = src
        self._count_read(1, n)
        return n

    def readable(self) -> bool:
        return True


class LatencyModel:
    """Simulated shared-resource latency: busy-until charge + centered sleep.

    The resource (a disk, a NIC) is modeled as a busy-until timestamp:
    each operation charges ``nbytes / bw`` seconds to the window under a
    lock — concurrent callers serialize at the resource, like a request
    queue — and then sleeps until its own completion time.  A per-op
    latency floor (an RTT) does NOT occupy the shared window: concurrent
    round trips overlap, only bytes contend.  One implementation serves
    both :class:`ThrottledSink` (device bandwidth, paper Figs. 3–4) and
    the remote ``FakeTransport`` (network RTT + shared NIC bandwidth).
    """

    #: time.sleep() on this container overshoots by ~0.1-1 ms, which at
    #: NVMe-class simulated bandwidths would make the modeled device
    #: slower than its nominal bw (a 2 MB extent at 2 GB/s costs 1 ms).
    #: Undershooting the target by half the typical overshoot centers the
    #: per-completion error near zero without burning a core on a
    #: spin-wait; aggregate occupancy stays exact either way — it is
    #: carried by the busy-until timestamp, not by the sleeps.
    SLEEP_SLOP = 0.0005

    def __init__(self, bw: float = 0.0) -> None:
        self.bw = bw  # bytes/second; 0 = unlimited
        self._lock = threading.Lock()
        self._busy_until = time.perf_counter()

    def charge(self, nbytes: int, bw: Optional[float] = None,
               floor_s: float = 0.0) -> float:
        """Extend the busy window by this operation's byte cost; returns
        the completion timestamp the caller must :meth:`settle` to.
        ``floor_s`` is a per-op latency floor (RTT + injected slow-tail
        delay) added *outside* the shared window."""
        eff = self.bw if bw is None else bw
        cost = nbytes / eff if eff else 0.0
        with self._lock:
            now = time.perf_counter()
            start = max(now, self._busy_until)
            done = start + cost
            self._busy_until = done
        return max(done, now + floor_s)

    def settle(self, done: float) -> None:
        delay = done - time.perf_counter()
        if delay > self.SLEEP_SLOP:
            time.sleep(delay - self.SLEEP_SLOP)


class ThrottledSink(Sink):
    """Wraps another sink and enforces a byte bandwidth on writes.

    Used to emulate the fio-measured device limits of the paper's SSD
    (771 / 1075 MB/s) and HDD (217 MB/s) on this container.  When
    ``fallocated`` extents are written, the effective bandwidth is
    ``bw_prealloc`` (the paper's Fig. 3 dashed line), otherwise ``bw``.
    The busy-window timing itself lives in :class:`LatencyModel`, shared
    with the remote transport simulator.
    """

    def __init__(self, inner: Sink, bw: float, bw_prealloc: Optional[float] = None):
        super().__init__()
        self.inner = inner
        self.bw = bw
        self.bw_prealloc = bw_prealloc if bw_prealloc is not None else bw
        self._model = LatencyModel()
        self._tlock = threading.Lock()  # guards _prealloc
        self._prealloc: list = []  # (start, end) fallocated extents

    def reserve(self, size: int) -> int:
        return self.inner.reserve(size)

    @property
    def size(self) -> int:
        return self.inner.size

    def _is_prealloc(self, offset: int, size: int) -> bool:
        with self._tlock:
            for s, e in self._prealloc:
                if offset >= s and offset + size <= e:
                    return True
        return False

    def _charge(self, offset: int, nbytes: int) -> float:
        """Charge this write to the shared device window at the effective
        bandwidth; returns the completion timestamp to settle to."""
        bw = self.bw_prealloc if self._is_prealloc(offset, nbytes) else self.bw
        return self._model.charge(nbytes, bw=bw)

    def _settle(self, done: float) -> None:
        self._model.settle(done)

    def pwrite(self, offset: int, data: bytes) -> None:
        done = self._charge(offset, len(data))
        self.inner.pwrite(offset, data)
        self._settle(done)
        self._count_write(1, len(data))

    def pwritev(self, offset: int, parts) -> None:
        if type(self).pwrite is not ThrottledSink.pwrite:
            return super().pwritev(offset, parts)
        total = sum(len(p) for p in parts)
        done = self._charge(offset, total)
        self.inner.pwritev(offset, parts)
        self._settle(done)
        self._count_writev(1, total)

    def pread(self, offset: int, size: int) -> bytes:
        out = self.inner.pread(offset, size)
        self._count_read(1, len(out))
        return out

    def fallocate(self, offset: int, size: int) -> None:
        super().fallocate(offset, size)
        with self._tlock:
            self._prealloc.append((offset, offset + size))
        self.inner.fallocate(offset, size)

    def fsync(self) -> None:
        super().fsync()
        self.inner.fsync()

    def close(self) -> None:
        self.inner.close()

    def readable(self) -> bool:
        return self.inner.readable()


def open_sink(path, create: bool = True, async_io: bool = False) -> Sink:
    """Resolve a path-ish spec to a sink.

    ``/dev/null``/``devnull``/``null:`` → :class:`DevNullSink`; ``mem:``
    → :class:`MemorySink`; an ``async:`` prefix (or ``async_io=True``)
    → :class:`AsyncFileSink`, which lets the I/O engine use io_uring
    ring submission when available; a ``scheme://bucket/key`` URL (e.g.
    ``mem-s3://bucket/file.rntj``) is refused: the object-store sink is
    not part of this package yet; anything else → :class:`FileSink`.
    """
    path = os.fspath(path)  # accept str and os.PathLike alike
    if path in ("/dev/null", "devnull", "null:"):
        return DevNullSink()
    if path == "mem:":
        return MemorySink()
    if "://" in path:
        raise NotImplementedError("remote sinks: later slice")
    if path.startswith("async:"):
        return AsyncFileSink(path[len("async:"):], create=create)
    if async_io:
        return AsyncFileSink(path, create=create)
    return FileSink(path, create=create)
