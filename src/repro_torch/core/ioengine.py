"""The sink-side I/O engine: scatter-gather, striped, async-ring commits.

The paper's evaluation (§5) scales the CPU side of parallel writing until
it is "only limited by storage bandwidth" — this module makes our commit
path actually behave that way (DESIGN.md §6).  Four cooperating levers,
each individually optional:

* **scatter-gather** — a sealed cluster's iovec plan goes to
  ``Sink.pwritev`` with no assembly memcpy (the plan comes from
  ``ClusterBuilder._gather``; this engine only chooses *how* to submit);
* **striping** — an extent larger than ``stripe_bytes`` splits into
  independent sub-extent jobs at computed offsets inside the reserved
  extent, executed concurrently, so ONE producer can keep a deep device
  queue busy the way chunked compression keeps the codec pool busy;
* **write-behind** — with ``inflight_bytes > 0`` a commit only *enqueues*
  its extent; producers seal cluster N+1..N+k while earlier extents
  drain.  ``admit()`` is the backpressure gate (called before the
  writer's critical section, so a stalled producer never holds the
  commit lock), errors poison the writer through ``on_error`` exactly
  like a synchronous failed ``pwrite``, and ``drain()`` is the
  drain-before-footer barrier ``close()`` runs;
* **ring submission** (DESIGN.md §6.7) — queued extents go onto a
  **submission ring** instead of one executor future per stripe: an
  io_uring ring through a thin ctypes/liburing binding when the library
  loads and the sink is a real fd (``AsyncFileSink``), otherwise a
  completion-thread + ``pwritev`` emulation whose observable behavior —
  ``io_inflight_bytes`` accounting, poisoning, drain-before-footer
  ordering, byte output — is identical on every platform.  A producer's
  submit cost drops to one deque append + notify (``io_submit_ns``
  counts it), and completions fold back through the same accounting as
  the executor path.

The engine also closes the commit path's last allocation: with a
:class:`~repro_torch.core.bufpool.BufferPool` attached, an extent owner's
detached scatter buffers are **returned to the pool when the extent's
last write lands** — never earlier, because a queued commit's iovecs
alias them until then (DESIGN.md §6.8).

The fsync policy rides here too: ``"on_close"`` (default; the writer's
close() fsyncs, as always), ``"every_cluster"`` (fsync when an extent's
last stripe lands), or an ``int`` byte interval (fsync each time that
many bytes have landed since the previous fsync).

With every lever off the engine degenerates to exactly the seed's
behavior: one synchronous ``pwrite``/``pwritev`` on the committing
thread.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import errno
import os
import random
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as _np

_ns = time.perf_counter_ns

# pool size when striping / write-behind is enabled without an explicit
# WriteOptions.io_workers: enough concurrent submissions to keep an NVMe
# queue (or a sleeping ThrottledSink window) busy without thread bloat
DEFAULT_IO_WORKERS = 4

FSYNC_ON_CLOSE = "on_close"
FSYNC_EVERY_CLUSTER = "every_cluster"

RING_AUTO = "auto"
RING_EMULATED = "emulated"
RING_URING = "uring"
RING_OFF = "off"


# ---------------------------------------------------------------------------
# retry policy (DESIGN.md §8.2)

#: errnos worth retrying: transient device/medium hiccups and interruptions.
#: ENOSPC is included deliberately — on shared/quota'd storage it is often
#: transient (another writer freeing space, quota refresh); a genuinely full
#: disk just exhausts the attempts and poisons like any permanent error.
DEFAULT_RETRYABLE_ERRNOS = (
    errno.EIO, errno.EAGAIN, errno.ENOSPC, errno.EINTR, errno.ETIMEDOUT,
    errno.EBUSY,
)


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded-retry policy applied by the I/O engine to every write and
    fsync (DESIGN.md §8.2).

    A failed operation whose errno is in ``retryable_errnos`` is retried
    up to ``max_attempts`` total attempts with exponential backoff
    (``backoff_base * 2**k`` seconds, capped at ``backoff_cap``, with
    ±50% deterministic jitter when ``jitter``).  ``deadline`` bounds one
    logical operation's total retry time in seconds (0 = unbounded).
    Positioned writes are idempotent — a retry rewrites the same extent
    bytes at the same offsets — so retrying after a *partial* (torn)
    write is always safe.  Non-``OSError`` failures (including the fault
    harness's :class:`~repro_torch.core.faults.ProcessKilled`) are never
    retried.  Only an exhausted retry budget poisons the writer.
    """

    max_attempts: int = 4
    backoff_base: float = 0.002
    backoff_cap: float = 0.25
    jitter: bool = True
    retryable_errnos: Tuple[int, ...] = DEFAULT_RETRYABLE_ERRNOS
    deadline: float = 0.0

    def retryable(self, exc: BaseException) -> bool:
        return isinstance(exc, OSError) and exc.errno in self.retryable_errnos

    def backoff(self, attempt: int, rng=None) -> float:
        """Sleep before retry number ``attempt`` (1-based)."""
        delay = min(self.backoff_cap, self.backoff_base * (2 ** (attempt - 1)))
        if self.jitter and rng is not None:
            delay *= 0.5 + rng.random()
        return delay


class Retrier:
    """The retry chokepoint as a standalone object: run any callable under
    a :class:`RetryPolicy`.

    Originally the loop lived inside :meth:`IOEngine._retrying` and covered
    only engine-issued writes and fsyncs; it is factored out here so the
    *read* paths — :class:`~repro_torch.core.reader.RNTJReader` preads and the
    remote :class:`~repro_torch.core.remote.ObjectStoreSink` transport ops —
    apply the identical semantics: retry ``retryable_errnos`` up to
    ``max_attempts`` with exponential backoff + deterministic jitter,
    honor the policy's per-logical-op ``deadline``, re-raise everything
    else (non-``OSError`` failures such as
    :class:`~repro_torch.core.faults.ProcessKilled` are never retried).

    Thread-safe: the jitter RNG is seeded (same backoff schedule every
    run) and guarded by a lock; ``on_retry``/``on_giveup`` fire once per
    retried / abandoned operation so callers can wire their own counters
    (sink IOStats, ReaderStats, engine mirrors).
    """

    def __init__(self, policy: Optional[RetryPolicy],
                 seed: int = 0x52455452,
                 on_retry: Optional[Callable] = None,
                 on_giveup: Optional[Callable] = None) -> None:
        self.policy = policy
        self._rng = random.Random(seed)
        self._mu = threading.Lock()
        self._on_retry = on_retry
        self._on_giveup = on_giveup

    def call(self, fn, *args):
        """``fn(*args)`` under the policy; a plain call when policy is
        ``None``."""
        policy = self.policy
        if policy is None:
            return fn(*args)
        deadline = (
            time.monotonic() + policy.deadline if policy.deadline else None
        )
        attempt = 0
        while True:
            try:
                return fn(*args)
            except OSError as e:
                attempt += 1
                if not policy.retryable(e):
                    raise
                if attempt >= policy.max_attempts or (
                        deadline is not None
                        and time.monotonic() >= deadline):
                    if self._on_giveup is not None:
                        self._on_giveup()
                    raise
                if self._on_retry is not None:
                    self._on_retry()
                with self._mu:
                    delay = policy.backoff(attempt, self._rng)
                if deadline is not None:
                    delay = min(delay, max(0.0, deadline - time.monotonic()))
                if delay > 0:
                    time.sleep(delay)


class _ExtentGroup:
    """One logical extent (a cluster or page) split into 1..n stripe jobs."""

    __slots__ = ("remaining", "nbytes", "owner", "striped")

    def __init__(self, remaining: int, nbytes: int, owner,
                 striped: bool = False):
        self.remaining = remaining
        self.nbytes = nbytes
        # the SealedCluster (or any object) whose buffers back the iovecs:
        # referenced until the last stripe lands, then recycled + released
        self.owner = owner
        self.striped = striped


# ---------------------------------------------------------------------------
# submission rings


class _RingOp:
    __slots__ = ("group", "off", "parts", "nbytes")

    def __init__(self, group, off, parts, nbytes):
        self.group = group
        self.off = off
        self.parts = parts
        self.nbytes = nbytes


class EmulatedRing:
    """Completion-thread + ``pwritev`` emulation of the submission ring.

    Producers append ops under one condition variable (a deque append —
    no future allocation, no executor work-queue churn); ``workers``
    completion threads pop small batches and execute them through the
    engine's normal job body, so accounting, poisoning and drain
    semantics are *identical* to the io_uring backend and to the
    executor path it replaces.
    """

    # ops claimed per lock acquisition: amortizes wakeups without letting
    # one thread hoard the queue
    BATCH = 8

    def __init__(self, engine: "IOEngine", workers: int):
        self._engine = engine
        self._cv = threading.Condition()
        self._ops: deque = deque()
        self._stop = False
        self._workers = max(1, workers)
        # completion threads start lazily at the first submit, so a
        # writer that never enters write-behind (or a skim spawning many
        # writers) pays no idle threads — matching the executor path
        self._threads: List[threading.Thread] = []

    def _ensure_threads(self) -> None:
        if self._threads:
            return
        self._threads = [
            threading.Thread(
                target=self._loop, daemon=True, name=f"rntj-ring-{i}"
            )
            for i in range(self._workers)
        ]
        for t in self._threads:
            t.start()

    def submit(self, group, off, parts, nbytes) -> None:
        with self._cv:
            self._ensure_threads()
            self._ops.append(_RingOp(group, off, parts, nbytes))
            self._cv.notify()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._ops and not self._stop:
                    self._cv.wait()
                if not self._ops:
                    return  # stopping and drained
                # claim a share of the queue, not the whole head: with
                # fewer ops than workers each claims one (a high-latency
                # sink keeps every worker busy); only a queue deeper than
                # the worker pool amortizes wakeups with bigger batches
                share = max(1, len(self._ops) // self._workers)
                batch = [
                    self._ops.popleft()
                    for _ in range(min(len(self._ops), self.BATCH, share))
                ]
            for op in batch:
                self._engine._run_job(op.group, op.off, op.parts, op.nbytes)

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join()


# -- io_uring (thin ctypes/liburing binding) --------------------------------
#
# Only engaged when (a) liburing.so loads, (b) the sink advertises a raw
# fd with no pwrite override (AsyncFileSink), and (c) REPRO_IO_URING is
# not "0".  The emulated ring above is the behavioral reference; this
# backend must be observationally identical (same bytes, same poisoning,
# same drain ordering) — it only changes *how* queued writes reach the
# kernel: batched SQE submission, no thread per write.

IORING_OP_WRITEV = 2
_URING_DEPTH = 256


class _IoUringSqe(ctypes.Structure):  # kernel UAPI, 64 bytes, stable
    _fields_ = [
        ("opcode", ctypes.c_uint8), ("flags", ctypes.c_uint8),
        ("ioprio", ctypes.c_uint16), ("fd", ctypes.c_int32),
        ("off", ctypes.c_uint64), ("addr", ctypes.c_uint64),
        ("len", ctypes.c_uint32), ("rw_flags", ctypes.c_uint32),
        ("user_data", ctypes.c_uint64), ("buf_index", ctypes.c_uint16),
        ("personality", ctypes.c_uint16), ("splice_fd_in", ctypes.c_int32),
        ("pad2", ctypes.c_uint64 * 2),
    ]


class _IoUringCqe(ctypes.Structure):  # kernel UAPI, stable
    _fields_ = [
        ("user_data", ctypes.c_uint64), ("res", ctypes.c_int32),
        ("flags", ctypes.c_uint32),
    ]


class _IoUringSq(ctypes.Structure):  # liburing 2.x ABI
    _fields_ = [
        ("khead", ctypes.POINTER(ctypes.c_uint)),
        ("ktail", ctypes.POINTER(ctypes.c_uint)),
        ("kring_mask", ctypes.POINTER(ctypes.c_uint)),
        ("kring_entries", ctypes.POINTER(ctypes.c_uint)),
        ("kflags", ctypes.POINTER(ctypes.c_uint)),
        ("kdropped", ctypes.POINTER(ctypes.c_uint)),
        ("array", ctypes.POINTER(ctypes.c_uint)),
        ("sqes", ctypes.POINTER(_IoUringSqe)),
        ("sqe_head", ctypes.c_uint), ("sqe_tail", ctypes.c_uint),
        ("ring_sz", ctypes.c_size_t), ("ring_ptr", ctypes.c_void_p),
        ("pad", ctypes.c_uint * 4),
    ]


class _IoUringCq(ctypes.Structure):  # liburing 2.x ABI
    _fields_ = [
        ("khead", ctypes.POINTER(ctypes.c_uint)),
        ("ktail", ctypes.POINTER(ctypes.c_uint)),
        ("kring_mask", ctypes.POINTER(ctypes.c_uint)),
        ("kring_entries", ctypes.POINTER(ctypes.c_uint)),
        ("kflags", ctypes.POINTER(ctypes.c_uint)),
        ("koverflow", ctypes.POINTER(ctypes.c_uint)),
        ("cqes", ctypes.POINTER(_IoUringCqe)),
        ("ring_sz", ctypes.c_size_t), ("ring_ptr", ctypes.c_void_p),
        ("pad", ctypes.c_uint * 4),
    ]


class _IoUring(ctypes.Structure):
    _fields_ = [
        ("sq", _IoUringSq), ("cq", _IoUringCq),
        ("flags", ctypes.c_uint), ("ring_fd", ctypes.c_int),
        ("features", ctypes.c_uint), ("enter_ring_fd", ctypes.c_int),
        ("int_flags", ctypes.c_uint8), ("pad", ctypes.c_uint8 * 3),
        ("pad2", ctypes.c_uint),
    ]


class _Iovec(ctypes.Structure):
    _fields_ = [("iov_base", ctypes.c_void_p), ("iov_len", ctypes.c_size_t)]


_liburing = None          # loaded library handle; False once ruled out
_liburing_lock = threading.Lock()


def load_liburing():
    """The liburing handle, or ``None`` when unavailable.

    ``REPRO_IO_URING=0`` disables loading outright (the emulated ring is
    then the only async backend); any load/symbol failure also resolves
    to ``None`` — callers fall back, they never crash.
    """
    global _liburing
    with _liburing_lock:
        if _liburing is None:
            if os.environ.get("REPRO_IO_URING", "").strip() == "0":
                _liburing = False
            else:
                _liburing = _try_load_liburing() or False
    return _liburing or None


def _try_load_liburing():
    name = ctypes.util.find_library("uring")
    candidates = [name] if name else []
    candidates += ["liburing.so.2", "liburing.so.1", "liburing.so"]
    for cand in candidates:
        if not cand:
            continue
        try:
            lib = ctypes.CDLL(cand, use_errno=True)
            for sym in ("io_uring_queue_init", "io_uring_get_sqe",
                        "io_uring_submit", "__io_uring_get_cqe",
                        "io_uring_queue_exit"):
                getattr(lib, sym)
            lib.io_uring_queue_init.restype = ctypes.c_int
            lib.io_uring_submit.restype = ctypes.c_int
            lib.io_uring_get_sqe.restype = ctypes.POINTER(_IoUringSqe)
            lib.__io_uring_get_cqe.restype = ctypes.c_int
            return lib
        except (OSError, AttributeError):
            continue
    return None


class UringRing:
    """io_uring submission ring over a raw file descriptor.

    One event-loop thread both flushes queued ops as batched SQEs (one
    ``io_uring_submit`` syscall for a whole burst — the submission cost
    the executor path paid per stripe) and reaps CQEs, folding each
    completion back through the engine's normal accounting.  Buffers and
    iovec arrays are pinned in ``_live`` from submit to completion.
    """

    def __init__(self, engine: "IOEngine", fd: int, lib=None,
                 depth: int = _URING_DEPTH):
        self._engine = engine
        self._fd = fd
        self._lib = lib or load_liburing()
        if self._lib is None:
            raise ValueError(
                "io_uring requested but liburing is not loadable on this "
                "platform (and REPRO_IO_URING may disable it); use the "
                "emulated ring instead"
            )
        self._ring = _IoUring()
        rc = self._lib.io_uring_queue_init(
            ctypes.c_uint(depth), ctypes.byref(self._ring), ctypes.c_uint(0)
        )
        if rc < 0:
            raise OSError(-rc, "io_uring_queue_init failed")
        self._cv = threading.Condition()
        self._ops: deque = deque()
        self._stop = False
        self._live = {}  # user_data -> (op, iovec array, pinned parts, t0)
        self._next_id = 1
        self._degraded = False  # submission broke: run ops synchronously
        self._seen_fence = threading.Lock()  # memory fence for CQ-head store
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="rntj-uring"
        )
        self._thread.start()

    def submit(self, group, off, parts, nbytes) -> None:
        with self._cv:
            self._ops.append(_RingOp(group, off, parts, nbytes))
            self._cv.notify()

    # -- event loop ----------------------------------------------------------

    def _prep(self, op: _RingOp) -> bool:
        sqe = self._lib.io_uring_get_sqe(ctypes.byref(self._ring))
        if not sqe:
            return False  # SQ full: flush + reap first
        parts = [memoryview(p) for p in op.parts if len(p)]
        iov = (_Iovec * max(1, len(parts)))()
        # read-only views reject ctypes.from_buffer; a zero-copy numpy
        # wrap exposes the address either way, and pinning the wrapper
        # (plus the view it holds) keeps the bytes alive until the CQE
        pinned = []
        for i, mv in enumerate(parts):
            arr = _np.frombuffer(mv, dtype=_np.uint8)
            iov[i].iov_base = arr.ctypes.data
            iov[i].iov_len = arr.nbytes
            pinned.append(arr)
        uid = self._next_id
        self._next_id += 1
        s = sqe.contents
        s.opcode = IORING_OP_WRITEV
        s.flags = 0
        s.ioprio = 0
        s.fd = self._fd
        s.off = op.off
        s.addr = ctypes.cast(iov, ctypes.c_void_p).value or 0
        s.len = len(parts)
        s.rw_flags = 0
        s.user_data = uid
        s.buf_index = 0
        s.personality = 0
        s.splice_fd_in = 0
        self._live[uid] = (op, iov, pinned, self._engine._job_begin())
        return True

    def _reap(self, wait: bool) -> int:
        cqe_pp = ctypes.POINTER(_IoUringCqe)()
        rc = self._lib.__io_uring_get_cqe(
            ctypes.byref(self._ring), ctypes.byref(cqe_pp),
            ctypes.c_uint(0), ctypes.c_uint(1 if wait else 0), None,
        )
        if rc < 0 or not cqe_pp:
            return 0
        cqe = cqe_pp.contents
        uid, res = cqe.user_data, cqe.res
        # mark seen: advance the CQ head.  The store must not become
        # visible before the field loads above (liburing uses a release
        # store); pure ctypes has no atomics, so acquire/release a lock —
        # a full fence on CPython — between the loads and the store.
        with self._seen_fence:
            self._ring.cq.khead.contents.value = (
                self._ring.cq.khead.contents.value + 1
            )
        entry = self._live.pop(uid, None)
        if entry is None:
            return 1
        op, _iov, _pinned, t0 = entry
        err = None
        if res > 0:
            # the kernel wrote past the Sink API: account what landed so
            # IOStats stays truthful on the native ring path too (a
            # partial write's resumed tail is counted by sink.pwrite)
            self._engine.sink._count_writev(1, res)
        if res < 0:
            err = OSError(-res, os.strerror(-res))
            if self._engine.retry is not None and self._engine.retry.retryable(err):
                # a retryable CQE error re-enters the engine's retrying
                # write path synchronously (positioned rewrite: idempotent)
                self._engine._count_retry()
                try:
                    self._engine._pwritev(op.off, op.parts)
                    err = None
                except BaseException as e:  # noqa: BLE001
                    err = e
        elif res != op.nbytes:
            # a partial vectored write: finish it synchronously through
            # the engine (correctness first; partials are rare here)
            try:
                self._engine._pwritev_resume(op.off, op.parts, res)
            except BaseException as e:  # noqa: BLE001
                err = e
        self._engine._job_end(op.group, op.nbytes, t0, err)
        return 1

    def _submit_prepared(self) -> None:
        """Flush prepared SQEs to the kernel.  On failure (the SQEs never
        reached — or will never leave — the kernel, so no CQE will ever
        arrive; silently dropping them would hang ``drain()`` forever)
        the ring *degrades* instead of failing every in-flight extent:
        :meth:`_fallback_execute` writes them out synchronously."""
        rc = self._lib.io_uring_submit(ctypes.byref(self._ring))
        if rc < 0:
            self._fallback_execute(OSError(-rc, os.strerror(-rc)))

    def _fallback_execute(self, err: OSError) -> None:
        """Ring submission broke (DESIGN.md §8.2): execute every op still
        in ``_live`` synchronously through the engine's retrying
        ``_pwritev`` and fold the completions through ``_job_end``, then
        stay degraded — future ops run the same way on this thread, like
        a one-worker emulated ring.  Ops already submitted in an earlier
        successful batch may still complete via CQE; a rewrite of the
        same extent bytes is idempotent, and ``_reap`` ignores CQEs whose
        op has already been folded."""
        self._degraded = True
        self._engine._note_ring_fallback(err)
        for uid in list(self._live):
            op, _iov, _pinned, t0 = self._live.pop(uid)
            op_err = None
            try:
                self._engine._pwritev(op.off, op.parts)
            except BaseException as e:  # noqa: BLE001
                op_err = e
            self._engine._job_end(op.group, op.nbytes, t0, op_err)

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._ops and not self._stop and not self._live:
                    self._cv.wait()
                if self._stop and not self._ops and not self._live:
                    return
                batch = list(self._ops)
                self._ops.clear()
            for op in batch:
                if self._degraded:
                    self._engine._run_job(op.group, op.off, op.parts,
                                          op.nbytes)
                    continue
                prepped = self._prep(op)
                while not prepped and not self._degraded:
                    # SQ full: flush prepared SQEs, then reap for room
                    self._submit_prepared()
                    if self._degraded:
                        break
                    self._reap(wait=True)
                    prepped = self._prep(op)
                if not prepped and self._degraded:
                    # never made it into _live: run it directly
                    self._engine._run_job(op.group, op.off, op.parts,
                                          op.nbytes)
            if batch and not self._degraded:
                self._submit_prepared()
            # reap whatever is ready; block only when nothing new can be
            # submitted and completions are still owed
            while self._reap(wait=False):
                pass
            if self._live:
                with self._cv:
                    if self._ops or self._stop:
                        continue
                self._reap(wait=True)

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join()
        self._lib.io_uring_queue_exit(ctypes.byref(self._ring))


def make_ring(engine: "IOEngine", mode, workers: int):
    """Resolve a ring ``mode`` to a backend (or ``None`` for the
    executor path): ``"uring"`` requires the liburing binding + a native
    async sink and raises otherwise; ``"auto"`` prefers io_uring when
    both are available and falls back to the emulation; ``"emulated"``
    forces the emulation; ``"off"``/falsy keeps one executor job
    per stripe."""
    if not mode or mode == RING_OFF:
        return None
    if mode is True:
        mode = RING_AUTO
    if mode not in (RING_AUTO, RING_EMULATED, RING_URING):
        raise ValueError(f"unknown io_ring mode {mode!r}")
    sink = engine.sink
    fd = getattr(sink, "fd", None)
    # only a sink that advertises native ring capability (AsyncFileSink:
    # a real fd AND no pwrite override — instrumentation/fault-injection
    # subclasses must keep seeing every byte) may bypass Sink.pwritev
    native = bool(getattr(sink, "native_ring", False)) and isinstance(fd, int)
    if mode == RING_URING:
        if not native:
            raise ValueError(
                "io_ring='uring' needs an AsyncFileSink (a real fd with no "
                "pwrite override)"
            )
        return UringRing(engine, fd)
    if mode == RING_AUTO and native and load_liburing() is not None:
        try:
            return UringRing(engine, fd)
        except (OSError, ValueError):
            pass  # kernel without io_uring etc.: fall through to emulation
    return EmulatedRing(engine, workers)


# ---------------------------------------------------------------------------
# the engine


class IOEngine:
    """Positioned-write executor for one writer's sink.

    ``write_extent(off, parts, nbytes)`` is the single entry point used by
    every commit path (buffered clusters, unbuffered pages, merge's raw
    cluster copies).  Synchronous mode writes on the calling thread
    (striped over the pool when configured) and returns the measured
    io_ns; write-behind mode enqueues — onto the submission ring when one
    is configured (``ring=``), else as executor jobs — and returns 0: the
    workers add their io time to ``stats`` directly and report drained
    bytes through ``on_drain`` (the rate-aware codec policy's bandwidth
    signal).  ``buffer_pool`` receives an extent owner's recyclable
    buffers when its last write lands.
    """

    def __init__(
        self,
        sink,
        workers: int = 0,
        inflight_bytes: int = 0,
        stripe_bytes: int = 0,
        fsync_policy=FSYNC_ON_CLOSE,
        stats=None,
        on_error: Optional[Callable] = None,
        on_drain: Optional[Callable] = None,
        ring=RING_OFF,
        buffer_pool=None,
        retry: Optional[RetryPolicy] = None,
    ):
        self.sink = sink
        self.stripe_bytes = int(stripe_bytes)
        self.inflight_bytes = int(inflight_bytes)
        self.stats = stats
        self.buffer_pool = buffer_pool
        self._on_error = on_error
        self._on_drain = on_drain
        # -- retry + degradation state (DESIGN.md §8.2) ---------------------
        self.retry = retry
        # seeded Retrier: fault-injection runs replay the same backoff
        # schedule; the counters mirror into the engine AND the sink
        self._retrier = Retrier(retry, on_retry=self._count_retry,
                                on_giveup=self._count_giveup)
        self._retry_mu = threading.Lock()
        self.retries = 0             # retried operations (mirror of IOStats)
        self.giveups = 0             # operations that exhausted the budget
        self.stripe_fallbacks = 0    # striping disabled after stripe failure
        self.ring_fallbacks = 0      # native ring degraded to synchronous
        self._stripe_disabled = False
        self._closed = False
        if not workers and (self.stripe_bytes > 0 or self.inflight_bytes > 0):
            workers = DEFAULT_IO_WORKERS
        self._workers = workers
        # the submission ring exists only in write-behind mode; when it
        # does, it owns all queued submissions and the executor would be
        # dead weight — create one or the other, never both
        self._ring = (
            make_ring(self, ring, workers) if self.inflight_bytes > 0 else None
        )
        self._pool = (
            ThreadPoolExecutor(max_workers=workers, thread_name_prefix="rntj-io")
            if workers and self._ring is None
            else None
        )
        self._cv = threading.Condition()
        self._inflight = 0      # admitted write-behind bytes not yet drained
        self._pending = 0       # queued/running async jobs
        self._error: Optional[BaseException] = None
        # busy-window drain accounting for on_drain: concurrent jobs must
        # not each report their own wall time (that would under-report the
        # sink's bandwidth by the concurrency factor) — instead bytes
        # accumulate and are reported over the union busy window whenever
        # the last running job finishes
        self._running = 0
        self._busy_start = 0
        self._drained_bytes = 0
        # fsync policy state
        self._fsync_every = fsync_policy == FSYNC_EVERY_CLUSTER
        self._fsync_interval = (
            int(fsync_policy) if isinstance(fsync_policy, int) else 0
        )
        self._since_fsync = 0
        self._fsync_lock = threading.Lock()

    # -- mode ----------------------------------------------------------------

    @property
    def async_mode(self) -> bool:
        """True when commits are queued (write-behind) instead of written
        on the committing thread."""
        return self.inflight_bytes > 0 and (
            self._pool is not None or self._ring is not None
        )

    @property
    def ring(self):
        """The active submission ring backend, or ``None`` (executor
        submission / synchronous mode)."""
        return self._ring

    # -- backpressure ---------------------------------------------------------

    def admit(self, nbytes: int) -> None:
        """Block until ``nbytes`` fits in the in-flight budget.

        Called by producers BEFORE the writer's critical section: a
        producer stalled on storage must never stall the other producers'
        commits.  An extent larger than the whole budget is admitted alone
        (the engine never deadlocks on one oversized cluster).  No-op in
        synchronous mode.
        """
        if not self.async_mode:
            return
        t0 = _ns()
        with self._cv:
            while self._inflight and self._inflight + nbytes > self.inflight_bytes:
                self._cv.wait()
            self._inflight += nbytes
        stall = _ns() - t0
        if self.stats is not None and stall:
            self.stats.add_io_stall_ns(stall)

    def _release(self, nbytes: int) -> None:
        with self._cv:
            self._inflight -= nbytes
            self._cv.notify_all()

    # -- retrying (DESIGN.md §8.2) --------------------------------------------

    def _count_retry(self) -> None:
        with self._retry_mu:
            self.retries += 1
        counter = getattr(self.sink, "_count_retry", None)
        if counter is not None:
            counter()

    def _count_giveup(self) -> None:
        with self._retry_mu:
            self.giveups += 1
        counter = getattr(self.sink, "_count_giveup", None)
        if counter is not None:
            counter()

    def _retrying(self, fn, *args):
        """Run ``fn(*args)`` under the engine's retry policy.  The single
        choke point every engine-issued write and fsync goes through:
        sync, striped, emulated-ring, and uring-resume paths all call it
        via :meth:`_pwritev`; CQE errors re-enter it via
        :meth:`_pwritev`.  The loop itself lives in :class:`Retrier` —
        shared with the reader's retrying preads and the remote sink's
        transport ops.  Without a policy it is a plain call."""
        return self._retrier.call(fn, *args)

    def _note_stripe_fallback(self) -> None:
        """A striped sub-extent failed even with retries: stop striping
        for the rest of this engine's life (the device is telling us it
        dislikes concurrent sub-extent writes) and count the event."""
        with self._retry_mu:
            self.stripe_fallbacks += 1
            self._stripe_disabled = True
        if self.stats is not None:
            self.stats.note_stripe_fallback()

    def _note_ring_fallback(self, err: BaseException) -> None:
        """The native submission ring can no longer submit: it degrades to
        executing ops synchronously on its own thread (same bytes, same
        accounting) rather than failing in-flight extents."""
        with self._retry_mu:
            self.ring_fallbacks += 1
        if self.stats is not None:
            self.stats.note_ring_fallback()

    # -- submission -----------------------------------------------------------

    def write_extent(self, off: int, parts: List, nbytes: int,
                     owner=None) -> int:
        """Write ``parts`` contiguously at ``off`` — inline, striped, or
        queued.  Returns the io_ns spent on THIS thread (0 when queued).

        The caller has already ``admit()``ed ``nbytes`` in write-behind
        mode and already reserved the extent; stripes never overlap, so
        no ordering between jobs is needed.  A failed write calls
        ``on_error`` (the writer's commit-poison hook) — synchronous
        failures also raise, exactly like the direct ``pwrite`` they
        replace.
        """
        stripes = self._stripes(off, parts, nbytes)
        if not self.async_mode:
            t0 = _ns()
            try:
                try:
                    if len(stripes) == 1 or self._pool is None:
                        for s_off, s_parts, _n in stripes:
                            self._pwritev(s_off, s_parts)
                    else:
                        futs = [
                            self._pool.submit(self._pwritev, s_off, s_parts)
                            for s_off, s_parts, _n in stripes
                        ]
                        for f in futs:
                            f.result()
                except OSError:
                    if len(stripes) <= 1 or self.retry is None:
                        raise
                    # stripe degradation: the reserved extent is untouched
                    # by readers until the footer lands, so rewriting it
                    # monolithically (with a fresh retry budget) is
                    # idempotent; striping stays off from here on
                    self._note_stripe_fallback()
                    self._pwritev(off, list(parts))
            except BaseException as e:
                self._fail(e)
                raise
            io_ns = _ns() - t0
            try:
                # fsync policy failures poison exactly like write failures
                # (they used to be able to slip through mid-run)
                self._extent_done(nbytes)
            except BaseException as e:
                self._fail(e)
                raise
            self._recycle(owner)
            if self._on_drain is not None:
                self._on_drain(nbytes, io_ns)
            return io_ns
        # write-behind: enqueue one job per stripe
        if self._error is not None:
            # the writer is poisoned: drop the bytes (finalization will
            # refuse anyway) but keep the budget accounting balanced
            self._release(nbytes)
            return 0
        t0 = _ns()
        group = _ExtentGroup(len(stripes), nbytes, owner, len(stripes) > 1)
        with self._cv:
            self._pending += len(stripes)
            depth = self._pending
        if self.stats is not None:
            for _ in stripes:
                self.stats.note_io_job(depth, self._inflight)
        if self._ring is not None:
            for s_off, s_parts, s_n in stripes:
                self._ring.submit(group, s_off, s_parts, s_n)
        else:
            for s_off, s_parts, s_n in stripes:
                self._pool.submit(self._run_job, group, s_off, s_parts, s_n)
        if self.stats is not None:
            self.stats.add_io_submit_ns(_ns() - t0)
        return 0

    def _stripes(self, off: int, parts: List, nbytes: int
                 ) -> List[Tuple[int, List, int]]:
        """Split an extent's iovec plan into ``[(offset, parts, nbytes)]``
        stripe sub-extents of at most ``stripe_bytes`` each."""
        if (
            self.stripe_bytes <= 0
            or self._stripe_disabled
            or nbytes <= self.stripe_bytes
            or (self._pool is None and self._ring is None)
        ):
            return [(off, list(parts), nbytes)]
        out: List[Tuple[int, List, int]] = []
        cur: List = []
        cur_n = 0
        cur_off = off
        for part in parts:
            mv = memoryview(part)
            pos = 0
            while pos < len(mv):
                take = min(len(mv) - pos, self.stripe_bytes - cur_n)
                cur.append(mv[pos : pos + take])
                cur_n += take
                pos += take
                if cur_n == self.stripe_bytes:
                    out.append((cur_off, cur, cur_n))
                    cur_off += cur_n
                    cur, cur_n = [], 0
        if cur:
            out.append((cur_off, cur, cur_n))
        return out

    def _pwritev(self, off: int, parts: List) -> None:
        self._retrying(self._pwritev_once, off, parts)

    def _pwritev_once(self, off: int, parts: List) -> None:
        if len(parts) == 1:
            self.sink.pwrite(off, parts[0])
        else:
            self.sink.pwritev(off, parts)

    def _pwritev_resume(self, off: int, parts: List, written: int) -> None:
        """Finish a partially completed vectored write from byte
        ``written`` onward (io_uring short-write recovery).  Retried as a
        whole — re-running the resume loop rewrites the same tail bytes."""
        self._retrying(self._pwritev_resume_once, off, parts, written)

    def _pwritev_resume_once(self, off: int, parts: List, written: int) -> None:
        pos = 0
        for p in parts:
            mv = memoryview(p)
            n = len(mv)
            if written >= pos + n:
                pos += n
                continue
            skip = max(0, written - pos)
            self.sink.pwrite(off + pos + skip, mv[skip:])
            pos += n

    # -- job body (executor and ring workers share it) ------------------------

    def _job_begin(self) -> int:
        t0 = _ns()
        with self._cv:
            if self._running == 0:
                self._busy_start = t0
            self._running += 1
        return t0

    def _job_end(self, group: _ExtentGroup, nbytes: int, t0: int,
                 err: Optional[BaseException]) -> None:
        """Completion fold shared by every async backend: stats, budget
        release, busy-window drain reporting, last-stripe recycling +
        fsync, poisoning."""
        io_ns = _ns() - t0
        if err is not None:
            self._fail(err)
        if self.stats is not None:
            self.stats.add_io_ns(io_ns)
        last = False
        drained = None
        with self._cv:
            self._running -= 1
            self._drained_bytes += nbytes
            if self._running == 0:
                # window closed: report accumulated bytes over the
                # union busy time — the sink's actual drain bandwidth
                drained = (self._drained_bytes, _ns() - self._busy_start)
                self._drained_bytes = 0
            self._pending -= 1
            self._inflight -= nbytes
            group.remaining -= 1
            last = group.remaining == 0
            self._cv.notify_all()
        if drained is not None and self._on_drain is not None:
            self._on_drain(*drained)
        if last:
            # the extent's final byte has landed (or failed): only now is
            # it safe to hand its buffers back to the pool — a queued
            # write referenced them until this moment
            self._recycle(group.owner)
            group.owner = None  # release the sealed cluster's buffers
            if self._error is None:
                try:
                    self._extent_done(group.nbytes)
                except BaseException as e:
                    self._fail(e)

    def _run_job(self, group: _ExtentGroup, off: int, parts: List,
                 nbytes: int) -> None:
        t0 = self._job_begin()
        err = None
        try:
            if self._error is None:
                self._pwritev(off, parts)
        except BaseException as e:
            err = e
            if isinstance(e, OSError) and group.striped:
                # the group's other stripes may already be in flight, so
                # this extent cannot be rewritten monolithically; poison,
                # but stop striping future extents
                self._note_stripe_fallback()
        self._job_end(group, nbytes, t0, err)

    def _recycle(self, owner) -> None:
        """Return an extent owner's pooled buffers (``owner.recycle``)."""
        if owner is None or self.buffer_pool is None:
            return
        bufs = getattr(owner, "recycle", None)
        if bufs:
            self.buffer_pool.put_all(bufs)
            try:
                owner.recycle = None
            except AttributeError:
                pass

    def _fail(self, e: BaseException) -> None:
        with self._cv:
            if self._error is None:
                self._error = e
            self._cv.notify_all()
        if self._on_error is not None:
            self._on_error(e)

    # -- fsync policy ---------------------------------------------------------

    def _do_fsync(self) -> None:
        """One retried fsync; a final failure is accounted in IOStats
        before it propagates (callers decide how it poisons)."""
        try:
            self._retrying(self.sink.fsync)
        except BaseException:
            counter = getattr(self.sink, "_count_fsync_failure", None)
            if counter is not None:
                counter()
            raise

    def fsync(self) -> None:
        """Retrying fsync that poisons the writer on failure — the entry
        point the writer's journal barrier and close() use, so a failed
        final sync surfaces exactly like a failed write."""
        try:
            self._do_fsync()
        except BaseException as e:
            self._fail(e)
            raise

    def _extent_done(self, nbytes: int) -> None:
        """Apply the every-cluster / byte-interval fsync policy after an
        extent's bytes have fully landed.  Raises on (retry-exhausted)
        fsync failure: both the sync path and ``_job_end`` route that
        into ``_fail`` — the mid-run fsync error is never swallowed."""
        if self._fsync_every:
            self._do_fsync()
        elif self._fsync_interval:
            due = False
            with self._fsync_lock:
                self._since_fsync += nbytes
                if self._since_fsync >= self._fsync_interval:
                    self._since_fsync = 0
                    due = True
            if due:
                self._do_fsync()

    # -- drain / shutdown ------------------------------------------------------

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    def drain(self) -> None:
        """Block until every queued write job has finished (successfully
        or not).  The drain-before-footer barrier: any failure is already
        latched in the writer via ``on_error``; this never raises."""
        with self._cv:
            while self._pending:
                self._cv.wait()

    def close(self) -> None:
        """Drain and release workers.  Idempotent: a poisoned writer's
        second close (``__exit__`` after the first raised) must not touch
        an already-shut-down ring or pool."""
        if self._closed:
            return
        self._closed = True
        self.drain()
        if self._ring is not None:
            self._ring.close()
            self._ring = None
        if self._pool is not None:
            self._pool.shutdown(wait=True)
