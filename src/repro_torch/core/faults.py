"""Deterministic fault injection for the I/O paths (DESIGN.md §8.1, §10).

:class:`FaultInjectingSink` wraps any :class:`~repro_torch.core.container.Sink`
and injects storage faults on the way through: transient/permanent
``EIO``/``ENOSPC`` errors, short (torn) writes that persist a prefix and
then fail, torn reads, fsync failures, latency spikes, and *process-kill
points* that freeze the file at an exact byte count — the writer sees an
unrecoverable exception and everything written after the kill point is
lost, which is how the tests produce the torn files
that :mod:`repro_torch.core.recover` must salvage.

Faults come from two sources, combinable:

* **scripted** — an ordered list of :class:`FaultSpec` rules, each firing
  on a chosen operation at a chosen call index / file-offset window /
  cumulative-byte threshold, a bounded or unbounded number of times;
* **seeded** — a ``random.Random(seed)`` schedule injecting transient
  errors at ``error_rate`` per matching call.  Same seed, same workload →
  same fault sequence, so chaos runs are reproducible.

The decision core lives in :class:`FaultSchedule`, keyed by free-form op
names — the sink keys it by ``"write"``/``"fsync"``/``"read"``; the
remote :class:`~repro_torch.core.remote.FakeTransport` reuses the same engine
keyed by transport ops (``"put"``/``"part"``/``"get"``/``"create"``/
``"complete"``/``"abort"``), so one fault-plan vocabulary covers local
device chaos and simulated object-store chaos alike.

Because the base :class:`Sink.pwritev` decomposes vectored writes into one
``pwrite`` per part (and every concrete sink falls back to it when
``pwrite`` is overridden), this wrapper observes *every byte* of every
engine path — monolithic, striped, write-behind, and ring submission all
funnel through here.  The same holds on the read side: the base
``pread_into`` copies through ``pread``, and :class:`FaultInjectingSink`
additionally overrides ``pread_into`` itself so the reader's zero-copy
staging path sees the schedule first-hand (torn reads fill a prefix into
the caller's buffer before failing — exercising the stale-tail contract).
A wrapped sink never advertises ``native_ring``, so the engine cannot
bypass it through the kernel.

Byte-count determinism: ``at_byte`` thresholds count bytes *persisted to
the inner sink* (retried bytes count again).  With a single producer and
no write-behind the writer emits the file front to back, so the persisted
count equals the file offset — kill points map exactly onto the on-disk
layout.
"""

from __future__ import annotations

import errno
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from .container import MemorySink, Sink


class ProcessKilled(RuntimeError):
    """Raised when a kill-point fires: models the writing process dying
    mid-write.  Deliberately NOT an ``OSError`` — no retry policy applies;
    the failure is terminal and poisons the writer."""


@dataclass
class FaultSpec:
    """One scripted fault rule.

    op        -- "write", "fsync", or "read" on a sink; a transport op
                 name ("put", "part", "get", ...) on a FakeTransport
    kind      -- "error" | "short" | "latency" | "kill"
    err       -- errno for error/short kinds
    at_call   -- fire on the Nth matching call (0-based); None = any call
    at_offset -- fire when the op touches file offsets [lo, hi); None = any
    at_byte   -- fire when cumulative persisted write bytes cross this
                 threshold (write ops only); None = any
    count     -- times to fire (-1 = every matching call, i.e. permanent)
    fraction  -- portion of the write persisted (or of the read delivered)
                 before a short/kill fault when at_byte does not pin the
                 split point
    delay_s   -- sleep for latency faults
    """

    op: str = "write"
    kind: str = "error"
    err: int = errno.EIO
    at_call: Optional[int] = None
    at_offset: Optional[Tuple[int, int]] = None
    at_byte: Optional[int] = None
    count: int = 1
    fraction: float = 0.5
    delay_s: float = 0.0

    # -- common scenarios ---------------------------------------------------

    @staticmethod
    def transient_error(err: int = errno.EIO, count: int = 1, op: str = "write",
                        at_call: Optional[int] = None,
                        at_offset: Optional[Tuple[int, int]] = None) -> "FaultSpec":
        return FaultSpec(op=op, kind="error", err=err, count=count,
                         at_call=at_call, at_offset=at_offset)

    @staticmethod
    def permanent_error(err: int = errno.EIO, op: str = "write",
                        at_call: Optional[int] = None) -> "FaultSpec":
        return FaultSpec(op=op, kind="error", err=err, count=-1,
                         at_call=at_call)

    @staticmethod
    def short_write(err: int = errno.EIO, fraction: float = 0.5,
                    count: int = 1, at_call: Optional[int] = None,
                    at_byte: Optional[int] = None) -> "FaultSpec":
        return FaultSpec(op="write", kind="short", err=err, count=count,
                         fraction=fraction, at_call=at_call, at_byte=at_byte)

    @staticmethod
    def short_read(err: int = errno.EIO, fraction: float = 0.5,
                   count: int = 1, at_call: Optional[int] = None,
                   op: str = "read") -> "FaultSpec":
        """A torn response: a prefix of the requested bytes arrives, then
        the op fails with ``err`` (retryable — a fresh attempt may get the
        whole range)."""
        return FaultSpec(op=op, kind="short", err=err, count=count,
                         fraction=fraction, at_call=at_call)

    @staticmethod
    def fsync_error(err: int = errno.EIO, count: int = 1) -> "FaultSpec":
        return FaultSpec(op="fsync", kind="error", err=err, count=count)

    @staticmethod
    def latency(delay_s: float, op: str = "write", count: int = -1) -> "FaultSpec":
        return FaultSpec(op=op, kind="latency", delay_s=delay_s, count=count)

    @staticmethod
    def kill_at(byte: int, op: str = "write") -> "FaultSpec":
        """Kill the process once cumulative persisted bytes reach ``byte``:
        the crossing write persists exactly up to the threshold, then every
        subsequent operation raises :class:`ProcessKilled`."""
        return FaultSpec(op=op, kind="kill", at_byte=byte, count=1)


@dataclass
class FaultStats:
    errors: int = 0
    short_writes: int = 0
    short_reads: int = 0
    latencies: int = 0
    fsync_errors: int = 0
    kills: int = 0
    random_errors: int = 0

    @property
    def injected(self) -> int:
        return (self.errors + self.short_writes + self.short_reads
                + self.latencies + self.fsync_errors + self.kills)

    def as_dict(self) -> dict:
        return {
            "errors": self.errors, "short_writes": self.short_writes,
            "short_reads": self.short_reads,
            "latencies": self.latencies, "fsync_errors": self.fsync_errors,
            "kills": self.kills, "random_errors": self.random_errors,
            "injected": self.injected,
        }


def injected_os_error(err: int) -> OSError:
    return OSError(err, os.strerror(err) + " (injected)")


class FaultSchedule:
    """The scripted + seeded fault decision engine, keyed by op name.

    Holds the rule list, per-op call counters, the cumulative
    persisted-byte counter that ``at_byte`` rules trigger on, the
    dead-after-kill flag, and the :class:`FaultStats`.  Thread-safe.
    :class:`FaultInjectingSink` keys it by sink ops; the remote
    :class:`~repro_torch.core.remote.FakeTransport` keys the identical engine
    by transport ops — one schedule, one vocabulary, two fault surfaces.
    """

    def __init__(
        self,
        faults: Sequence[FaultSpec] = (),
        seed: Optional[int] = None,
        error_rate: float = 0.0,
        errnos: Sequence[int] = (errno.EIO,),
        random_ops: Sequence[str] = ("write",),
    ) -> None:
        self._rules: List[FaultSpec] = list(faults)
        self._fired = [0] * len(self._rules)
        self._rng = random.Random(seed) if seed is not None else None
        self._error_rate = float(error_rate)
        self._errnos = tuple(errnos)
        self._random_ops = frozenset(random_ops)
        self._mu = threading.Lock()
        self._calls: dict = {}
        self.persisted_bytes = 0   # bytes actually persisted downstream
        self.dead = False          # a kill point fired
        self.killed_at: Optional[int] = None
        self.stats = FaultStats()

    def decide(self, op: str, offset: int = 0, nbytes: int = 0):
        """Pick the fault (if any) for this call.  Returns (rule, persisted)
        where ``persisted`` is the byte counter before this operation."""
        with self._mu:
            idx = self._calls.get(op, 0)
            self._calls[op] = idx + 1
            persisted = self.persisted_bytes
            for i, r in enumerate(self._rules):
                if r.op != op:
                    continue
                if r.count >= 0 and self._fired[i] >= r.count:
                    continue
                if r.at_call is not None and r.at_call != idx:
                    continue
                if r.at_offset is not None and not (
                        offset < r.at_offset[1] and offset + max(nbytes, 1) > r.at_offset[0]):
                    continue
                if r.at_byte is not None:
                    if not (persisted <= r.at_byte < persisted + nbytes or
                            (persisted >= r.at_byte and r.kind == "kill")):
                        continue
                self._fired[i] += 1
                return r, persisted
            if (self._rng is not None and op in self._random_ops
                    and self._error_rate > 0.0
                    and self._rng.random() < self._error_rate):
                self.stats.random_errors += 1
                err = self._rng.choice(self._errnos)
                return FaultSpec(op=op, kind="error", err=err), persisted
        return None, persisted

    def advance(self, n: int) -> None:
        """Account ``n`` bytes as persisted (the ``at_byte`` clock)."""
        with self._mu:
            self.persisted_bytes += n

    def note_kill(self, at_byte: int) -> None:
        self.stats.kills += 1
        self.dead = True
        self.killed_at = at_byte

    def check_dead(self) -> None:
        if self.dead:
            raise ProcessKilled(
                f"process killed at byte {self.killed_at}; sink is dead")


class FaultInjectingSink(Sink):
    """Wrap ``inner`` and inject the given faults (see module docstring).

    Covers every :class:`Sink` read/write entry point: ``pwrite`` and
    ``fsync`` directly, ``pwritev`` through the base one-``pwrite``-per-
    part decomposition (every concrete sink falls back to it when
    ``pwrite`` is overridden — the vectored fast paths check
    ``type(self).pwrite``), and both ``pread`` and ``pread_into`` — the
    latter explicitly, so the reader's zero-copy staging reads cannot
    bypass the schedule.
    """

    def __init__(
        self,
        inner: Sink,
        faults: Sequence[FaultSpec] = (),
        seed: Optional[int] = None,
        error_rate: float = 0.0,
        errnos: Sequence[int] = (errno.EIO,),
        random_ops: Sequence[str] = ("write",),
    ) -> None:
        super().__init__()
        self.inner = inner
        self.schedule = FaultSchedule(
            faults, seed=seed, error_rate=error_rate, errnos=errnos,
            random_ops=random_ops,
        )

    # -- back-compat views onto the schedule --------------------------------

    @property
    def faults(self) -> FaultStats:
        return self.schedule.stats

    @property
    def persisted_bytes(self) -> int:
        return self.schedule.persisted_bytes

    @property
    def dead(self) -> bool:
        return self.schedule.dead

    @property
    def killed_at(self) -> Optional[int]:
        return self.schedule.killed_at

    # -- layout delegation (the wrapper owns no bytes) ----------------------

    def reserve(self, size: int) -> int:
        off = self.inner.reserve(size)
        self._end = self.inner.size
        return off

    @property
    def size(self) -> int:
        return self.inner.size

    def fallocate(self, offset: int, size: int) -> None:
        super().fallocate(offset, size)
        self.inner.fallocate(offset, size)

    def readable(self) -> bool:
        return self.inner.readable()

    def close(self) -> None:
        # teardown always works, dead or alive: the writer's poisoned
        # close path must be able to release the sink
        self.inner.close()

    # -- fault scheduling ---------------------------------------------------

    def _decide(self, op: str, offset: int, nbytes: int):
        return self.schedule.decide(op, offset, nbytes)

    def _advance(self, n: int) -> None:
        self.schedule.advance(n)

    def _check_dead(self) -> None:
        self.schedule.check_dead()

    @staticmethod
    def _os_error(err: int) -> OSError:
        return injected_os_error(err)

    # -- faulted operations -------------------------------------------------

    def pwrite(self, offset: int, data) -> None:
        self._check_dead()
        n = len(data)
        rule, persisted = self._decide("write", offset, n)
        if rule is None:
            self.inner.pwrite(offset, data)
            self._advance(n)
            self._count_write(1, n)
            return
        if rule.kind == "latency":
            self.faults.latencies += 1
            time.sleep(rule.delay_s)
            self.inner.pwrite(offset, data)
            self._advance(n)
            self._count_write(1, n)
            return
        # split point for torn writes / kills
        if rule.at_byte is not None:
            keep = max(0, min(n, rule.at_byte - persisted))
        else:
            keep = int(n * rule.fraction)
        if rule.kind == "error":
            self.faults.errors += 1
            raise self._os_error(rule.err)
        if keep:
            self.inner.pwrite(offset, bytes(memoryview(data)[:keep]))
            self._advance(keep)
            self._count_write(1, keep)
        if rule.kind == "short":
            self.faults.short_writes += 1
            raise self._os_error(rule.err)
        # kill
        self.schedule.note_kill(persisted + keep)
        raise ProcessKilled(f"process killed at byte {self.killed_at}")

    def fsync(self) -> None:
        self._check_dead()
        rule, _ = self._decide("fsync", 0, 0)
        if rule is not None:
            if rule.kind == "latency":
                self.faults.latencies += 1
                time.sleep(rule.delay_s)
            elif rule.kind == "kill":
                self.schedule.note_kill(self.persisted_bytes)
                raise ProcessKilled(f"process killed at byte {self.killed_at}")
            else:
                self.faults.fsync_errors += 1
                raise self._os_error(rule.err)
        super().fsync()
        self.inner.fsync()

    def _read_fault(self, rule: FaultSpec) -> Optional[Tuple[int, float]]:
        """Handle a read-op rule: sleeps for latency (returns None), raises
        for plain errors, and returns ``(err, fraction)`` for torn reads so
        the caller can deliver the prefix its path supports."""
        if rule.kind == "latency":
            self.faults.latencies += 1
            time.sleep(rule.delay_s)
            return None
        if rule.kind == "short":
            self.faults.short_reads += 1
            return rule.err, rule.fraction
        self.faults.errors += 1
        raise self._os_error(rule.err)

    def pread(self, offset: int, size: int) -> bytes:
        self._check_dead()
        rule, _ = self._decide("read", offset, size)
        if rule is not None:
            torn = self._read_fault(rule)
            if torn is not None:
                # a bytes-returning pread has nowhere to leave a prefix:
                # the torn response is just the error
                raise self._os_error(torn[0])
        out = self.inner.pread(offset, size)
        self._count_read(1, len(out))
        return out

    def pread_into(self, offset: int, buf) -> int:
        """The zero-copy read path under the same schedule as ``pread``.

        Without this override the base class would still funnel through
        the faulted ``pread`` — but via an extra copy, and a torn read
        could never exercise the caller's stale-prefix handling.  Torn
        reads here fill ``fraction`` of the caller's buffer before
        raising, exactly like a device delivering a partial DMA.
        """
        self._check_dead()
        mv = memoryview(buf)
        n = len(mv)
        rule, _ = self._decide("read", offset, n)
        if rule is not None:
            torn = self._read_fault(rule)
            if torn is not None:
                err, fraction = torn
                keep = int(n * fraction)
                if keep:
                    self.inner.pread_into(offset, mv[:keep])
                raise self._os_error(err)
        got = self.inner.pread_into(offset, mv)
        self._count_read(1, got)
        return got


def crashed_file_bytes(fault_sink: FaultInjectingSink) -> bytes:
    """The inner file's bytes as a crash would leave them on disk.

    Reserved-but-never-written regions read back as zeros (a sparse file's
    holes); everything past the persisted region of a :class:`MemorySink`
    is whatever was reserved — exactly what ``recover_container`` has to
    cope with."""
    inner = fault_sink.inner
    if isinstance(inner, MemorySink):
        return bytes(inner.buf[: inner.size])
    raise TypeError("crashed_file_bytes needs a MemorySink inner")


def memory_sink_from_bytes(data: bytes, slack: int = 0) -> MemorySink:
    """A readable/appendable :class:`MemorySink` over existing file bytes
    (the in-memory analog of opening a torn file for recovery).  ``slack``
    preallocates append headroom — without it, appending even a small
    footer to a large file doubles the backing bytearray (a realloc a
    recovery *benchmark* must keep out of its timings; a real file sink
    has no such cost)."""
    ms = MemorySink(len(data) + slack)
    ms.buf[: len(data)] = data
    ms._end = len(data)
    return ms
