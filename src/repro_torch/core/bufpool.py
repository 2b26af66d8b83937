"""Cluster-sized buffer pool: recycle the commit path's detached buffers.

The scatter-gather seal (DESIGN.md §6.1) made the assembly memcpy
disappear, but left an allocation behind: every raw-stored column's
buffer is *detached* into the sealed cluster's iovec plan, so the next
cluster pays a fresh ``np.empty`` per detached column — and with
write-behind every queued commit holds such buffers until its bytes
land.  At steady state that is a malloc/free pair per column per
cluster, exactly the allocator churn the ROOT I/O parallelism papers
identify as the wall after compression is parallel.

:class:`BufferPool` closes the loop (DESIGN.md §7 lists the knobs):

* **power-of-two size classes** — ``take(nbytes)`` rounds up to the next
  power of two and pops a buffer from that class; a miss allocates the
  class size, so every buffer ever returned fits its class exactly;
* **bounded residency** — ``put`` drops buffers once ``limit_bytes`` of
  storage is resident, so an adversarial size mix cannot hoard memory;
* **completion-driven recycling** — the I/O engine returns a sealed
  cluster's detached buffers the moment its extent's last write lands
  (never earlier: a queued write-behind commit still references them),
  and the reader recycles its decode scratch the same way.

Buffers are flat ``uint8`` numpy arrays internally; :meth:`take` hands
out the raw class-sized array and callers view/slice it as needed
(numpy views keep the base alive, and :meth:`put` walks back to the
base before filing a buffer into its class).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, replace
from typing import Dict, List, Optional

import numpy as np

# residency default: a handful of 8 MiB default clusters' worth of
# detached buffers — enough for double-buffered sealing plus a deep
# write-behind queue without hoarding
DEFAULT_LIMIT_BYTES = 64 * 1024 * 1024

_MIN_CLASS = 4096  # below this, malloc is cheaper than the pool round trip


@dataclass
class PoolStats:
    """Hit/miss accounting, merged into Writer/ReaderStats at close."""

    pool_hits: int = 0
    pool_misses: int = 0
    pool_returns: int = 0
    # returns rejected — residency bound reached, or storage the pool
    # never issued (non-power-of-two); always <= pool_returns
    pool_drops: int = 0

    def merge(self, other: "PoolStats") -> None:
        self.pool_hits += other.pool_hits
        self.pool_misses += other.pool_misses
        self.pool_returns += other.pool_returns
        self.pool_drops += other.pool_drops

    def snapshot(self) -> "PoolStats":
        return replace(self)

    @property
    def hit_rate(self) -> float:
        total = self.pool_hits + self.pool_misses
        return self.pool_hits / total if total else 0.0


def _base_array(arr: np.ndarray) -> np.ndarray:
    """Walk a view chain back to the owning ndarray."""
    while isinstance(arr.base, np.ndarray):
        arr = arr.base
    return arr


def _class_bytes(nbytes: int) -> int:
    """The power-of-two size class serving an ``nbytes`` request."""
    need = max(int(nbytes), _MIN_CLASS)
    return 1 << (need - 1).bit_length()


class BufferPool:
    """Thread-safe power-of-two recycler of flat ``uint8`` buffers.

    One pool per writer (``WriteOptions.buffer_pool_bytes``) or reader
    (``ReadOptions.buffer_pool_bytes``); producers, engine completion
    workers and decode workers all share it, so every method locks.
    """

    def __init__(self, limit_bytes: int = DEFAULT_LIMIT_BYTES):
        self.limit_bytes = int(limit_bytes)
        self._lock = threading.Lock()
        self._classes: Dict[int, List[np.ndarray]] = {}
        self._resident = 0
        self.stats = PoolStats()

    # -- introspection -------------------------------------------------------

    @property
    def resident_bytes(self) -> int:
        """Bytes currently parked in the pool (not handed out)."""
        with self._lock:
            return self._resident

    # -- take / put ----------------------------------------------------------

    def take(self, nbytes: int) -> np.ndarray:
        """A ``uint8`` buffer of at least ``nbytes`` (its size class).

        Pops from the smallest fitting class; a miss allocates the class
        size so the buffer files back into the same class on return.
        """
        cls = _class_bytes(nbytes)
        with self._lock:
            bucket = self._classes.get(cls)
            if bucket:
                self.stats.pool_hits += 1
                self._resident -= cls
                return bucket.pop()
            self.stats.pool_misses += 1
        return np.empty(cls, dtype=np.uint8)

    def take_view(self, nbytes: int) -> memoryview:
        """:meth:`take`, sliced to exactly ``nbytes`` as a memoryview
        (the base array rides along via the view, so :meth:`put` of the
        view's ``obj`` — or of any numpy view of it — recycles it)."""
        return memoryview(self.take(nbytes))[: int(nbytes)]

    def put(self, buf) -> None:
        """Return a buffer (or any view of one) to its size class.

        Accepts numpy arrays and memoryviews; walks views back to the
        owning array, rejects storage it cannot re-issue safely (foreign
        buffers, non-power-of-two sizes), and drops buffers beyond the
        residency bound.  Callers must guarantee nothing references the
        buffer anymore — the I/O engine only calls this after an
        extent's last byte has landed.
        """
        if buf is None:
            return
        if isinstance(buf, memoryview):
            buf = buf.obj
        if not isinstance(buf, np.ndarray):
            return
        arr = _base_array(buf)
        if not arr.flags.owndata or not arr.flags.c_contiguous:
            return
        nbytes = arr.nbytes
        if nbytes < _MIN_CLASS or nbytes & (nbytes - 1):
            # never pooled by take(): filing it would corrupt the class.
            # Counted as a (rejected) return so drops never exceed returns.
            with self._lock:
                self.stats.pool_returns += 1
                self.stats.pool_drops += 1
            return
        if arr.dtype != np.uint8:
            arr = arr.view(np.uint8).reshape(-1)
        elif arr.ndim != 1:
            arr = arr.reshape(-1)
        with self._lock:
            self.stats.pool_returns += 1
            if self._resident + nbytes > self.limit_bytes:
                self.stats.pool_drops += 1
                return
            self._resident += nbytes
            self._classes.setdefault(nbytes, []).append(arr)

    def put_all(self, bufs) -> None:
        for b in bufs:
            self.put(b)

    def snapshot(self) -> PoolStats:
        with self._lock:
            return self.stats.snapshot()


class Recyclable:
    """Owner handed to the I/O engine alongside an extent: ``recycle``
    carries the pooled buffers backing the extent's iovecs, returned to
    the engine's pool when the extent's last write lands (the same
    protocol ``SealedCluster.recycle`` uses)."""

    __slots__ = ("recycle",)

    def __init__(self, buffers):
        self.recycle = list(buffers)


def make_pool(limit_bytes: int) -> Optional[BufferPool]:
    """``BufferPool`` or ``None`` when pooling is disabled (0 bytes)."""
    return BufferPool(limit_bytes) if limit_bytes > 0 else None
