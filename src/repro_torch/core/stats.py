"""Instrumentation: lock, I/O, and per-phase time counters.

The paper diagnoses the buffered-vs-unbuffered scalability gap by counting
futex system calls under strace (§6.1: ~300 vs >27,000 at 64 threads).  On
Linux a futex syscall only happens when a lock is *contended*, so we count
both acquisitions and contended acquisitions, plus time held, and the sinks
count write syscalls and bytes.  These measurements are hardware-independent
and reproduce the paper's diagnosis exactly.

:class:`WriterStats` additionally breaks the write path into phases —
``fill`` (decompose + buffer append), ``seal`` (serialize, wall time),
``compress`` (summed per-page build time, a CPU-time view that exceeds the
seal wall time when a compression pool is active), ``commit`` (reserve +
metadata + write path) and ``io`` (time inside ``pwrite``) — so benchmarks
can attribute wins to the right layer.  All mutation goes through locked
``add_*``/``merge_*`` methods: with pipelined sealing, commits run on
background threads concurrently with producer fills.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional


def _merge_codec_stats(into: Dict[int, List[int]],
                       stats: Optional[Dict[int, List[int]]]) -> None:
    """Fold one ``{codec: [pages, bytes_in, bytes_out, ns]}`` map into
    another (the shared shape of writer and reader per-codec entries)."""
    if not stats:
        return
    for cid, vals in stats.items():
        st = into.setdefault(cid, [0, 0, 0, 0])
        for k in range(4):
            st[k] += vals[k]


def _codec_stats_dict(per_codec: Dict[int, List[int]]) -> dict:
    from . import compression as comp

    return {
        comp.codec_name(cid): {
            "pages": st[0],
            "bytes_in": st[1],
            "bytes_out": st[2],
            "ms": st[3] / 1e6,
        }
        for cid, st in sorted(per_codec.items())
    }


@dataclass
class LockStats:
    acquisitions: int = 0
    contended: int = 0
    held_ns: int = 0
    wait_ns: int = 0

    def merge(self, other: "LockStats") -> None:
        self.acquisitions += other.acquisitions
        self.contended += other.contended
        self.held_ns += other.held_ns
        self.wait_ns += other.wait_ns


class CountingLock:
    """A mutex that records acquisition counts, contention, and held time."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._meta = threading.Lock()  # guards the counters
        self.stats = LockStats()
        self._acquired_at = 0

    def acquire(self) -> None:
        t0 = time.perf_counter_ns()
        fast = self._lock.acquire(blocking=False)
        if not fast:
            self._lock.acquire()
        t1 = time.perf_counter_ns()
        with self._meta:
            self.stats.acquisitions += 1
            if not fast:
                self.stats.contended += 1
                self.stats.wait_ns += t1 - t0
        self._acquired_at = t1

    def release(self) -> None:
        held = time.perf_counter_ns() - self._acquired_at
        self._lock.release()
        with self._meta:
            self.stats.held_ns += held

    def snapshot(self) -> LockStats:
        """Consistent copy of the counters (safe to merge while live)."""
        with self._meta:
            return replace(self.stats)

    def __enter__(self) -> "CountingLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


@dataclass
class IOStats:
    write_calls: int = 0
    writev_calls: int = 0     # vectored (scatter-gather) submissions
    bytes_written: int = 0
    read_calls: int = 0
    bytes_read: int = 0
    fallocate_calls: int = 0
    fsync_calls: int = 0
    # fault handling (DESIGN.md §8.2): operations retried by the I/O
    # engine's RetryPolicy, operations that exhausted their retry budget,
    # and fsyncs that still failed after retrying
    retries: int = 0
    giveups: int = 0
    fsync_failures: int = 0
    # remote transport (DESIGN.md §10): hedged ranged reads launched, races
    # the hedge won, and multipart→serial-put degradations
    hedges: int = 0
    hedge_wins: int = 0
    degradations: int = 0

    def merge(self, other: "IOStats") -> None:
        self.write_calls += other.write_calls
        self.writev_calls += other.writev_calls
        self.bytes_written += other.bytes_written
        self.read_calls += other.read_calls
        self.bytes_read += other.bytes_read
        self.fallocate_calls += other.fallocate_calls
        self.fsync_calls += other.fsync_calls
        self.retries += other.retries
        self.giveups += other.giveups
        self.fsync_failures += other.fsync_failures
        self.hedges += other.hedges
        self.hedge_wins += other.hedge_wins
        self.degradations += other.degradations

    def snapshot(self) -> "IOStats":
        return replace(self)


@dataclass
class WriterStats:
    """Aggregated per-writer statistics, reported by the benchmarks.

    Thread-safe: concurrent producers and background seal/commit threads
    funnel updates through the locked ``add_*`` methods.
    """

    lock: LockStats = field(default_factory=LockStats)
    io: IOStats = field(default_factory=IOStats)
    uncompressed_bytes: int = 0
    compressed_bytes: int = 0
    fill_ns: int = 0         # producer time in decompose + buffer append
    seal_ns: int = 0         # wall time in serialization+compression (no lock held)
    compress_ns: int = 0     # summed per-page build time (CPU view of seal)
    commit_ns: int = 0       # time in commit path (reserve+metadata+write)
    io_ns: int = 0           # time inside pwrite/pwritev (any thread)
    # -- I/O engine (write-behind / striping, DESIGN.md §6) -----------------
    io_stall_ns: int = 0     # producer time blocked on the in-flight budget
    io_jobs: int = 0         # write jobs executed by the engine
    io_queue_peak: int = 0   # max write jobs queued/running at once
    io_inflight_peak: int = 0  # max write-behind bytes in flight at once
    # -- async submission + buffer pool (DESIGN.md §6.7/§6.8) ---------------
    io_submit_ns: int = 0    # producer time spent submitting queued extents
    # -- fault handling / degradation (DESIGN.md §8.2) -----------------------
    io_stripe_fallbacks: int = 0  # striping disabled after a stripe failure
    io_ring_fallbacks: int = 0    # native ring degraded to synchronous ops
    pool_hits: int = 0       # buffer-pool takes served from a size class
    pool_misses: int = 0     # buffer-pool takes that had to allocate
    pool_returns: int = 0    # buffers returned to the pool
    pool_drops: int = 0      # returns rejected (residency bound / foreign)
    entries: int = 0
    clusters: int = 0
    pages: int = 0
    # codec id -> [pages, bytes_in (uncompressed), bytes_out (stored),
    # compress_ns]: the per-codec attribution of the engine's work
    per_codec: Dict[int, List[int]] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self._mu = threading.Lock()

    # -- race-safe mutation -------------------------------------------------

    def add_sealed_cluster(self, sealed, commit_ns: int, io_ns: int = 0) -> None:
        with self._mu:
            self.commit_ns += commit_ns
            self.io_ns += io_ns
            self.seal_ns += sealed.seal_ns
            self.compress_ns += sealed.compress_ns
            self.clusters += 1
            self.pages += len(sealed.pages)
            self.entries += sealed.n_entries
            self.uncompressed_bytes += sealed.uncompressed_bytes
            self.compressed_bytes += sealed.size
            _merge_codec_stats(self.per_codec,
                               getattr(sealed, "codec_stats", None))

    def add_page(self, compressed_size: int, commit_ns: int = 0,
                 io_ns: int = 0, codec: Optional[int] = None,
                 uncompressed_size: int = 0, build_ns: int = 0) -> None:
        with self._mu:
            self.pages += 1
            self.compressed_bytes += compressed_size
            self.commit_ns += commit_ns
            self.io_ns += io_ns
            self.compress_ns += build_ns
            if codec is not None:
                _merge_codec_stats(self.per_codec, {
                    codec: [1, uncompressed_size, compressed_size, build_ns]
                })

    def add_cluster_meta(self, n_entries: int, uncompressed_bytes: int) -> None:
        with self._mu:
            self.clusters += 1
            self.entries += n_entries
            self.uncompressed_bytes += uncompressed_bytes

    def add_fill_ns(self, ns: int) -> None:
        with self._mu:
            self.fill_ns += ns

    def add_io_ns(self, ns: int) -> None:
        """Time inside pwrite/pwritev on an engine worker (write-behind:
        the io phase no longer happens on the committing thread)."""
        with self._mu:
            self.io_ns += ns

    def add_io_stall_ns(self, ns: int) -> None:
        with self._mu:
            self.io_stall_ns += ns

    def add_io_submit_ns(self, ns: int) -> None:
        """Producer time spent handing a queued extent to the engine
        (ring append / pool dispatch) — the submission overhead the async
        engine exists to shrink."""
        with self._mu:
            self.io_submit_ns += ns

    def merge_pool(self, snapshot) -> None:
        """Fold a :class:`~repro_torch.core.bufpool.PoolStats` snapshot in."""
        with self._mu:
            self.pool_hits += snapshot.pool_hits
            self.pool_misses += snapshot.pool_misses
            self.pool_returns += snapshot.pool_returns
            self.pool_drops += snapshot.pool_drops

    def note_stripe_fallback(self) -> None:
        with self._mu:
            self.io_stripe_fallbacks += 1

    def note_ring_fallback(self) -> None:
        with self._mu:
            self.io_ring_fallbacks += 1

    def note_io_job(self, queued: int, inflight: int) -> None:
        """One engine write job observed with ``queued`` jobs outstanding
        and ``inflight`` write-behind bytes admitted."""
        with self._mu:
            self.io_jobs += 1
            if queued > self.io_queue_peak:
                self.io_queue_peak = queued
            if inflight > self.io_inflight_peak:
                self.io_inflight_peak = inflight

    def merge_lock(self, snapshot: LockStats) -> None:
        with self._mu:
            self.lock.merge(snapshot)

    def merge_io(self, snapshot: IOStats) -> None:
        with self._mu:
            self.io.merge(snapshot)

    # -- reporting ----------------------------------------------------------

    def phases_ms(self) -> dict:
        """The per-phase time breakdown, in milliseconds."""
        return {
            "fill": self.fill_ns / 1e6,
            "seal": self.seal_ns / 1e6,
            "compress": self.compress_ns / 1e6,
            "commit": self.commit_ns / 1e6,
            "io": self.io_ns / 1e6,
        }

    def as_dict(self) -> dict:
        return {
            "entries": self.entries,
            "clusters": self.clusters,
            "pages": self.pages,
            "uncompressed_bytes": self.uncompressed_bytes,
            "compressed_bytes": self.compressed_bytes,
            "lock_acquisitions": self.lock.acquisitions,
            "lock_contended": self.lock.contended,
            "lock_held_ms": self.lock.held_ns / 1e6,
            "lock_wait_ms": self.lock.wait_ns / 1e6,
            "fill_ms": self.fill_ns / 1e6,
            "seal_ms": self.seal_ns / 1e6,
            "compress_ms": self.compress_ns / 1e6,
            "commit_ms": self.commit_ns / 1e6,
            "io_ms": self.io_ns / 1e6,
            "io_stall_ms": self.io_stall_ns / 1e6,
            "io_submit_ms": self.io_submit_ns / 1e6,
            "io_jobs": self.io_jobs,
            "io_queue_peak": self.io_queue_peak,
            "io_inflight_peak_bytes": self.io_inflight_peak,
            "pool_hits": self.pool_hits,
            "pool_misses": self.pool_misses,
            "pool_returns": self.pool_returns,
            "pool_drops": self.pool_drops,
            "phases_ms": self.phases_ms(),
            "per_codec": _codec_stats_dict(self.per_codec),
            "write_calls": self.io.write_calls,
            "writev_calls": self.io.writev_calls,
            "bytes_written": self.io.bytes_written,
            "fallocate_calls": self.io.fallocate_calls,
            "io_retries": self.io.retries,
            "io_giveups": self.io.giveups,
            "io_fsync_failures": self.io.fsync_failures,
            "io_hedges": self.io.hedges,
            "io_hedge_wins": self.io.hedge_wins,
            "io_degradations": self.io.degradations,
            "io_stripe_fallbacks": self.io_stripe_fallbacks,
            "io_ring_fallbacks": self.io_ring_fallbacks,
        }


@dataclass
class ReaderStats:
    """Aggregated per-reader statistics — the read-side mirror of
    :class:`WriterStats`.

    Phase breakdown (``phases_ms``):
      * ``io``         — time inside ``pread`` (after coalescing)
      * ``decompress`` — summed per-page entropy-decode time
      * ``decode``     — summed per-page unprecondition + offset-integration
        time (writes straight into the per-column output arrays)
      * ``wait``       — time the consumer blocked on the prefetch pipeline

    ``decompress``/``decode`` are summed per-page times: a CPU-time view
    that exceeds wall time when the decode pool is active (exactly like
    ``WriterStats.compress_ns`` on the write side).  Thread-safe: decode
    workers and the prefetch pipeline funnel updates through the locked
    ``add_*`` methods.
    """

    io: IOStats = field(default_factory=IOStats)
    clusters: int = 0
    pages: int = 0
    coalesced_reads: int = 0  # preads issued for page data after coalescing
    compressed_bytes: int = 0
    uncompressed_bytes: int = 0
    io_ns: int = 0            # time inside pread
    decompress_ns: int = 0    # summed per-page entropy decode
    decode_ns: int = 0        # summed per-page unprecondition/integration
    wait_ns: int = 0          # consumer blocked on the prefetch pipeline
    h2d_ns: int = 0           # staging upload (host->device transfer, §9)
    device_clusters: int = 0  # clusters decoded through the device chain
    pool_hits: int = 0        # reader buffer-pool takes served from a class
    pool_misses: int = 0      # reader buffer-pool takes that allocated
    pool_returns: int = 0
    pool_drops: int = 0
    # read-path retry accounting (DESIGN.md §8.2/§10): preads retried by
    # the reader's RetryPolicy and preads that exhausted their budget.
    # Sink-internal retries (the remote sink's transport loop) live in
    # ``io.retries`` instead, merged at close.
    retries: int = 0
    giveups: int = 0
    # zone-map pruning (DESIGN.md §11): clusters/pages the prune plan
    # skipped before any pread was issued for them
    clusters_pruned: int = 0
    pages_pruned: int = 0
    # codec id -> [pages, bytes_in (stored), bytes_out (decoded),
    # decompress_ns]: the read-side mirror of WriterStats.per_codec
    per_codec: Dict[int, List[int]] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self._mu = threading.Lock()

    # -- race-safe mutation -------------------------------------------------

    def add_cluster_read(
        self,
        pages: int,
        reads: int,
        compressed_bytes: int,
        uncompressed_bytes: int,
        io_ns: int,
        decompress_ns: int,
        decode_ns: int,
        per_codec: Optional[Dict[int, List[int]]] = None,
        clusters: int = 1,
    ) -> None:
        with self._mu:
            self.clusters += clusters
            self.pages += pages
            self.coalesced_reads += reads
            self.compressed_bytes += compressed_bytes
            self.uncompressed_bytes += uncompressed_bytes
            self.io_ns += io_ns
            self.decompress_ns += decompress_ns
            self.decode_ns += decode_ns
            _merge_codec_stats(self.per_codec, per_codec)

    def add_wait_ns(self, ns: int) -> None:
        with self._mu:
            self.wait_ns += ns

    def add_device_cluster(self, h2d_ns: int) -> None:
        with self._mu:
            self.device_clusters += 1
            self.h2d_ns += h2d_ns

    def add_decode_ns(self, ns: int) -> None:
        with self._mu:
            self.decode_ns += ns

    def add_retry(self) -> None:
        with self._mu:
            self.retries += 1

    def add_giveup(self) -> None:
        with self._mu:
            self.giveups += 1

    def add_pruned(self, clusters: int = 0, pages: int = 0) -> None:
        with self._mu:
            self.clusters_pruned += clusters
            self.pages_pruned += pages

    def merge_io(self, snapshot: IOStats) -> None:
        with self._mu:
            self.io.merge(snapshot)

    def merge_pool(self, snapshot) -> None:
        """Fold a :class:`~repro_torch.core.bufpool.PoolStats` snapshot in."""
        with self._mu:
            self.pool_hits += snapshot.pool_hits
            self.pool_misses += snapshot.pool_misses
            self.pool_returns += snapshot.pool_returns
            self.pool_drops += snapshot.pool_drops

    # -- reporting ----------------------------------------------------------

    def phases_ms(self) -> dict:
        return {
            "io": self.io_ns / 1e6,
            "decompress": self.decompress_ns / 1e6,
            "decode": self.decode_ns / 1e6,
            "wait": self.wait_ns / 1e6,
            "h2d": self.h2d_ns / 1e6,
        }

    def as_dict(self) -> dict:
        return {
            "clusters": self.clusters,
            "pages": self.pages,
            "coalesced_reads": self.coalesced_reads,
            "compressed_bytes": self.compressed_bytes,
            "uncompressed_bytes": self.uncompressed_bytes,
            "io_ms": self.io_ns / 1e6,
            "decompress_ms": self.decompress_ns / 1e6,
            "decode_ms": self.decode_ns / 1e6,
            "wait_ms": self.wait_ns / 1e6,
            "h2d_ms": self.h2d_ns / 1e6,
            "device_clusters": self.device_clusters,
            "pool_hits": self.pool_hits,
            "pool_misses": self.pool_misses,
            "pool_returns": self.pool_returns,
            "pool_drops": self.pool_drops,
            "phases_ms": self.phases_ms(),
            "per_codec": _codec_stats_dict(self.per_codec),
            "read_calls": self.io.read_calls,
            "bytes_read": self.io.bytes_read,
            "retries": self.retries,
            "giveups": self.giveups,
            "clusters_pruned": self.clusters_pruned,
            "pages_pruned": self.pages_pruned,
            "io_retries": self.io.retries,
            "io_giveups": self.io.giveups,
            "io_hedges": self.io.hedges,
            "io_hedge_wins": self.io.hedge_wins,
        }
