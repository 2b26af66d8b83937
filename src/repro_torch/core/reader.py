"""RNT-J read engine.

Knows nothing about parallel writing: it reads the anchor, footer, page
list and header and iterates clusters in entry order — which, by the
commit protocol, is exactly the sequential-equivalent order (paper §4.3).

A three-layer engine mirroring the write path's architecture:

1. **I/O coalescing** — a cluster's page descriptors are sorted by byte
   offset and adjacent/near ranges (hole ≤ ``ReadOptions.coalesce_gap``)
   merge into a few large ``pread``s; each page decodes from a zero-copy
   ``memoryview`` slice of its coalesced buffer.
2. **Parallel decode** — page decompression + decoding runs on a
   reader-owned worker pool (``decode_workers``; the same pool plumbing
   the writers use for compression, ``compression.make_pool``).  Every
   page decodes straight into its slice of ONE preallocated array per
   column (no ``np.concatenate``), and offset pages integrate their
   deltas through ``integrate_sizes`` (numpy: a page holds fewer
   elements than the offsets-scan kernel's size floor).
3. **Cluster prefetch** — ``iter_clusters`` keeps ``prefetch_clusters``
   clusters in flight on a background pool, so cluster *i+1* is being
   read and decoded while the caller consumes cluster *i* (double
   buffering at depth 1, the read-side analog of ``pipelined_seal``).

``ReaderStats`` breaks reader time into io / decompress / decode / wait
phases, mirroring ``WriterStats`` on the write side.
"""

from __future__ import annotations

import math
import os
import struct
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import decode_pages as dk
from repro_torch.kernels.ops import resolve_device

from . import compression as comp
from .bufpool import make_pool as make_buffer_pool
from .container import FileSink, Sink, open_sink
from .encoding import unprecondition_pages_into
from .filter import (
    EvalContext,
    Expr,
    T_FALSE,
    Zone,
    filter_paths,
    required_columns,
)
from .ioengine import Retrier, RetryPolicy
from .encoding import unprecondition_into
from .metadata import (
    ANCHOR_SIZE,
    ClusterMeta,
    decode_zonemaps,
    parse_anchor,
    parse_footer,
    parse_header,
    parse_member_sidecar,
    parse_pagelist,
)
from .pages import PageDesc, _thread_scratch, decode_page_into
from .schema import KIND_OFFSET, ColumnSpec, Schema, recompose_entries
from .stats import ReaderStats, _merge_codec_stats

_ns = time.perf_counter_ns


def _member_plan(d: PageDesc) -> Optional[List[Tuple[int, int, int, int]]]:
    """``[(compressed_off, csize, raw_off, usize)]`` member layout of a
    side-car'd chunk-framed page, or ``None`` when the record does not
    exactly tile the payload (then the page decodes serially)."""
    chunk = d.member_chunk
    if not d.members or chunk <= 0 or sum(d.members) != d.size:
        return None
    n = len(d.members)
    usize = d.uncompressed_size
    if not ((n - 1) * chunk < usize <= n * chunk):
        return None
    plan = []
    coff = 0
    for k, csz in enumerate(d.members):
        uoff = k * chunk
        plan.append((coff, csz, uoff, min(chunk, usize - uoff)))
        coff += csz
    return plan


@dataclass
class ReadOptions:
    """Read-engine tuning knobs (the read-side mirror of WriteOptions).

    * ``coalesce_gap`` — merge two page reads into one ``pread`` when the
      hole between them is at most this many bytes (reading and
      discarding a small hole is cheaper than a second syscall/seek).
      A negative value disables coalescing: one ``pread`` per page, the
      seed's behavior.
    * ``max_coalesced_bytes`` — cap on a single merged read, bounding
      buffer size.
    * ``decode_workers`` — size of the reader-owned page-decode pool
      (0 = decode on the calling thread).
    * ``prefetch_clusters`` — clusters kept in flight ahead of the
      consumer by the streaming iterators (``iter_clusters``,
      ``iter_entries``, ``read_column``); 0 = fully synchronous.
    * ``parallel_members`` — when the file carries the framed-member
      side-car, decompress a chunked page's members as independent
      pool jobs (needs ``decode_workers``); files without the side-car
      (or with it disabled) decode members serially inside one job.
    * ``buffer_pool_bytes`` — residency bound of the reader-owned
      :class:`~repro_torch.core.bufpool.BufferPool` (member-decompress scratch
      always recycles through it; 0 disables pooling).
    * ``recycle_buffers`` — draw the per-column decode output arrays from
      the pool and let :meth:`RNTJReader.iter_clusters` return the
      previous cluster's arrays once the consumer advances.  The yielded
      arrays are then only valid until the next iteration — strictly a
      streaming contract (``iter_entries``/``read_column`` never recycle,
      they may hold views across clusters).
    * ``device_decode`` — the fused device decode chain used by
      :meth:`RNTJReader.read_cluster_device` /
      :meth:`RNTJReader.iter_clusters_device` (DESIGN.md §9): ``"auto"``
      decodes on the reader's device — the CUDA kernels on a card, their
      plain PyTorch versions on ``device="cpu"``; ``"off"`` disables the
      device path entirely (the device entry points raise).  The
      host-path methods (``read_cluster``, ``iter_clusters``) never
      consult this knob.
    * ``retry_policy`` — retry transient pread failures (retryable
      ``OSError``: ``EIO``, ``ETIMEDOUT``, …) with exponential backoff
      before giving up, through the same
      :class:`~repro_torch.core.ioengine.Retrier` chokepoint the write engine
      uses.  Reader-level retries land in ``ReaderStats.retries`` /
      ``giveups``, distinct from any retrying the sink does internally
      (the remote sink's transport retries show up in ``io_retries``).
      ``None`` (default) preserves the fail-fast behavior: the first
      error raises.  Non-``OSError`` failures always raise.
    * ``filter`` — a :mod:`repro_torch.core.filter` predicate (built from
      ``F("path")`` comparisons).  ``iter_filtered`` evaluates it
      exactly; with ``prune`` on, the footer's zone maps compile into a
      per-cluster/per-page prune plan first, so clusters and pages that
      cannot satisfy the predicate are skipped before a single pread
      (DESIGN.md §11).  ``iter_clusters`` only *skips whole clusters*
      the plan proves empty — it still yields full clusters otherwise.
    * ``prune`` — consult zone maps for ``filter`` (on by default).
      Off, or on a file without the ``zonemaps`` footer extra, every
      path degrades to the exact unpruned scan — pruning is an
      optimization, never a correctness dependency.
    * ``tolerant`` — when the anchor/footer chain is missing or corrupt
      (a crashed writer), fall back to the journal scan of
      :mod:`repro_torch.core.recover` and serve whatever clusters it
      salvages; :attr:`RNTJReader.salvage` then carries the
      :class:`~repro_torch.core.recover.RecoveryReport` (``None`` on a
      normal open).  DESIGN.md §8.5.

    The full option table lives in DESIGN.md §7.
    """

    coalesce_gap: int = 256 * 1024
    max_coalesced_bytes: int = 32 * 1024 * 1024
    decode_workers: int = 0
    prefetch_clusters: int = 1
    parallel_members: bool = True
    buffer_pool_bytes: int = 32 * 1024 * 1024
    recycle_buffers: bool = False
    device_decode: str = "auto"
    retry_policy: Optional["RetryPolicy"] = None
    tolerant: bool = False
    filter: Optional["Expr"] = None
    prune: bool = True


DEVICE_DECODE_MODES = ("auto", "off")
#: byte alignment of each column's slot in the device staging buffer
STAGE_ALIGN = 256


def slice_entry_range(
    schema: Schema, cols: Dict[int, np.ndarray], e0: int, e1: int
) -> Dict[int, np.ndarray]:
    """Subset a range-local column dict to entries ``[e0, e1)``.

    Pure array math (no I/O): offset columns are walked parent-first to
    locate each column's element range and rebased so the result is
    again range-local.  ``cols`` must contain every ancestor offset
    column of every column it contains (readers always decode them)."""
    out: Dict[int, np.ndarray] = {}
    crng: Dict[int, Tuple[int, int]] = {}
    for ci in sorted(cols):
        p = schema.parent[ci]
        a, b = (e0, e1) if p == -1 else crng[p]
        arr = cols[ci]
        if schema.columns[ci].kind == KIND_OFFSET:
            base = int(arr[a - 1]) if a > 0 else 0
            end = int(arr[b - 1]) if b > a else base
            crng[ci] = (base, end)
            out[ci] = arr[a:b] - base
        else:
            out[ci] = arr[a:b]
    return out


class RNTJReader:
    """Reads RNT-J files; ``device`` (default ``"cuda"``) is where the
    device decode chain runs.  Without a card and without
    ``device="cpu"`` the constructor raises ``RuntimeError``."""

    def __init__(
        self,
        sink_or_path,
        verify_checksums: bool = True,
        options: Optional[ReadOptions] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if (options is not None
                and options.device_decode not in DEVICE_DECODE_MODES):
            raise ValueError(
                f"device_decode must be one of {DEVICE_DECODE_MODES}, "
                f"got {options.device_decode!r}"
            )
        owns_sink = isinstance(sink_or_path, (str, os.PathLike))
        if owns_sink:
            path = os.fspath(sink_or_path)
            if "://" in path:
                # remote URL: route through the scheme registry
                # (ObjectStoreSink in read mode — DESIGN.md §10)
                self.sink: Sink = open_sink(path, create=False)
            else:
                self.sink = FileSink(path, create=False)
        else:
            self.sink = sink_or_path
        self.verify = verify_checksums
        self.read_options = options or ReadOptions()
        self.stats = ReaderStats()
        # reader-level pread retry chokepoint (ReadOptions.retry_policy;
        # None = fail fast).  Counts land in ReaderStats.retries/giveups.
        self._retrier = Retrier(
            self.read_options.retry_policy,
            on_retry=self.stats.add_retry,
            on_giveup=self.stats.add_giveup,
        )
        self._decode_pool = None
        self._prefetch_pool = None
        self._pool_lock = threading.Lock()
        # reader-owned buffer pool: member-decompress scratch always
        # recycles through it; decode output arrays do too when
        # recycle_buffers is on (DESIGN.md §6.8)
        self._bufpool = make_buffer_pool(self.read_options.buffer_pool_bytes)
        self._closed = False
        self._plan_cache = None  # compiled prune plan (ReadOptions.filter)
        self.salvage = None  # RecoveryReport when a tolerant open salvaged
        try:
            if not self.sink.readable():
                raise IOError("sink is not readable")
            try:
                self._load_footer_metadata()
            except (IOError, ValueError, KeyError, struct.error):
                if not self.read_options.tolerant:
                    raise
                # torn or corrupt finalization metadata: fall back to the
                # journal scan and serve whatever it salvages (§8.5)
                from .recover import scan_container
                self.schema, self.options, self.clusters, self.salvage = (
                    scan_container(self.sink)
                )
                self.n_entries = self.salvage.entries_salvaged
                # the journal never carries zone maps (finalization
                # metadata): a salvaged open serves no stale bounds
                self.zonemaps = [None] * len(self.clusters)
            # column ranges: first element index of each column per cluster
            # (paper §3) — the running sums of per-cluster element counts.
            self.column_ranges = np.zeros(
                (len(self.clusters), self.schema.n_columns), dtype=np.int64
            )
            acc = np.zeros(self.schema.n_columns, dtype=np.int64)
            for i, cm in enumerate(self.clusters):
                self.column_ranges[i] = acc
                acc += np.asarray(cm.n_elements, dtype=np.int64)
            self.total_elements = acc
        except BaseException:
            # never leak a file we opened ourselves when the metadata is
            # corrupt — the exact failure mode skim workers retry on
            if owns_sink:
                self.sink.close()
            raise

    def _pread(self, offset: int, size: int) -> bytes:
        """Every reader pread funnels through here: the retry chokepoint
        (ReadOptions.retry_policy; pass-through when None)."""
        return self._retrier.call(self.sink.pread, offset, size)

    def _pread_into(self, offset: int, buf) -> int:
        return self._retrier.call(self.sink.pread_into, offset, buf)

    def _load_footer_metadata(self) -> None:
        """The normal open path: anchor → header → footer → page list."""
        size = self.sink.size
        anchor = parse_anchor(self._pread(size - ANCHOR_SIZE, ANCHOR_SIZE))
        hoff, hsize = anchor["header"]
        foff, fsize = anchor["footer"]
        self.schema, self.options = parse_header(self._pread(hoff, hsize))
        footer = parse_footer(self._pread(foff, fsize))
        pl_off, pl_size = footer["pagelist"]
        self.clusters: List[ClusterMeta] = parse_pagelist(
            self._pread(pl_off, pl_size)
        )
        # optional framed-member side-car: attach member layouts so
        # chunked pages can decompress as parallel pool jobs.  Old
        # files simply have no locator and decode serially as before.
        mc_loc = (footer.get("extra") or {}).get("members")
        if mc_loc:
            parse_member_sidecar(
                self._pread(mc_loc[0], mc_loc[1]), self.clusters
            )
        self.n_entries = int(footer["n_entries"])
        # optional per-page zone maps (DESIGN.md §11).  Old files have
        # no "zonemaps" extra and simply never prune; malformed stats
        # decode to None per cluster (decode_zonemaps is defensive).
        self.zonemaps = decode_zonemaps(
            (footer.get("extra") or {}).get("zonemaps"), len(self.clusters)
        ) or [None] * len(self.clusters)

    # -- worker pools --------------------------------------------------------

    def _get_decode_pool(self):
        if self.read_options.decode_workers and self._decode_pool is None:
            with self._pool_lock:
                if self._decode_pool is None:
                    self._decode_pool = comp.make_pool(
                        self.read_options.decode_workers, "rntj-decode"
                    )
        return self._decode_pool

    def _get_prefetch_pool(self):
        if self.read_options.prefetch_clusters and self._prefetch_pool is None:
            with self._pool_lock:
                if self._prefetch_pool is None:
                    self._prefetch_pool = comp.make_pool(
                        self.read_options.prefetch_clusters, "rntj-prefetch"
                    )
        return self._prefetch_pool

    # -- cluster-level access ------------------------------------------------

    @property
    def n_clusters(self) -> int:
        return len(self.clusters)

    def _alloc_column(self, ci: int, count: int) -> np.ndarray:
        """One decode output array — drawn from the reader's buffer pool
        when ``recycle_buffers`` is on (returned via :meth:`recycle`)."""
        dtype = self.schema.columns[ci].dtype
        if self._bufpool is not None and self.read_options.recycle_buffers:
            raw = self._bufpool.take(count * dtype.itemsize)
            return raw.view(dtype)[:count]
        return np.empty(count, dtype=dtype)

    def recycle(self, cols: Dict[int, np.ndarray]) -> None:
        """Return a cluster's decoded arrays to the reader's pool.

        Only call this when nothing references the arrays (or views of
        them) anymore; ``iter_clusters`` does it automatically for the
        previous cluster when ``ReadOptions.recycle_buffers`` is set.
        """
        if self._bufpool is None:
            return
        for arr in cols.values():
            self._bufpool.put(arr)

    def _coalesce(self, descs: List[PageDesc]) -> List[Tuple[int, int, List[PageDesc]]]:
        """Plan the cluster's reads: ``[(offset, end, pages)]`` ranges.

        Pages sort by byte offset; a page joins the previous range when
        the hole between them is ≤ ``coalesce_gap`` and the merged range
        stays under ``max_coalesced_bytes``.
        """
        o = self.read_options
        if o.coalesce_gap < 0:
            return [(d.offset, d.offset + d.size, [d]) for d in descs]
        ranges: List[List] = []
        for d in sorted(descs, key=lambda p: p.offset):
            if ranges:
                start, end, group = ranges[-1]
                if (
                    d.offset - end <= o.coalesce_gap
                    and d.offset + d.size - start <= o.max_coalesced_bytes
                ):
                    ranges[-1][1] = max(end, d.offset + d.size)
                    group.append(d)
                    continue
            ranges.append([d.offset, d.offset + d.size, [d]])
        return [(s, e, g) for s, e, g in ranges]

    def read_cluster(
        self, cluster_index: int, columns: Optional[Sequence[int]] = None
    ) -> Dict[int, np.ndarray]:
        """Read the element arrays of a cluster.

        Offset columns keep their on-disk cluster-relative form (ends of
        each collection within the cluster).  I/O is coalesced; pages
        decode — on the decode pool when one is configured — directly
        into one preallocated array per column, in page-list order.
        Consecutive stored-uncompressed pages of a column decode as ONE
        column-batched run (``unprecondition_pages_into``); the remaining
        pages decode per page, chunked to amortize pool dispatch.
        """
        cm = self.clusters[cluster_index]
        want = set(columns) if columns is not None else None
        targets = list(want) if want is not None else list(range(self.schema.n_columns))
        descs = [d for d in cm.pages if want is None or d.column in want]

        # one output array per column; pages fill slices in page-list order
        counts = {ci: 0 for ci in targets}
        for d in descs:
            counts[d.column] += d.n_elements
        out: Dict[int, np.ndarray] = {
            ci: self._alloc_column(ci, counts[ci]) for ci in targets
        }
        if not descs:
            return out
        pos = {}         # id(desc) -> first element index in its column array
        by_col: Dict[int, List[PageDesc]] = {}
        cursor = {ci: 0 for ci in targets}
        for d in descs:
            pos[id(d)] = cursor[d.column]
            cursor[d.column] += d.n_elements
            by_col.setdefault(d.column, []).append(d)

        # coalesced I/O
        ranges = self._coalesce(descs)
        t0 = _ns()
        bufs = [self._pread(start, end - start) for start, end, _ in ranges]
        io_ns = _ns() - t0
        loc = {}         # id(desc) -> (range index, zero-copy payload view)
        for ri, ((start, _end, group), buf) in enumerate(zip(ranges, bufs)):
            mv = memoryview(buf)
            for d in group:
                rel = d.offset - start
                loc[id(d)] = (ri, mv[rel : rel + d.size])

        # plan: column-batched runs of byte-contiguous stored pages vs
        # per-page decode (compressed pages, or broken adjacency) vs
        # member-parallel decompression (side-car'd chunk-framed pages)
        pool = self._get_decode_pool()
        run_jobs: List[Tuple] = []
        page_jobs: List[PageDesc] = []
        member_pages: List[PageDesc] = []
        use_members = pool is not None and self.read_options.parallel_members
        for ci, ds in by_col.items():
            i = 0
            while i < len(ds):
                d = ds[i]
                if d.codec != comp.CODEC_NONE:
                    if use_members and d.members and len(d.members) > 1:
                        member_pages.append(d)
                    else:
                        page_jobs.append(d)
                    i += 1
                    continue
                run = [d]
                per = d.n_elements
                j = i + 1
                while j < len(ds):
                    p, q = ds[j - 1], ds[j]
                    if (
                        q.codec == comp.CODEC_NONE
                        and loc[id(q)][0] == loc[id(p)][0]
                        and q.offset == p.offset + p.size
                        and p.n_elements == per
                        and q.n_elements <= per
                    ):
                        run.append(q)
                        j += 1
                    else:
                        break
                if len(run) == 1:
                    page_jobs.append(d)
                else:
                    run_jobs.append((ci, run, per))
                i = j

        def _decode_run(job):
            ci, run, per = job
            col = self.schema.columns[ci]
            if self.verify:
                for d in run:
                    if d.checksum and zlib.crc32(loc[id(d)][1]) != d.checksum:
                        raise IOError(
                            f"page checksum mismatch (column {col.path!r})"
                        )
            first, last = run[0], run[-1]
            ri = loc[id(first)][0]
            base = memoryview(bufs[ri])
            rel = first.offset - ranges[ri][0]
            raw = base[rel : rel + (last.offset + last.size - first.offset)]
            n = pos[id(last)] + last.n_elements - pos[id(first)]
            dst = out[ci][pos[id(first)] : pos[id(first)] + n]
            t0 = _ns()
            unprecondition_pages_into(raw, col.encoding, per, dst,
                                      _thread_scratch())
            nbytes = sum(d.size for d in run)
            return 0, _ns() - t0, {
                comp.CODEC_NONE: [len(run), nbytes, nbytes, 0]
            }

        def _decode_pages(chunk):
            dec = deco = 0
            per_codec = {}
            for d in chunk:
                s = pos[id(d)]
                a, b = decode_page_into(
                    loc[id(d)][1], d, self.schema.columns[d.column],
                    out[d.column][s : s + d.n_elements], self.verify,
                )
                dec += a
                deco += b
                st = per_codec.setdefault(d.codec, [0, 0, 0, 0])
                st[0] += 1
                st[1] += d.size
                st[2] += d.uncompressed_size
                st[3] += a
            return dec, deco, per_codec

        # wave 1 — member-parallel entropy decode:
        # each side-car'd page's members decompress as independent pool
        # jobs into one preallocated raw buffer per page; the page then
        # unpreconditions like any raw page in the main task wave.  A page
        # whose side-car record does not cover its payload falls back to
        # the serial whole-page path.
        member_state: Dict[int, Tuple[bytearray, List[int]]] = {}
        if member_pages:
            mjobs: List[Tuple] = []
            ok_pages: List[PageDesc] = []
            for d in member_pages:
                plan = _member_plan(d)
                if plan is None:
                    page_jobs.append(d)
                    continue
                payload = loc[id(d)][1]
                if self.verify and d.checksum and zlib.crc32(payload) != d.checksum:
                    raise IOError(
                        "page checksum mismatch (column "
                        f"{self.schema.columns[d.column].path!r})"
                    )
                # member scratch recycles through the reader pool: it is
                # internal (dropped right after the unprecondition copies
                # into the output array), so pooling it is always safe
                if self._bufpool is not None:
                    raw = self._bufpool.take_view(d.uncompressed_size)
                else:
                    raw = bytearray(d.uncompressed_size)
                member_state[id(d)] = (raw, [0])
                for coff, csz, uoff, ulen in plan:
                    mjobs.append((d, payload[coff : coff + csz], raw, uoff, ulen))
                ok_pages.append(d)
            member_pages = ok_pages

            def _run_member(job):
                d, part, raw, uoff, ulen = job
                t0 = _ns()
                raw[uoff : uoff + ulen] = comp.decompress(part, d.codec, ulen)
                return id(d), _ns() - t0

            for did, ns in pool.map(_run_member, mjobs):
                member_state[did][1][0] += ns

        def _decode_member_page(d):
            raw, acc = member_state[id(d)]
            col = self.schema.columns[d.column]
            s = pos[id(d)]
            t0 = _ns()
            unprecondition_into(
                raw, col.encoding, out[d.column][s : s + d.n_elements],
                _thread_scratch(),
            )
            if self._bufpool is not None:
                self._bufpool.put(raw)  # scratch fully copied out: recycle
            return acc[0], _ns() - t0, {
                d.codec: [1, d.size, d.uncompressed_size, acc[0]]
            }

        tasks = [(_decode_run, j) for j in run_jobs]
        tasks += [(_decode_member_page, d) for d in member_pages]
        if page_jobs:
            if pool is None:
                chunks = [page_jobs]
            else:
                # ~2 chunks per worker: parallelism without per-page futures
                k = max(1, len(page_jobs)
                        // (2 * self.read_options.decode_workers))
                chunks = [page_jobs[i : i + k]
                          for i in range(0, len(page_jobs), k)]
            tasks += [(_decode_pages, c) for c in chunks]
        if pool is None:
            times = [fn(arg) for fn, arg in tasks]
        else:
            times = list(pool.map(lambda t: t[0](t[1]), tasks))
        per_codec: Dict[int, List[int]] = {}
        for _dec, _deco, pc in times:
            _merge_codec_stats(per_codec, pc)
        self.stats.add_cluster_read(
            pages=len(descs),
            reads=len(ranges),
            compressed_bytes=sum(d.size for d in descs),
            uncompressed_bytes=sum(d.uncompressed_size for d in descs),
            io_ns=io_ns,
            decompress_ns=sum(t[0] for t in times),
            decode_ns=sum(t[1] for t in times),
            per_codec=per_codec,
        )
        return out

    def cluster_entry_range(self, cluster_index: int) -> Tuple[int, int]:
        cm = self.clusters[cluster_index]
        return cm.first_entry, cm.first_entry + cm.n_entries

    # -- zone-map pruning (DESIGN.md §11) ------------------------------------

    def _fold_zone(self, i: int, ci: int) -> Optional[Zone]:
        """Cluster-level :class:`Zone` of leaf column ``ci`` in cluster
        ``i`` — the fold of its page rows — or ``None`` when the cluster
        carries no stats for it."""
        cm = self.clusters[i]
        nested = self.schema.parent[ci] != -1
        count = int(cm.n_elements[ci])
        if count == 0:
            return Zone.empty(nested)
        zm = self.zonemaps[i]
        d = None if zm is None else zm.get(ci)
        if d is None or "lo" not in d:
            return None
        lo = hi = None
        for v, w in zip(d["lo"], d["hi"]):
            if isinstance(v, float) and math.isnan(v):
                continue  # all-NaN page: contributes no bounds
            if lo is None or v < lo:
                lo = v
            if hi is None or w > hi:
                hi = w
        return Zone(lo, hi, int(sum(d.get("nn", ()))), count, nested)

    def _page_counts(self, cm: ClusterMeta) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for d in cm.pages:
            out.setdefault(d.column, []).append(d.n_elements)
        return out

    def _prune_plan(self):
        """Compile ``ReadOptions.filter`` against the footer zone maps.

        Returns one slot per cluster: ``None`` — no pruning possible,
        read the whole cluster; ``[]`` — the zone maps prove no entry
        can match, skip the cluster entirely; else the surviving
        half-open entry ranges ``[(e0, e1), ...]`` (cluster-relative).
        Returns ``None`` overall when no filter is set or pruning is
        disabled.  The plan is conservative: ranges are a *superset* of
        the matching entries; exactness comes from re-evaluating the
        predicate on what they decode.
        """
        o = self.read_options
        expr = o.filter
        if expr is None or not o.prune:
            return None
        if self._plan_cache is not None:
            return self._plan_cache
        expr.validate(self.schema)
        paths = filter_paths(self.schema, expr)
        plan: List[Optional[List[Tuple[int, int]]]] = []
        for i, cm in enumerate(self.clusters):
            plan.append(self._plan_cluster(i, cm, expr, paths))
        self._plan_cache = plan
        return plan

    def _plan_cluster(self, i, cm, expr, paths):
        n = cm.n_entries
        zm = self.zonemaps[i]
        if zm is None or n == 0:
            return None
        # cluster-scope zones: one fold per filter column.  A column
        # without stats stays out of the dict (= unconstrained).
        zones: Dict[str, Zone] = {}
        for path, ci in paths.items():
            z = self._fold_zone(i, ci)
            if z is not None:
                zones[path] = z
        if expr.zone_eval(zones) == T_FALSE:
            return []
        # per-page refinement: restrict one filter column at a time to a
        # single page's zone (the others stay at cluster scope) and keep
        # the page's entry range unless the verdict is T_FALSE.
        page_counts = self._page_counts(cm)
        cand = np.ones(n, dtype=bool)
        for path, ci in paths.items():
            d = zm.get(ci)
            if d is None or "lo" not in d:
                continue
            fe, le = d["fe"], d["le"]
            counts = page_counts.get(ci)
            if counts is None or len(counts) != len(fe):
                continue  # inconsistent stats: no refinement from ci
            nested = self.schema.parent[ci] != -1
            nn = d.get("nn") or [0] * len(fe)
            keep = np.zeros(n, dtype=bool)
            covered = np.zeros(n, dtype=bool)
            ok = True
            for k in range(len(fe)):
                a, b = int(fe[k]), int(le[k])
                if a < 0 or b >= n or b < a or (k and a < int(fe[k - 1])):
                    ok = False  # corrupt row: refine nothing from ci
                    break
                covered[a : b + 1] = True
                pz = Zone(d["lo"][k], d["hi"][k], int(nn[k]),
                          int(counts[k]), nested)
                if expr.zone_eval({**zones, path: pz}) != T_FALSE:
                    keep[a : b + 1] = True
            if not ok:
                continue
            # an entry whose elements STRADDLE pages is only soundly
            # judged by a zone covering all of them: re-judge every
            # boundary-shared entry against the fold of its pages
            for k in range(1, len(fe)):
                e = int(fe[k])
                if e > int(le[k - 1]) or keep[e]:
                    continue
                span = [j for j in range(len(fe))
                        if int(fe[j]) <= e <= int(le[j])]
                lo = hi = None
                nnn = cnt = 0
                for j in span:
                    v, w = d["lo"][j], d["hi"][j]
                    if not (isinstance(v, float) and math.isnan(v)):
                        lo = v if lo is None or v < lo else lo
                        hi = w if hi is None or w > hi else hi
                    nnn += int(nn[j])
                    cnt += int(counts[j])
                fz = Zone(lo, hi, nnn, cnt, nested)
                if expr.zone_eval({**zones, path: fz}) != T_FALSE:
                    keep[e] = True
            if not covered.all():
                # entries with no element in this column (empty
                # collections in page-boundary gaps): judge them
                # against an empty zone
                if expr.zone_eval(
                    {**zones, path: Zone.empty(nested)}
                ) != T_FALSE:
                    keep |= ~covered
            cand &= keep
        if cand.all():
            return None
        if not cand.any():
            return []
        d8 = np.diff(cand.astype(np.int8), prepend=0, append=0)
        starts = np.nonzero(d8 == 1)[0]
        ends = np.nonzero(d8 == -1)[0]
        return list(zip(starts.tolist(), ends.tolist()))

    def _pages_of(self, cm: ClusterMeta,
                  columns: Optional[Sequence[int]]) -> int:
        if columns is None:
            return len(cm.pages)
        want = set(columns)
        return sum(1 for d in cm.pages if d.column in want)

    def _expand_ancestors(
        self, columns: Optional[Sequence[int]]
    ) -> Optional[set]:
        """Requested columns plus every ancestor offset column (which
        locate the element ranges), or ``None`` for "all columns"."""
        if columns is None:
            return None
        want = set(columns)
        for ci in list(want):
            p = self.schema.parent[ci]
            while p != -1:
                want.add(p)
                p = self.schema.parent[p]
        return want

    def read_entry_range(
        self,
        cluster_index: int,
        e0: int,
        e1: int,
        columns: Optional[Sequence[int]] = None,
        _page_cache: Optional[Dict[int, np.ndarray]] = None,
    ) -> Dict[int, np.ndarray]:
        """Decode one entry range ``[e0, e1)`` of a cluster (entries are
        cluster-relative), reading only the pages that overlap it.

        Returns ``{column: array}`` where offset columns hold
        **range-local** end offsets (rebased so the range recomposes
        like a miniature cluster).  Ancestor offset columns of every
        requested column ride along — they locate the element ranges.

        ``_page_cache`` (one dict per cluster, shared across the ranges
        of a prune plan) memoizes decoded pages so adjacent ranges that
        straddle a page boundary never pread or decode that page twice —
        the pruned path can only ever read *fewer* pages than a full
        cluster scan, never more.

        ``ReaderStats.pages_pruned`` accounting is owned by the CALLER:
        a plan-driven iterator counts each cluster exactly once, as its
        page total minus the distinct pages decoded (``len(cache)``).
        Per-call accounting here would re-count the same unread pages
        for every range issued against one cluster, so a standalone
        range read contributes nothing to ``pages_pruned`` (``clusters``
        is likewise not bumped: range reads are sub-cluster).
        """
        cm = self.clusters[cluster_index]
        want = self._expand_ancestors(columns)
        if want is None:
            want = set(range(self.schema.n_columns))
        targets = sorted(want)  # schema order: parents precede children
        by_col: Dict[int, List[PageDesc]] = {ci: [] for ci in targets}
        for dsc in cm.pages:
            if dsc.column in want:
                by_col[dsc.column].append(dsc)

        out: Dict[int, np.ndarray] = {}
        child_range: Dict[int, Tuple[int, int]] = {}
        pages_read = reads = cbytes = ubytes = 0
        io_ns = deco_ns = dec_ns = 0
        for ci in targets:
            col = self.schema.columns[ci]
            is_off = col.kind == KIND_OFFSET
            p = self.schema.parent[ci]
            a, b = (e0, e1) if p == -1 else child_range[p]
            # offset columns fetch one extra leading element: the end of
            # the previous collection is the range's rebase base
            fa = max(a - 1, 0) if is_off else a
            ds = by_col[ci]
            if b <= fa or not ds:
                out[ci] = np.empty(0, dtype=col.dtype)
                if is_off:
                    child_range[ci] = (0, 0)
                continue
            starts = [0]
            for dsc in ds:
                starts.append(starts[-1] + dsc.n_elements)
            k0 = np.searchsorted(starts, fa, side="right") - 1
            kl = np.searchsorted(starts, b - 1, side="right") - 1
            picked = ds[k0 : kl + 1]
            fetch = (picked if _page_cache is None else
                     [dsc for dsc in picked if id(dsc) not in _page_cache])
            if fetch:
                ranges = self._coalesce(fetch)
                t0 = _ns()
                bufs = [self._pread(s, e - s) for s, e, _ in ranges]
                io_ns += _ns() - t0
                loc = {}
                for (s, _e, group), raw in zip(ranges, bufs):
                    mv = memoryview(raw)
                    for dsc in group:
                        rel = dsc.offset - s
                        loc[id(dsc)] = mv[rel : rel + dsc.size]
                pages_read += len(fetch)
                reads += len(ranges)
                cbytes += sum(dsc.size for dsc in fetch)
                ubytes += sum(dsc.uncompressed_size for dsc in fetch)
            if _page_cache is None:
                buf = np.empty(starts[kl + 1] - starts[k0], dtype=col.dtype)
                off = 0
                for dsc in picked:
                    da, db = decode_page_into(
                        loc[id(dsc)], dsc, col,
                        buf[off : off + dsc.n_elements], self.verify,
                    )
                    dec_ns += da
                    deco_ns += db
                    off += dsc.n_elements
            else:
                for dsc in fetch:
                    pb = np.empty(dsc.n_elements, dtype=col.dtype)
                    da, db = decode_page_into(
                        loc[id(dsc)], dsc, col, pb, self.verify,
                    )
                    dec_ns += da
                    deco_ns += db
                    _page_cache[id(dsc)] = pb
                arrs = [_page_cache[id(dsc)] for dsc in picked]
                buf = arrs[0] if len(arrs) == 1 else np.concatenate(arrs)
            sl = buf[fa - starts[k0] : b - starts[k0]]
            if is_off:
                base = int(sl[0]) if a > 0 else 0
                vals = sl[1:] if a > 0 else sl
                child_range[ci] = (
                    base, int(vals[-1]) if len(vals) else base
                )
                out[ci] = vals - base
            else:
                out[ci] = sl
        self.stats.add_cluster_read(
            pages=pages_read, reads=reads, compressed_bytes=cbytes,
            uncompressed_bytes=ubytes, io_ns=io_ns, decompress_ns=dec_ns,
            decode_ns=deco_ns, clusters=0,
        )
        return out

    def iter_cluster_segments(
        self,
        columns: Optional[Sequence[int]] = None,
        start: int = 0,
        stop: Optional[int] = None,
    ) -> Iterator[Tuple[int, List[Tuple[int, Dict[int, np.ndarray], int]]]]:
        """The shared entry-range-selection helper (skim engine +
        :meth:`iter_filtered`).

        Yields ``(cluster_index, segments)`` for EVERY cluster in entry
        order, ``segments`` being ``[(first_entry, cols, n_entries),
        ...]`` with cluster-relative ``first_entry`` and range-local
        arrays.  Without an applicable filter each cluster yields one
        full-cluster segment (the arrays of :meth:`iter_clusters`); with
        one, only zone-surviving entry ranges are decoded and fully
        pruned clusters yield ``(i, [])`` — so pruned and unpruned
        consumers see identical per-cluster grouping (the skim engine's
        byte-identity contract).
        """
        plan = self._prune_plan()
        n = self.n_clusters
        if stop is None or stop > n:
            stop = n
        if plan is None:
            for i, cols in self.iter_clusters(columns, start, stop,
                                              recycle=False):
                yield i, [(0, cols, self.clusters[i].n_entries)]
            return

        def read_segments(i):
            p = plan[i]
            if p is None:
                return [(0, self.read_cluster(i, columns),
                         self.clusters[i].n_entries)]
            # one decoded-page cache per cluster: ranges that straddle a
            # page boundary share the decode, so the pruned path never
            # reads more pages than the full-cluster scan would
            cache: Dict[int, np.ndarray] = {}
            segs = [(a, self.read_entry_range(i, a, b, columns,
                                              _page_cache=cache), b - a)
                    for a, b in p]
            want = self._expand_ancestors(columns)
            total = self._pages_of(
                self.clusters[i], None if want is None else sorted(want))
            self.stats.add_pruned(pages=max(total - len(cache), 0))
            return segs

        depth = self.read_options.prefetch_clusters
        pool = self._get_prefetch_pool() if depth > 0 else None
        live = [i for i in range(start, stop) if plan[i] != []]
        skipped = [i for i in range(start, stop) if plan[i] == []]
        for i in skipped:
            self.stats.add_pruned(
                clusters=1, pages=self._pages_of(self.clusters[i], columns)
            )
        if pool is None:
            for i in range(start, stop):
                yield i, ([] if plan[i] == [] else read_segments(i))
            return
        # double-buffered like iter_clusters: only live clusters occupy
        # prefetch slots; skipped ones yield [] inline (no I/O at all)
        pending: deque = deque()
        live_iter = iter(live)

        def top_up():
            while len(pending) < depth:
                j = next(live_iter, None)
                if j is None:
                    return
                pending.append((j, pool.submit(read_segments, j)))

        top_up()
        try:
            for i in range(start, stop):
                if plan[i] == []:
                    yield i, []
                    continue
                _j, fut = pending.popleft()
                t0 = _ns()
                got = fut.result()
                self.stats.add_wait_ns(_ns() - t0)
                top_up()
                yield i, got
        finally:
            for _, fut in pending:
                fut.cancel()

    def _live_clusters(
        self, start: int, stop: Optional[int],
        columns: Optional[Sequence[int]]
    ) -> List[int]:
        """Cluster indices to iterate after the cluster-level prune skip
        (``ReadOptions.filter``): clusters whose zone maps prove no
        entry can match drop out before any pread is issued for them
        (counted in ``ReaderStats.clusters_pruned``)."""
        n = self.n_clusters
        if stop is None or stop > n:
            stop = n
        plan = self._prune_plan()
        if plan is None:
            return list(range(start, stop))
        out = []
        for i in range(start, stop):
            if plan[i] == []:
                self.stats.add_pruned(
                    clusters=1,
                    pages=self._pages_of(self.clusters[i], columns),
                )
            else:
                out.append(i)
        return out

    def iter_filtered(
        self,
        columns: Optional[Sequence[int]] = None,
        start: int = 0,
        stop: Optional[int] = None,
    ) -> Iterator[Tuple[int, int, Dict[int, np.ndarray], int]]:
        """Exact filtered iteration over ``ReadOptions.filter``.

        Yields ``(cluster_index, absolute_first_entry, cols, n_entries)``
        for every maximal run of entries matching the predicate.  Two
        phases per zone-surviving segment: the filter's columns decode
        first and the predicate is evaluated exactly; the remaining
        requested columns are then **late-materialized** only for the
        matching runs.  ``cols`` carries the requested columns plus the
        filter's columns and any ancestor offsets, all range-local.

        The matching runs of one cluster late-materialize through ONE
        shared decoded-page cache (mirroring the phase-1 reads inside
        :meth:`iter_cluster_segments`), so adjacent runs never pread or
        decode a shared page twice — the pruned read touches no more
        pages than the unpruned scan here too.  Skipped pages of the
        late-materialized columns are counted in
        ``ReaderStats.pages_pruned`` once per cluster.
        """
        expr = self.read_options.filter
        if expr is None:
            raise ValueError("iter_filtered requires ReadOptions.filter")
        expr.validate(self.schema)
        freq = required_columns(self.schema, expr)
        want = (set(columns) if columns is not None
                else set(range(self.schema.n_columns)))
        phase1 = sorted(set(freq))
        rest = sorted(want - set(phase1))
        rest_want = (sorted(self._expand_ancestors(rest))
                     if rest else None)
        for i, segs in self.iter_cluster_segments(columns=phase1,
                                                  start=start, stop=stop):
            abs0 = self.clusters[i].first_entry
            cache: Dict[int, np.ndarray] = {}
            for e0, cols, n in segs:
                if n == 0:
                    continue
                mask = expr.evaluate(EvalContext(self.schema, cols, n))
                if not mask.any():
                    continue
                d8 = np.diff(mask.astype(np.int8), prepend=0, append=0)
                rs = np.nonzero(d8 == 1)[0].tolist()
                re_ = np.nonzero(d8 == -1)[0].tolist()
                for r0, r1 in zip(rs, re_):
                    out: Dict[int, np.ndarray] = {}
                    if rest:
                        out.update(self.read_entry_range(
                            i, e0 + r0, e0 + r1, rest, _page_cache=cache
                        ))
                    # the filter columns slice straight out of phase 1
                    out.update(
                        slice_entry_range(self.schema, cols, r0, r1)
                    )
                    yield i, abs0 + e0 + r0, out, r1 - r0
            if rest and segs:
                # zone-skipped clusters (segs == []) are accounted inside
                # iter_cluster_segments; surviving ones account their
                # late-materialization columns here, once per cluster
                total = self._pages_of(self.clusters[i], rest_want)
                self.stats.add_pruned(pages=max(total - len(cache), 0))

    # -- the device decode path (DESIGN.md §9) -------------------------------

    def _plan_device_cluster(self, cluster_index: int, targets: Sequence[int]):
        """Split a cluster's columns into device plans and host fallbacks,
        and lay out the staging buffer.

        A column decodes on device when its pages are *uniform* (every
        page but the last carries the same element count — the sealed
        layout), its element width survives 32-bit lanes (8-byte leaf
        columns fall back, as in the reference), and — for offset
        columns — the cluster's child element total fits int32, which
        makes the fused int32 offsets EXACT (§9).  Everything else
        decodes through the host path unchanged.
        """
        cm = self.clusters[cluster_index]
        by_col: Dict[int, List[PageDesc]] = {}
        want = set(targets)
        for d in cm.pages:
            if d.column in want:
                by_col.setdefault(d.column, []).append(d)
        plans: List[Dict] = []
        fallback: List[int] = []
        base = 0
        for ci in targets:
            ds = by_col.get(ci, [])
            col = self.schema.columns[ci]
            n = sum(d.n_elements for d in ds)
            nb = col.itemsize
            per = ds[0].n_elements if ds else 0
            uniform = bool(ds) and all(
                d.n_elements == per for d in ds[:-1]
            ) and ds[-1].n_elements <= per
            ok_bytes = all(
                d.uncompressed_size == d.n_elements * nb for d in ds
            )
            route = None
            if n and uniform and ok_bytes:
                enc = col.encoding
                if enc == "none" and nb < 8:
                    route = "none"
                elif enc == "split" and nb < 8:
                    route = "split"
                elif enc == "dzs" and col.kind == KIND_OFFSET:
                    kids = [
                        k for k, p in enumerate(self.schema.parent) if p == ci
                    ]
                    if kids and int(cm.n_elements[kids[0]]) < 2**31:
                        route = "offsets"
            if route is None:
                fallback.append(ci)
                continue
            plans.append({"ci": ci, "descs": ds, "per": per, "n": n,
                          "nb": nb, "base": base, "route": route})
            # each column starts STAGE_ALIGN-aligned, so the kernels'
            # 16-byte vector paths apply to every column on the card
            base += -(-(n * nb) // STAGE_ALIGN) * STAGE_ALIGN
        return plans, fallback, base

    def _stage_cluster_device(self, cluster_index: int,
                              columns: Optional[Sequence[int]]):
        """The HOST half of the device decode: pread + entropy-decode the
        cluster's device-eligible pages into ONE pooled staging buffer
        (page ``p`` of a column at byte range ``[p*per*nb, p*per*nb +
        k*nb)``), then run the single H2D upload to the reader's device.
        Returns ``(plans, device_bytes, fallback_columns, staging)``.
        ``iter_clusters_device`` runs this on the prefetch pool so
        cluster *N+1*'s I/O, decompression and upload overlap cluster
        *N*'s device decode.

        The staging buffer rides along in the return value because the
        caller must recycle it only AFTER the device half: on
        ``device="cpu"`` the upload ``.to(device)`` returns the staging
        memory itself, so ``dev`` aliases ``staging`` — recycling it here
        would let the next cluster's fill clobber this cluster's device
        bytes mid-decode.  (The none route copies for the same reason:
        its bitcast is a view of ``dev``.)
        """
        targets = (list(columns) if columns is not None
                   else list(range(self.schema.n_columns)))
        plans, fallback, total = self._plan_device_cluster(
            cluster_index, targets
        )
        if not plans:
            return [], None, fallback, None
        descs = [d for p in plans for d in p["descs"]]
        slot = {}  # id(desc) -> staging byte offset of the page's payload
        for p in plans:
            stride = p["per"] * p["nb"]
            for k, d in enumerate(p["descs"]):
                slot[id(d)] = p["base"] + k * stride

        if self._bufpool is not None:
            staging = self._bufpool.take(total)
        else:
            staging = np.empty(total, dtype=np.uint8)

        # Fast path: a codec-none column whose pages sit contiguously in
        # the file already IS in sealed staging layout — pread straight
        # into its staging slot, skipping the bounce buffer and the
        # memcpy pass entirely.
        direct, rest = [], []
        for p in plans:
            ds = p["descs"]
            stride = p["per"] * p["nb"]
            if ds and all(d.codec == comp.CODEC_NONE
                          and d.offset == ds[0].offset + k * stride
                          for k, d in enumerate(ds)):
                direct.append(p)
            else:
                rest.extend(p["descs"])

        smv = memoryview(staging)
        t0 = _ns()
        for p in direct:
            nbytes = sum(d.size for d in p["descs"])
            self._pread_into(
                p["descs"][0].offset, smv[p["base"] : p["base"] + nbytes]
            )
        ranges = self._coalesce(rest)
        bufs = [self._pread(start, end - start) for start, end, _ in ranges]
        io_ns = _ns() - t0
        if self.verify:
            for p in direct:
                for d in p["descs"]:
                    s = slot[id(d)]
                    if d.checksum and zlib.crc32(smv[s : s + d.size]) != d.checksum:
                        raise IOError(
                            "page checksum mismatch (column "
                            f"{self.schema.columns[d.column].path!r})"
                        )
        jobs = []
        for (start, _end, group), buf in zip(ranges, bufs):
            mv = memoryview(buf)
            for d in group:
                rel = d.offset - start
                jobs.append((d, mv[rel : rel + d.size]))

        def _fill(chunk):
            ns = 0
            per_codec: Dict[int, List[int]] = {}
            for d, payload in chunk:
                if self.verify and d.checksum and zlib.crc32(payload) != d.checksum:
                    raise IOError(
                        "page checksum mismatch (column "
                        f"{self.schema.columns[d.column].path!r})"
                    )
                s = slot[id(d)]
                t0 = _ns()
                if d.codec == comp.CODEC_NONE:
                    staging[s : s + d.size] = payload
                else:
                    staging[s : s + d.uncompressed_size] = np.frombuffer(
                        comp.decompress(payload, d.codec, d.uncompressed_size),
                        dtype=np.uint8,
                    )
                dt = _ns() - t0
                ns += dt
                st = per_codec.setdefault(d.codec, [0, 0, 0, 0])
                st[0] += 1
                st[1] += d.size
                st[2] += d.uncompressed_size
                st[3] += dt
            return ns, per_codec

        pool = self._get_decode_pool()
        if not jobs:
            results = []
        elif pool is None:
            results = [_fill(jobs)]
        else:
            k = max(1, len(jobs) // (2 * self.read_options.decode_workers))
            chunks = [jobs[i : i + k] for i in range(0, len(jobs), k)]
            results = list(pool.map(_fill, chunks))
        per_codec: Dict[int, List[int]] = {}
        deco_ns = 0
        for ns, pc in results:
            deco_ns += ns
            _merge_codec_stats(per_codec, pc)
        if direct:  # direct preads bypass _fill; account their pages
            st = per_codec.setdefault(comp.CODEC_NONE, [0, 0, 0, 0])
            for p in direct:
                for d in p["descs"]:
                    st[0] += 1
                    st[1] += d.size
                    st[2] += d.uncompressed_size

        t0 = _ns()
        # a synchronous copy: from pageable memory ``.to`` returns once
        # the bytes have left ``staging``
        dev = torch.from_numpy(staging[:total]).to(self.device)
        h2d_ns = _ns() - t0
        self.stats.add_cluster_read(
            pages=len(descs),
            reads=len(ranges) + len(direct),
            compressed_bytes=sum(d.size for d in descs),
            uncompressed_bytes=sum(d.uncompressed_size for d in descs),
            io_ns=io_ns,
            decompress_ns=deco_ns,
            decode_ns=0,
            per_codec=per_codec,
        )
        self.stats.add_device_cluster(h2d_ns)
        return plans, dev, fallback, staging

    def _decode_staged(self, plans: List[Dict], dev) -> Dict[int, object]:
        """The DEVICE half: run the fused per-column decode drivers over
        the uploaded staging bytes -> ``{column: torch tensor}`` on the
        reader's device (kernels on a card, plain versions on the CPU)."""
        out: Dict[int, object] = {}
        t0 = _ns()
        for p in plans:
            raw = dev[p["base"] : p["base"] + p["n"] * p["nb"]]
            if p["route"] == "offsets":
                out[p["ci"]] = dk.device_decode_offsets(raw, p["n"], p["per"])
            elif p["route"] == "split":
                out[p["ci"]] = dk.device_decode_split(
                    raw, p["n"], p["per"], self.schema.columns[p["ci"]].dtype,
                )
            else:
                out[p["ci"]] = dk.device_decode_none(
                    raw, p["n"], p["per"], self.schema.columns[p["ci"]].dtype,
                )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats.add_decode_ns(_ns() - t0)
        return out

    def read_cluster_device(
        self, cluster_index: int, columns: Optional[Sequence[int]] = None
    ) -> Dict[int, object]:
        """Read a cluster through the fused device decode chain (§9).

        Device-eligible columns come back as torch tensors on the
        reader's device — offset columns as EXACT int32 cluster-relative
        ends (the dispatch guard proves every offset fits) — after ONE
        H2D upload of the stored
        page bytes.  Columns the plan gates out (8-byte leaves, oversize
        clusters, non-uniform pages) decode through the host path
        unchanged and come back as numpy arrays.
        """
        if self.read_options.device_decode == "off":
            raise RuntimeError(
                "device decode disabled (ReadOptions.device_decode='off')"
            )
        return self._finish_staged(
            self._stage_cluster_device(cluster_index, columns), cluster_index
        )

    def _finish_staged(self, staged, cluster_index: int) -> Dict[int, object]:
        """Device half + host fallbacks for one staged cluster, then
        recycle the staging buffer (safe only now — ``dev`` may alias
        it, see :meth:`_stage_cluster_device`)."""
        plans, dev, fallback, staging = staged
        out = self._decode_staged(plans, dev) if plans else {}
        if staging is not None and self._bufpool is not None:
            # the decode outputs are materialized (synchronized in
            # _decode_staged) and none aliases ``dev``, so nothing
            # references the staged bytes
            self._bufpool.put(staging)
        if fallback:
            out.update(self.read_cluster(cluster_index, fallback))
        return out

    def iter_clusters_device(
        self,
        columns: Optional[Sequence[int]] = None,
        start: int = 0,
        stop: Optional[int] = None,
    ) -> Iterator[Tuple[int, Dict[int, object]]]:
        """Device-path analog of :meth:`iter_clusters` (DESIGN.md §9).

        With ``prefetch_clusters > 0`` the prefetch pool runs the HOST
        half of cluster *N+1* (pread, entropy decode into pooled staging,
        H2D upload) while the consumer's thread runs the DEVICE half of
        cluster *N* — double-buffered read/decode overlap with the device
        in the loop.  Yields ``(cluster_index, {column: array})`` with
        the same array types as :meth:`read_cluster_device`.
        """
        if self.read_options.device_decode == "off":
            raise RuntimeError(
                "device decode disabled (ReadOptions.device_decode='off')"
            )
        order = self._live_clusters(start, stop, columns)
        depth = self.read_options.prefetch_clusters
        pool = self._get_prefetch_pool() if depth > 0 else None
        if pool is None:
            for i in order:
                yield i, self._finish_staged(
                    self._stage_cluster_device(i, columns), i
                )
            return
        pending: deque = deque()
        nxt = 0
        try:
            while pending or nxt < len(order):
                while nxt < len(order) and len(pending) < depth:
                    j = order[nxt]
                    pending.append(
                        (j, pool.submit(self._stage_cluster_device, j, columns))
                    )
                    nxt += 1
                i, fut = pending.popleft()
                t0 = _ns()
                staged = fut.result()
                self.stats.add_wait_ns(_ns() - t0)
                # top up BEFORE the device half + yield: the next
                # cluster's host half makes progress while this one
                # decodes on device and the consumer packs it
                while nxt < len(order) and len(pending) < depth:
                    j = order[nxt]
                    pending.append(
                        (j, pool.submit(self._stage_cluster_device, j, columns))
                    )
                    nxt += 1
                yield i, self._finish_staged(staged, i)
        finally:
            for _, fut in pending:
                fut.cancel()

    # -- the prefetch pipeline -----------------------------------------------

    def iter_clusters(
        self,
        columns: Optional[Sequence[int]] = None,
        start: int = 0,
        stop: Optional[int] = None,
        recycle: Optional[bool] = None,
        prune: bool = True,
    ) -> Iterator[Tuple[int, Dict[int, np.ndarray]]]:
        """Yield ``(cluster_index, {column: elements})`` in entry order.

        With ``prefetch_clusters > 0`` up to that many clusters are read
        and decoded on a background pool while the caller consumes the
        current one; the ``wait`` phase of :class:`ReaderStats` records
        how long the consumer actually blocked.

        ``recycle`` (default: ``ReadOptions.recycle_buffers``) returns
        each cluster's arrays to the reader's buffer pool once the
        consumer advances past it — the yielded arrays are then only
        valid until the next iteration.  ``iter_entries`` and
        ``read_column`` always pass ``False``: they may hold views of a
        cluster's arrays beyond the iteration that produced them.

        With ``ReadOptions.filter`` set (and ``prune`` on), clusters the
        zone maps prove empty are skipped before any pread; surviving
        clusters still yield in full — re-evaluate the predicate (or use
        :meth:`iter_filtered`) for exact per-entry selection.
        ``prune=False`` ignores the filter entirely (every cluster
        yields, no pruned-stats recorded) — the full-scan mode the
        whole-file accessors :meth:`iter_entries` / :meth:`read_column`
        use so their results never depend on ``ReadOptions.filter``.
        """
        if prune:
            order = self._live_clusters(start, stop, columns)
        else:
            n = self.n_clusters
            order = list(range(start, n if stop is None or stop > n
                               else stop))
        if recycle is None:
            recycle = self.read_options.recycle_buffers
        recycle = recycle and self._bufpool is not None
        depth = self.read_options.prefetch_clusters
        pool = self._get_prefetch_pool() if depth > 0 else None
        if pool is None:
            for i in order:
                cols = self.read_cluster(i, columns)
                yield i, cols
                if recycle:
                    self.recycle(cols)
            return
        pending: deque = deque()
        nxt = 0
        try:
            while pending or nxt < len(order):
                while nxt < len(order) and len(pending) < depth:
                    j = order[nxt]
                    pending.append((j, pool.submit(self.read_cluster, j, columns)))
                    nxt += 1
                i, fut = pending.popleft()
                t0 = _ns()
                cols = fut.result()
                self.stats.add_wait_ns(_ns() - t0)
                # top up BEFORE yielding: the next clusters make progress
                # while the consumer processes this one
                while nxt < len(order) and len(pending) < depth:
                    j = order[nxt]
                    pending.append((j, pool.submit(self.read_cluster, j, columns)))
                    nxt += 1
                yield i, cols
                if recycle:
                    # the consumer advanced: this cluster's arrays feed
                    # the allocations of the clusters still to come
                    self.recycle(cols)
        finally:
            for _, fut in pending:
                fut.cancel()

    # -- entry-level access ----------------------------------------------------

    def iter_cluster_entries(
        self, cluster_index: int, fields: Optional[Sequence[str]] = None
    ) -> List[Dict]:
        cm = self.clusters[cluster_index]
        schema = self.schema if fields is None else self.schema.project(fields)
        if fields is None:
            cols = self.read_cluster(cluster_index)
            arrays = [cols[i] for i in range(self.schema.n_columns)]
        else:
            # map projected columns back to file columns (horizontal skim)
            file_idx = [self.schema.column_of_path[c.path] for c in schema.columns]
            cols = self.read_cluster(cluster_index, file_idx)
            arrays = [cols[i] for i in file_idx]
        return recompose_entries(schema, arrays, cm.n_entries)

    def iter_entries(self, fields: Optional[Sequence[str]] = None) -> Iterator[Dict]:
        """EVERY entry of the file, recomposed in entry order.

        A full scan regardless of ``ReadOptions.filter`` (``prune=False``
        below bypasses the plan): the filter belongs to
        :meth:`iter_filtered` / :meth:`iter_filtered_entries`, and a
        whole-file accessor silently dropping zone-pruned-but-unfiltered
        clusters would be a trap.
        """
        schema = self.schema if fields is None else self.schema.project(fields)
        file_idx = (
            None
            if fields is None
            else [self.schema.column_of_path[c.path] for c in schema.columns]
        )
        # recycle=False: recomposed entries may hold views of the arrays
        for i, cols in self.iter_clusters(columns=file_idx, recycle=False,
                                          prune=False):
            idx = file_idx if file_idx is not None else range(self.schema.n_columns)
            arrays = [cols[j] for j in idx]
            yield from recompose_entries(schema, arrays, self.clusters[i].n_entries)

    def iter_filtered_entries(
        self, fields: Optional[Sequence[str]] = None
    ) -> Iterator[Dict]:
        """Entries matching ``ReadOptions.filter``, recomposed like
        :meth:`iter_entries` — the pruned equivalent of a full scan
        followed by an exact predicate filter (DESIGN.md §11)."""
        schema = self.schema if fields is None else self.schema.project(fields)
        file_idx = (
            None
            if fields is None
            else [self.schema.column_of_path[c.path] for c in schema.columns]
        )
        for _i, _e0, cols, n in self.iter_filtered(columns=file_idx):
            idx = file_idx if file_idx is not None else range(self.schema.n_columns)
            arrays = [cols[j] for j in idx]
            yield from recompose_entries(schema, arrays, n)

    # -- whole-column access (analysis-style reads) ------------------------------

    def read_column(self, path: str) -> np.ndarray:
        """Concatenate a column across ALL clusters (prefetched).

        Offset columns are globalized: cluster-relative offsets are shifted
        by the running element count of their *child* column — giving the
        usual global offsets array.

        Like :meth:`iter_entries`, a full scan regardless of
        ``ReadOptions.filter``: the result always has exactly
        ``n_entries`` top-level elements, zone maps or not.
        """
        ci = self.schema.column_of_path[path]
        col = self.schema.columns[ci]
        chunks = []
        if col.kind == KIND_OFFSET:
            children = [
                k for k, p in enumerate(self.schema.parent) if p == ci
            ]
            child = children[0] if children else None
            base = 0
            # recycle=False on both paths: chunks holds every cluster's
            # array until the final concatenate
            for i, cols in self.iter_clusters(columns=[ci], recycle=False,
                                              prune=False):
                arr = cols[ci].astype(np.int64)
                chunks.append(arr + base)
                if child is not None:
                    base += self.clusters[i].n_elements[child]
                elif len(arr):
                    base += int(arr[-1])
        else:
            for _i, cols in self.iter_clusters(columns=[ci], recycle=False,
                                               prune=False):
                chunks.append(cols[ci])
        return (
            np.concatenate(chunks)
            if chunks
            else np.empty(0, dtype=col.dtype)
        )

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._prefetch_pool is not None:
            self._prefetch_pool.shutdown(wait=True)
        if self._decode_pool is not None:
            self._decode_pool.shutdown(wait=True)
        self.stats.merge_io(self.sink.io.snapshot())
        if self._bufpool is not None:
            self.stats.merge_pool(self._bufpool.snapshot())
        self.sink.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()
