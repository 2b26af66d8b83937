"""Sequential and parallel RNT-J writers — the paper's contribution (§4, §5).

Protocol (paper §4):
  1. Each producer prepares its own *unit of writing* (a cluster, or a page
     in unbuffered mode) — serialization + compression run with **no
     synchronization** because sealed clusters are relocatable.
  2. A short critical section *reserves* a byte extent in the container
     and appends format metadata in commit order (sequential-equivalent).
  3. The bytes are written at the reserved offset — inside the critical
     section by default (paper §5 base implementation), or outside it with
     opt-2 (``write_outside_lock``), after optionally preallocating the
     extent with opt-1 (``fallocate``).

Modes (paper §5 / §6.1):
  * buffered   — unit of writing = cluster; compressed pages buffered in
    memory until the cluster commits.  ~1 lock acquisition per cluster.
  * unbuffered — unit of writing = page; pages stream out under a
    per-page lock; lower memory, collapses under lock contention at high
    thread counts (the paper's 300-vs-27,000 futex observation).

Throughput machinery (DESIGN.md §2):
  * ``imt_workers`` — a single writer-owned compression pool; every seal
    (sequential IMT and parallel producers alike) runs page compression
    through ``ClusterBuilder.seal(pool)``, the one shared code path.
  * ``pipelined_seal`` — double-buffered sealing: while one cluster
    compresses and commits on a background thread, the producer keeps
    filling the next builder.  The paper's opt-2 moves the *write* out of
    the critical path; this moves the entire seal phase off the producer.

I/O engine (DESIGN.md §6): every commit path funnels through one
:class:`~repro_torch.core.ioengine.IOEngine` per writer — scatter-gather
``pwritev`` commits of un-assembled iovec plans (``scatter_commit``),
striped parallel sub-extent writes (``io_stripe_bytes``), and bounded
write-behind with producer backpressure (``io_inflight_bytes``), plus
the fsync policy knob.  Queued extents submit through an async
submission ring (``io_ring`` — io_uring on an ``AsyncFileSink`` when
liburing loads, a behavior-identical emulation elsewhere, §6.7), and a
writer-owned buffer pool (``buffer_pool_bytes``, §6.8) recycles
detached scatter buffers on write completion, so the steady-state
commit path allocates nothing.  ``close()`` drains the engine before
the footer is ever built, and engine write failures poison finalization
through the same ``_commit_error`` latch as a synchronous failed
``pwrite``.  All knobs: DESIGN.md §7.1.

Device (``device=``, default ``"cuda"``): every writer builds its kernel
dispatch (:func:`~repro_torch.kernels.ops.encode_kernels`) from its
device — the offsets scan at fill time and the page-wise byte-plane split
at seal time run as CUDA kernels on a card, or as their plain PyTorch
versions when the caller asked for ``device="cpu"``.  Without a card and
without ``device="cpu"`` the constructor raises ``RuntimeError``.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.kernels.ops import encode_kernels, resolve_device

from . import compression as comp
from .bufpool import Recyclable, make_pool as make_buffer_pool
from .cluster import ClusterBuilder, SealedCluster
from .container import Sink, open_sink
from .ioengine import FSYNC_ON_CLOSE, RING_AUTO, IOEngine, RetryPolicy
from .metadata import (
    ANCHOR_SIZE,
    CLUSTER_ENV_SIZE,
    JREC_BUFFERED,
    ClusterMeta,
    build_anchor,
    build_cluster_envelope,
    build_footer,
    build_header,
    build_journal_body,
    build_member_sidecar,
    build_pagelist,
    encode_zonemaps,
    finish_journal_record,
    journal_record_size,
)
from .pages import DEFAULT_PAGE_SIZE, PageDesc
from .schema import ColumnBatch, Schema
from .stats import CountingLock, WriterStats

_ns = time.perf_counter_ns


@dataclass
class WriteOptions:
    """Every write-side tuning knob; the field comments below are the
    short form — DESIGN.md §7.1 is the single consolidated reference
    (defaults, composition notes, and section pointers per knob)."""

    page_size: int = DEFAULT_PAGE_SIZE       # uncompressed bytes per page
    codec: object = "zlib"                   # name or id
    level: int = -1
    cluster_bytes: int = 8 * 1024 * 1024     # uncompressed bytes per cluster
    buffered: bool = True                    # cluster-granular unit of writing
    fallocate: bool = False                  # opt-1: preallocate extents
    write_outside_lock: bool = False         # opt-2: write after the critical section
    imt_workers: int = 0                     # shared page-compression pool size
    pipelined_seal: bool = False             # double-buffered background seal+commit
    checksum: bool = True
    # -- codec engine (DESIGN.md §5) ----------------------------------------
    # pages whose preconditioned payload exceeds this are compressed as
    # independent concatenated members ("framed chunking"), concurrently
    # on the writer's pool; 0 disables framing
    codec_chunk_bytes: int = 256 * 1024
    # per-column codec overrides: column path -> codec name/id, or a
    # (codec, level) pair; wins over ColumnSpec.codec and options.codec
    column_codecs: Optional[Dict[str, object]] = None
    # adaptive policy: sample each column's first sealed pages and fall
    # back to raw storage (CODEC_NONE, as ROOT does) when the achieved
    # compressed/uncompressed ratio exceeds adaptive_threshold
    adaptive_codec: bool = False
    adaptive_sample_pages: int = 8
    adaptive_threshold: float = 0.9
    # split/delta preconditioning of pages; False stores every column's
    # elements verbatim (recorded in the header so readers decode right)
    precondition: bool = True
    # -- I/O engine (DESIGN.md §6) -------------------------------------------
    # seal clusters to a zero-copy iovec plan committed via pwritev
    # (scatter-gather) instead of assembling a blob; the assembled path
    # stays as the byte-identical reference
    scatter_commit: bool = True
    # clusters above this size split into independent parallel stripe
    # writes at computed offsets inside the reserved extent (0 = off)
    io_stripe_bytes: int = 0
    # write-behind budget: producers seal ahead while up to this many
    # bytes of committed extents drain in the background (0 = synchronous
    # commit, the paper's base protocol)
    io_inflight_bytes: int = 0
    # engine pool size; 0 = auto (4) when striping/write-behind is on
    io_workers: int = 0
    # "on_close" | "every_cluster" | int byte interval between fsyncs
    fsync_policy: object = FSYNC_ON_CLOSE
    # -- async submission + buffer pool (DESIGN.md §6.7/§6.8) ----------------
    # how queued (write-behind) extents are submitted: "auto" uses an
    # io_uring submission ring when liburing loads and the sink is an
    # AsyncFileSink, else the emulated completion-thread ring; "uring"
    # requires the real ring; "emulated" forces the emulation; "off"
    # keeps one executor job per stripe
    io_ring: object = RING_AUTO
    # residency bound of the writer's buffer pool, recycling detached
    # scatter buffers / scratch / merge copy buffers; 0 disables pooling
    buffer_pool_bytes: int = 64 * 1024 * 1024
    # rate-aware adaptive codec: weigh each column's measured savings
    # rate (bytes removed per CPU second) against the sink's observed
    # drain bandwidth — a slow sink keeps compression a fast sink drops
    adaptive_rate_aware: bool = False
    # -- failure model (DESIGN.md §8) ----------------------------------------
    # frame every committed cluster with a self-describing envelope and
    # append a commit-journal record, so recover_container() can rebuild
    # the footer of a torn file from the data region alone; False writes
    # the exact pre-journal (v1-shaped) data region
    journal: bool = True
    # record per-page zone maps (min/max/null-count + entry ranges,
    # DESIGN.md §11) at seal time and persist them in
    # footer.extra["zonemaps"]; False writes a footer without them
    zone_maps: bool = True
    # bounded-retry policy applied by the I/O engine to every write and
    # fsync (None = fail fast)
    retry_policy: Optional[RetryPolicy] = None
    # -- multi-process writing (DESIGN.md §8.6) ------------------------------
    # lease heartbeat period of a participant writer; a writer silent for
    # 2x this is considered dead and may be fenced by the coordinator
    lease_interval: float = 5.0
    # how long the coordinator's footer-assembly rendezvous waits for
    # stragglers before fencing them and sealing over what is journaled
    rendezvous_timeout: float = 30.0
    # fsync the side-car reservation log on every append (crash-consistent
    # allocation); False trades durability of the log for append latency
    mpw_log_fsync: bool = True

    @property
    def codec_id(self) -> int:
        return comp.codec_id(self.codec)

    def as_dict(self) -> dict:
        return {
            "page_size": self.page_size,
            "codec": self.codec_id,
            "cluster_bytes": self.cluster_bytes,
            "buffered": self.buffered,
            "chunk_bytes": self.codec_chunk_bytes,
            "precondition": self.precondition,
            "journal": self.journal,
        }


class _WriterBase:
    """Shared container/metadata handling, compression pool + close()."""

    # multi-writer participants (repro_torch.core.mpwrite) flip these: they skip
    # the header (the coordinator owns it), stamp journal records with
    # their fencing identity, and take commit seqs from the shared log
    _writes_header = True
    _jrec_writer_id: Optional[int] = None
    _jrec_epoch: int = 0

    def __init__(self, schema: Schema, sink, options: Optional[WriteOptions] = None,
                 device="cuda"):
        # the device first: without a card (and without device="cpu")
        # nothing is opened or written
        self.device = resolve_device(device)
        self._kernels = encode_kernels(self.device)
        self.schema = schema
        self.options = options or WriteOptions()
        self.sink: Sink = (
            open_sink(sink) if isinstance(sink, (str, os.PathLike)) else sink
        )
        self.lock = CountingLock()
        self.stats = WriterStats()
        self._clusters: List[ClusterMeta] = []
        # per-cluster zone maps, parallel to _clusters (None = no stats)
        self._zonemaps: List[Optional[dict]] = []
        self._n_entries = 0
        self._closed = False
        # first seal/commit failure: once set, close() releases resources
        # but refuses to finalize — a footer must never reference a
        # cluster whose bytes did not reach the sink
        self._commit_error: Optional[BaseException] = None
        # the writer-owned compression pool: ONE pool shared by every seal
        # (sequential IMT and all parallel producers), sized independently
        # of the producer count
        self._pool = comp.make_pool(self.options.imt_workers, "rntj-compress")
        # codec-engine state shared by every builder of this writer: the
        # per-column (codec, level) resolution and the adaptive policy
        self._column_codecs = self._resolve_column_codecs()
        self._policy = (
            comp.CodecPolicy(
                schema.n_columns,
                self.options.adaptive_sample_pages,
                self.options.adaptive_threshold,
                rate_aware=self.options.adaptive_rate_aware,
            )
            if self.options.adaptive_codec
            else None
        )
        # the writer's buffer pool (DESIGN.md §6.8): detached scatter
        # buffers, seal scratch, pooled page payloads and merge copy
        # buffers all recycle through it; the I/O engine returns an
        # extent's buffers when its last write lands
        self._bufpool = make_buffer_pool(self.options.buffer_pool_bytes)
        # the writer's I/O engine: one per writer, shared by every commit
        # path (clusters, unbuffered pages, merge's raw copies).  Write
        # failures poison finalization through _commit_error; drained
        # bytes feed the rate-aware codec policy its bandwidth signal.
        self._io = IOEngine(
            self.sink,
            workers=self.options.io_workers,
            inflight_bytes=self.options.io_inflight_bytes,
            stripe_bytes=self.options.io_stripe_bytes,
            fsync_policy=self.options.fsync_policy,
            stats=self.stats,
            on_error=self._poison,
            on_drain=(
                self._policy.observe_drain if self._policy is not None else None
            ),
            ring=self.options.io_ring,
            buffer_pool=self._bufpool,
            retry=self.options.retry_policy,
        )
        # crash-consistency framing (DESIGN.md §8.3)
        self._journal = bool(self.options.journal)
        # header goes first; its location is fixed so no lock is needed yet.
        # It records the EFFECTIVE per-column encodings (a reused schema —
        # e.g. one parsed from a precondition=False file — may carry
        # non-default encodings): readers restore them verbatim, so what
        # the builders encode and what readers decode can never diverge.
        if self._writes_header:
            hdr_opts = self.options.as_dict()
            hdr_opts["encodings"] = self.column_encodings()
            hdr = build_header(schema, hdr_opts)
            off = self.sink.reserve(len(hdr))
            self._meta_pwrite(off, hdr)
            self._header_loc = (off, len(hdr))
        else:
            self._header_loc = (0, 0)

    def _meta_pwrite(self, off: int, data: bytes) -> None:
        """Direct metadata write (header/page list/footer/anchor), through
        the engine's retry chokepoint so transient storage errors don't
        fail finalization."""
        self._io._retrying(self.sink.pwrite, off, data)

    def column_encodings(self) -> List[str]:
        """The encodings this writer's pages actually use."""
        if not self.options.precondition:
            return ["none"] * self.schema.n_columns
        return [c.encoding for c in self.schema.columns]

    def _resolve_column_codecs(self):
        """Per-column (codec_id, level): ``WriteOptions.column_codecs`` >
        ``ColumnSpec.codec`` > ``WriteOptions.codec``.  ``None`` when no
        override exists (builders then track the live default)."""
        o = self.options
        overrides = o.column_codecs or {}
        unknown = [p for p in overrides if p not in self.schema.column_of_path]
        if unknown:
            raise KeyError(
                f"column_codecs names unknown column path(s): {unknown}"
            )
        if not overrides and all(c.codec is None for c in self.schema.columns):
            return None
        out = []
        for col in self.schema.columns:
            codec, level = o.codec_id, o.level
            if col.codec is not None:
                codec, level = comp.codec_id(col.codec), col.level
            ov = overrides.get(col.path)
            if ov is not None:
                if isinstance(ov, (tuple, list)):
                    codec, level = comp.codec_id(ov[0]), int(ov[1])
                else:
                    codec, level = comp.codec_id(ov), -1
            out.append((codec, level))
        return out

    def _make_builder(self) -> ClusterBuilder:
        o = self.options
        return ClusterBuilder(self.schema, o.page_size, o.codec_id, o.level,
                              o.checksum,
                              column_codecs=self._column_codecs,
                              chunk_bytes=o.codec_chunk_bytes,
                              policy=self._policy,
                              precondition=o.precondition,
                              scatter=o.scatter_commit,
                              buffer_pool=self._bufpool,
                              zone_maps=o.zone_maps,
                              kernels=self._kernels)

    # -- commit protocol ----------------------------------------------------

    def _commit_seq(self) -> int:
        """Sequence number of the cluster being committed (caller holds the
        writer lock, right after the extent reserve).  Multi-writer
        participants override this to return the shared log's global seq."""
        return len(self._clusters)

    def _post_commit(self, ext: int) -> None:
        """Hook after an extent's bytes are handed to the I/O engine.
        Multi-writer participants append the COMMIT record here."""

    def _jrec_size(self, n_columns: int, n_pages: int) -> int:
        return journal_record_size(n_columns, n_pages,
                                   multi=self._jrec_writer_id is not None)

    def _finish_jrec(self, seq, flags, cluster_off, cluster_size, first_entry,
                     n_entries, n_columns, body):
        return finish_journal_record(
            seq, flags, cluster_off, cluster_size, first_entry, n_entries,
            n_columns, body, writer_id=self._jrec_writer_id,
            epoch=self._jrec_epoch,
        )

    def _commit_cluster(self, sealed: SealedCluster) -> None:
        """The paper's critical section (§4.2/§4.3), buffered mode.

        With write-behind (``io_inflight_bytes > 0``) the backpressure
        gate runs BEFORE the critical section — a producer stalled on
        storage never blocks the other producers' commits — and the
        critical section only enqueues the extent; the engine's workers
        drain it while this producer seals ahead.
        """
        opts = self.options
        t0 = _ns()
        # With the journal on, the reserved extent is
        # [envelope][payload][journal record], submitted as ONE vectored
        # engine write — no extra syscall.  The page list's byte_offset
        # still points at the payload, so footer-based readers never see
        # the framing.  The record body (element counts + page records
        # with cluster-relative offsets) serializes OUTSIDE the critical
        # section; only the fixed prefix needs the reserved offset.
        env_len = CLUSTER_ENV_SIZE if self._journal else 0
        if self._journal:
            jbody = build_journal_body(sealed.n_elements, sealed.pages)
            jlen = self._jrec_size(len(sealed.n_elements), len(sealed.pages))
        else:
            jbody, jlen = b"", 0
        total = env_len + sealed.size + jlen
        self._io.admit(total)
        io_ns = 0
        with self.lock:
            ext = self.sink.reserve(total)
            off = ext + env_len
            if opts.fallocate:
                self.sink.fallocate(ext, total)
            first_entry = self._n_entries
            self._n_entries += sealed.n_entries
            seq = self._commit_seq()
            self._clusters.append(
                ClusterMeta(
                    first_entry=first_entry,
                    n_entries=sealed.n_entries,
                    n_elements=sealed.n_elements,
                    pages=sealed.rebase(off),
                    byte_offset=off,
                    byte_size=sealed.size,
                )
            )
            self._zonemaps.append(sealed.zonemaps)
            if self._journal:
                jrec, desc_crc = self._finish_jrec(
                    seq, JREC_BUFFERED, off, sealed.size, first_entry,
                    sealed.n_entries, len(sealed.n_elements), jbody,
                )
                parts = ([build_cluster_envelope(seq, sealed.size, desc_crc)]
                         + sealed.iov_plan() + [jrec])
            else:
                parts = sealed.iov_plan()
            if not opts.write_outside_lock:
                io_ns = self._submit_or_latch(ext, parts, total, owner=sealed)
                self._post_commit(ext)
        if opts.write_outside_lock:
            # opt-2: the extent is reserved and the metadata final — the
            # actual bytes go out truly in parallel (paper §5).
            io_ns = self._submit_or_latch(ext, parts, total, owner=sealed)
            self._post_commit(ext)
        self.stats.add_sealed_cluster(sealed, commit_ns=_ns() - t0, io_ns=io_ns)

    def _poison(self, e: BaseException) -> None:
        """First seal/commit failure latches here; close() then refuses to
        finalize — a footer must never reference bytes that never landed."""
        if self._commit_error is None:
            self._commit_error = e

    def _submit_or_latch(self, off: int, parts, nbytes: int,
                         owner=None) -> int:
        """Hand an extent to the I/O engine; on failure, poison
        finalization.

        The metadata for this extent is already appended (the paper's
        commit protocol publishes it inside the critical section), so a
        failed write must prevent close() from emitting a footer that
        references bytes that never landed.  The engine's own error hook
        covers failures inside the write; this wrapper additionally
        latches anything raised before submission.  Returns the io time
        spent on this thread (0 when the engine queued the write).
        """
        try:
            return self._io.write_extent(off, parts, nbytes, owner=owner)
        except BaseException as e:
            self._poison(e)
            raise

    def _commit_page(self, payload, desc: PageDesc,
                     build_ns: int = 0) -> PageDesc:
        """Page-granular critical section (unbuffered mode).

        A pooled raw payload (a memoryview of a BufferPool array, see
        ``build_page``) rides with a ``Recyclable`` owner so the engine
        returns its buffer once the page's write lands.
        """
        owner = None
        if (
            self._bufpool is not None
            and isinstance(payload, memoryview)
            and isinstance(payload.obj, np.ndarray)
        ):
            owner = Recyclable([payload.obj])
        t0 = _ns()
        self._io.admit(len(payload))
        with self.lock:
            off = self.sink.reserve(len(payload))
            io_ns = self._submit_or_latch(off, [payload], len(payload),
                                          owner=owner)
        desc.offset = off
        self.stats.add_page(len(payload), commit_ns=_ns() - t0, io_ns=io_ns,
                            codec=desc.codec,
                            uncompressed_size=desc.uncompressed_size,
                            build_ns=build_ns)
        return desc

    def _commit_cluster_meta_unbuffered(
        self, n_entries: int, n_elements: List[int], pages: List[PageDesc],
        uncompressed: int, zonemaps: Optional[dict] = None,
    ) -> None:
        # Unbuffered clusters have no contiguous payload to frame, so the
        # journal contribution is a record alone (flags=0: absolute page
        # offsets); recovery validates the scattered pages by their CRCs.
        jlen = (self._jrec_size(len(n_elements), len(pages))
                if self._journal else 0)
        jbody = build_journal_body(n_elements, pages) if self._journal else b""
        if jlen:
            self._io.admit(jlen)
        with self.lock:
            first_entry = self._n_entries
            self._n_entries += n_entries
            self._clusters.append(
                ClusterMeta(first_entry, n_entries, n_elements, list(pages))
            )
            self._zonemaps.append(zonemaps)
            if jlen:
                jrec, _ = self._finish_jrec(
                    len(self._clusters) - 1, 0, 0, 0, first_entry, n_entries,
                    len(n_elements), jbody,
                )
                j_off = self.sink.reserve(jlen)
                self._submit_or_latch(j_off, [jrec], jlen)
        self.stats.add_cluster_meta(n_entries, uncompressed)

    def _commit_raw_cluster(
        self,
        blob,
        n_entries: int,
        n_elements: List[int],
        pages: List[PageDesc],
        base: int,
        owner=None,
        zonemaps: Optional[dict] = None,
    ) -> None:
        """Commit an already-assembled cluster payload byte-verbatim — the
        merge fast path's critical section.  ``pages`` carry offsets
        relative to ``base`` (the payload's offset in its source file);
        the output gets a fresh envelope + journal record, so merged
        files are as recoverable as directly written ones.  ``zonemaps``
        rides the source cluster's zone maps through unchanged (entry
        indices are cluster-relative, so a byte-verbatim copy keeps them
        valid)."""
        nbytes = len(blob)
        rel = [p.rebase(-base) for p in pages] if base else list(pages)
        env_len = CLUSTER_ENV_SIZE if self._journal else 0
        if self._journal:
            jbody = build_journal_body(n_elements, rel)
            jlen = self._jrec_size(len(n_elements), len(rel))
        else:
            jbody, jlen = b"", 0
        total = env_len + nbytes + jlen
        self._io.admit(total)
        with self.lock:
            ext = self.sink.reserve(total)
            off = ext + env_len
            first_entry = self._n_entries
            self._n_entries += n_entries
            seq = self._commit_seq()
            self._clusters.append(
                ClusterMeta(
                    first_entry=first_entry,
                    n_entries=n_entries,
                    n_elements=list(n_elements),
                    pages=[p.rebase(off) for p in rel],
                    byte_offset=off,
                    byte_size=nbytes,
                )
            )
            self._zonemaps.append(zonemaps)
            if self._journal:
                jrec, desc_crc = self._finish_jrec(
                    seq, JREC_BUFFERED, off, nbytes, first_entry, n_entries,
                    len(n_elements), jbody,
                )
                parts = [build_cluster_envelope(seq, nbytes, desc_crc),
                         blob, jrec]
            else:
                parts = [blob]
            self._submit_or_latch(ext, parts, total, owner=owner)
            self._post_commit(ext)
        with self.stats._mu:
            self.stats.clusters += 1
            self.stats.entries += n_entries
            self.stats.pages += len(pages)
            self.stats.compressed_bytes += nbytes

    # -- finalization ---------------------------------------------------------

    def _finalize(self) -> None:
        """Seal the container: page list + footer + anchor + final fsync.
        Runs only on a clean close (engine drained, nothing poisoned).
        Multi-writer participants override this — the coordinator owns the
        footer; a participant just makes its clusters durable and reports
        DONE to the shared log."""
        if (self._journal and self._clusters
                and self._io._fsync_interval
                and not self._io._fsync_every):
            # journal-before-footer barrier (DESIGN.md §8.3):
            # every committed cluster's envelope + journal record
            # is durable before the first finalization byte
            # exists, so a crash during finalization always
            # leaves a journal that covers all committed data.
            # Only the byte-interval policy needs it: every-cluster
            # already synced each extent, and under on_close
            # nothing is durable until the single close fsync
            # below — which then covers journal and footer alike.
            self._io.fsync()
        with self.lock:
            extra = None
            sc = build_member_sidecar(self._clusters)
            if sc is not None:
                sc_off = self.sink.reserve(len(sc))
                self._meta_pwrite(sc_off, sc)
                extra = {"members": [sc_off, len(sc)]}
            zm = encode_zonemaps(self._zonemaps)
            if zm is not None:
                extra = dict(extra or {})
                extra["zonemaps"] = zm
            pl = build_pagelist(self._clusters, self.schema.n_columns)
            pl_off = self.sink.reserve(len(pl))
            self._meta_pwrite(pl_off, pl)
            ftr = build_footer(self._n_entries, len(self._clusters),
                               (pl_off, len(pl)), extra=extra)
            f_off = self.sink.reserve(len(ftr))
            self._meta_pwrite(f_off, ftr)
            anchor = build_anchor(
                self._header_loc, (f_off, len(ftr)), self._n_entries,
                len(self._clusters),
            )
            a_off = self.sink.reserve(ANCHOR_SIZE)
            self._meta_pwrite(a_off, anchor)
        # Durability before close: fsync the sink unconditionally
        # (sinks without a backing fd make it a no-op counter
        # bump).  The seed gated this on readable() — which
        # skipped the fsync exactly for write-only sinks — and as
        # a discarded conditional expression.  Routed through the
        # engine so it is retried and a final failure poisons
        # (and is accounted) like any other I/O error.  The fsync
        # must precede the io-stats snapshot to be counted.
        self._io.fsync()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
            # drain-before-footer: every queued write-behind extent must
            # land (or fail, poisoning _commit_error via the engine's
            # error hook) before any finalization byte is even built
            self._io.drain()
            if self._commit_error is None:
                self._finalize()
        finally:
            # resources are released on every path, even a poisoned one —
            # and even when one release step itself fails
            try:
                self._io.close()
            finally:
                self.stats.merge_lock(self.lock.snapshot())
                if self._bufpool is not None:
                    self.stats.merge_pool(self._bufpool.snapshot())
                # the io-stats snapshot must FOLLOW sink.close(): remote
                # sinks finalize there (multipart complete, tail part
                # uploads), and retries fired inside that window would
                # otherwise vanish from WriterStats
                try:
                    self.sink.close()
                finally:
                    self.stats.merge_io(self.sink.io.snapshot())
        if self._commit_error is not None:
            raise RuntimeError(
                "writer aborted: a cluster failed to seal or commit; the "
                "file was NOT finalized (no footer written)"
            ) from self._commit_error

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def n_entries(self) -> int:
        return self._n_entries


class _PipelinedSealer:
    """Double-buffered background seal+commit for one producer.

    ``submit(builder)`` hands the full builder to a single background
    worker (which seals through the writer's shared compression pool and
    commits) and returns a drained builder to keep filling — the spare
    from the previous round, so exactly two builders alternate and their
    ColumnBuffer storage is reused with no steady-state allocation.

    The single worker preserves per-producer commit order, so a
    one-producer pipelined file is byte-identical to a synchronous one.
    Background exceptions re-raise on the producer thread at the next
    ``submit``/``wait``.
    """

    def __init__(self, writer: "_WriterBase"):
        self._writer = writer
        self._exec = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="rntj-seal"
        )
        self._future = None
        self._spare: Optional[ClusterBuilder] = None

    def _run(self, builder: ClusterBuilder) -> ClusterBuilder:
        try:
            sealed = builder.seal(self._writer._pool)
            self._writer._commit_cluster(sealed)
        except BaseException as e:
            # the cluster's data is lost (its builder was handed off):
            # poison finalization directly, so even a caller that
            # swallows the re-raised error at the next wait() can never
            # close a footer over the missing entries
            self._writer._poison(e)
            raise
        return builder  # drained: its buffers are reusable now

    def submit(self, builder: ClusterBuilder) -> ClusterBuilder:
        self.wait()
        nxt = self._spare if self._spare is not None else self._writer._make_builder()
        self._spare = None
        self._future = self._exec.submit(self._run, builder)
        return nxt

    def wait(self) -> None:
        if self._future is not None:
            fut, self._future = self._future, None
            self._spare = fut.result()

    def close(self) -> None:
        self.wait()
        self._exec.shutdown(wait=True)


# ---------------------------------------------------------------------------
# Sequential writer (the baseline RNTuple writer + IMT page compression)


class SequentialWriter(_WriterBase):
    """Single-producer writer.

    With ``options.imt_workers > 0`` page compression of a cluster is
    distributed over the writer's shared pool — ROOT's *implicit
    multithreading* (IMT) model, which the paper shows plateaus around 4
    threads (Fig. 5) because everything else stays serial.  With
    ``options.pipelined_seal`` the whole seal+commit runs behind the
    producer (double buffering).
    """

    def __init__(self, schema: Schema, sink, options: Optional[WriteOptions] = None,
                 device="cuda"):
        super().__init__(schema, sink, options, device=device)
        self._builder = self._make_builder()
        self._sealer = (
            _PipelinedSealer(self)
            if self.options.pipelined_seal and self.options.buffered
            else None
        )
        self._fill_ns = 0

    def fill(self, entry: Dict) -> None:
        t0 = _ns()
        self._builder.fill(entry)
        self._fill_ns += _ns() - t0
        self._maybe_flush()

    def fill_batch(self, batch: ColumnBatch) -> None:
        t0 = _ns()
        self._builder.fill_batch(batch)
        self._fill_ns += _ns() - t0
        self._maybe_flush()

    def _maybe_flush(self) -> None:
        if self._builder.uncompressed_bytes >= self.options.cluster_bytes:
            self.flush_cluster()

    def flush_cluster(self) -> None:
        if self._builder.is_empty:
            if self._sealer is not None:
                self._sealer.wait()
            return
        if self._sealer is not None:
            self._builder = self._sealer.submit(self._builder)
        else:
            self._commit_cluster(self._builder.seal(self._pool))

    def close(self) -> None:
        if not self._closed:
            try:
                self.flush_cluster()
                if self._sealer is not None:
                    self._sealer.close()
            except BaseException as e:
                # a cluster was lost: poison finalization, surface via
                # super().close() after resources are released
                if self._commit_error is None:
                    self._commit_error = e
            finally:
                self.stats.add_fill_ns(self._fill_ns)
                self._fill_ns = 0
        super().close()


# ---------------------------------------------------------------------------
# Parallel writer (the paper's contribution)


class FillContext:
    """Per-producer context: its own cluster under construction.

    Everything up to the commit happens without synchronization; the commit
    is the short critical section described in paper §4.2/§4.3.  With
    ``pipelined_seal`` the seal+commit of a full cluster runs on a
    background thread while this producer fills the next builder.
    """

    def __init__(self, writer: "ParallelWriter"):
        self.writer = writer
        o = writer.options
        self.builder = writer._make_builder()
        self._page_buf: List = []  # unbuffered mode: descs of committed pages
        self._sealer = (
            _PipelinedSealer(writer) if o.pipelined_seal and o.buffered else None
        )
        self._fill_ns = 0
        self._ctx_closed = False

    def fill(self, entry: Dict) -> None:
        t0 = _ns()
        self.builder.fill(entry)
        self._fill_ns += _ns() - t0
        self._maybe_flush()

    def fill_batch(self, batch: ColumnBatch) -> None:
        with obs.span("writer.fill_batch"):
            t0 = _ns()
            self.builder.fill_batch(batch)
            self._fill_ns += _ns() - t0
            self._maybe_flush()

    def _maybe_flush(self) -> None:
        o = self.writer.options
        if not o.buffered:
            # the writer pool parallelizes chunk-framed page members; the
            # drain itself runs on this producer thread
            for payload, desc, ns in self.builder.drain_full_pages(self.writer._pool):
                self._page_buf.append(self.writer._commit_page(payload, desc, ns))
        if self.builder.uncompressed_bytes >= o.cluster_bytes:
            self.flush_cluster()

    def flush_cluster(self) -> None:
        if self.builder.is_empty:
            if self._sealer is not None:
                self._sealer.wait()
            return
        if self.writer.options.buffered:
            if self._sealer is not None:
                self.builder = self._sealer.submit(self.builder)
            else:
                self.writer._commit_cluster(self.builder.seal(self.writer._pool))
        else:
            for payload, desc, ns in self.builder.drain_rest(self.writer._pool):
                self._page_buf.append(self.writer._commit_page(payload, desc, ns))
            zm = self.builder.take_zonemaps()
            n_entries, n_elements, unc = self.builder.finish_unbuffered()
            self.writer._commit_cluster_meta_unbuffered(
                n_entries, n_elements, self._page_buf, unc, zonemaps=zm
            )
            self._page_buf = []

    def close(self) -> None:
        with obs.span("writer.close"):
            self._close()

    def _close(self) -> None:
        if self._ctx_closed:
            return
        self.flush_cluster()
        if self._sealer is not None:
            self._sealer.close()
        # only mark closed after a successful drain: a failed close stays
        # retryable and is never silently dropped by ParallelWriter.close
        self._ctx_closed = True
        self.writer.stats.add_fill_ns(self._fill_ns)
        self._fill_ns = 0


class ParallelWriter(_WriterBase):
    """Multithreaded single-file writer (paper §5).

    Usage::

        with ParallelWriter(schema, path, options) as w:
            # per thread:
            ctx = w.create_fill_context()
            ctx.fill(...); ctx.fill_batch(...)
            ctx.close()
    """

    def __init__(self, schema: Schema, sink, options: Optional[WriteOptions] = None,
                 device="cuda"):
        super().__init__(schema, sink, options, device=device)
        self._contexts: List[FillContext] = []
        self._ctx_lock = threading.Lock()

    def create_fill_context(self) -> FillContext:
        ctx = FillContext(self)
        with self._ctx_lock:
            self._contexts.append(ctx)
        return ctx

    def close(self) -> None:
        with obs.span("writer.close"):
            if not self._closed:
                # Flush (and drain the seal pipelines of) any contexts the
                # producers did not close themselves.  One failing context
                # must not stop the others from draining, nor leak the
                # sink — the first error poisons finalization instead.
                with self._ctx_lock:
                    for ctx in self._contexts:
                        try:
                            ctx._close()
                        except BaseException as e:
                            if self._commit_error is None:
                                self._commit_error = e
            super().close()


# ---------------------------------------------------------------------------
# Convenience


def write_entries(
    schema: Schema,
    sink,
    entries: Sequence[Dict],
    options: Optional[WriteOptions] = None,
    device="cuda",
) -> WriterStats:
    with SequentialWriter(schema, sink, options, device=device) as w:
        for e in entries:
            w.fill(e)
        w.flush_cluster()
        stats = w.stats
    return stats


def write_options_from_dict(d: Dict) -> WriteOptions:
    """Rebuild :class:`WriteOptions` from ``dataclasses.asdict`` output.

    The plain-data form carries a configuration across processes and
    packages: ``retry_policy`` comes back as a :class:`RetryPolicy` (its
    errno list as a tuple), every other field verbatim.  Unknown keys
    raise ``TypeError``, as the dataclass constructor does.
    """
    d = dict(d)
    rp = d.get("retry_policy")
    if isinstance(rp, dict):
        rp = dict(rp)
        if "retryable_errnos" in rp:
            rp["retryable_errnos"] = tuple(rp["retryable_errnos"])
        d["retry_policy"] = RetryPolicy(**rp)
    return WriteOptions(**d)
