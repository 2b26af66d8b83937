"""Clusters: the (default) unit of writing (paper §4, §5).

A cluster holds all pages of a consecutive range of entries.  Offset
columns are accumulated as *sizes* and integrated to **cluster-relative**
offsets at seal time, which makes the sealed byte blob relocatable: it can
be committed at any file offset without content changes — the property
that lets serialization and compression run with no synchronization.

Hot-path layout: each column accumulates into a contiguous, amortized-
doubling :class:`~repro_torch.core.colbuf.ColumnBuffer` — appends are vectorized
copies, offset integration happens in place on the reserved tail, and page
extraction at seal time is a zero-copy view slice (no ``np.concatenate``).

``seal()`` is the ONE compression code path shared by the sequential
writer (IMT mode) and the parallel writer, structured as two passes:

1. **column-batched preconditioning** on the sealing thread — every
   column's pages split/delta-encoded in a handful of vectorized calls
   (with the ``byteshuffle_pages`` kernel dispatch of the writer's device);
2. **chunk-granular compression** — each page becomes one or more framed
   compression jobs (pages above ``chunk_bytes`` split into independent
   concatenated members), distributed over the writer-owned pool when one
   is given, so a *single producer* sealing one cluster saturates the
   pool.  zlib/lzma/bz2 (and lz4/zstd when installed) release the GIL, so
   members compress truly in parallel; per-page CRCs fold over the
   members incrementally.

Per-column codecs resolve once per builder (``column_codecs``), and an
optional shared :class:`~repro_torch.core.compression.CodecPolicy` downgrades
columns whose sampled compression ratio is not worth the CPU to raw
storage.  The pooled and serial paths are byte-identical.
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, replace as dc_replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import compression as comp
from .colbuf import ColumnBuffer
from .encoding import EncodeScratch, integrate_sizes, precondition_column_pages
from .pages import PageDesc, build_page, elements_per_page
from .schema import (
    ENC_NONE,
    KIND_OFFSET,
    OFFSET_DTYPE,
    ColumnBatch,
    Schema,
    decompose_entry,
)

_ns = time.perf_counter_ns

# plan-slot sentinel: this page's codec resolves mid-seal, after the
# column's adaptive-policy trial pages have been compressed and recorded
_PENDING = -2


@dataclass
class SealedCluster:
    """A serialized+compressed cluster, ready to commit anywhere.

    Two carrier forms, byte-identical on disk (DESIGN.md §6):

    * **assembled** — ``blob`` is a bytes-like single allocation holding
      every page payload back to back (the reference path);
    * **scatter-gather** — ``blob`` is ``None`` and ``iovecs`` is the
      ordered list of page-payload buffers (bytes for compressed pages,
      zero-copy views of the builder's detached buffers for raw pages),
      handed to ``Sink.pwritev`` with no assembly memcpy.  The views keep
      their backing arrays alive; the builder detached those buffers at
      seal time, so queued write-behind commits stay valid while the
      builder refills.

    ``pages[i]`` descriptors carry cluster-relative offsets into the
    payload stream either way.  ``codec_stats`` maps codec id ->
    ``[pages, bytes_in, bytes_out, ns]`` so writer stats can attribute
    bytes and time to each codec.
    """

    blob: Optional[bytes]          # bytes-like (bytearray from seal())
    n_entries: int
    n_elements: List[int]          # per column
    pages: List[PageDesc]          # cluster-relative offsets
    uncompressed_bytes: int
    seal_ns: int = 0               # wall time of the whole seal
    compress_ns: int = 0           # summed per-page build time (CPU view)
    codec_stats: Optional[Dict[int, List[int]]] = None
    iovecs: Optional[List] = None  # scatter-gather payload buffers
    nbytes: int = -1               # total payload bytes (-1: use len(blob))
    # detached buffers backing raw-stored iovecs, returned to the
    # writer's BufferPool by the I/O engine once this cluster's last
    # write lands (this object and its iovecs must not be read after
    # that point — DESIGN.md §6.8)
    recycle: Optional[List] = None
    # per-page zone maps (DESIGN.md §11): column index -> parallel page
    # lists {"fe","le"[,"lo","hi","nn"]}, cluster-relative entry indices
    zonemaps: Optional[Dict[int, Dict[str, list]]] = None

    @property
    def size(self) -> int:
        if self.nbytes >= 0:
            return self.nbytes
        return len(self.blob)

    def iov_plan(self) -> List:
        """The write plan: payload buffers in offset order (an assembled
        cluster is simply a one-buffer plan)."""
        if self.iovecs is not None:
            return self.iovecs
        return [self.blob]

    def tobytes(self) -> bytes:
        """Materialize the full payload (tests / reference comparisons)."""
        if self.blob is not None:
            return bytes(self.blob)
        return b"".join(bytes(memoryview(p)) for p in self.iovecs)

    def rebase(self, base: int) -> List[PageDesc]:
        return [p.rebase(base) for p in self.pages]


class ClusterBuilder:
    """Accumulates decomposed entries and seals them into a cluster.

    Also supports *page draining* for the unbuffered (page-granular) writer
    mode: whenever a column holds a full page of elements it can be built
    and handed out immediately.

    Builders are reusable: after :meth:`seal` / :meth:`finish_unbuffered`
    the column buffers keep their storage, so refilling performs no
    allocations in steady state (this is what double-buffered pipelined
    sealing relies on).

    ``column_codecs`` is an optional per-column ``[(codec_id, level)]``
    resolution (writers compute it once from ``WriteOptions`` +
    ``ColumnSpec`` overrides); ``policy`` is the writer-shared adaptive
    :class:`~repro_torch.core.compression.CodecPolicy`; ``chunk_bytes`` frames
    pages larger than it into independently compressed members; and
    ``precondition=False`` disables split/delta encodings (every column
    stored with ``ENC_NONE``, matching the header's ``precondition`` flag).
    ``kernels`` is the writer's :class:`~repro_torch.kernels.ops.EncodeKernels`
    (the offsets-scan and byteshuffle dispatch of its device); ``None``
    keeps every column on the numpy reference.
    """

    def __init__(self, schema: Schema, page_size: int, codec: int, level: int = -1,
                 checksum: bool = True,
                 column_codecs: Optional[Sequence[Tuple[int, int]]] = None,
                 chunk_bytes: int = 0,
                 policy: Optional[comp.CodecPolicy] = None,
                 precondition: bool = True,
                 scatter: bool = False,
                 buffer_pool=None,
                 zone_maps: bool = True,
                 kernels=None):
        self.schema = schema
        self._offsets_kernel = kernels.offsets if kernels is not None else None
        self._shuffle_kernel = kernels.shuffle if kernels is not None else None
        self.page_size = page_size
        self.codec = codec
        self.level = level
        self.checksum = checksum
        self.chunk_bytes = chunk_bytes
        self.scatter = scatter
        self.zone_maps = zone_maps
        # writer-shared BufferPool (DESIGN.md §6.8): column storage and
        # preconditioning scratch draw from it, and seal() hands detached
        # buffers to the sealed cluster for completion-time recycling
        self._bufpool = buffer_pool
        self._policy = policy
        # effective per-column specs: encodings drop to ENC_NONE when
        # preconditioning is disabled (the reader honors the header flag)
        self._specs = [
            c if precondition else dc_replace(c, encoding=ENC_NONE)
            for c in schema.columns
        ]
        self._page_elems = [
            elements_per_page(c, page_size) for c in schema.columns
        ]
        self._cols = [
            ColumnBuffer(
                OFFSET_DTYPE if c.kind == KIND_OFFSET else c.dtype,
                capacity=self._page_elems[c.index],
                pool=buffer_pool,
            )
            for c in schema.columns
        ]
        # cluster-relative running end-offset per offset column
        self._acc_offset = [0] * schema.n_columns
        self.n_entries = 0
        self.uncompressed_bytes = 0
        # unbuffered mode: elements already drained into standalone pages
        self._drained: List[int] = [0] * schema.n_columns
        # unbuffered mode: zone-map rows accumulated as pages drain
        self._zm_acc: Dict[int, Dict[str, list]] = {}
        # seal() runs on one thread at a time; the scratch amortizes the
        # column-wide preconditioning temporaries across clusters (and
        # recycles them through the pool when one is attached)
        self._scratch = EncodeScratch(pool=buffer_pool)
        # None = no explicit table: every page uses the live
        # ``self.codec``/``self.level`` (kept mutable for tests and
        # ad-hoc callers)
        self._column_codecs = (
            list(column_codecs) if column_codecs is not None else None
        )

    # -- filling -----------------------------------------------------------

    def fill(self, entry: Dict) -> None:
        arrays = decompose_entry(self.schema, entry)
        self._append_arrays(arrays, 1)

    def fill_batch(self, batch: ColumnBatch) -> None:
        if batch.schema.n_columns != self.schema.n_columns:
            raise ValueError("batch schema does not match writer schema")
        arrays = [batch.data[c.index] for c in self.schema.columns]
        self._append_arrays(arrays, batch.n_entries)

    def _append_arrays(self, arrays: Sequence[np.ndarray], n_entries: int) -> None:
        for col in self.schema.columns:
            a = arrays[col.index]
            n = len(a)
            if not n:
                continue
            buf = self._cols[col.index]
            if col.kind == KIND_OFFSET:
                # sizes -> cluster-relative end offsets, integrated in
                # place on the reserved buffer tail (no temporary)
                dst = buf.reserve(n)
                integrate_sizes(a, base=self._acc_offset[col.index], out=dst,
                                offsets=self._offsets_kernel)
                self._acc_offset[col.index] = int(dst[-1])
            else:
                buf.extend(a)
            self.uncompressed_bytes += n * buf.dtype.itemsize
        self.n_entries += n_entries

    @property
    def is_empty(self) -> bool:
        return self.n_entries == 0

    def n_elements(self, idx: int) -> int:
        return len(self._cols[idx])

    # -- sealing (buffered mode) --------------------------------------------

    def _column_elements(self, idx: int) -> np.ndarray:
        """Zero-copy view of all elements accumulated for column ``idx``."""
        return self._cols[idx].view()

    def _page_codec(self, column: int) -> Tuple[int, int]:
        """(codec, level) for the column's next page, after the adaptive
        policy's say."""
        if self._column_codecs is not None:
            codec, level = self._column_codecs[column]
        else:
            codec, level = self.codec, self.level
        if self._policy is not None:
            codec = self._policy.effective_codec(column, codec)
        return codec, level

    # -- zone maps (DESIGN.md §11) ------------------------------------------

    def _entries_of(self, ci: int, pos: np.ndarray) -> np.ndarray:
        """Cluster-relative entry index of each element position of
        column ``ci``, walking positions up the offset-column chain
        (offset columns hold cluster-relative *end* offsets, so the
        parent element of child position j is the first i with
        ends[i] > j)."""
        p = self.schema.parent[ci]
        while p != -1:
            pos = np.searchsorted(self._cols[p].view(), pos, side="right")
            p = self.schema.parent[p]
        return pos

    def _zone_page_row(self, col, elems: np.ndarray, start: int,
                       stop: int) -> None:
        """Accumulate one page's zone-map row (unbuffered drain path)."""
        d = self._zm_acc.setdefault(
            col.index,
            {"fe": [], "le": []} if col.kind == KIND_OFFSET
            else {"fe": [], "le": [], "lo": [], "hi": [], "nn": []},
        )
        fe, le = self._entries_of(
            col.index, np.array([start, stop - 1], dtype=np.int64)
        ).tolist()
        d["fe"].append(fe)
        d["le"].append(le)
        if col.kind == KIND_OFFSET:
            return
        if elems.dtype.kind == "f":
            d["lo"].append(float(np.fmin.reduce(elems)))
            d["hi"].append(float(np.fmax.reduce(elems)))
            d["nn"].append(int(np.count_nonzero(np.isnan(elems))))
        else:
            d["lo"].append(elems.min().item())
            d["hi"].append(elems.max().item())
            d["nn"].append(0)

    def _zone_maps(self) -> Optional[Dict[int, Dict[str, list]]]:
        """Per-page zone maps for every non-empty column.

        For each page: first/last cluster-relative entry index (element
        positions walked up the offset chain), plus — for leaf columns —
        min/max over non-NaN elements and the NaN ("null") count.  One
        vectorized ``reduceat`` pass per column over the still-contiguous
        column buffers; an all-NaN page records NaN bounds.
        """
        if not self.zone_maps:
            return None
        zm: Dict[int, Dict[str, list]] = {}
        for col in self.schema.columns:
            n = len(self._cols[col.index])
            if n == 0:
                continue
            per = self._page_elems[col.index]
            starts = np.arange(0, n, per, dtype=np.int64)
            fe = self._entries_of(col.index, starts)
            le = self._entries_of(
                col.index, np.minimum(starts + per, n) - 1
            )
            entry = {"fe": fe.tolist(), "le": le.tolist()}
            if col.kind != KIND_OFFSET:
                elems = self._cols[col.index].view()
                if elems.dtype.kind == "f":
                    lo = np.fmin.reduceat(elems, starts)
                    hi = np.fmax.reduceat(elems, starts)
                    nn = np.add.reduceat(
                        np.isnan(elems).astype(np.int64), starts
                    )
                else:
                    lo = np.minimum.reduceat(elems, starts)
                    hi = np.maximum.reduceat(elems, starts)
                    nn = np.zeros(len(starts), dtype=np.int64)
                entry["lo"] = lo.tolist()
                entry["hi"] = hi.tolist()
                entry["nn"] = nn.tolist()
            zm[col.index] = entry
        return zm

    def seal(self, pool=None) -> SealedCluster:
        """Serialize + compress all pages.  No lock required (paper §4.1).

        The single compression code path behind both ROOT-style IMT in the
        sequential writer and the shared writer-owned pool of the parallel
        writer.  Pass 1 preconditions whole columns in O(1) vectorized
        calls on this thread; pass 2 compresses chunk-granular jobs — over
        ``pool`` (any Executor with ``map``) when given, serially
        otherwise, with byte-identical output either way.

        While the adaptive policy is still *sampling* a column, only its
        next ``sample_pages`` pages are compressed up front (the trial);
        the column's remaining pages are marked ``_PENDING`` and resolve
        — mid-seal, once the trial results are recorded — to either the
        codec or raw storage, so a doomed codec never burns more than the
        sample on its first cluster.
        """
        t0 = _ns()
        # zone maps come first: the column views are still contiguous and
        # untouched (gathering may detach raw-aliased buffers later)
        zonemaps = self._zone_maps()
        # pass 1: column-batched preconditioning -> per-page plan
        # [column, n_elements, raw_u8_view, codec, level] (mutable: the
        # codec slot of _PENDING pages is resolved in pass 2).  Each
        # column gets its own scratch key so every page's payload stays
        # alive until assembly.
        plan: List[List] = []
        for col in self._specs:
            elems = self._cols[col.index].view()
            n = len(elems)
            if n == 0:
                continue
            per = self._page_elems[col.index]
            itemb = elems.dtype.itemsize
            codec, level = self._page_codec(col.index)
            budget = None
            if (
                self._policy is not None
                and codec != comp.CODEC_NONE
                and self._policy.decision(col.index) is None
            ):
                budget = self._policy.remaining_sample(col.index)
            raw_all = precondition_column_pages(
                elems, col.encoding, per, self._scratch,
                out_key=f"u8:{col.index}", shuffle=self._shuffle_kernel,
            )
            for pi, start in enumerate(range(0, n, per)):
                count = min(per, n - start)
                page_codec = (
                    _PENDING if budget is not None and pi >= budget else codec
                )
                plan.append([
                    col.index, count,
                    raw_all[start * itemb : (start + count) * itemb],
                    page_codec, level,
                ])
        # pass 2: chunk-granular compression
        if pool is None:
            payloads, build_ns = self._compress_serial(plan)
        else:
            payloads, build_ns = self._compress_pooled(plan, pool)
        final, total = self._finalize(plan, payloads)
        # element counts BEFORE gathering: _detach_aliased hands raw-page
        # columns' storage to the sealed cluster, emptying the buffers
        n_elements = [len(c) for c in self._cols]
        recycle = None
        if self.scatter:
            blob = None
            iovecs, descs, compress_ns, codec_stats, recycle = self._gather(
                plan, final, build_ns
            )
        else:
            iovecs = None
            blob, descs, compress_ns, codec_stats = self._assemble(
                plan, final, build_ns, total
            )
        sealed = SealedCluster(
            blob=blob,
            n_entries=self.n_entries,
            n_elements=n_elements,
            pages=descs,
            uncompressed_bytes=self.uncompressed_bytes,
            seal_ns=_ns() - t0,
            compress_ns=compress_ns,
            codec_stats=codec_stats,
            iovecs=iovecs,
            nbytes=total,
            recycle=recycle,
            zonemaps=zonemaps,
        )
        self._reset()
        return sealed

    def _record_trial(self, ci: int, raw_len: int, size: int,
                      ns: int = 0) -> None:
        if self._policy is not None:
            self._policy.record(ci, raw_len, size, ns)

    def _resolve_pending(self, ci: int) -> int:
        """A _PENDING page's codec, once its column's trial is recorded.

        Falls back to the configured codec when the sample is still short
        (the column simply had fewer pages than the sample wants)."""
        codec, _level = self._page_codec(ci)
        return codec

    def _compress_serial(self, plan):
        """Compress every planned page on this thread (member-framed)."""
        payloads: List[Optional[List[bytes]]] = []
        build_ns: List[int] = []
        for entry in plan:
            ci, _count, raw, codec, level = entry
            if codec == _PENDING:
                # the column's trial pages precede this page in the plan,
                # so their ratios are recorded by now
                codec = entry[3] = self._resolve_pending(ci)
            if codec == comp.CODEC_NONE:
                payloads.append(None)
                build_ns.append(0)
                continue
            tb = _ns()
            parts = comp.compress_parts(raw, codec, level, self.chunk_bytes)
            build_ns.append(_ns() - tb)
            payloads.append(parts)
            self._record_trial(ci, len(raw), sum(len(p) for p in parts),
                               build_ns[-1])
        return payloads, build_ns

    def _compress_pooled(self, plan, pool):
        """Distribute chunk-granular compression jobs over ``pool``.

        Jobs are (page, member) pairs: one small page is one job, a page
        above ``chunk_bytes`` fans out into one job per member — which is
        how a single producer's seal saturates the whole pool.  ``map``
        preserves order, so reassembly (and the resulting bytes) match
        the serial path exactly.  _PENDING pages wait for the first
        phase's trial results, then compress (or store) in a second
        phase — an extra barrier paid only while the policy samples.
        """
        payloads: List[Optional[List[bytes]]] = [None] * len(plan)
        build_ns: List[int] = [0] * len(plan)

        def run(job):
            i, a, b = job
            _ci, _count, raw, codec, level = plan[i]
            c = comp.require(codec)
            if level < 0:
                level = c.default_level
            tb = _ns()
            out = c.compress(memoryview(raw)[a:b], level)
            return i, out, _ns() - tb

        def submit(indices):
            jobs: List[Tuple[int, int, int]] = []
            for i in indices:
                raw = plan[i][2]
                for a, b in comp.chunk_ranges(len(raw), self.chunk_bytes):
                    jobs.append((i, a, b))
            for i, out, dt in pool.map(run, jobs):
                if payloads[i] is None:
                    payloads[i] = []
                payloads[i].append(out)
                build_ns[i] += dt
            for i in indices:
                self._record_trial(
                    plan[i][0], len(plan[i][2]),
                    sum(len(p) for p in payloads[i]), build_ns[i],
                )

        pending = [i for i, e in enumerate(plan) if e[3] == _PENDING]
        submit([
            i for i, e in enumerate(plan)
            if e[3] not in (comp.CODEC_NONE, _PENDING)
        ])
        if pending:
            for i in pending:
                plan[i][3] = self._resolve_pending(plan[i][0])
            submit([i for i in pending if plan[i][3] != comp.CODEC_NONE])
        return payloads, build_ns

    def _finalize(self, plan, payloads):
        """Per-page fallback decisions: ``[(parts|None, used_codec, size)]``.

        ``parts is None`` means the page stores its raw preconditioned
        bytes verbatim (``CODEC_NONE``) — either because no codec was
        configured or because compression did not shrink it (ROOT's
        store-uncompressed fallback).
        """
        final: List[Tuple[Optional[List[bytes]], int, int]] = []
        total = 0
        for (ci, _count, raw, codec, _level), parts in zip(plan, payloads):
            nbytes = len(raw)
            if parts is None:
                used, size = comp.CODEC_NONE, nbytes
                parts = None
            else:
                size = sum(len(p) for p in parts)
                if size >= nbytes:
                    # Like ROOT, store uncompressed when compression does
                    # not shrink the page.
                    used, size, parts = comp.CODEC_NONE, nbytes, None
                else:
                    used = codec
            final.append((parts, used, size))
            total += size
        return final, total

    def _page_desc(self, ci, count, raw, parts, used, size, pos):
        """Build one page descriptor (checksum folded over the parts)."""
        crc = 0
        if self.checksum:
            for p in parts:
                # per-chunk CRCs fold into the page checksum
                # incrementally: equals the whole-payload crc32
                crc = zlib.crc32(p, crc)
        members = None
        if used != comp.CODEC_NONE and len(parts) > 1:
            members = [len(p) for p in parts]
        return PageDesc(
            column=ci,
            n_elements=count,
            offset=pos,
            size=size,
            uncompressed_size=len(raw),
            checksum=crc,
            codec=used,
            members=members,
            member_chunk=self.chunk_bytes if members else 0,
        )

    def _assemble(self, plan, final, build_ns, total):
        """Checksums + single-allocation assembly (the reference path)."""
        blob = bytearray(total)
        mv = memoryview(blob)
        descs: List[PageDesc] = []
        codec_stats: Dict[int, List[int]] = {}
        compress_ns = 0
        pos = 0
        for (ci, count, raw, _codec, _level), (parts, used, size), ns in zip(
            plan, final, build_ns
        ):
            if parts is None:
                parts = (raw,)
            descs.append(self._page_desc(ci, count, raw, parts, used, size, pos))
            for p in parts:
                mv[pos : pos + len(p)] = p
                pos += len(p)
            compress_ns += ns
            st = codec_stats.setdefault(used, [0, 0, 0, 0])
            st[0] += 1
            st[1] += len(raw)
            st[2] += size
            st[3] += ns
        return blob, descs, compress_ns, codec_stats

    def _gather(self, plan, final, build_ns):
        """Zero-copy iovec plan: page payloads in offset order, no blob.

        Byte-identical to :meth:`_assemble`'s blob (the benchmarks and
        tests assert it), minus the full-cluster memcpy.  Raw-stored parts
        are views of the builder's preconditioning buffers; those buffers
        are detached (see :meth:`_detach_aliased`) so the plan stays valid
        while this builder refills and the write drains in the background.
        """
        iovecs: List = []
        descs: List[PageDesc] = []
        codec_stats: Dict[int, List[int]] = {}
        compress_ns = 0
        pos = 0
        alias_cols = set()
        for (ci, count, raw, _codec, _level), (parts, used, size), ns in zip(
            plan, final, build_ns
        ):
            if parts is None:
                parts = (raw,)
                alias_cols.add(ci)
            descs.append(self._page_desc(ci, count, raw, parts, used, size, pos))
            for p in parts:
                # normalize ndarray views to memoryviews: every sink's
                # pwritev (and bytearray slice assignment) accepts those
                iovecs.append(memoryview(p) if isinstance(p, np.ndarray) else p)
                pos += len(p)
            compress_ns += ns
            st = codec_stats.setdefault(used, [0, 0, 0, 0])
            st[0] += 1
            st[1] += len(raw)
            st[2] += size
            st[3] += ns
        recycle = self._detach_aliased(alias_cols)
        return iovecs, descs, compress_ns, codec_stats, recycle

    def _detach_aliased(self, alias_cols) -> Optional[List]:
        """Hand ownership of raw-aliased buffers to the sealed cluster.

        A raw-stored part is a view of either this builder's per-column
        preconditioning scratch (split/dzs encodings) or the live
        :class:`ColumnBuffer` storage (``none`` encoding).  numpy views
        keep their base arrays alive, so the only hazard is *reuse*: the
        next fill/seal of this builder would overwrite the bytes before a
        write-behind commit drains them.  Dropping the scratch slot /
        detaching the ColumnBuffer storage makes the next cluster allocate
        fresh buffers — recycled from the writer's :class:`BufferPool`
        when one is attached, a fresh O(1) allocation otherwise; either
        way no O(bytes) assembly memcpy.  Columns whose pages all
        compressed keep their buffers for steady-state reuse.

        Returns the detached arrays so the sealed cluster can carry them
        to the I/O engine, which returns them to the pool when the
        cluster's last write lands (``SealedCluster.recycle``).
        """
        if not alias_cols:
            return None
        detached: List = []
        for col in self._specs:
            if col.index not in alias_cols:
                continue
            if col.encoding == ENC_NONE:
                detached.append(self._cols[col.index].detach())
            else:
                buf = self._scratch._bufs.pop(f"u8:{col.index}", None)
                if buf is not None:
                    detached.append(buf)
        return detached if self._bufpool is not None else None

    # -- page draining (unbuffered mode) -------------------------------------

    def drain_full_pages(self, pool=None) -> List[Tuple[bytes, PageDesc, int]]:
        """Build pages for every column that holds >= one full page.

        Used by the page-granular ("unbuffered") writer: compressed pages
        are written out immediately, only their descriptors are retained
        until the cluster is finalized (paper §5).  ``pool`` parallelizes
        the members of chunk-framed pages.  Yields ``(payload, desc,
        build_ns)`` so writer stats can attribute the build time per codec.
        """
        out: List[Tuple[bytes, PageDesc, int]] = []
        for col in self._specs:
            per = self._page_elems[col.index]
            start = self._drained[col.index]
            pending = len(self._cols[col.index]) - start
            if pending < per:
                continue
            while pending >= per:
                out.append(self._drain_one(col, start, start + per, pool))
                start += per
                pending -= per
            self._drained[col.index] = start
        return out

    def drain_rest(self, pool=None) -> List[Tuple[bytes, PageDesc, int]]:
        """Build the final partial pages (cluster finalization)."""
        out: List[Tuple[bytes, PageDesc, int]] = []
        for col in self._specs:
            start = self._drained[col.index]
            per = self._page_elems[col.index]
            end = len(self._cols[col.index])
            while start < end:
                payload, desc, ns = self._drain_one(
                    col, start, start + per, pool
                )
                out.append((payload, desc, ns))
                start += desc.n_elements
            self._drained[col.index] = start
        return out

    def _drain_one(self, col, start, stop, pool):
        codec, level = self._page_codec(col.index)
        elems = self._cols[col.index].view(start, stop)
        if self.zone_maps:
            self._zone_page_row(col, elems, start, start + len(elems))
        t0 = _ns()
        payload, desc = build_page(
            col, elems, codec, level, self.checksum, self.chunk_bytes, pool,
            buffer_pool=self._bufpool,
        )
        build_ns = _ns() - t0
        if self._policy is not None and codec != comp.CODEC_NONE:
            # after an in-page raw fallback desc.size == uncompressed_size,
            # which records as ratio 1.0 — the right signal either way
            self._policy.record(col.index, desc.uncompressed_size, desc.size,
                                build_ns)
        return payload, desc, build_ns

    def finish_unbuffered(self) -> Tuple[int, List[int], int]:
        """Return (n_entries, per-column n_elements, uncompressed) and reset."""
        res = (self.n_entries, [len(c) for c in self._cols], self.uncompressed_bytes)
        self._reset()
        return res

    def take_zonemaps(self) -> Optional[Dict[int, Dict[str, list]]]:
        """Zone-map rows accumulated by page draining (unbuffered mode).
        Must be called before :meth:`finish_unbuffered`'s reset."""
        if not self.zone_maps or not self._zm_acc:
            return None
        zm = self._zm_acc
        self._zm_acc = {}
        return zm

    def _reset(self) -> None:
        # keep the ColumnBuffer storage: steady-state refills are
        # allocation-free (and pipelined sealing hands builders back
        # for exactly this reuse)
        for c in self._cols:
            c.reset()
        self._acc_offset = [0] * self.schema.n_columns
        self._drained = [0] * self.schema.n_columns
        self._zm_acc = {}
        self.n_entries = 0
        self.uncompressed_bytes = 0
