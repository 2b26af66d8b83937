"""The paper's comparison baselines: file merging (hadd) and TBufferMerger.

Both exploit cluster relocatability: the **raw fast path** never
recompresses — sealed cluster bytes are copied verbatim and only the
metadata (entry ranges, page locators) is rebuilt, exactly like ROOT's
fast hadd path.  When the caller asks for a *different* codec than an
input file carries, that input takes the **re-encode slow path** instead:
it streams through the read engine's prefetching cluster iterator and is
refilled through the normal write path (hadd's slow mode).

Device (``device=``, default ``"cuda"``): the merge's readers and its
output writer take the caller's device, so the re-encode path's offsets
scan and byte-plane split run as CUDA kernels on a card, or as their plain
PyTorch versions on ``device="cpu"``.  The raw copy runs no kernel.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

from .bufpool import Recyclable
from .container import MemorySink, close_all
from .encoding import offsets_to_sizes
from .metadata import ClusterMeta
from .reader import RNTJReader
from .schema import KIND_OFFSET, ColumnBatch, Schema
from .writer import ParallelWriter, SequentialWriter, WriteOptions, _WriterBase


def _copy_clusters(reader: RNTJReader, writer: _WriterBase) -> None:
    """Raw fast path: copy committed clusters byte-verbatim.

    The critical section per cluster is the same reserve+metadata protocol
    as parallel writing — relocatability makes this a pure byte copy, no
    decompression and no re-encoding.  The bytes go out through the
    writer's I/O engine, so merges inherit striping and write-behind from
    the output's ``WriteOptions`` for free (framed-member side-car records
    ride along on the rebased descriptors).  With a writer buffer pool
    the copy buffer is pooled too — ``pread_into`` a recycled buffer,
    returned by the engine when the cluster's write lands — so the merge
    path performs no per-cluster allocation in steady state.
    """
    pool = writer._bufpool
    for idx, cm in enumerate(reader.clusters):
        owner = None
        if cm.byte_size:
            if pool is not None:
                blob = pool.take_view(cm.byte_size)
                reader.sink.pread_into(cm.byte_offset, blob)
                owner = Recyclable([blob.obj])
            else:
                blob = reader.sink.pread(cm.byte_offset, cm.byte_size)
            base = cm.byte_offset
        else:
            # unbuffered-mode source: pages are scattered; gather them.
            pages = sorted(cm.pages, key=lambda p: p.offset)
            descs = []
            pos = 0
            for p in pages:
                q = p.rebase(-p.offset)  # zero-base
                q.offset = pos
                pos += p.size
                descs.append(q)
            if pool is not None:
                blob = pool.take_view(pos)
                for p, q in zip(pages, descs):
                    reader.sink.pread_into(
                        p.offset, blob[q.offset : q.offset + p.size]
                    )
                owner = Recyclable([blob.obj])
            else:
                blob = b"".join(
                    reader.sink.pread(p.offset, p.size) for p in pages
                )
            cm = ClusterMeta(cm.first_entry, cm.n_entries, cm.n_elements, descs, 0, len(blob))
            base = 0
        # reserve + metadata + envelope/journal framing + submit: the same
        # critical section every direct commit uses, so merged outputs are
        # crash-recoverable exactly like directly written ones.  Zone maps
        # travel verbatim: their entry indices are cluster-relative, so a
        # byte-verbatim cluster copy keeps them valid without a rebase.
        writer._commit_raw_cluster(blob, cm.n_entries, cm.n_elements,
                                   cm.pages, base, owner=owner,
                                   zonemaps=reader.zonemaps[idx])


def _reencode_clusters(reader: RNTJReader, writer: ParallelWriter) -> None:
    """Slow path: decode through the read engine, refill through the
    write path — used when the output codec differs from the input's.

    Streams via the prefetching cluster iterator, so the next cluster's
    I/O + decode overlaps this cluster's re-compression.
    """
    ctx = writer.create_fill_context()
    try:
        for ci, cols in reader.iter_clusters():
            cm = reader.clusters[ci]
            data = {}
            for c in reader.schema.columns:
                arr = cols[c.index]
                # on-disk offsets are cluster-relative ends; the fill
                # path wants per-collection sizes back
                data[c.index] = (
                    offsets_to_sizes(arr) if c.kind == KIND_OFFSET else arr
                )
            ctx.fill_batch(ColumnBatch(reader.schema, cm.n_entries, data))
    finally:
        ctx.close()


def _needs_reencode(
    reader: RNTJReader,
    out: ParallelWriter,
    options: Optional[WriteOptions],
    recompress: Optional[bool],
) -> bool:
    if recompress is not None:
        return recompress
    # encodings are file-level state (e.g. a precondition=False source):
    # raw-copying clusters whose per-column encodings differ from what the
    # output header records would silently mis-decode, so such inputs
    # always re-encode
    if [c.encoding for c in reader.schema.columns] != out.column_encodings():
        return True
    if options is None:
        return False  # no target codec named: raw copy, never recompress
    src = reader.options.get("codec")
    return src is not None and int(src) != options.codec_id


def merge_files(
    inputs: Sequence[str],
    output,
    options: Optional[WriteOptions] = None,
    schema: Optional[Schema] = None,
    recompress: Optional[bool] = None,
    device="cuda",
) -> None:
    """``hadd`` analog: sequential post-processing merge of many files.

    The paper's Fig. 5 "separate files + merge" baseline: scalable writing
    but pays a read-back + rewrite and transiently doubles storage.

    Inputs whose on-disk codec matches the requested ``options.codec``
    (or all inputs, when ``options`` is None) take the raw byte-verbatim
    fast path; mismatching inputs are decoded and re-encoded with
    ``options``.  ``recompress`` overrides the auto choice: ``True``
    forces the re-encode path, ``False`` forces raw copy.  ``device`` is
    where the readers and the output writer run.
    """
    readers: List[RNTJReader] = []
    try:
        for p in inputs:  # opened one at a time: a failed open leaks nothing
            readers.append(RNTJReader(p, device=device))
        schema = schema or readers[0].schema
        for r in readers:
            if r.schema != schema:
                raise ValueError("cannot merge files with differing schemas")
        out = ParallelWriter(schema, output, options, device=device)
        try:
            for r in readers:
                if _needs_reencode(r, out, options, recompress):
                    _reencode_clusters(r, out)
                else:
                    _copy_clusters(r, out)
        finally:
            # surfaces a poisoned close on the success path; suppresses
            # it while another exception is already unwinding
            close_all([out])
    finally:
        close_all(readers)


class BufferMerger:
    """TBufferMerger analog (paper §2): per-producer in-memory files merged
    into one output from the worker threads themselves.

    Each producer gets a :class:`BufferMergerFile` — a complete sequential
    writer into a :class:`MemorySink`.  On ``commit()`` the worker takes the
    merger lock and copies its clusters into the shared output.  Matching
    the refined TBufferMerger design, there is no queue: workers block until
    they may merge.
    """

    def __init__(self, schema: Schema, output, options: Optional[WriteOptions] = None,
                 device="cuda"):
        self.schema = schema
        self.options = options or WriteOptions()
        self.out = ParallelWriter(schema, output, self.options, device=device)
        self.device = self.out.device
        self._merge_lock = threading.Lock()

    def get_file(self) -> "BufferMergerFile":
        return BufferMergerFile(self)

    def close(self) -> None:
        self.out.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class BufferMergerFile:
    def __init__(self, merger: BufferMerger):
        self.merger = merger
        self._new_writer()

    def _new_writer(self) -> None:
        self.sink = MemorySink()
        self.writer = SequentialWriter(
            self.merger.schema, self.sink, self.merger.options,
            device=self.merger.device,
        )

    def fill(self, entry) -> None:
        self.writer.fill(entry)

    def fill_batch(self, batch) -> None:
        self.writer.fill_batch(batch)

    def commit(self) -> None:
        """Close the in-memory file and merge it into the shared output."""
        self.writer.close()
        reader = RNTJReader(self.sink, device=self.merger.device)
        with self.merger._merge_lock:
            _copy_clusters(reader, self.merger.out)
        self._new_writer()

    def close(self) -> None:
        has_data = self.writer.n_entries > 0 or not self.writer._builder.is_empty
        if has_data:
            self.commit()
        self.writer.close()
