"""Pages: the unit of compression (paper §3).

Elements of a column are written consecutively into pages; a page is
preconditioned (encoding.py) and compressed (compression.py) as one block.
RNTuple targets 64 KiB of uncompressed elements per page by default
(paper §6.1) — we keep that default.
"""

from __future__ import annotations

import threading
import time
import zlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from . import compression as comp
from .encoding import (
    EncodeScratch,
    precondition_buffer,
    unprecondition,
    unprecondition_into,
)
from .schema import ColumnSpec

DEFAULT_PAGE_SIZE = 64 * 1024

# Per-thread reusable preconditioning scratch: build_page runs concurrently
# on compression-pool workers, each of which amortizes its own buffers.
_TLS = threading.local()


def _thread_scratch() -> EncodeScratch:
    scratch = getattr(_TLS, "scratch", None)
    if scratch is None:
        scratch = _TLS.scratch = EncodeScratch()
    return scratch


@dataclass
class PageDesc:
    """Descriptor of one page; lives in the page list (paper §3).

    ``offset`` is cluster-relative while the cluster is sealed-but-uncommitted
    (that is the relocatability property), and absolute once committed.

    ``members``/``member_chunk`` describe the framed-chunk layout of a
    compressed page (DESIGN.md §5.2): the compressed byte size of each
    independent member and the uncompressed bytes every full member
    decodes to.  They are NOT part of the fixed page record — they ride
    in the optional member side-car envelope (metadata.py) so the read
    engine can decompress a page's members as parallel pool jobs; files
    without the side-car (or pages without framing) decode exactly as
    before.
    """

    column: int
    n_elements: int
    offset: int
    size: int                # compressed bytes
    uncompressed_size: int
    checksum: int
    codec: int
    members: Optional[List[int]] = None  # per-member compressed sizes
    member_chunk: int = 0                # uncompressed bytes per full member

    def rebase(self, base: int) -> "PageDesc":
        return PageDesc(
            self.column,
            self.n_elements,
            self.offset + base,
            self.size,
            self.uncompressed_size,
            self.checksum,
            self.codec,
            self.members,
            self.member_chunk,
        )


def build_page(
    col: ColumnSpec,
    elements: np.ndarray,
    codec: int,
    level: int = -1,
    checksum: bool = True,
    chunk_bytes: int = 0,
    pool=None,
    buffer_pool=None,
) -> (bytes, PageDesc):
    """Precondition + compress one page of elements.

    Runs with NO synchronization — this is the paper's §4.1 observation that
    serialization and compression parallelize perfectly once the unit of
    writing is relocatable.

    With ``chunk_bytes > 0``, a page whose preconditioned payload exceeds
    it is compressed as independent concatenated members (framed
    chunking) — concurrently when ``pool`` is given — and the page
    checksum folds over the members incrementally, which equals the
    whole-payload CRC, so the on-disk format is unchanged.

    ``elements`` may be a zero-copy view into a live ColumnBuffer; the
    preconditioned bytes live in a per-thread scratch, so the returned
    payload is always independent of the caller's buffers.  With a
    ``buffer_pool``, a raw-stored payload is a memoryview of a pooled
    buffer instead of a fresh ``bytes`` copy — the unbuffered commit
    path hands it to the I/O engine, which returns the buffer to the
    pool once the page's write lands (DESIGN.md §6.8).
    """

    def materialize(raw_buf):
        if buffer_pool is None:
            return bytes(raw_buf)
        buf = buffer_pool.take(len(raw_buf))
        buf[: len(raw_buf)] = raw_buf
        return memoryview(buf)[: len(raw_buf)]

    raw = precondition_buffer(elements, col.encoding, _thread_scratch())
    uncompressed_size = len(raw)
    used_codec = codec
    members = None
    if codec == comp.CODEC_NONE:
        # materialize: raw aliases the scratch (or the caller's buffer)
        payload = materialize(raw)
        crc = zlib.crc32(payload) if checksum else 0
    else:
        # Like ROOT, fall back to storing uncompressed when compression
        # does not shrink the page.
        parts = comp.compress_parts(raw, codec, level, chunk_bytes, pool)
        size = sum(len(p) for p in parts)
        if size >= uncompressed_size:
            payload, used_codec = materialize(raw), comp.CODEC_NONE
            crc = zlib.crc32(payload) if checksum else 0
        else:
            # per-chunk CRCs fold into the page checksum incrementally
            crc = comp.crc32_parts(parts) if checksum else 0
            payload = parts[0] if len(parts) == 1 else b"".join(parts)
            if len(parts) > 1:
                members = [len(p) for p in parts]
    desc = PageDesc(
        column=col.index,
        n_elements=int(len(elements)),
        offset=-1,
        size=len(payload),
        uncompressed_size=uncompressed_size,
        checksum=crc,
        codec=used_codec,
        members=members,
        member_chunk=chunk_bytes if members else 0,
    )
    return payload, desc


def read_page(buf: bytes, desc: PageDesc, col: ColumnSpec, verify: bool = True) -> np.ndarray:
    if verify and desc.checksum and zlib.crc32(buf) != desc.checksum:
        raise IOError(f"page checksum mismatch (column {col.path!r})")
    raw = comp.decompress(buf, desc.codec, desc.uncompressed_size)
    return unprecondition(raw, col.encoding, col.dtype, desc.n_elements)


def decode_page_into(
    buf, desc: PageDesc, col: ColumnSpec, out: np.ndarray, verify: bool = True
) -> Tuple[int, int]:
    """:func:`read_page` minus its allocations — the read-engine hot path.

    ``buf`` may be a zero-copy memoryview into a coalesced read buffer;
    ``out`` is the page's slice (``len == desc.n_elements``) of a
    preallocated contiguous column array.  Runs with no synchronization
    on decode-pool workers, each reusing its per-thread scratch.  Returns
    ``(decompress_ns, decode_ns)`` for the reader's phase accounting.
    """
    if verify and desc.checksum and zlib.crc32(buf) != desc.checksum:
        raise IOError(f"page checksum mismatch (column {col.path!r})")
    t0 = time.perf_counter_ns()
    raw = comp.decompress(buf, desc.codec, desc.uncompressed_size)
    t1 = time.perf_counter_ns()
    unprecondition_into(raw, col.encoding, out, _thread_scratch())
    return t1 - t0, time.perf_counter_ns() - t1


def elements_per_page(col: ColumnSpec, page_size: int = DEFAULT_PAGE_SIZE) -> int:
    return max(1, page_size // col.itemsize)
