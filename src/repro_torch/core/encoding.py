"""Column preconditioning encodings (numpy reference implementations).

These mirror RNTuple's on-disk column encodings: *split* (byte-plane
shuffle) for multi-byte primitives and *delta + zigzag + split* for offset
columns.  Preconditioning radically improves the entropy coder's ratio on
monotonic offset columns and on floats with correlated exponents.

The numpy functions here are the canonical host implementations; the CUDA
kernels behind ``repro_torch.kernels.{offsets_scan,byteshuffle}`` take over
the two column-wide hot spots (the offsets scan at fill time, the page-wise
byte-plane split at seal time) through a :class:`KernelDispatch` built from
the writer's device, and are tested bit-identical against these.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.kernels.ops import KernelDispatch

from .schema import ENC_DELTA_ZIGZAG_SPLIT, ENC_NONE, ENC_SPLIT

# ---------------------------------------------------------------------------
# split (byte-plane shuffle)


def split_encode(arr: np.ndarray) -> bytes:
    """Byte-plane split: [b0 of all elems][b1 of all elems]...

    Little-endian byte planes of a contiguous primitive array.
    """
    a = np.ascontiguousarray(arr)
    if a.dtype.byteorder == ">":  # normalize to little-endian
        a = a.astype(a.dtype.newbyteorder("<"))
    nbytes = a.dtype.itemsize
    planes = a.view(np.uint8).reshape(-1, nbytes)
    return planes.T.tobytes()


def split_decode(buf: bytes, dtype: np.dtype, n: int) -> np.ndarray:
    dtype = np.dtype(dtype)
    nbytes = dtype.itemsize
    planes = np.frombuffer(buf, dtype=np.uint8, count=n * nbytes).reshape(nbytes, n)
    return np.ascontiguousarray(planes.T).reshape(-1).view(dtype)[:n].copy()


# ---------------------------------------------------------------------------
# delta + zigzag (for int64 offset columns)


def zigzag_encode(x: np.ndarray) -> np.ndarray:
    """Map signed -> unsigned: 0,-1,1,-2,2 ... -> 0,1,2,3,4."""
    x = x.astype(np.int64, copy=False)
    return ((x << np.int64(1)) ^ (x >> np.int64(63))).view(np.uint64)


def zigzag_decode(u: np.ndarray) -> np.ndarray:
    u = u.view(np.uint64) if u.dtype != np.uint64 else u
    return ((u >> np.uint64(1)).astype(np.int64)) ^ -(u & np.uint64(1)).astype(np.int64)


def delta_encode(x: np.ndarray, first_reference: int = 0) -> np.ndarray:
    """x[i] - x[i-1], with x[-1] := first_reference."""
    x = x.astype(np.int64, copy=False)
    d = np.empty_like(x)
    if len(x):
        d[0] = x[0] - first_reference
        np.subtract(x[1:], x[:-1], out=d[1:])
    return d


def delta_decode(d: np.ndarray, first_reference: int = 0) -> np.ndarray:
    d = d.astype(np.int64, copy=False)
    out = np.cumsum(d, dtype=np.int64)
    if first_reference:
        out = out + np.int64(first_reference)
    return out


def dzs_encode(arr: np.ndarray, first_reference: int = 0) -> bytes:
    """delta -> zigzag -> split; the offset-column encoding."""
    return split_encode(zigzag_encode(delta_encode(arr, first_reference)))


def dzs_decode(buf: bytes, n: int, first_reference: int = 0) -> np.ndarray:
    u = split_decode(buf, np.dtype(np.uint64), n)
    return delta_decode(zigzag_decode(u), first_reference)


# ---------------------------------------------------------------------------
# scratch-based preconditioning (the per-page hot path)


class EncodeScratch:
    """Reusable temporaries for :func:`precondition_buffer`.

    One instance per thread (pages.py keeps them thread-local): a page
    build reuses the same scratch arrays instead of allocating fresh
    intermediates for the split transpose and the delta/zigzag stages.

    With a :class:`~repro_torch.core.bufpool.BufferPool` attached (the
    cluster builder's writer-shared pool), scratch storage is drawn
    from — and outgrown buffers returned to — the pool's power-of-two
    size classes, so the scatter-gather seal's detached scratch slots
    recycle instead of reallocating (DESIGN.md §6.8).
    """

    def __init__(self, pool=None) -> None:
        self._bufs: dict = {}
        self._pool = pool

    def array(self, key: str, dtype, n: int) -> np.ndarray:
        dtype = np.dtype(dtype)
        buf = self._bufs.get(key)
        if buf is None or len(buf) < n:
            if self._pool is not None:
                if buf is not None:
                    # outgrown and referenced by nothing durable (detached
                    # slots were popped, compressed payloads are copies)
                    self._pool.put(buf)
                raw = self._pool.take(max(n, 4096) * dtype.itemsize)
                buf = raw.view(dtype)
            else:
                buf = np.empty(max(n, 4096), dtype=dtype)
            self._bufs[key] = buf
        return buf[:n]


def _split_into(a: np.ndarray, out_u8: np.ndarray) -> np.ndarray:
    """Byte-plane split of contiguous ``a`` into preallocated ``out_u8``."""
    if a.dtype.byteorder == ">":  # normalize to little-endian
        a = a.astype(a.dtype.newbyteorder("<"))
    nb = a.dtype.itemsize
    n = len(a)
    planes = a.view(np.uint8).reshape(n, nb)
    out_u8[: n * nb].reshape(nb, n)[:] = planes.T
    return out_u8[: n * nb]


def precondition_buffer(
    arr: np.ndarray, encoding: str, scratch: Optional[EncodeScratch] = None
) -> np.ndarray:
    """Precondition one page of elements with minimal allocation.

    Returns a ``uint8`` array (``len == nbytes``) byte-identical to
    :func:`precondition`.  With a scratch, split/dzs intermediates reuse
    buffers and the ``none`` encoding is a zero-copy reinterpret view of
    the input.  The result may alias ``arr`` or ``scratch``: it is valid
    only until the next call with the same scratch, and callers storing it
    must copy (``bytes(...)``) first.
    """
    a = np.ascontiguousarray(arr)
    if encoding == ENC_NONE:
        return a.view(np.uint8) if len(a) else np.empty(0, np.uint8)
    if scratch is None:
        scratch = EncodeScratch()
    if encoding == ENC_SPLIT:
        out = scratch.array("u8", np.uint8, a.nbytes)
        return _split_into(a, out)
    if encoding == ENC_DELTA_ZIGZAG_SPLIT:
        x = a.astype(np.int64, copy=False)
        n = len(x)
        d = scratch.array("i64a", np.int64, n)
        t = scratch.array("i64b", np.int64, n)
        if n:
            d[0] = x[0]
            np.subtract(x[1:], x[:-1], out=d[1:])
        # zigzag in place: (d << 1) ^ (d >> 63)
        np.right_shift(d, 63, out=t)
        np.left_shift(d, 1, out=d)
        np.bitwise_xor(d, t, out=d)
        out = scratch.array("u8", np.uint8, d.nbytes)
        return _split_into(d.view(np.uint64), out)
    raise ValueError(f"unknown encoding {encoding!r}")


def _batched_split_into(a: np.ndarray, per: int, out_u8: np.ndarray,
                        shuffle: Optional[KernelDispatch] = None) -> None:
    """Page-wise byte-plane split of a whole column in O(1) numpy calls.

    Writes, for each page of ``per`` elements, that page's plane-split
    bytes contiguously into ``out_u8`` — bit-identical to running
    :func:`split_encode` page by page, but the full pages go through one
    batched strided copy instead of a Python loop.  Large columns
    dispatch the full-pages block to ``shuffle`` (the writer's
    ``byteshuffle_pages`` kernel on its device) when the block reaches the
    dispatch's size floor, and the partial last page as a page of its own
    when it does; the strided numpy copy is the reference and the path
    below the floor.  A kernel failure raises: nothing falls back.
    """
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    nb = a.dtype.itemsize
    n = len(a)
    n_full = n // per
    head = n_full * per
    if n_full:
        src = a[:head].view(np.uint8).reshape(n_full, per, nb)
        if shuffle is not None and shuffle.want(head * nb):
            out_u8[: head * nb].reshape(n_full, nb, per)[:] = shuffle(src)
        else:
            np.copyto(
                out_u8[: head * nb].reshape(n_full, nb, per),
                src.transpose(0, 2, 1),
            )
    if head < n:
        if shuffle is not None and shuffle.want((n - head) * nb):
            out_u8[head * nb: n * nb].reshape(1, nb, n - head)[:] = shuffle(
                a[head:].view(np.uint8).reshape(1, n - head, nb))
        else:
            _split_into(a[head:], out_u8[head * nb:])


def precondition_column_pages(
    arr: np.ndarray, encoding: str, per: int,
    scratch: Optional[EncodeScratch] = None, out_key: str = "u8",
    shuffle: Optional[KernelDispatch] = None,
) -> np.ndarray:
    """Precondition ALL pages of a column at once (the seal fast path).

    Returns a ``uint8`` array holding each page's preconditioned bytes
    back to back: page ``p`` of ``k`` elements occupies the byte range
    ``[p*per*itemsize, p*per*itemsize + k*itemsize)``.  Bit-identical to
    calling :func:`precondition_buffer` per page slice, but the per-page
    Python loop, temporaries and dispatch collapse into a handful of
    vectorized column-wide operations.  The result aliases ``scratch``
    (or ``arr`` for the ``none`` encoding) under the usual rules;
    ``out_key`` selects which scratch buffer holds it, so a caller that
    needs several columns' payloads alive at once (the chunk-parallel
    pooled seal) can give each column its own key.  ``shuffle`` is the
    page-wise byte-plane split dispatch (see :func:`_batched_split_into`).
    """
    a = np.ascontiguousarray(arr)
    if encoding == ENC_NONE:
        return a.view(np.uint8) if len(a) else np.empty(0, np.uint8)
    if scratch is None:
        scratch = EncodeScratch()
    if encoding == ENC_SPLIT:
        out = scratch.array(out_key, np.uint8, a.nbytes)
        _batched_split_into(a, per, out, shuffle)
        return out
    if encoding == ENC_DELTA_ZIGZAG_SPLIT:
        x = a.astype(np.int64, copy=False)
        n = len(x)
        d = scratch.array("i64a", np.int64, n)
        t = scratch.array("i64b", np.int64, n)
        if n:
            d[0] = x[0]
            np.subtract(x[1:], x[:-1], out=d[1:])
            # per-page delta restarts at each page boundary
            # (first_reference = 0), exactly like the per-page encoder
            d[per::per] = x[per::per]
        np.right_shift(d, 63, out=t)
        np.left_shift(d, 1, out=d)
        np.bitwise_xor(d, t, out=d)
        out = scratch.array(out_key, np.uint8, d.nbytes)
        _batched_split_into(d.view(np.uint64), per, out, shuffle)
        return out
    raise ValueError(f"unknown encoding {encoding!r}")


# ---------------------------------------------------------------------------
# scratch-based unpreconditioning (the per-page read hot path)


def _unsplit_into(buf, out: np.ndarray) -> None:
    """Inverse byte-plane split of one page into contiguous ``out``.

    Copies plane by plane (contiguous reads, stride-``nb`` writes): on
    this container ~2-4x the bandwidth of the single transposed copy.
    """
    n = len(out)
    if not n:
        return
    nb = out.dtype.itemsize
    planes = np.frombuffer(buf, dtype=np.uint8, count=n * nb).reshape(nb, n)
    o = out.view(np.uint8).reshape(n, nb)
    for k in range(nb):
        o[:, k] = planes[k]


def unprecondition_into(
    raw, encoding: str, out: np.ndarray,
    scratch: Optional[EncodeScratch] = None,
) -> None:
    """Inverse of :func:`precondition_buffer`, decoding into ``out``.

    ``raw`` is the decompressed page payload (bytes-like); ``out`` is the
    page's slice of a preallocated contiguous column array with
    ``len(out) == n_elements``.  Bit-identical to :func:`unprecondition`
    minus its allocations: split pages transpose straight into ``out``
    and offset pages run their delta integration through
    :func:`integrate_sizes` (numpy: one page sits below the offsets-scan
    kernel's size floor), with the zigzag/delta intermediates living in
    the per-thread scratch.
    """
    n = len(out)
    if n == 0:
        return
    if encoding == ENC_NONE:
        out[:] = np.frombuffer(raw, dtype=out.dtype, count=n)
        return
    if scratch is None:
        scratch = EncodeScratch()
    if encoding == ENC_SPLIT:
        _unsplit_into(raw, out)
        return
    if encoding == ENC_DELTA_ZIGZAG_SPLIT:
        u = scratch.array("r_u64", np.uint64, n)
        _unsplit_into(raw, u)
        _zigzag_decode_inplace(u, scratch)
        # deltas -> absolute cluster-relative end offsets: the same
        # inclusive scan (and kernel dispatch) the writer integrates with
        integrate_sizes(u.view(np.int64), out=out)
        return
    raise ValueError(f"unknown encoding {encoding!r}")


def _zigzag_decode_inplace(u: np.ndarray, scratch: EncodeScratch) -> None:
    """``u`` (uint64 zigzag) -> signed deltas, in place: (u >> 1) ^ -(u & 1)."""
    t = scratch.array("r_u64b", np.uint64, len(u))
    np.bitwise_and(u, np.uint64(1), out=t)
    np.right_shift(u, np.uint64(1), out=u)
    d = u.view(np.int64)
    s = t.view(np.int64)
    np.negative(s, out=s)
    np.bitwise_xor(d, s, out=d)


def _batched_unsplit_into(raw, per: int, out: np.ndarray) -> None:
    """Inverse of :func:`_batched_split_into`: page-wise byte-plane unsplit
    of a whole column region in O(1) numpy calls.

    ``raw`` holds the plane-split payloads of consecutive pages of
    ``per`` elements each (final page may be partial) back to back.
    """
    nb = out.dtype.itemsize
    n = len(out)
    n_full = n // per
    head = n_full * per
    if n_full:
        src = np.frombuffer(raw, dtype=np.uint8, count=head * nb)
        s = src.reshape(n_full, nb, per)
        o = out[:head].view(np.uint8).reshape(n_full, per, nb)
        # plane-by-plane (contiguous reads) beats one transposed copyto
        # by 2-4x on this container
        for k in range(nb):
            o[:, :, k] = s[:, k, :]
    if head < n:
        _unsplit_into(raw[head * nb :], out[head:])


def unprecondition_pages_into(
    raw, encoding: str, per: int, out: np.ndarray,
    scratch: Optional[EncodeScratch] = None,
) -> None:
    """Decode ALL pages of a column region at once (column-batched).

    ``raw`` holds the preconditioned payloads of consecutive pages of one
    column back to back — page ``p`` of ``k ≤ per`` elements at byte range
    ``[p*per*itemsize, p*per*itemsize + k*itemsize)`` — exactly the layout
    a sealed cluster stores them in for the ``none`` codec.  Bit-identical
    to calling :func:`unprecondition_into` per page, but the per-page
    Python dispatch and temporaries collapse into a handful of vectorized
    column-wide operations (the read-side mirror of
    :func:`precondition_column_pages`).
    """
    n = len(out)
    if n == 0:
        return
    if encoding == ENC_NONE:
        out[:] = np.frombuffer(raw, dtype=out.dtype, count=n)
        return
    if scratch is None:
        scratch = EncodeScratch()
    if encoding == ENC_SPLIT:
        _batched_unsplit_into(raw, per, out)
        return
    if encoding == ENC_DELTA_ZIGZAG_SPLIT:
        u = scratch.array("r_u64", np.uint64, n)
        _batched_unsplit_into(raw, per, u)
        _zigzag_decode_inplace(u, scratch)
        d = u.view(np.int64)
        # the per-page delta restart means each page integrates from 0
        for start in range(0, n, per):
            seg = d[start : start + per]
            integrate_sizes(seg, out=out[start : start + len(seg)])
        return
    raise ValueError(f"unknown encoding {encoding!r}")


# ---------------------------------------------------------------------------
# dispatch


def precondition(arr: np.ndarray, encoding: str) -> bytes:
    return bytes(precondition_buffer(arr, encoding))


def unprecondition(buf: bytes, encoding: str, dtype: np.dtype, n: int) -> np.ndarray:
    dtype = np.dtype(dtype)
    if encoding == ENC_NONE:
        return np.frombuffer(buf, dtype=dtype, count=n).copy()
    if encoding == ENC_SPLIT:
        return split_decode(buf, dtype, n)
    if encoding == ENC_DELTA_ZIGZAG_SPLIT:
        assert dtype == np.dtype(np.int64)
        return dzs_decode(buf, n)
    raise ValueError(f"unknown encoding {encoding!r}")


# Kernel seam: a writer builds one KernelDispatch per kernel family from its
# device (repro_torch.kernels.ops.encode_kernels) and hands it to the calls
# below; ``None`` keeps the numpy reference.  REPRO_TORCH_KERNEL_BACKEND
# sets the backend of both ("auto" | "numpy"); REPRO_TORCH_OFFSETS_MIN and
# REPRO_TORCH_SHUFFLE_MIN set the size floors (elements for the offsets
# scan, bytes for the shuffle) below which numpy runs.


def integrate_sizes(
    sizes: np.ndarray, base: int = 0, out: Optional[np.ndarray] = None,
    offsets: Optional[KernelDispatch] = None,
) -> np.ndarray:
    """Collection sizes -> cluster-relative end offsets, starting at ``base``.

    The write hot path: integrates in place into ``out`` when given (the
    reserved tail of an offset :class:`~repro_torch.core.colbuf.ColumnBuffer`).
    Large columns dispatch to ``offsets`` (the writer's ``offsets_scan``
    kernel on its device) when the column reaches the dispatch's size
    floor and its total fits int32, the kernel route of the reference
    writer; the numpy inclusive scan is the reference and the path
    otherwise.  A kernel failure raises: nothing falls back.
    """
    n = len(sizes)
    if out is None:
        out = np.empty(n, dtype=np.int64)
    if (n and offsets is not None and offsets.want(n)
            # the same int32 route guard as the reference writer
            and int(np.sum(sizes, dtype=np.int64)) < 2**31):
        out[:] = offsets(np.asarray(sizes))
    else:
        np.cumsum(
            np.asarray(sizes).astype(np.int64, copy=False),
            dtype=np.int64, out=out,
        )
    if base:
        out += np.int64(base)
    return out


def sizes_to_offsets(sizes: np.ndarray) -> np.ndarray:
    """Collection sizes -> cluster-relative *end* offsets (inclusive scan).

    This is the on-disk form of an offset column: ``offsets[j]`` is the end
    of collection ``j`` within the cluster; the start is ``offsets[j-1]``
    (or 0).  Being cluster-relative is what makes a sealed cluster
    relocatable (paper §5).
    """
    return integrate_sizes(np.asarray(sizes))


def offsets_to_sizes(offsets: np.ndarray) -> np.ndarray:
    o = offsets.astype(np.int64, copy=False)
    s = np.empty_like(o)
    if len(o):
        s[0] = o[0]
        np.subtract(o[1:], o[:-1], out=s[1:])
    return s
