"""Contiguous per-column element buffers for the write hot path.

The seed accumulated a Python list of chunk arrays per column and paid an
``np.concatenate`` per column at seal time plus one allocation per append.
A :class:`ColumnBuffer` is a single preallocated contiguous array with
amortized-doubling growth:

* appends are vectorized copies into the tail (no per-append allocation),
* page extraction at seal time is a zero-copy view slice,
* :meth:`reset` keeps the storage, so in steady state a builder that is
  reused across clusters performs **no** allocations at all.

Offset columns additionally use :meth:`reserve`: the builder reserves the
tail slice and integrates collection sizes into cluster-relative end
offsets directly in place (``np.cumsum(..., out=tail)``), avoiding the
temporary the seed allocated per batch.

With a :class:`~repro_torch.core.bufpool.BufferPool` attached, storage is drawn
from the pool's power-of-two size classes instead of ``np.empty`` — so
:meth:`detach` (the scatter-gather seal handing storage to a queued
commit) recycles instead of allocating once the I/O engine returns the
previous cluster's buffers on write completion (DESIGN.md §6.8).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

DEFAULT_CAPACITY = 1024


class ColumnBuffer:
    """Amortized-doubling contiguous buffer of primitive elements."""

    __slots__ = ("dtype", "pool", "_data", "_len")

    def __init__(self, dtype, capacity: int = DEFAULT_CAPACITY, pool=None):
        self.dtype = np.dtype(dtype)
        self.pool = pool
        self._data = self._alloc(max(int(capacity), 1))
        self._len = 0

    def _alloc(self, n_elems: int) -> np.ndarray:
        """Storage for ``n_elems`` elements — pooled when a pool is set
        (the returned view keeps the pooled base array alive)."""
        if self.pool is not None:
            raw = self.pool.take(n_elems * self.dtype.itemsize)
            return raw.view(self.dtype)
        return np.empty(n_elems, dtype=self.dtype)

    # -- introspection -----------------------------------------------------

    def __len__(self) -> int:
        return self._len

    @property
    def nbytes(self) -> int:
        return self._len * self.dtype.itemsize

    @property
    def capacity(self) -> int:
        return len(self._data)

    # -- growth ------------------------------------------------------------

    def _grow(self, need: int) -> None:
        cap = len(self._data)
        new_cap = max(need, 2 * cap)
        data = self._alloc(new_cap)
        data[: self._len] = self._data[: self._len]
        old, self._data = self._data, data
        if self.pool is not None:
            # the outgrown storage is aliased by nothing durable (views
            # are documented invalid after extend/reserve): recycle it
            self.pool.put(old)

    # -- filling -----------------------------------------------------------

    def extend(self, arr: np.ndarray) -> None:
        """Append ``arr`` with one vectorized copy."""
        n = len(arr)
        if n == 0:
            return
        need = self._len + n
        if need > len(self._data):
            self._grow(need)
        self._data[self._len : need] = arr
        self._len = need

    def reserve(self, n: int) -> np.ndarray:
        """Grow by ``n`` elements and return the writable tail view.

        The caller fills the returned slice in place (used for in-place
        offset integration).
        """
        need = self._len + n
        if need > len(self._data):
            self._grow(need)
        view = self._data[self._len : need]
        self._len = need
        return view

    # -- extraction ----------------------------------------------------------

    def view(self, start: int = 0, stop: Optional[int] = None) -> np.ndarray:
        """Zero-copy view of elements ``[start, stop)`` (default: all).

        The view aliases the buffer storage: it is valid until the next
        :meth:`extend`/:meth:`reserve` (which may reallocate) or
        :meth:`reset` followed by refilling.
        """
        if stop is None or stop > self._len:
            stop = self._len
        return self._data[start:stop]

    def reset(self) -> None:
        """Forget the contents but keep the allocated storage for reuse."""
        self._len = 0

    def detach(self) -> np.ndarray:
        """Give up the current storage and start over with a fresh array.

        Used by the scatter-gather seal: zero-copy views of the old
        storage stay valid (numpy views keep their base alive) while this
        buffer refills into new storage.  With a pool, the replacement is
        recycled from the pool's size classes and the detached array is
        returned to the pool by the I/O engine when the queued write that
        references it lands — steady-state detaching is then
        allocation-free.  Returns the detached array.
        """
        old = self._data
        self._data = self._alloc(max(len(old), 1))
        self._len = 0
        return old
