"""K3 and K4: the per-column page decode chain of the device read-back.

The read-side inverse of the write path's preconditioning: stored page
bytes upload to the reader's device once, and columns materialize there
as torch tensors (DESIGN.md §9).

* :func:`unsplit_pages` (K3) — inverse page-batched byteshuffle,
  ``(P, nb, per) uint8 -> (P, per, nb)``; replaces the Pallas
  ``unsplit_pages``.
* :func:`decode_offset_pages` (K4) — the fused offset-column decode:
  the low four byte planes of the stored uint64 zigzag deltas ->
  unzigzag -> inclusive scan restarting at every page ->
  ``(P, per) int32`` end offsets; replaces the Pallas
  ``decode_offset_pages``.

Both CUDA kernels live in ``csrc/``; K4 runs a page as one thread-block
cluster, its geometry from :func:`launch_shape`.  On a CPU tensor each
wrapper runs its plain PyTorch version; on a CUDA tensor it launches its
kernel or raises.  int32 offsets are exact under the reader's route guard (the
cluster's child element total is below 2**31, so planes 4..7 are zero).

The drivers below (``device_decode_*``) decode one column's staged page
payloads — page ``p`` of ``k <= per`` elements at byte range
``[p*per*nb, p*per*nb + k*nb)`` of a flat uint8 tensor — into its
``(n,)`` element tensor on the same device.  The partial tail page runs
as torch ops on that device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import _build, ref
from .byteshuffle import check_pages, launch_transpose
from .ops import count_launch


def unsplit_pages(planes: torch.Tensor) -> torch.Tensor:
    """(P, nb, per) uint8 -> (P, per, nb): inverse page-wise byteshuffle."""
    check_pages(planes, "unsplit_pages")
    if planes.device.type == "cpu":
        return ref.unsplit_pages_ref(planes)
    planes = planes.contiguous()
    n_pages, nb, per = planes.shape
    out = torch.empty((n_pages, per, nb), dtype=torch.uint8,
                      device=planes.device)
    if planes.numel():
        launch_transpose("repro_unsplit_pages", planes, out, n_pages, per, nb,
                         "unsplit_pages")
    return out


#: K4's geometry (``csrc/scans.cu``, built for it): a block of
#: ``DECODE_THREADS`` threads takes ``DECODE_ITEMS`` elements a thread and
#: round, a tile of ``DECODE_TILE``; a page is one cluster of at most
#: ``MAX_CLUSTER`` blocks (the portable cluster size)
DECODE_THREADS, DECODE_ITEMS = 128, 8
DECODE_TILE = DECODE_THREADS * DECODE_ITEMS
MAX_CLUSTER = 8


def launch_shape(per: int) -> Tuple[int, int]:
    """``(C, tile)`` of K4 for pages of ``per`` elements: one cluster of
    ``C`` blocks a page, as many as the page has tiles up to 8; in each
    round of ``C * tile`` elements rank ``r`` takes the ``r``-th tile, and
    a longer page loops in rounds with a running carry.  The grid is
    ``n_pages * C`` blocks."""
    if per < 1:
        raise ValueError(f"decode_offset_pages: per {per} < 1")
    return max(1, min(MAX_CLUSTER, -(-per // DECODE_TILE))), DECODE_TILE


def decode_offset_pages(planes: torch.Tensor) -> torch.Tensor:
    """(P, 8, per) uint8 split zigzag deltas -> (P, per) int32 end offsets."""
    check_pages(planes, "decode_offset_pages")
    if planes.shape[1] != 8:
        raise ValueError("offset columns store uint64 planes: (P, 8, per)")
    if planes.device.type == "cpu":
        return ref.decode_offset_pages_ref(planes)
    planes = planes.contiguous()
    n_pages, _, per = planes.shape
    out = torch.empty((n_pages, per), dtype=torch.int32, device=planes.device)
    if planes.numel():
        cluster, tile = launch_shape(per)
        lib = _build.library("scans")
        guard, stream = _build.launch_args(planes)
        with guard:
            rc = lib.repro_decode_offset_pages(planes.data_ptr(),
                                               out.data_ptr(), n_pages, per,
                                               cluster, tile, stream)
        _build.check(lib, rc, "decode_offset_pages")
        count_launch("decode_offset_pages", planes.shape)
    return out


# ---------------------------------------------------------------------------
# the device decode chain (drivers used by the read engine)


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (or its name)."""
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def _tail_split(raw: torch.Tensor, head: int, n: int, nb: int) -> torch.Tensor:
    """Unsplit the final partial page ((nb, k) planes -> (k, nb) bytes),
    into new memory: never a view of ``raw``."""
    k = n - head
    t = raw[head * nb : head * nb + k * nb].reshape(nb, k).t()
    return t.clone(memory_format=torch.contiguous_format)


def _bitcast_elems(rows: torch.Tensor, dtype) -> torch.Tensor:
    """(N, nb) uint8 little-endian rows -> (N,) dtype elements."""
    flat = rows.contiguous().reshape(-1)
    tdt = torch_dtype(dtype)
    return flat if tdt == torch.uint8 else flat.view(tdt)


def device_decode_none(raw: torch.Tensor, n: int, per: int,
                       dtype) -> torch.Tensor:
    """ENC_NONE: the stored bytes as elements.

    A copy, never a view: the bitcast alone would alias ``raw``, which on
    the CPU is the reader's pooled staging buffer, recycled right after
    the decode.
    """
    nb = np.dtype(dtype).itemsize
    return _bitcast_elems(raw[: n * nb].reshape(n, nb), dtype).clone()


def device_decode_split(raw: torch.Tensor, n: int, per: int,
                        dtype) -> torch.Tensor:
    """ENC_SPLIT: page-batched inverse byteshuffle -> (n,) dtype elements."""
    nb = np.dtype(dtype).itemsize
    n_full = n // per
    head = n_full * per
    parts = []
    if n_full:
        src = raw[: head * nb].reshape(n_full, nb, per)
        parts.append(unsplit_pages(src).reshape(head, nb))
    if head < n:
        parts.append(_tail_split(raw, head, n, nb))
    rows = parts[0] if len(parts) == 1 else torch.cat(parts)
    return _bitcast_elems(rows, dtype)


def device_decode_offsets(raw: torch.Tensor, n: int, per: int) -> torch.Tensor:
    """ENC_DELTA_ZIGZAG_SPLIT: fused decode to (n,) int32 end offsets.

    Exact under the reader's route guard: every offset in the cluster is
    below 2**31, so the int32 column equals the int64 host decode after
    widening.
    """
    n_full = n // per
    head = n_full * per
    parts = []
    if n_full:
        src = raw[: head * 8].reshape(n_full, 8, per)
        parts.append(decode_offset_pages(src).reshape(head))
    if head < n:
        rows = _tail_split(raw, head, n, 8)  # (k, 8) uint8
        d = ref.unzigzag_ref(ref.low_u32(rows[:, 0], rows[:, 1], rows[:, 2],
                                         rows[:, 3]))
        parts.append(torch.cumsum(d, dim=0, dtype=torch.int32))
    return parts[0] if len(parts) == 1 else torch.cat(parts)
