"""Plain PyTorch versions of the write -> read path's kernels.

Each function computes exactly what its CUDA kernel computes, with
PyTorch ops on whatever device its input lies on.  The wrappers run them
for tensors on the CPU; ``chip_smoke.py`` holds every kernel against them
on the card.  They are oracles, not yardsticks of speed.
"""

from __future__ import annotations

import torch


def offsets_scan_ref(sizes: torch.Tensor) -> torch.Tensor:
    """(N,) int64 collection sizes -> (N,) int64 inclusive scan."""
    return torch.cumsum(sizes, dim=0)


def byteshuffle_pages_ref(pages: torch.Tensor) -> torch.Tensor:
    """(P, per, nb) uint8 -> (P, nb, per): page-wise byte planes."""
    return pages.transpose(1, 2).contiguous()


def unsplit_pages_ref(planes: torch.Tensor) -> torch.Tensor:
    """(P, nb, per) uint8 -> (P, per, nb): inverse page-wise byteshuffle."""
    return planes.transpose(1, 2).contiguous()


def low_u32(b0, b1, b2, b3) -> torch.Tensor:
    """The low 4 little-endian bytes of stored uint64s, as int64 lanes
    (uint32 has few ops on the CPU; int64 holds every uint32 exactly)."""
    return (b0.to(torch.int64) | (b1.to(torch.int64) << 8)
            | (b2.to(torch.int64) << 16) | (b3.to(torch.int64) << 24))


def unzigzag_ref(z: torch.Tensor) -> torch.Tensor:
    """Zigzag inverse of uint32 values held in int64 -> int32.

    ``(z >> 1) ^ -(z & 1)`` lies in [-2**31, 2**31) for every uint32, so
    the cast is exact.
    """
    return ((z >> 1) ^ -(z & 1)).to(torch.int32)


def decode_offset_pages_ref(planes: torch.Tensor) -> torch.Tensor:
    """(P, 8, per) uint8 split zigzag deltas -> (P, per) int32 end offsets.

    Only the low four byte planes are read (the reader routes an offset
    column here only when its offsets fit int32, so planes 4..7 are zero);
    each page integrates from 0 (per-page delta restart).
    """
    d = unzigzag_ref(low_u32(planes[:, 0], planes[:, 1], planes[:, 2],
                             planes[:, 3]))
    return torch.cumsum(d, dim=-1, dtype=torch.int32)
