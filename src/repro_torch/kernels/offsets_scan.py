"""K1: collection sizes -> cluster-relative end offsets (inclusive scan).

The CUDA kernel (``csrc/scans.cu``) replaces the JAX package's Pallas
``offsets_scan``: a three-pass scan in int64 on the card, equal to
``np.cumsum(int64)`` bit for bit.  On a CPU tensor the wrapper runs the
plain PyTorch version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build, ref
from .ops import count_launch


def offsets_scan(sizes: torch.Tensor) -> torch.Tensor:
    """(N,) int64 -> (N,) int64 inclusive scan, on ``sizes``' device."""
    if sizes.dtype != torch.int64 or sizes.dim() != 1:
        raise ValueError(
            f"offsets_scan takes a 1-D int64 tensor, got {sizes.dtype} "
            f"of shape {tuple(sizes.shape)}"
        )
    if sizes.device.type == "cpu":
        return ref.offsets_scan_ref(sizes)
    if sizes.device.type != "cuda":
        raise ValueError(f"offsets_scan: unsupported device {sizes.device}")
    sizes = sizes.contiguous()
    n = sizes.numel()
    out = torch.empty_like(sizes)
    if n == 0:
        return out
    lib = _build.library("scans")
    tile = lib.repro_offsets_scan_tile()
    tile_sums = torch.empty(-(-n // tile), dtype=torch.int64,
                            device=sizes.device)
    guard, stream = _build.launch_args(sizes)
    with guard:
        rc = lib.repro_offsets_scan_i64(sizes.data_ptr(), out.data_ptr(),
                                        tile_sums.data_ptr(), n, stream)
    _build.check(lib, rc, "offsets_scan")
    count_launch("offsets_scan", sizes.shape)
    return out


def offsets_scan_host(sizes: np.ndarray, device) -> np.ndarray:
    """Numpy-in / numpy-out entry point for the write hot path.

    Uploads the sizes to ``device`` (one H2D copy), scans there, and
    brings the int64 end offsets back (one D2H copy).
    """
    a = np.ascontiguousarray(sizes, dtype=np.int64)
    if not a.flags.writeable:
        a = a.copy()  # torch.from_numpy wants writable memory
    x = torch.from_numpy(a).to(device)
    return offsets_scan(x).cpu().numpy()
