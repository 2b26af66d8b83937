"""K1: collection sizes -> cluster-relative end offsets (inclusive scan).

The CUDA kernel (``csrc/scans.cu``) replaces the JAX package's Pallas
``offsets_scan``: ONE launch per call, a single-pass int64 scan with
decoupled look-back, equal to ``np.cumsum(int64)`` bit for bit.  Its
tiles publish their aggregates and prefixes in a workspace that belongs
to K1 alone, one per (device, stream), zeroed once when it is made and
never reset: each call gets a fresh epoch, which tags its status words,
and the count of tickets issued on the workspace before it, so a word
or ticket left by an earlier call is never read as this call's.  Calls
on one workspace take its lock while they are enqueued, so epochs and
tickets follow stream order under concurrent producer threads.

On a CPU tensor the wrapper runs the plain PyTorch version; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np
import torch

from . import _build, ref
from .ops import count_launch


class _Workspace:
    """Tickets and tile slots of K1 on one (device, stream): ``[counter,
    pad, slot[cap]]`` int64, a slot ``{status, value}`` 16 bytes."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.buf = None
        self.cap = 0
        self.epoch = 0      # the last epoch handed out
        self.issued = 0     # tickets taken on ``buf``'s counter so far

    def reserve(self, tiles: int, device) -> Tuple[torch.Tensor, int, int]:
        """-> (buffer, epoch, base) of one call of ``tiles`` blocks; the
        caller holds :attr:`lock` until the launch is enqueued."""
        if tiles > self.cap:
            cap = max(tiles, 2 * self.cap, 64)
            # zeroed once, on the stream the workspace belongs to: no
            # status word of it reads as any epoch >= 1
            self.buf = torch.zeros(2 + 2 * cap, dtype=torch.int64,
                                   device=device)
            self.cap, self.issued = cap, 0
        self.epoch += 1
        base = self.issued
        self.issued += tiles
        return self.buf, self.epoch, base


_workspaces: Dict[Tuple[int, int], _Workspace] = {}
_workspaces_lock = threading.Lock()


def _workspace(device: torch.device, stream: int) -> _Workspace:
    key = (device.index, stream)
    with _workspaces_lock:
        ws = _workspaces.get(key)
        if ws is None:
            ws = _workspaces[key] = _Workspace()
        return ws


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
    tiles = -(-n // lib.repro_offsets_scan_tile())
    guard, stream = _build.launch_args(sizes)
    ws = _workspace(sizes.device, stream)
    with guard, ws.lock:
        buf, epoch, base = ws.reserve(tiles, sizes.device)
        rc = lib.repro_offsets_scan_i64(sizes.data_ptr(), out.data_ptr(),
                                        buf.data_ptr(), ws.cap, n, epoch,
                                        base, stream)
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
