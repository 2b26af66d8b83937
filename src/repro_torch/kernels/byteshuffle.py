"""K2 and K9: byte-plane split ("byteshuffle").

* :func:`byteshuffle_pages` (K2), the seal path's page-wise split:
  ``(P, per, nb) uint8 -> (P, nb, per)``, each page its own transpose;
  replaces the Pallas ``byteshuffle_pages``.
* :func:`byteshuffle` (K9), the single-buffer split behind
  ``ops.byteshuffle``: ``(N, nb) uint8 -> (nb, N)`` for any ``nb >= 1``;
  replaces the Pallas ``byteshuffle``.

Both CUDA kernels live in ``csrc/byteplanes.cu``.  On a CPU tensor each
wrapper runs its plain PyTorch version; on a CUDA tensor it launches its
kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build, ref
from .ops import count_launch

#: element widths the kernels take (every column dtype of a schema)
ITEMSIZES = (1, 2, 4, 8)


def check_pages(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.uint8 or x.dim() != 3:
        raise ValueError(
            f"{name} takes a 3-D uint8 tensor, got {x.dtype} of shape "
            f"{tuple(x.shape)}"
        )
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def launch_transpose(lib_fn: str, x: torch.Tensor, out: torch.Tensor,
                     n_pages: int, per: int, nb: int, name: str) -> None:
    """Launch one of the byte-plane kernels of ``csrc/byteplanes.cu``."""
    if nb not in ITEMSIZES:
        raise ValueError(f"{name}: element width {nb} not in {ITEMSIZES}")
    lib = _build.library("byteplanes")
    guard, stream = _build.launch_args(x)
    with guard:
        rc = getattr(lib, lib_fn)(x.data_ptr(), out.data_ptr(), n_pages, per,
                                  nb, stream)
    _build.check(lib, rc, name)
    count_launch(name, x.shape)


def byteshuffle_pages(pages: torch.Tensor) -> torch.Tensor:
    """(P, per, nb) uint8 -> (P, nb, per): page ``p``'s byte planes land
    contiguously in ``out[p]``."""
    check_pages(pages, "byteshuffle_pages")
    if pages.device.type == "cpu":
        return ref.byteshuffle_pages_ref(pages)
    pages = pages.contiguous()
    n_pages, per, nb = pages.shape
    out = torch.empty((n_pages, nb, per), dtype=torch.uint8,
                      device=pages.device)
    if pages.numel():
        launch_transpose("repro_byteshuffle_pages", pages, out, n_pages, per,
                         nb, "byteshuffle_pages")
    return out


def byteshuffle_pages_host(pages: np.ndarray, device) -> np.ndarray:
    """Numpy-in / numpy-out page-batched entry point (seal hot path): one
    H2D copy of the pages, the kernel, one D2H copy of the planes."""
    a = np.ascontiguousarray(pages, dtype=np.uint8)
    if not a.flags.writeable:
        a = a.copy()  # torch.from_numpy wants writable memory
    x = torch.from_numpy(a).to(device)
    return byteshuffle_pages(x).cpu().numpy()


def byteshuffle(planes: torch.Tensor) -> torch.Tensor:
    """(N, nb) uint8 -> (nb, N): byte plane ``j`` of every element lands
    contiguously in ``out[j]``; any element width ``nb``."""
    if planes.dtype != torch.uint8 or planes.dim() != 2:
        raise ValueError(
            f"byteshuffle takes a 2-D uint8 tensor, got {planes.dtype} of "
            f"shape {tuple(planes.shape)}"
        )
    if planes.device.type == "cpu":
        return ref.byteshuffle_ref(planes)
    if planes.device.type != "cuda":
        raise ValueError(f"byteshuffle: unsupported device {planes.device}")
    planes = planes.contiguous()
    n, nb = planes.shape
    out = torch.empty((nb, n), dtype=torch.uint8, device=planes.device)
    if planes.numel():
        lib = _build.library("byteplanes")
        guard, stream = _build.launch_args(planes)
        with guard:
            rc = lib.repro_byteshuffle(planes.data_ptr(), out.data_ptr(), n,
                                       nb, stream)
        _build.check(lib, rc, "byteshuffle")
        count_launch("byteshuffle", planes.shape)
    return out


def byteshuffle_host(planes: np.ndarray, device) -> np.ndarray:
    """Numpy-in / numpy-out single-buffer entry point: the (N, nb) uint8
    view of one contiguous primitive array -> its (nb, N) planes, through
    one H2D copy, the kernel and one D2H copy."""
    a = np.ascontiguousarray(planes, dtype=np.uint8)
    if not a.flags.writeable:
        a = a.copy()  # torch.from_numpy wants writable memory
    return byteshuffle(torch.from_numpy(a).to(device)).cpu().numpy()
