"""K2: page-wise byte-plane split ("byteshuffle") of the seal path.

The CUDA kernel (``csrc/byteplanes.cu``) replaces the JAX package's
Pallas ``byteshuffle_pages``: ``(P, per, nb) uint8 -> (P, nb, per)``,
each page its own transpose.  On a CPU tensor the wrapper runs the plain
PyTorch version; on a CUDA tensor it launches the kernel or raises.
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
