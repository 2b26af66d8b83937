"""K10: delta + zigzag of an offset column.

The CUDA kernel (``csrc/scans.cu``) replaces the JAX package's Pallas
``delta_zigzag``: ``z[i] = zigzag(x[i] - x[i-1])`` with the first
element absolute, int32 -> uint32 and int64 -> uint64, wrapping as the
reference's integer ops do.  Every element needs only its predecessor,
so the kernel has no carry between blocks (the Pallas kernel's carry
across its sequential grid is the TPU's).  On a CPU tensor the wrapper
runs the plain PyTorch version; on a CUDA tensor it launches the kernel
or raises.
"""

from __future__ import annotations

import torch

from . import _build, ref
from .ops import count_launch

_LAUNCHERS = {torch.int32: "repro_delta_zigzag_i32",
              torch.int64: "repro_delta_zigzag_i64"}


def delta_zigzag(x: torch.Tensor) -> torch.Tensor:
    """(N,) int32 -> (N,) uint32, int64 -> uint64, on ``x``'s device."""
    if x.dtype not in _LAUNCHERS or x.dim() != 1:
        raise ValueError(
            f"delta_zigzag takes a 1-D int32 or int64 tensor, got {x.dtype} "
            f"of shape {tuple(x.shape)}"
        )
    if x.device.type == "cpu":
        return ref.delta_zigzag_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"delta_zigzag: unsupported device {x.device}")
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=ref.ZIGZAG_DTYPES[x.dtype],
                      device=x.device)
    if x.numel():
        lib = _build.library("scans")
        guard, stream = _build.launch_args(x)
        with guard:
            rc = getattr(lib, _LAUNCHERS[x.dtype])(x.data_ptr(),
                                                   out.data_ptr(),
                                                   x.numel(), stream)
        _build.check(lib, rc, "delta_zigzag")
        count_launch("delta_zigzag", x.shape)
    return out
