"""Kernel dispatch of the port: device resolution, backend selection and
launch counts.

The twin of ``KernelDispatch`` in the JAX package, with three changes:

* a dispatch belongs to ONE device — writers build theirs from their own
  ``device=`` (:func:`encode_kernels`), so the route is a property of the
  writer, not of what the process happened to import;
* a kernel failure raises: no dispatch rules itself out and falls back;
* environment variables live under their own prefix (``REPRO_TORCH_*``),
  so the JAX package's variables never change what the port does.

``REPRO_TORCH_KERNEL_BACKEND`` selects the backend of every write-path
kernel: ``auto`` (the default) runs the kernel's host entry (the CUDA
kernel on a card, its plain PyTorch version on ``device="cpu"``) when the
call's size reaches the floor ``REPRO_TORCH_<NAME>_MIN``; ``numpy`` pins
the numpy reference.
The floors are the JAX package's: they are part of its host algorithm.
The serve path's kernels have no dispatch here: their wrappers
(``flash_attention.flash_attention``, ``decode_attention.decode_attention``,
``rwkv6_scan.rwkv6_scan``, ``mamba2_ssd.mamba2_ssd``) follow their
inputs' device, and the reference's ``use_pallas``, ``impl`` and
``chunk`` have no counterpart.

Every kernel wrapper counts its launches here (:func:`count_launch`), one
per launch of its CUDA kernel and nowhere else, with the shape it was
given, so a run can show which kernels its path went through and at
which shapes.
"""

from __future__ import annotations

import os
import threading
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

GLOBAL_BACKEND_ENV = "REPRO_TORCH_KERNEL_BACKEND"
BACKENDS = ("auto", "numpy")

#: the kernels of the write -> read path, by wrapper name
WRITE_READ_KERNELS = ("offsets_scan", "byteshuffle_pages", "unsplit_pages",
                      "decode_offset_pages")
#: the kernels of the serve path: K5 in prefill and K6 in every decode
#: step (dense family; zamba2's shared attention blocks), K7 in the rwkv6
#: family's prefill, K8 in zamba2's
SERVE_KERNELS = ("flash_attention", "decode_attention", "rwkv6_scan",
                 "mamba2_ssd")
KERNELS = WRITE_READ_KERNELS + SERVE_KERNELS

_count_lock = threading.Lock()
_launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
_shapes: Dict[str, Counter] = {k: Counter() for k in KERNELS}


def count_launch(name: str, shape: Tuple[int, ...]) -> None:
    """One launch of kernel ``name`` on an input of ``shape`` (thread-safe:
    fills run on many producer threads, seals on the writer's pool)."""
    with _count_lock:
        _launches[name] += 1
        _shapes[name][tuple(shape)] += 1


def launch_counts() -> Dict[str, int]:
    with _count_lock:
        return dict(_launches)


def launch_shapes() -> Dict[str, Counter]:
    """``{kernel: Counter({input shape: launches})}`` since the last reset."""
    with _count_lock:
        return {k: Counter(c) for k, c in _shapes.items()}


def reset_launch_counts() -> None:
    with _count_lock:
        for k in _launches:
            _launches[k] = 0
            _shapes[k].clear()


def resolve_device(device="cuda") -> torch.device:
    """The device of a writer or reader: ``"cuda"`` (the default) needs a
    card and raises ``RuntimeError`` without one; the CPU runs only when
    the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


class KernelDispatch:
    """auto / numpy selection for one kernel family on one device.

    ``host_entry(array, device)`` is numpy in, numpy out; calling the
    dispatch runs it on the dispatch's device.  ``want(measure)`` is the
    size gate (units chosen by the call site: elements or bytes).
    """

    def __init__(self, name: str, host_entry: Callable, min_default: int,
                 device: torch.device) -> None:
        self.name = name
        self.backend = os.environ.get(GLOBAL_BACKEND_ENV, "auto").lower()
        if self.backend not in BACKENDS:
            raise ValueError(
                f"{GLOBAL_BACKEND_ENV} must be one of {BACKENDS}, got "
                f"{self.backend!r}"
            )
        self.min = int(os.environ.get(f"REPRO_TORCH_{name.upper()}_MIN",
                                      str(min_default)))
        self.device = device
        self._entry = host_entry

    def want(self, measure: int) -> bool:
        """Should this call run the kernel? (backend + size gate)"""
        return self.backend == "auto" and measure >= self.min

    def __call__(self, arr):
        return self._entry(arr, self.device)


@dataclass(frozen=True)
class EncodeKernels:
    """The write path's two kernel dispatches, built for one device."""

    offsets: KernelDispatch   # floor in ELEMENTS
    shuffle: KernelDispatch   # floor in BYTES


def encode_kernels(device: torch.device) -> EncodeKernels:
    from .byteshuffle import byteshuffle_pages_host
    from .offsets_scan import offsets_scan_host

    return EncodeKernels(
        offsets=KernelDispatch("offsets", offsets_scan_host, 65536, device),
        shuffle=KernelDispatch("shuffle", byteshuffle_pages_host,
                               256 * 1024, device),
    )
