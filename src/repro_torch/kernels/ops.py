"""The port's kernel API: the op entries of ``repro.kernels.ops``, the
write path's kernel dispatch, device resolution and launch counts.

**Op entries.**  ``offsets_scan``, ``delta_zigzag``, ``byteshuffle``,
``unsplit_pages``, ``decode_offset_pages``, ``flash_attention``,
``decode_attention``, ``rwkv6`` and ``mamba2`` take the reference's
arguments and return its dtypes and shapes.  Each follows its inputs'
device: a CUDA tensor launches the Hopper kernel (K1, K10, K9, K3, K4,
K5, K6, K7, K8) or raises, with no fallback; a CPU tensor runs the plain
PyTorch version of ``ref``.  The reference's ``use_pallas`` has no
counterpart (the device decides) and is refused.  ``impl`` of
``flash_attention`` is honored on the CPU route (``"chunked"`` runs
``ref.flash_attention_chunked``); on the card K5 is the one route.
The tuning keywords ``chunk``, ``block``, ``block_q`` and ``block_k``
are accepted and ignored: the kernels pick their own tiles.
``offsets_scan`` on int32 sizes scans in int64 (K1) and narrows: the
result equals the reference's int32 scan modulo 2**32.  The kernel
modules load inside the entries, so importing this module stays cheap.

**Write-path dispatch.**  The twin of ``KernelDispatch`` in the JAX
package, with three changes:

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
The models call the serve path's kernel wrappers directly
(``flash_attention.flash_attention``, ``decode_attention.decode_attention``,
``rwkv6_scan.rwkv6_scan``, ``mamba2_ssd.mamba2_ssd``), which follow their
inputs' device as the op entries do.

Every kernel wrapper counts its launches here (:func:`count_launch`), one
per launch of its CUDA kernel and nowhere else, with the shape it was
given, so a run can show which kernels its path went through and at
which shapes.
The backwards (``flash_attention_bwd``, ``rwkv6_scan_bwd``,
``mamba2_ssd_bwd``) count one launch per call of their C entry, which
runs their kernels (K5's: dQ, then dK and dV; K7's and K8's: the reverse
scan, then the sums across its blocks).  The card route of K6 has no
backward and refuses inputs that require grad (:func:`refuse_grad`).
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
#: the single-buffer codec kernels, K9 and K10: no path of the writer or
#: the models runs them, only the op entries below
CODEC_KERNELS = ("byteshuffle", "delta_zigzag")
#: the kernels of the train step: K5's forward and its backward (one
#: ``flash_attention_bwd`` launch per attention layer), K7's and K8's (one
#: ``rwkv6_scan_bwd`` / ``mamba2_ssd_bwd`` per recurrent layer)
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "rwkv6_scan",
                 "rwkv6_scan_bwd", "mamba2_ssd", "mamba2_ssd_bwd")
KERNELS = WRITE_READ_KERNELS + SERVE_KERNELS + CODEC_KERNELS + tuple(
    k for k in TRAIN_KERNELS if k not in SERVE_KERNELS)

_count_lock = threading.Lock()
_launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
_shapes: Dict[str, Counter] = {k: Counter() for k in KERNELS}


def count_launch(name: str, shape: Tuple[int, ...]) -> None:
    """One launch of kernel ``name`` on an input of ``shape`` (thread-safe:
    fills run on many producer threads, seals on the writer's pool)."""
    with _count_lock:
        _launches[name] += 1
        _shapes[name][tuple(shape)] += 1


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise when a kernel without a backward is asked for a gradient:
    grad mode on and an input that requires grad.  Its wrapper writes
    through ``data_ptr`` and would return an output detached from them."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the port has no backward kernel for it yet; call it "
            "under torch.no_grad() or with inputs that do not require grad")


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


# ---------------------------------------------------------------------------
# op entries: the twins of ``repro.kernels.ops``' model-kernel entry points

#: the reference's tuning keywords: accepted, ignored
TUNING_KEYWORDS = ("chunk", "block", "block_q", "block_k")


def _tuning_only(op: str, kw) -> None:
    bad = sorted(set(kw) - set(TUNING_KEYWORDS))
    if bad:
        raise TypeError(
            f"ops.{op} got unexpected keyword(s) {bad} (the device of the "
            f"inputs picks the route; tuning keywords {TUNING_KEYWORDS} are "
            "ignored)"
        )


def offsets_scan(lengths: torch.Tensor, **kw) -> torch.Tensor:
    """(N,) int32 or int64 collection sizes -> their inclusive scan, in
    the sizes' dtype (K1 scans int64; int32 results wrap modulo 2**32)."""
    from .offsets_scan import offsets_scan as k

    _tuning_only("offsets_scan", kw)
    if lengths.dtype == torch.int64:
        return k(lengths)
    if lengths.dtype != torch.int32:
        raise ValueError(f"ops.offsets_scan takes int32 or int64 sizes, got "
                         f"{lengths.dtype}")
    return k(lengths.to(torch.int64)).to(torch.int32)


def delta_zigzag(x: torch.Tensor, **kw) -> torch.Tensor:
    """(N,) int32 -> uint32, int64 -> uint64 zigzag deltas (K10)."""
    from .delta_zigzag import delta_zigzag as k

    _tuning_only("delta_zigzag", kw)
    return k(x)


def byteshuffle(planes: torch.Tensor, **kw) -> torch.Tensor:
    """(N, itemsize) uint8 -> (itemsize, N) byte planes (K9)."""
    from .byteshuffle import byteshuffle as k

    _tuning_only("byteshuffle", kw)
    return k(planes)


def unsplit_pages(planes: torch.Tensor, **kw) -> torch.Tensor:
    """Inverse page-batched byteshuffle: (P, itemsize, per) -> (P, per,
    itemsize) (K3)."""
    from .decode_pages import unsplit_pages as k

    _tuning_only("unsplit_pages", kw)
    return k(planes)


def decode_offset_pages(planes: torch.Tensor, **kw) -> torch.Tensor:
    """Fused offset-column decode: (P, 8, per) split uint64 zigzag deltas
    -> (P, per) int32 offsets (K4)."""
    from .decode_pages import decode_offset_pages as k

    _tuning_only("decode_offset_pages", kw)
    return k(planes)


def flash_attention(q, k, v, causal=True, window=None, scale=None,
                    impl: str = "ref", **kw) -> torch.Tensor:
    """q (B, H, Sq, D), k/v (B, G, Sk, D) -> (B, H, Sq, D) (K5).  On the
    CPU, ``impl`` picks the plain version: ``"ref"`` (the whole softmax)
    or ``"chunked"`` (the online-softmax scan over kv blocks)."""
    from . import ref
    from .flash_attention import flash_attention as kern

    _tuning_only("flash_attention", kw)
    if impl not in ("ref", "chunked"):
        raise ValueError(f"ops.flash_attention: impl {impl!r} is not 'ref' "
                         "or 'chunked'")
    if q.device.type == "cpu":
        plain = (ref.flash_attention_chunked if impl == "chunked"
                 else ref.flash_attention_ref)
        return plain(q, k, v, causal=causal, window=window, scale=scale)
    return kern(q, k, v, causal=causal, window=window, scale=scale)


def decode_attention(q, k, v, length=None, window=None, scale=None,
                     **kw) -> torch.Tensor:
    """q (B, H, D) against k/v (B, G, S, D) caches of ``length`` (B,)
    valid rows -> (B, H, D) (K6)."""
    from .decode_attention import decode_attention as kern

    _tuning_only("decode_attention", kw)
    return kern(q, k, v, length=length, window=window, scale=scale)


def rwkv6(r, k, v, w, u, **kw):
    """-> (out (B, H, T, Dv), final_state (B, H, Dk, Dv) fp32) (K7)."""
    from .rwkv6_scan import rwkv6_scan as kern

    _tuning_only("rwkv6", kw)
    return kern(r, k, v, w, u)


def mamba2(x, log_a, Bm, Cm, **kw):
    """-> (out (B, H, T, P) without the D skip, final_state (B, H, N, P)
    fp32) (K8)."""
    from .mamba2_ssd import mamba2_ssd as kern

    _tuning_only("mamba2", kw)
    return kern(x, log_a, Bm, Cm)
