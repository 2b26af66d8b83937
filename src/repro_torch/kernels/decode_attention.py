"""K6: decode attention, one new token per sequence against its KV cache.

Replaces the Pallas ``decode_attention``
(``src/repro/kernels/decode_attention.py``): q ``(B, H, D)`` against
k/v ``(B, G, S, D)``, keys at positions ``< length[b]`` (and, with a
window, ``>= length[b] - window``), fp32 softmax.  The CUDA kernel
(``csrc/attention.cu``) is split-K flash-decoding: the cache splits into
chunks, one block per (chunk, kv group, sequence) reads each K/V row once
for the ``H // G`` query heads of its group (up to 8 per block) and
writes fp32 partials; the last block of a head group to finish combines
them.  It finds out through a counter per (sequence, head group), zero
between launches; each stream has its own counters, so launches on two
streams never share one.  A cache split into one chunk skips all that:
its block writes the result.  Both dtypes take the same kernel: each warp
stages its rows unconverted with 16-byte ``cp.async`` into a ring of
three stages, a lane owns a 16-byte slice of a row, and the heads'
running softmax stays in registers.  ``length`` stays on the card: the
kernel reads it there and no step waits on the host.  On a CPU tensor
the wrapper runs the plain version (``ref.decode_attention_ref``), on a
``meta`` tensor the dry-run's stand-in (``meta.py``), on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch

from . import _build, meta, ref
from .flash_attention import DTYPE_CODES, aligned16, check_kernel_args
from .ops import count_launch, refuse_grad

#: cache rows a block of 4 warps stages per step: 4 x ``da_warp_rows`` of
#: the kernel (about 2 KB of K and of V per warp in bf16); chunks are whole
#: multiples of it
TILE_ROWS = {32: 128, 64: 64, 80: 48, 128: 32, 256: 16}


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


#: (device, stream) -> int32 zeros: the kernel's per-launch counters, left
#: at zero by every launch
_COUNTERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters for launches on ``stream``."""
    buf = _COUNTERS.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[(device, stream)] = buf
    return buf


#: most chunks per cache: the combining block holds their (m, l) in
#: shared memory (``DA_MAX_CHUNKS`` in the kernel)
MAX_CHUNKS = 256


def chunking(b: int, g: int, s: int, d: int, target: int):
    """(chunk, n_chunks): whole tiles per chunk, enough chunks that the
    (chunk, group, sequence) grid reaches ``target`` blocks, at most
    ``MAX_CHUNKS``."""
    tk = TILE_ROWS[d]
    tiles = -(-s // tk)
    split = max(1, min(tiles, MAX_CHUNKS, -(-target // (b * g))))
    chunk = -(-tiles // split) * tk
    return chunk, -(-s // chunk)


def heads_per_block(hg: int) -> int:
    """Query heads a block holds in registers (as the kernel picks)."""
    return hg if hg <= 4 else 8


def launch_shape(b: int, g: int, hg: int, s: int, d: int, sms: int):
    """(chunk, n_chunks, warps per block) of one launch on a card of
    ``sms`` SMs.  Splitting the cache costs a combining pass and more
    blocks each paying the start-up, so the split only aims for half the
    SMs; a grid that stays under one block per SM gets 8 warps a block
    where the heads leave the registers for it."""
    blocks = b * g * -(-hg // heads_per_block(hg))
    chunk, nch = chunking(b, blocks // b, s, d, sms // 2)
    small = blocks * nch < sms and heads_per_block(hg) <= 4
    return chunk, nch, 8 if small else 4


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: Optional[torch.Tensor] = None,
                     window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q (B, H, D), k/v (B, G, S, D), length (B,) -> (B, H, D)."""
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("decode_attention: q (B,H,D), k/v (B,G,S,D)")
    b, h, d = q.shape
    g, s = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or g < 1 or h % g:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not group")
    if length is not None and tuple(length.shape) != (b,):
        raise ValueError(f"decode_attention: length must be ({b},)")
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, length=length, window=window,
                                        scale=scale)
    refuse_grad("decode_attention", q, k, v)
    check_kernel_args("decode_attention", q, k, v, window=window)
    if q.device.type == "meta":  # the dry-run: shapes and FLOPs
        return meta.ops().decode_attention(q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    q, k, v = (aligned16(t.contiguous()) for t in (q, k, v))
    if length is None:
        length = torch.full((b,), s, dtype=torch.int32, device=q.device)
    elif length.device != q.device:
        raise ValueError("decode_attention: length must lie on q's device")
    length = length.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if s == 0:
        return out.zero_()
    chunk, nch, warps = launch_shape(b, g, h // g, s, d, sm_count(q.device))
    part_m = torch.empty((b, h, nch), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, h, nch, d), dtype=torch.float32,
                           device=q.device)
    lib = _build.library("attention")
    guard, stream = _build.launch_args(q)
    with guard:
        cnt = counters(q.device, stream, b * h)
        rc = lib.repro_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
            out.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
            part_acc.data_ptr(), cnt.data_ptr(), b, h, g, s, d,
            DTYPE_CODES[q.dtype], chunk, nch, warps,
            0 if window is None else int(window), float(scale), stream)
    _build.check(lib, rc, "decode_attention")
    count_launch("decode_attention", (b, h, g, s, d))
    return out
