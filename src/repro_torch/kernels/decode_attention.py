"""K6: decode attention, one new token per sequence against its KV cache.

Replaces the Pallas ``decode_attention``
(``src/repro/kernels/decode_attention.py``): q ``(B, H, D)`` against
k/v ``(B, G, S, D)``, keys at positions ``< length[b]`` (and, with a
window, ``>= length[b] - window``), fp32 softmax.  The CUDA kernel
(``csrc/attention.cu``) is split-K flash-decoding: the cache splits into
chunks, one block per (chunk, kv group, sequence) reads each K/V row once
for all ``H // G`` query heads of its group and writes fp32 partials; a
second kernel combines them.  ``length`` stays on the card: the kernel
reads it there and no step waits on the host.  On a CPU tensor the
wrapper runs the plain version (``ref.decode_attention_ref``), on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from . import _build, ref
from .flash_attention import DTYPE_CODES, check_kernel_args
from .ops import count_launch

#: cache rows a block stages per tile (as in the kernel)
TILE_ROWS = {32: 64, 64: 64, 80: 64, 128: 64, 256: 32}


@functools.lru_cache(maxsize=None)
def target_blocks(device: torch.device) -> int:
    """Blocks the split aims for: two waves of the card's SMs."""
    return 2 * torch.cuda.get_device_properties(device).multi_processor_count


def chunking(b: int, g: int, s: int, d: int, target: int):
    """(chunk, n_chunks): whole tiles per chunk, enough chunks that the
    (chunk, group, sequence) grid reaches ``target`` blocks."""
    tk = TILE_ROWS[d]
    tiles = -(-s // tk)
    split = max(1, min(tiles, -(-target // (b * g))))
    chunk = -(-tiles // split) * tk
    return chunk, -(-s // chunk)


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
    check_kernel_args("decode_attention", q, k, v, window=window)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
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
    chunk, nch = chunking(b, g, s, d, target_blocks(q.device))
    part_m = torch.empty((b, h, nch), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, h, nch, d), dtype=torch.float32,
                           device=q.device)
    lib = _build.library("attention")
    guard, stream = _build.launch_args(q)
    with guard:
        rc = lib.repro_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
            out.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
            part_acc.data_ptr(), b, h, g, s, d, DTYPE_CODES[q.dtype], chunk,
            nch, 0 if window is None else int(window), float(scale), stream)
    _build.check(lib, rc, "decode_attention")
    count_launch("decode_attention", (b, h, g, s, d))
    return out
