"""Attention mixers: GQA/MQA (+ sliding window, qk-norm).

The twin of ``repro.models.attention``'s GQA half::

    gqa_init(gen, cfg, device)                        -> params
    gqa_apply(params, x, cfg, positions)              -> y     (prefill/forward)
    gqa_apply_decode(params, x, cfg, cache, pos)      -> (y, cache)  (one token)

The reference's ``gqa_init_cache`` has no twin here: ``backbone.init_cache``
allocates every layer's cache at once.

The attention itself goes through the kernels' wrappers: K5
``flash_attention`` in prefill, K6 ``decode_attention`` in decode (the
CUDA kernels on a card, their plain versions on the CPU).

Differences from the reference:

* the cache is updated **in place**: the new token's k/v are written at
  each sequence's slot of the given cache tensors (the reference's
  per-sequence ``dynamic_update_slice`` builds a new cache), and the same
  dict is returned;
* the ring-buffered window decode runs through K6 with
  ``length = min(pos + 1, cache_len)``: attention is order-free over the
  keys it sees, so this is the reference's ``_masked_decode``;
* the reference's ``shard(...)`` annotations are no-ops on one card and
  are dropped; its ``attn_impl`` ("ref" | "chunked") has no counterpart:
  K5 is the online-softmax form either way.

MLA waits for its slice.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention

from .layers import apply_rope, cdtype, dense_init, ones, pdtype, rms_norm


def gqa_init(gen, cfg: ArchConfig, device) -> Dict:
    d, h, g, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dt = pdtype(cfg)
    p = {
        "wq": dense_init(gen, d, h * hd, dt, device),
        "wk": dense_init(gen, d, g * hd, dt, device),
        "wv": dense_init(gen, d, g * hd, dt, device),
        "wo": dense_init(gen, h * hd, d, dt, device,
                         scale=1.0 / math.sqrt(h * hd)),
    }
    if cfg.qk_norm:
        p["q_norm"] = ones(hd, dt, device)
        p["k_norm"] = ones(hd, dt, device)
    return p


def _qkv(params: Dict, x: torch.Tensor, cfg: ArchConfig,
         positions: torch.Tensor):
    """-> q (B, H, T, hd), k and v (B, G, T, hd), rope applied."""
    dt = cdtype(cfg)
    b, t, _ = x.shape
    h, g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    x = x.to(dt)
    q = (x @ params["wq"].to(dt)).reshape(b, t, h, hd)
    k = (x @ params["wk"].to(dt)).reshape(b, t, g, hd)
    v = (x @ params["wv"].to(dt)).reshape(b, t, g, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q.transpose(1, 2), positions[:, None], cfg.rope_theta)
    k = apply_rope(k.transpose(1, 2), positions[:, None], cfg.rope_theta)
    return q, k, v.transpose(1, 2)


def attend_out(params: Dict, y: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """(B, H, T, hd) attention output -> (B, T, D) through ``wo``."""
    b, _, t, _ = y.shape
    y = y.transpose(1, 2).reshape(b, t, cfg.n_heads * cfg.resolved_head_dim)
    return y @ params["wo"].to(y.dtype)


def gqa_apply(params: Dict, x: torch.Tensor, cfg: ArchConfig,
              positions: torch.Tensor) -> torch.Tensor:
    q, k, v = _qkv(params, x, cfg, positions)
    y = flash_attention(q, k, v, causal=True, window=cfg.window)
    return attend_out(params, y, cfg)


def gqa_apply_decode(params: Dict, x: torch.Tensor, cfg: ArchConfig,
                     cache: Dict, pos: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, D); pos: (B,) int32 current absolute position, on x's
    device.  Writes the token's k/v into ``cache`` in place (ring slot
    ``pos % cache_len`` with a window) and returns ``(y, cache)``."""
    b = x.shape[0]
    q, k, v = _qkv(params, x, cfg, positions=pos[:, None])
    n_slots = cache["k"].shape[2]
    slot = (pos % n_slots if cfg.window else pos).long()
    rows = torch.arange(b, device=x.device)
    cache["k"][rows, :, slot] = k[:, :, 0].to(cache["k"].dtype)
    cache["v"][rows, :, slot] = v[:, :, 0].to(cache["v"].dtype)
    if cfg.window:
        # ring buffer: every slot is valid once pos + 1 >= cache_len
        length = torch.clamp(pos + 1, max=n_slots)
    else:
        length = pos + 1
    y = decode_attention(q[:, :, 0], cache["k"], cache["v"],
                         length=length.to(torch.int32))
    return attend_out(params, y[:, :, None], cfg), cache
