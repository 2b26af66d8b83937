"""Attention mixers: GQA/MQA (+ sliding window, qk-norm) and MLA.

The twin of ``repro.models.attention``::

    gqa_init(gen, cfg, device)                        -> params
    gqa_apply(params, x, cfg, positions)              -> y     (prefill/forward)
    gqa_apply_decode(params, x, cfg, cache, pos)      -> (y, cache)  (one token)
    mla_init(gen, cfg, device)                        -> params
    mla_apply(params, x, cfg, positions)              -> y
    mla_init_cache(cfg, n_layers, batch, max_len, dtype, device) -> cache
    mla_apply_decode(params, x, cfg, cache, pos)      -> (y, cache)

The reference's ``gqa_init_cache`` has no twin here: ``backbone.init_cache``
allocates every layer's cache at once (``mla_init_cache`` stacks
``n_layers`` of them too).

The attention itself goes through the kernels' wrappers: K5
``flash_attention`` in prefill (MLA's too, at q/k ``d_nope + d_rope`` and
v ``d_v``: minicpm3-4b's 96 and 64), K6 ``decode_attention`` in GQA's
decode (the CUDA kernels on a card, their plain versions on the CPU).
MLA's decode is the reference's latent-space form in plain PyTorch: q
folded through ``W_uk`` attends to the cached latents ``c`` (and the
shared rotary key), so the cache holds only ``c`` and ``k_rope``.

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


# ---------------------------------------------------------------------------
# MLA (Multi-head Latent Attention, MiniCPM3 / DeepSeek-V2)
#
# Queries:  q = W_uq norm(W_dq x)   per head split into (d_nope | d_rope)
# KV:       c = norm(W_dkv x)  (kv_rank)  +  k_rope = W_kr x (d_rope, shared)
#           k_nope = W_uk c ; v = W_uv c  per head
# The decode cache stores ONLY (c, k_rope): rank + d_rope values a token.


def mla_init(gen, cfg: ArchConfig, device) -> Dict:
    m = cfg.mla
    d, h, dt = cfg.d_model, cfg.n_heads, pdtype(cfg)
    qd = m.d_nope + m.d_rope
    return {
        "w_dq": dense_init(gen, d, m.q_rank, dt, device),
        "q_norm": ones(m.q_rank, dt, device),
        "w_uq": dense_init(gen, m.q_rank, h * qd, dt, device),
        "w_dkv": dense_init(gen, d, m.kv_rank, dt, device),
        "kv_norm": ones(m.kv_rank, dt, device),
        "w_kr": dense_init(gen, d, m.d_rope, dt, device),
        "w_uk": dense_init(gen, m.kv_rank, h * m.d_nope, dt, device),
        "w_uv": dense_init(gen, m.kv_rank, h * m.d_v, dt, device),
        "wo": dense_init(gen, h * m.d_v, d, dt, device),
    }


def _mla_qckr(params: Dict, x: torch.Tensor, cfg: ArchConfig,
              positions: torch.Tensor):
    """-> q_nope (B, T, H, d_nope), q_rope (B, T, H, d_rope) (rope
    applied), the latents c (B, T, kv_rank) and k_rope (B, T, d_rope)."""
    m = cfg.mla
    dt = cdtype(cfg)
    b, t, _ = x.shape
    x = x.to(dt)
    cq = rms_norm(x @ params["w_dq"].to(dt), params["q_norm"], cfg.norm_eps)
    q = (cq @ params["w_uq"].to(dt)).reshape(b, t, cfg.n_heads,
                                            m.d_nope + m.d_rope)
    q_nope, q_rope = q[..., :m.d_nope], q[..., m.d_nope:]
    q_rope = apply_rope(q_rope.transpose(1, 2), positions[:, None],
                        cfg.rope_theta).transpose(1, 2)
    c = rms_norm(x @ params["w_dkv"].to(dt), params["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope((x @ params["w_kr"].to(dt))[:, None],
                        positions[:, None], cfg.rope_theta)[:, 0]
    return q_nope, q_rope, c, k_rope


def _mla_attend(params: Dict, q_nope, q_rope, c, k_rope,
                cfg: ArchConfig) -> torch.Tensor:
    """Full-form MLA attention: per-head k/v made from the latents, then
    K5 at q/k ``d_nope + d_rope`` and v ``d_v`` -> (B, Tq, D)."""
    m = cfg.mla
    h = cfg.n_heads
    dt = q_nope.dtype
    b, tq = q_nope.shape[:2]
    tk = c.shape[1]
    k_nope = (c @ params["w_uk"].to(dt)).reshape(b, tk, h, m.d_nope)
    v = (c @ params["w_uv"].to(dt)).reshape(b, tk, h, m.d_v)
    q = torch.cat([q_nope, q_rope], dim=-1).transpose(1, 2)      # (B,H,Tq,.)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(b, tk, h, m.d_rope)],
                  dim=-1).transpose(1, 2)
    y = flash_attention(q, k, v.transpose(1, 2), causal=True,
                        scale=1.0 / math.sqrt(m.d_nope + m.d_rope))
    y = y.transpose(1, 2).reshape(b, tq, h * m.d_v)
    return y @ params["wo"].to(dt)


def mla_apply(params: Dict, x: torch.Tensor, cfg: ArchConfig,
              positions: torch.Tensor) -> torch.Tensor:
    q_nope, q_rope, c, k_rope = _mla_qckr(params, x, cfg, positions)
    return _mla_attend(params, q_nope, q_rope, c, k_rope, cfg)


def mla_init_cache(cfg: ArchConfig, n_layers: int, batch: int, max_len: int,
                   dtype, device) -> Dict:
    """Every layer's latent cache, stacked: ``c`` (L, B, max_len,
    kv_rank) and ``k_rope`` (L, B, max_len, d_rope)."""
    m = cfg.mla
    return {
        "c": torch.zeros((n_layers, batch, max_len, m.kv_rank), dtype=dtype,
                         device=device),
        "k_rope": torch.zeros((n_layers, batch, max_len, m.d_rope),
                              dtype=dtype, device=device),
    }


def mla_apply_decode(params: Dict, x: torch.Tensor, cfg: ArchConfig,
                     cache: Dict, pos: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, D); pos: (B,) int32 on x's device.  Writes the token's
    latents into ``cache`` in place and attends in latent space: ``W_uk``
    folded into q, so the cache is read once in compressed form."""
    m = cfg.mla
    b, h = x.shape[0], cfg.n_heads
    q_nope, q_rope, c_new, kr_new = _mla_qckr(params, x, cfg, pos[:, None])
    rows, slot = torch.arange(b, device=x.device), pos.long()
    cache["c"][rows, slot] = c_new[:, 0].to(cache["c"].dtype)
    cache["k_rope"][rows, slot] = kr_new[:, 0].to(cache["k_rope"].dtype)
    c, kr = cache["c"], cache["k_rope"]
    dt = q_nope.dtype
    w_uk = params["w_uk"].to(dt).reshape(m.kv_rank, h, m.d_nope)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], w_uk)      # (B,H,rank)
    logits = (torch.einsum("bhr,btr->bht", q_lat, c)
              + torch.einsum("bhe,bte->bht", q_rope[:, 0], kr))
    logits = logits * (1.0 / math.sqrt(m.d_nope + m.d_rope))
    slots = torch.arange(c.shape[1], device=x.device)
    valid = slots[None, :] < (pos + 1)[:, None]
    logits = torch.where(valid[:, None, :], logits.float(),
                         torch.tensor(-1e30, device=x.device))
    p = torch.softmax(logits, dim=-1).to(dt)
    ctx = torch.einsum("bht,btr->bhr", p, c)                      # (B,H,rank)
    w_uv = params["w_uv"].to(dt).reshape(m.kv_rank, h, m.d_v)
    y = torch.einsum("bhr,rhv->bhv", ctx, w_uv).reshape(b, 1, h * m.d_v)
    return y @ params["wo"].to(dt), cache
