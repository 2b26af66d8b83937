"""Decoder backbone of the dense family (GQA/MQA attention + gated MLP).

The twin of ``repro.models.backbone`` for ``family == "dense"`` with GQA
attention (smollm-360m, gemma-2b, deepseek-67b).  The parameter tree
keeps the reference's names and its stacked leading layer axis
(``params["layers"][name]`` is ``(n_layers, ...)``), so weights carry
across as they are (``repro_torch.models.weights``).  The reference's
``jax.lax.scan`` over the stacked layers is a Python loop over views of
layer ``i``.

Entry points (see ``registry.ModelBundle``):

* ``forward``     — full-sequence logits (teacher forcing);
* ``prefill``     — forward over the prompt that fills the decode cache,
  -> (last-token logits, cache);
* ``decode_step`` — one token per sequence against the cache.

The cache is ``{"layers": {"k": (L, B, G, C, hd), "v": ...}}`` as in the
reference; ``prefill`` and ``decode_step`` write into it **in place**
(views of layer ``i``) and return it.  Other families raise
``NotImplementedError`` until their slices come (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention

from . import attention as A
from .layers import (
    cdtype, embed_tokens, embedding_init, lm_logits, mlp_apply, mlp_init,
    ones, pdtype, rms_norm,
)


def check_ported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` unless the port has this model."""
    if (cfg.family != "dense" or cfg.attention != "gqa" or cfg.moe is not None
            or cfg.ssm is not None or cfg.shared_attn_every
            or cfg.n_codebooks != 1):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with {cfg.attention!r} "
            "attention is not ported yet; the port has the dense family "
            "with GQA attention")


# ---------------------------------------------------------------------------
# per-layer block: init / apply / prefill / decode


def block_init(gen, cfg: ArchConfig, device) -> Dict:
    dt = pdtype(cfg)
    return {
        "norm1": ones(cfg.d_model, dt, device),
        "norm2": ones(cfg.d_model, dt, device),
        "attn": A.gqa_init(gen, cfg, device),
        "mlp": mlp_init(gen, cfg, device),
    }


def _finish_block(p: Dict, x: torch.Tensor, attn_out: torch.Tensor,
                  cfg: ArchConfig) -> torch.Tensor:
    x = x + attn_out
    return x + mlp_apply(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps), cfg)


def block_apply(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor) -> torch.Tensor:
    xn = rms_norm(x, p["norm1"], cfg.norm_eps)
    return _finish_block(p, x, A.gqa_apply(p["attn"], xn, cfg, positions), cfg)


def block_decode(p: Dict, x: torch.Tensor, cfg: ArchConfig, cache: Dict,
                 pos: torch.Tensor) -> torch.Tensor:
    xn = rms_norm(x, p["norm1"], cfg.norm_eps)
    y, _ = A.gqa_apply_decode(p["attn"], xn, cfg, cache, pos)
    return _finish_block(p, x, y, cfg)


def _gqa_prefill(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor, cache: Dict) -> torch.Tensor:
    """The block's forward; writes the prompt's k/v into this layer's
    ``cache`` (``(B, G, C, hd)`` views) in place."""
    s = x.shape[1]
    xn = rms_norm(x, p["norm1"], cfg.norm_eps)
    q, k, v = A._qkv(p["attn"], xn, cfg, positions)
    y = flash_attention(q, k, v, causal=True, window=cfg.window)
    x = _finish_block(p, x, A.attend_out(p["attn"], y, cfg), cfg)

    cache_len = cache["k"].shape[2]
    if cache_len >= s:
        cache["k"][:, :, :s] = k
        cache["v"][:, :, :s] = v
    else:
        # ring buffer (SWA): keep the last cache_len tokens at slots pos % len
        slots = torch.arange(s - cache_len, s, device=x.device) % cache_len
        cache["k"][:, :, slots] = k[:, :, -cache_len:].to(cache["k"].dtype)
        cache["v"][:, :, slots] = v[:, :, -cache_len:].to(cache["v"].dtype)
    return x


# ---------------------------------------------------------------------------
# model init


def init_params(gen, cfg: ArchConfig, device) -> Dict:
    """``gen`` is a ``torch.Generator`` on ``device`` (``None`` on the
    ``meta`` device).  Layers are drawn one after another and stacked."""
    check_ported(cfg)
    params: Dict[str, Any] = {"embedding": embedding_init(gen, cfg, device)}
    layers = [block_init(gen, cfg, device) for _ in range(cfg.n_layers)]
    params["layers"] = _stack(layers)
    return params


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _layer_slice(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# forward passes


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def forward(params: Dict, tokens: torch.Tensor,
            cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V), aux).  ``aux`` is the MoE
    balance loss of the reference: 0 in the dense family."""
    b, s = tokens.shape[:2]
    positions = _positions(b, s, tokens.device)
    x = embed_tokens(params["embedding"], tokens, cfg)
    for i in range(cfg.n_layers):
        x = block_apply(_layer_slice(params["layers"], i), x, cfg, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return lm_logits(params["embedding"], x, cfg), aux


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
               device) -> Dict:
    """The stacked cache ``{"layers": {"k", "v": (L, B, G, C, hd)}}``, all
    layers at once (the reference's per-layer ``gqa_init_cache``, stacked);
    ``C`` is ``max_len``, or the window when that is shorter."""
    cache_len = min(max_len, cfg.window) if cfg.window else max_len
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, cache_len,
             cfg.resolved_head_dim)
    dtype = dtype or cdtype(cfg)
    return {"layers": {k: torch.zeros(shape, dtype=dtype, device=device)
                       for k in ("k", "v")}}


def prefill(params: Dict, tokens: torch.Tensor, cfg: ArchConfig,
            max_len: int, cache_dtype=None) -> Tuple[torch.Tensor, Dict]:
    """-> (last-token logits (B, 1, V), stacked cache of ``max_len``)."""
    b, s = tokens.shape[:2]
    cache = init_cache(cfg, b, max_len, cache_dtype, tokens.device)
    positions = _positions(b, s, tokens.device)
    x = embed_tokens(params["embedding"], tokens, cfg)
    for i in range(cfg.n_layers):
        x = _gqa_prefill(_layer_slice(params["layers"], i), x, cfg, positions,
                         _layer_slice(cache["layers"], i))
    return lm_logits(params["embedding"], x[:, -1:], cfg), cache


def decode_step(params: Dict, tokens: torch.Tensor, cache: Dict,
                pos: torch.Tensor, cfg: ArchConfig) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, 1), pos (B,) int32 on the tokens' device -> (logits
    (B, 1, V), cache updated in place)."""
    x = embed_tokens(params["embedding"], tokens, cfg)
    for i in range(cfg.n_layers):
        x = block_decode(_layer_slice(params["layers"], i), x, cfg,
                         _layer_slice(cache["layers"], i), pos)
    return lm_logits(params["embedding"], x, cfg), cache
