"""Decoder backbone of the dense, rwkv6 (``ssm``) and zamba2 (``hybrid``)
families.

The twin of ``repro.models.backbone`` for ``family == "dense"`` with GQA
attention (smollm-360m, gemma-2b, deepseek-67b), ``family == "ssm"`` with
RWKV-6 layers (rwkv6-7b) and ``family == "hybrid"`` (zamba2-2.7b: groups
of ``shared_attn_every`` Mamba-2 layers, each group followed by one
shared attention block whose parameters all groups share).  The
parameter tree keeps the reference's names and its stacked leading layer
axis (``params["layers"][name]`` is ``(n_layers, ...)``; zamba2's shared
block is ``params["shared_attn"]``), so weights carry across as they are
(``repro_torch.models.weights``).  The reference's ``jax.lax.scan`` over
the stacked layers, and zamba2's unrolled groups, are one Python loop
over views of layer ``i`` (``forward`` takes them with one ``unbind`` of
each stacked leaf: indexing layer by layer would give each index a
backward that writes a zero-filled copy of the whole stack; ``prefill``
and ``decode_step`` index, since they write the cache's views in place)
with the shared block after every
``shared_attn_every``-th layer.  ``cfg.remat`` recomputes each layer in
the backward pass (``torch.utils.checkpoint``, non-reentrant), as
``jax.checkpoint`` does over the reference's scan body.

Entry points (see ``registry.ModelBundle``):

* ``loss_fn``     — next-token cross-entropy of ``forward`` (dense family
  only: K7 and K8 have no backward yet, ``check_trainable``);
* ``forward``     — full-sequence logits (teacher forcing);
* ``prefill``     — forward over the prompt that fills the decode cache,
  -> (last-token logits, cache);
* ``decode_step`` — one token per sequence against the cache.

The cache is the reference's: ``{"layers": {"k", "v": (L, B, G, C, hd)}}``
(dense), ``{"layers": {"wkv": (L, B, H, hd, hd) fp32, "shift_tm",
"shift_cm": (L, B, D)}}`` (rwkv6), and ``{"layers": {"conv": (L, B, k-1,
conv_dim), "ssd": (L, B, H, N, P) fp32}, "shared": {"k", "v": (n_groups,
B, G, C, hd)}}`` (zamba2); ``prefill`` and ``decode_step`` write into it
**in place** (views of layer ``i`` or group ``g``) and return it.  Other
families raise ``NotImplementedError`` until their slices come (ROADMAP
Queue 1).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention

from . import attention as A
from . import mamba2 as M2
from . import rwkv6 as R6
from .layers import (
    cdtype, cross_entropy_loss, embed_tokens, embedding_init, lm_logits,
    mlp_apply, mlp_init, ones, pdtype, rms_norm,
)


def check_ported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` unless the port has this model."""
    plain = cfg.moe is None and cfg.mla is None and cfg.n_codebooks == 1
    dense = (cfg.family == "dense" and cfg.attention == "gqa" and plain
             and cfg.ssm is None and not cfg.shared_attn_every)
    rwkv6 = (cfg.family == "ssm" and plain and cfg.ssm is not None
             and cfg.ssm.kind == "rwkv6" and not cfg.shared_attn_every)
    hybrid = (cfg.family == "hybrid" and cfg.attention == "gqa" and plain
              and cfg.ssm is not None and cfg.ssm.kind == "mamba2"
              and cfg.shared_attn_every > 0
              and cfg.n_layers % cfg.shared_attn_every == 0)
    if not (dense or rwkv6 or hybrid):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with {cfg.attention!r} "
            "attention is not ported yet; the port has the dense family "
            "with GQA attention, rwkv6 and the zamba2 hybrid")


def check_trainable(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` unless the port can train this model:
    the dense family only, until K7 and K8 have backward kernels."""
    check_ported(cfg)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: training family {cfg.family!r} needs backward "
            "kernels for K7/K8 that the port does not have yet; the port "
            "trains the dense family")


# ---------------------------------------------------------------------------
# per-layer block: init / apply / prefill / decode
#
# The dense block (attention + gated MLP) is also zamba2's shared block,
# called with ``_shared_attn_cfg(cfg)``.


def block_init(gen, cfg: ArchConfig, device) -> Dict:
    if cfg.family == "ssm":
        return R6.rwkv6_block_init(gen, cfg, device)
    if cfg.family == "hybrid":
        return M2.mamba2_block_init(gen, cfg, device)
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


def _recurrent_apply(cfg: ArchConfig):
    """The recurrent families' block: ``(p, x, cfg) -> (x, state)``."""
    return R6.rwkv6_block_apply if cfg.family == "ssm" else M2.mamba2_block_apply


def block_apply(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor) -> torch.Tensor:
    if cfg.family != "dense":
        return _recurrent_apply(cfg)(p, x, cfg)[0]
    xn = rms_norm(x, p["norm1"], cfg.norm_eps)
    return _finish_block(p, x, A.gqa_apply(p["attn"], xn, cfg, positions), cfg)


def block_decode(p: Dict, x: torch.Tensor, cfg: ArchConfig, cache: Dict,
                 pos: torch.Tensor) -> torch.Tensor:
    if cfg.family == "ssm":
        return R6.rwkv6_block_decode(p, x, cfg, cache)
    if cfg.family == "hybrid":
        return M2.mamba2_block_decode(p, x, cfg, cache)
    xn = rms_norm(x, p["norm1"], cfg.norm_eps)
    y, _ = A.gqa_apply_decode(p["attn"], xn, cfg, cache, pos)
    return _finish_block(p, x, y, cfg)


def block_prefill(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                  positions: torch.Tensor, cache: Dict) -> torch.Tensor:
    """The block's forward; writes its decode state into this layer's
    ``cache`` (views of the stacked cache) in place."""
    if cfg.family == "dense":
        return _gqa_prefill(p, x, cfg, positions, cache)
    x, state = _recurrent_apply(cfg)(p, x, cfg)
    for name, t in state.items():
        cache[name].copy_(t)
    return x


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
# zamba2's shared attention block


def _shared_attn_cfg(cfg: ArchConfig,
                     window: Optional[int] = None) -> ArchConfig:
    """Zamba2's shared transformer block config (attention + MLP), with
    ``window`` when one is given."""
    sc = cfg.with_(family="dense", attention="gqa", moe=None, ssm=None,
                   shared_attn_every=0)
    return sc if window is None else sc.with_(window=window)


def _zamba_shared_window(max_len: int) -> Optional[int]:
    """At long context the zamba2 shared-attn blocks run windowed (4096)
    to keep cache memory bounded, as in the reference."""
    return 4096 if max_len > 65536 else None


def _shared_after(cfg: ArchConfig, i: int) -> Optional[int]:
    """The group whose shared block follows layer ``i``, else None."""
    every = cfg.shared_attn_every
    if every and (i + 1) % every == 0:
        return i // every
    return None


# ---------------------------------------------------------------------------
# model init


def init_params(gen, cfg: ArchConfig, device) -> Dict:
    """``gen`` is a ``torch.Generator`` on ``device`` (``None`` on the
    ``meta`` device).  Layers are drawn one after another and stacked."""
    check_ported(cfg)
    params: Dict[str, Any] = {"embedding": embedding_init(gen, cfg, device)}
    layers = [block_init(gen, cfg, device) for _ in range(cfg.n_layers)]
    params["layers"] = _stack(layers)
    if cfg.shared_attn_every:
        params["shared_attn"] = block_init(gen, _shared_attn_cfg(cfg), device)
    return params


def _stack(trees):
    """Stack per-layer trees leaf by leaf, taking each leaf out of the
    layers' trees as it goes: the peak is the model plus one stacked leaf,
    not twice the model (rwkv6-7b: 30 GB of fp32 layers)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t.pop(k) for t in trees]) for k in list(trees[0])}
    return torch.stack(trees)


def _layer_slice(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree) -> List:
    """A stacked tree -> one tree of views per layer (``unbind`` of every
    leaf once)."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(tree.unbind(0))


# ---------------------------------------------------------------------------
# forward passes


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def forward(params: Dict, tokens: torch.Tensor,
            cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V), aux).  ``aux`` is the MoE
    balance loss of the reference: 0 in the ported families."""
    b, s = tokens.shape[:2]
    positions = _positions(b, s, tokens.device)
    sc = _shared_attn_cfg(cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    x = embed_tokens(params["embedding"], tokens, cfg)
    for i, p in enumerate(_unstack(params["layers"])):
        if remat:
            x = checkpoint(block_apply, p, x, cfg, positions,
                           use_reentrant=False)
        else:
            x = block_apply(p, x, cfg, positions)
        if _shared_after(cfg, i) is not None:
            x = block_apply(params["shared_attn"], x, sc, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return lm_logits(params["embedding"], x, cfg), aux


def loss_fn(params: Dict, batch: Dict,
            cfg: ArchConfig) -> Tuple[torch.Tensor, Dict]:
    """-> (ce + 0.01 aux, {"ce", "aux"}) over ``batch["tokens"]`` and
    ``batch["labels"]`` (B, S)."""
    check_trainable(cfg)
    logits, aux = forward(params, batch["tokens"], cfg)
    ce = cross_entropy_loss(logits, batch["labels"])
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def _kv_cache(cfg: ArchConfig, n: int, batch: int, max_len: int, dtype,
              device) -> Dict:
    """``{"k", "v": (n, B, G, C, hd)}``; ``C`` is ``max_len``, or the
    window when that is shorter."""
    cache_len = min(max_len, cfg.window) if cfg.window else max_len
    shape = (n, batch, cfg.n_kv_heads, cache_len, cfg.resolved_head_dim)
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k in ("k", "v")}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
               device) -> Dict:
    """The stacked cache, all layers at once (the reference's per-layer
    ``*_init_cache``, stacked; see the module docstring)."""
    dtype = dtype or cdtype(cfg)
    n = cfg.n_layers
    if cfg.family == "ssm":
        return {"layers": R6.rwkv6_init_cache(cfg, n, batch, dtype, device)}
    if cfg.family == "hybrid":
        sc = _shared_attn_cfg(cfg, cfg.window or _zamba_shared_window(max_len))
        return {"layers": M2.mamba2_init_cache(cfg, n, batch, dtype, device),
                "shared": _kv_cache(sc, n // cfg.shared_attn_every, batch,
                                    max_len, dtype, device)}
    return {"layers": _kv_cache(cfg, n, batch, max_len, dtype, device)}


def prefill(params: Dict, tokens: torch.Tensor, cfg: ArchConfig,
            max_len: int, cache_dtype=None) -> Tuple[torch.Tensor, Dict]:
    """-> (last-token logits (B, 1, V), stacked cache of ``max_len``)."""
    b, s = tokens.shape[:2]
    cache = init_cache(cfg, b, max_len, cache_dtype, tokens.device)
    positions = _positions(b, s, tokens.device)
    sc = _shared_attn_cfg(cfg, cfg.window or _zamba_shared_window(max_len))
    x = embed_tokens(params["embedding"], tokens, cfg)
    for i in range(cfg.n_layers):
        x = block_prefill(_layer_slice(params["layers"], i), x, cfg,
                          positions, _layer_slice(cache["layers"], i))
        g = _shared_after(cfg, i)
        if g is not None:
            x = _gqa_prefill(params["shared_attn"], x, sc, positions,
                             _layer_slice(cache["shared"], g))
    return lm_logits(params["embedding"], x[:, -1:], cfg), cache


def decode_step(params: Dict, tokens: torch.Tensor, cache: Dict,
                pos: torch.Tensor, cfg: ArchConfig) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, 1), pos (B,) int32 on the tokens' device -> (logits
    (B, 1, V), cache updated in place).  Zamba2's shared blocks decode
    with ``window = cache_len``, as in the reference: ring semantics that
    are exact when the cache holds every position."""
    x = embed_tokens(params["embedding"], tokens, cfg)
    if cfg.shared_attn_every:
        sc = _shared_attn_cfg(cfg, cache["shared"]["k"].shape[3])
    for i in range(cfg.n_layers):
        x = block_decode(_layer_slice(params["layers"], i), x, cfg,
                         _layer_slice(cache["layers"], i), pos)
        g = _shared_after(cfg, i)
        if g is not None:
            x = block_decode(params["shared_attn"], x, sc,
                             _layer_slice(cache["shared"], g), pos)
    return lm_logits(params["embedding"], x, cfg), cache
