"""Decoder backbone of every architecture of the registry.

The twin of ``repro.models.backbone``.  Attention blocks (attention, then
an MLP or a mixture of experts) make the ``dense``, ``vlm``, ``audio`` and
``moe`` families: GQA attention (smollm-360m, gemma-2b, deepseek-67b,
chameleon-34b with qk-norm, musicgen-large with 4 codebooks and a plain
gelu MLP, mixtral-8x22b with a sliding window) or MLA (minicpm3-4b), and
MoE in place of the MLP (deepseek-moe-16b, mixtral-8x22b).
``family == "ssm"`` is RWKV-6 layers (rwkv6-7b) and ``family ==
"hybrid"`` zamba2-2.7b: groups of ``shared_attn_every`` Mamba-2 layers,
each group followed by one shared attention block whose parameters all
groups share.  The parameter tree keeps the reference's names and its
stacked leading layer axis (``params["layers"][name]`` is ``(n_layers,
...)``; zamba2's shared block is ``params["shared_attn"]``), so weights
carry across as they are (``repro_torch.models.weights``).  The
reference's ``jax.lax.scan`` over the stacked layers, and zamba2's
unrolled groups, are one Python loop over views of layer ``i``
(``forward`` takes them with one ``unbind`` of each stacked leaf:
indexing layer by layer would give each index a backward that writes a
zero-filled copy of the whole stack; ``prefill`` and ``decode_step``
index, since they write the cache's views in place) with the shared
block after every ``shared_attn_every``-th layer.  ``cfg.remat``
recomputes each layer in the backward pass (``torch.utils.checkpoint``,
non-reentrant), as ``jax.checkpoint`` does over the reference's scan body.

Entry points (see ``registry.ModelBundle``):

* ``loss_fn``     — next-token cross-entropy of ``forward`` plus 0.01 times
  the MoE balance loss (every family), as ``loss_from_sums`` of
  ``loss_sums``: the sums over the batch first (the
  meshed train step adds the other ranks' counts to them);
* ``forward``     — full-sequence logits (teacher forcing) and the summed
  MoE balance loss;
* ``prefill``     — forward over the prompt that fills the decode cache,
  -> (last-token logits, cache);
* ``decode_step`` — one token per sequence against the cache.

Tokens are ``(B, S)``, or ``(B, S, Q)`` for a model of ``Q > 1`` codebooks,
whose logits are ``(..., Q, V)``.  A MoE layer routes each call's
sequences as its groups, so a one-token decode step routes with other
capacity buckets than ``forward`` over the whole sequence (as in the
reference): with drops, decode and teacher forcing differ by design.

The cache is the reference's: ``{"layers": {"k", "v": (L, B, G, C, hd)}}``
(GQA), ``{"layers": {"c": (L, B, C, kv_rank), "k_rope": (L, B, C,
d_rope)}}`` (MLA), ``{"layers": {"wkv": (L, B, H, hd, hd) fp32,
"shift_tm", "shift_cm": (L, B, D)}}`` (rwkv6), and ``{"layers": {"conv":
(L, B, k-1, conv_dim), "ssd": (L, B, H, N, P) fp32}, "shared": {"k", "v":
(n_groups, B, G, C, hd)}}`` (zamba2); ``prefill`` and ``decode_step``
write into it **in place** (views of layer ``i`` or group ``g``) and
return it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention

from . import attention as A
from . import mamba2 as M2
from . import moe as MOE
from . import rwkv6 as R6
from .layers import (
    cdtype, embed_tokens, embedding_init, lm_logits, mlp_apply, mlp_init,
    nll_sum, ones, pdtype, rms_norm,
)


def _is_attn_block(cfg: ArchConfig) -> bool:
    return cfg.family in ("dense", "vlm", "audio", "moe")


def check_ported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` unless the config is one the
    reference's backbone builds: attention blocks (GQA or MLA, an MLP or
    MoE), RWKV-6 layers, or the zamba2 hybrid."""
    attn = (_is_attn_block(cfg) and cfg.ssm is None
            and not cfg.shared_attn_every
            and (cfg.attention == "gqa"
                 or (cfg.attention == "mla" and cfg.mla is not None)))
    rwkv6 = (cfg.family == "ssm" and cfg.ssm is not None
             and cfg.ssm.kind == "rwkv6" and cfg.moe is None)
    hybrid = (cfg.family == "hybrid" and cfg.attention == "gqa"
              and cfg.ssm is not None and cfg.ssm.kind == "mamba2"
              and cfg.moe is None and cfg.shared_attn_every > 0
              and cfg.n_layers % cfg.shared_attn_every == 0)
    if not (attn or rwkv6 or hybrid):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with {cfg.attention!r} "
            "attention is not a model of the registry")


# ---------------------------------------------------------------------------
# per-layer block: init / apply / prefill / decode
#
# The attention block (attention + MLP or MoE) is also zamba2's shared
# block, called with ``_shared_attn_cfg(cfg)``.


def block_init(gen, cfg: ArchConfig, device) -> Dict:
    if cfg.family == "ssm":
        return R6.rwkv6_block_init(gen, cfg, device)
    if cfg.family == "hybrid":
        return M2.mamba2_block_init(gen, cfg, device)
    dt = pdtype(cfg)
    p = {
        "norm1": ones(cfg.d_model, dt, device),
        "norm2": ones(cfg.d_model, dt, device),
        "attn": (A.mla_init(gen, cfg, device) if cfg.attention == "mla"
                 else A.gqa_init(gen, cfg, device)),
    }
    if cfg.moe is not None:
        p["moe"] = MOE.moe_init(gen, cfg, device)
    else:
        p["mlp"] = mlp_init(gen, cfg, device)
    return p


def _finish_block(p: Dict, x: torch.Tensor, attn_out: torch.Tensor,
                  cfg: ArchConfig) -> Tuple[torch.Tensor, Optional[Tuple]]:
    """x + attention, then its MLP or MoE -> (x, the MoE layer's routing
    sums ``(probs, picks)`` (``moe.moe_route_sums``), or None without
    MoE)."""
    x = x + attn_out
    xn = rms_norm(x, p["norm2"], cfg.norm_eps)
    if cfg.moe is not None:
        y, probs, picks = MOE.moe_route_sums(p["moe"], xn, cfg)
        return x + y, (probs, picks)
    return x + mlp_apply(p["mlp"], xn, cfg), None


def _recurrent_apply(cfg: ArchConfig):
    """The recurrent families' block: ``(p, x, cfg) -> (x, state)``."""
    return R6.rwkv6_block_apply if cfg.family == "ssm" else M2.mamba2_block_apply


def block_apply(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor) -> torch.Tensor:
    return block_apply_aux(p, x, cfg, positions)[0]


def block_apply_aux(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                    positions: torch.Tensor
                    ) -> Tuple[torch.Tensor, Optional[Tuple]]:
    """The block's forward -> (x, the MoE layer's routing sums ``(probs,
    picks)``, from which ``moe.balance_loss`` forms the loss the
    reference's ``block_apply`` returns; None without MoE, the
    reference's zeros, without a launch a layer)."""
    if not _is_attn_block(cfg):
        return _recurrent_apply(cfg)(p, x, cfg)[0], None
    xn = rms_norm(x, p["norm1"], cfg.norm_eps)
    attn = A.mla_apply if cfg.attention == "mla" else A.gqa_apply
    return _finish_block(p, x, attn(p["attn"], xn, cfg, positions), cfg)


def block_decode(p: Dict, x: torch.Tensor, cfg: ArchConfig, cache: Dict,
                 pos: torch.Tensor) -> torch.Tensor:
    if cfg.family == "ssm":
        return R6.rwkv6_block_decode(p, x, cfg, cache)
    if cfg.family == "hybrid":
        return M2.mamba2_block_decode(p, x, cfg, cache)
    xn = rms_norm(x, p["norm1"], cfg.norm_eps)
    dec = A.mla_apply_decode if cfg.attention == "mla" else A.gqa_apply_decode
    y, _ = dec(p["attn"], xn, cfg, cache, pos)
    return _finish_block(p, x, y, cfg)[0]


def block_prefill(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                  positions: torch.Tensor, cache: Dict) -> torch.Tensor:
    """The block's forward; writes its decode state into this layer's
    ``cache`` (views of the stacked cache) in place."""
    if _is_attn_block(cfg):
        prefill = _mla_prefill if cfg.attention == "mla" else _gqa_prefill
        return prefill(p, x, cfg, positions, cache)
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
    x = _finish_block(p, x, A.attend_out(p["attn"], y, cfg), cfg)[0]

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


def _mla_prefill(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor, cache: Dict) -> torch.Tensor:
    """The MLA block's forward; writes the prompt's latents ``c`` and
    ``k_rope`` into this layer's ``cache`` in place."""
    s = x.shape[1]
    xn = rms_norm(x, p["norm1"], cfg.norm_eps)
    q_nope, q_rope, c, k_rope = A._mla_qckr(p["attn"], xn, cfg, positions)
    attn_out = A._mla_attend(p["attn"], q_nope, q_rope, c, k_rope, cfg)
    cache["c"][:, :s] = c
    cache["k_rope"][:, :s] = k_rope
    return _finish_block(p, x, attn_out, cfg)[0]


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


def init_params(gen, cfg: ArchConfig, device,
                keep: Optional[Callable] = None) -> Dict:
    """``gen`` is a ``torch.Generator`` on ``device`` (``None`` on the
    ``meta`` device).  Layers are drawn one after another, each into its
    slot of the stacked tree.  ``keep(path, t)`` maps each drawn tensor to
    what is stored (the meshed train state keeps a rank's shards); a
    layer's tensors come one layer at a time under their stacked leaf's
    path (``("layers", "attn", "wq")``)."""
    check_ported(cfg)
    keep = keep or _drawn
    params: Dict[str, Any] = {"embedding": _kept(
        keep, ("embedding",), embedding_init(gen, cfg, device))}
    params["layers"] = _init_stacked(gen, cfg, device, keep)
    if cfg.shared_attn_every:
        params["shared_attn"] = _kept(
            keep, ("shared_attn",),
            block_init(gen, _shared_attn_cfg(cfg), device))
    return params


def _drawn(_path, t):
    return t


def _kept(keep: Callable, path: Tuple[str, ...], tree):
    if isinstance(tree, dict):
        return {k: _kept(keep, path + (k,), v) for k, v in tree.items()}
    return keep(path, tree)


def _init_stacked(gen, cfg: ArchConfig, device, keep: Callable) -> Dict:
    """``cfg.n_layers`` draws of ``block_init``, each kept (``keep``) and
    copied into its slot of the stacked leaves as soon as it is drawn: the
    peak is the kept model plus one drawn layer (deepseek-moe-16b: 62.9 GiB
    of fp32 layers, whose stacked expert bank alone is 19 GiB)."""
    n, stacked = cfg.n_layers, None
    for i in range(n):
        layer = _kept(keep, ("layers",), block_init(gen, cfg, device))
        if stacked is None:
            stacked = _tree_map(lambda t: t.new_empty((n,) + t.shape), layer)
            if device.type == "meta":
                return stacked  # shapes only: one draw gives them
        _tree_map(lambda dst, src: dst[i].copy_(src), stacked, layer)
    return stacked


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


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
    """tokens (B, S[, Q]) -> (logits (B, S[, Q], V), aux): ``aux`` is the
    MoE balance loss summed over the layers (0 without MoE)."""
    logits, routed = forward_sums(params, tokens, cfg)
    if routed is None:
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=logits.device)
    return logits, MOE.balance_loss(*routed, _count(tokens))


def _block(view: Callable, p: Dict, x: torch.Tensor, cfg: ArchConfig,
           positions: torch.Tensor):
    return block_apply_aux(view(p), x, cfg, positions)


def _same(tree):
    return tree


def _count(tokens: torch.Tensor) -> torch.Tensor:
    """The (B, S) positions of ``tokens``, an fp32 scalar on its device."""
    b, s = tokens.shape[:2]
    return torch.full((), float(b * s), dtype=torch.float32,
                      device=tokens.device)


def forward_sums(params: Dict, tokens: torch.Tensor, cfg: ArchConfig,
                 view: Optional[Callable] = None
                 ) -> Tuple[torch.Tensor, Optional[Tuple]]:
    """tokens (B, S[, Q]) -> (logits, the MoE layers' routing sums
    ``(probs, picks)``, each (MoE layers, E), or None without MoE).

    ``view`` maps a subtree of ``params`` (the embedding's, one layer's,
    the shared block's) to the tensors the model computes on (the meshed
    train step gathers a layer's shards there).  A layer's view runs
    inside its remat region, so the backward takes it again and only one
    layer's view is alive at a time."""
    view = view or _same
    b, s = tokens.shape[:2]
    positions = _positions(b, s, tokens.device)
    sc = _shared_attn_cfg(cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    emb = view(params["embedding"])
    x = embed_tokens(emb, tokens, cfg)
    routed = []
    for i, p in enumerate(_unstack(params["layers"])):
        if remat:
            x, r = checkpoint(_block, view, p, x, cfg, positions,
                              use_reentrant=False)
        else:
            x, r = _block(view, p, x, cfg, positions)
        if r is not None:
            routed.append(r)
        if _shared_after(cfg, i) is not None:
            x = block_apply(view(params["shared_attn"]), x, sc, positions)
    sums = (tuple(torch.stack(t) for t in zip(*routed)) if routed
            else None)
    return lm_logits(emb, x, cfg), sums


def loss_sums(params: Dict, batch: Dict, cfg: ArchConfig,
              view: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """The loss's sums over ``batch`` (``tokens``, ``labels`` (B, S[, Q])),
    fp32: ``nll`` (the token NLL summed), ``labels`` (the labels counted),
    and with MoE ``probs``, ``picks`` ((MoE layers, E), ``forward_sums``)
    and ``routed`` (the tokens each layer routed).  ``loss_from_sums``
    forms the loss; ``view`` is ``forward_sums``'."""
    check_ported(cfg)
    logits, routed = forward_sums(params, batch["tokens"], cfg, view)
    nll, count = nll_sum(logits, batch["labels"])
    sums = {"nll": nll, "labels": count}
    if routed is not None:
        sums.update(probs=routed[0], picks=routed[1],
                    routed=_count(batch["tokens"]))
    return sums


def loss_from_sums(sums: Dict[str, torch.Tensor],
                   total: Optional[Callable] = None
                   ) -> Tuple[torch.Tensor, Dict]:
    """-> (ce + 0.01 aux, {"ce", "aux"}) from ``loss_sums``' sums.
    ``total`` maps a count to its sum over the batch the loss is taken on
    (the identity by default): the meshed train step passes the sum over
    the ranks holding other rows, so that each rank's result is its share
    of the loss over the global batch (the shares sum to it), with the
    counts, and the picks of the balance loss, the global batch's."""
    total = total or _same
    ce = sums["nll"] / torch.clamp(total(sums["labels"]), min=1.0)
    if "probs" in sums:
        routed = total(sums["routed"])
        aux = MOE.balance_loss(sums["probs"], total(sums["picks"]), routed)
    else:
        aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def loss_fn(params: Dict, batch: Dict,
            cfg: ArchConfig) -> Tuple[torch.Tensor, Dict]:
    """-> (ce + 0.01 aux, {"ce", "aux"}) over ``batch["tokens"]`` and
    ``batch["labels"]`` (B, S[, Q])."""
    return loss_from_sums(loss_sums(params, batch, cfg))


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
    if cfg.attention == "mla":
        return {"layers": A.mla_init_cache(cfg, n, batch, max_len, dtype,
                                           device)}
    return {"layers": _kv_cache(cfg, n, batch, max_len, dtype, device)}


def prefill(params: Dict, tokens: torch.Tensor, cfg: ArchConfig,
            max_len: int, cache_dtype=None) -> Tuple[torch.Tensor, Dict]:
    """-> (last-token logits (B, 1[, Q], V), stacked cache of
    ``max_len``)."""
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
    """tokens (B, 1[, Q]), pos (B,) int32 on the tokens' device -> (logits
    (B, 1[, Q], V), cache updated in place).  Zamba2's shared blocks decode
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
