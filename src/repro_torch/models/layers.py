"""Shared model layers: norms, rope, MLPs, embeddings.

The twin of ``repro.models.layers``.  Params are nested dicts of tensors
with the reference's names and its ``(in, out)`` matrix layout, applied as
``x @ w``.  Init functions take a ``torch.Generator`` (``None`` on the
``meta`` device) and a device; their numbers differ from ``jax.random``'s,
so parity tests carry the reference's weights over
(``repro_torch.models.weights``).  The reference's ``shard(...)``
annotations are no-ops on one card and are dropped.  Multi-codebook
models (musicgen-large) take tokens ``(B, T, Q)``: the embedding is the sum
of the ``Q`` codebooks' rows and the logits are ``(B, T, Q, V)``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig


def cdtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def pdtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _normal(gen, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device)


def dense_init(gen, in_dim: int, out_dim: int, dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return (_normal(gen, (in_dim, out_dim), device) * scale).to(dtype)


def embed_init(gen, vocab: int, d: int, dtype, device) -> torch.Tensor:
    return (_normal(gen, (vocab, d), device) * 0.02).to(dtype)


def ones(n: int, dtype, device) -> torch.Tensor:
    return torch.ones((n,), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# norms


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm in fp32; ``gamma`` multiplies directly (not ``1 + gamma``)."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(ms + eps)) * gamma.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Layer norm in fp32 (population variance), as the reference's; no
    architecture of the registry uses it."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings


def rope_freqs(dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, D) with D even; positions: (..., S) int.  Split-half
    rotation (first half against second half), angles in fp32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # (D/2,)
    angles = positions[..., None].float() * freqs                # (..., S, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs


def mlp_init(gen, cfg: ArchConfig, device) -> Dict:
    """Gated (swiglu / geglu) weights, or the plain gelu MLP's (musicgen)."""
    d, f, dt = cfg.d_model, cfg.d_ff, pdtype(cfg)
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(gen, d, f, dt, device),
            "w_up": dense_init(gen, d, f, dt, device),
            "w_down": dense_init(gen, f, d, dt, device),
        }
    return {
        "w_up": dense_init(gen, d, f, dt, device),
        "w_down": dense_init(gen, f, d, dt, device),
    }


def mlp_apply(params: Dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x: (B, T, D).  SwiGLU, GeGLU, or the plain MLP; every gelu is the
    tanh approximation."""
    dt = cdtype(cfg)
    x = x.to(dt)
    u = x @ params["w_up"].to(dt)
    if cfg.mlp in ("swiglu", "geglu"):
        g = x @ params["w_gate"].to(dt)
        act = F.silu(g) if cfg.mlp == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * u
    else:
        h = F.gelu(u, approximate="tanh")
    return h @ params["w_down"].to(dt)


# ---------------------------------------------------------------------------
# embeddings / lm head


def embedding_init(gen, cfg: ArchConfig, device) -> Dict:
    """``embed`` (V, D) and ``lm_head`` (D, V) unless tied; with ``Q > 1``
    codebooks one of each per codebook, stacked: (Q, V, D) and (Q, D, V)."""
    dt, q = pdtype(cfg), cfg.n_codebooks
    v, d = cfg.vocab_size, cfg.d_model

    def stack(make):
        return make() if q == 1 else torch.stack([make() for _ in range(q)])

    p: Dict = {"embed": stack(lambda: embed_init(gen, v, d, dt, device))}
    if not cfg.tie_embeddings:
        p["lm_head"] = stack(lambda: dense_init(gen, d, v, dt, device))
    p["final_norm"] = ones(d, dt, device)
    return p


def embed_tokens(params: Dict, tokens: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    """tokens: (B, T) int, or (B, T, Q) for a multi-codebook model (the
    sum of the codebooks' rows, in the compute dtype, codebook 0 first).
    The rows are gathered, then cast (the same values as the reference's
    cast-then-gather, without casting the whole table)."""
    dt = cdtype(cfg)
    emb, tokens = params["embed"], tokens.long()
    if cfg.n_codebooks > 1:
        x = sum(emb[q][tokens[..., q]].to(dt) for q in range(cfg.n_codebooks))
    else:
        x = emb[tokens].to(dt)
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt)
    return x


def lm_logits(params: Dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """(B, T, D) -> logits (B, T, V), or (B, T, Q, V) with codebooks."""
    dt = cdtype(cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps).to(dt)
    if cfg.n_codebooks > 1:
        return torch.einsum("btd,qdv->btqv", x, params["lm_head"].to(dt))
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ w.to(dt)


# ---------------------------------------------------------------------------
# loss


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -100) -> torch.Tensor:
    """Mean token NLL in fp32.  logits (..., V), labels (...); labels equal
    to ``ignore_index`` count for nothing."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels != ignore_index).float()
    return torch.sum((lse - gold) * mask) / torch.clamp(mask.sum(), min=1.0)
