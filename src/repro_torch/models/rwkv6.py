"""RWKV-6 (Finch) block: data-dependent-decay time mix + channel mix.

The twin of ``repro.models.rwkv6`` (arXiv:2404.05892): token shift with a
data-dependent low-rank interpolation ("ddlerp"), a low-rank
data-dependent decay ``w``, the wkv recurrence, a per-head group norm
``ln_x``, the output gate, and the squared-ReLU channel mix.  Parameter
names and shapes are the reference's, so weights carry across as they
are (``repro_torch.models.weights``)::

    rwkv6_block_init(gen, cfg, device)            -> params
    rwkv6_block_apply(p, x, cfg)                  -> (x, state)  (prefill/forward)
    rwkv6_block_decode(p, x, cfg, cache)          -> x           (one token)
    rwkv6_init_cache(cfg, n_layers, batch, dtype, device)

The wkv recurrence over a sequence goes through K7 (``rwkv6_scan``: the
CUDA kernel on a card, its plain version on the CPU).  The one-token step
of decode is plain PyTorch here, as it is jnp in the reference
(``kref.rwkv6_decode_ref``).  Differences from the reference:

* ``rwkv6_block_apply`` returns the block's decode state with its output
  (the reference has a second copy of the block, ``_rwkv6_prefill``, that
  returns it; its ``rwkv6_block_apply`` drops it);
* decode writes the new state into the given cache **in place**;
* the reference's ``shard(...)`` annotations are no-ops on one card and
  are dropped, and K7 takes no ``chunk``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.rwkv6_scan import rwkv6_scan

from .layers import _normal, cdtype, dense_init, ones, pdtype, rms_norm

DDLERP_RANK = 32
DECAY_RANK = 64


def _heads(cfg: ArchConfig) -> Tuple[int, int]:
    hd = cfg.ssm.head_dim
    return cfg.d_model // hd, hd


def rwkv6_block_init(gen, cfg: ArchConfig, device) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    h, hd = _heads(cfg)
    dt = pdtype(cfg)
    return {
        # time mix
        "mu_x": torch.full((5, d), 0.5, dtype=dt, device=device),  # w,k,v,r,g
        "ddlerp_a": dense_init(gen, d, 5 * DDLERP_RANK, dt, device),
        "ddlerp_b": dense_init(gen, 5 * DDLERP_RANK, 5 * d, dt, device,
                               scale=0.01),
        "w_decay_a": dense_init(gen, d, DECAY_RANK, dt, device),
        "w_decay_b": dense_init(gen, DECAY_RANK, d, dt, device, scale=0.01),
        "decay_base": torch.full((d,), -5.0, dtype=dt, device=device),
        "wr": dense_init(gen, d, d, dt, device),
        "wk": dense_init(gen, d, d, dt, device),
        "wv": dense_init(gen, d, d, dt, device),
        "wg": dense_init(gen, d, d, dt, device),
        "wo": dense_init(gen, d, d, dt, device),
        "u": (_normal(gen, (h, hd), device) * 0.3).to(dt),
        "ln_x": ones(d, dt, device),
        # channel mix
        "mu_ffn": torch.full((2, d), 0.5, dtype=dt, device=device),
        "wk_ffn": dense_init(gen, d, f, dt, device),
        "wv_ffn": dense_init(gen, f, d, dt, device),
        "wr_ffn": dense_init(gen, d, d, dt, device),
        # norms
        "norm1": ones(d, dt, device),
        "norm2": ones(d, dt, device),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x (B, T, D), prev (B, D) the token before x's first -> shifted x."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _time_mix(p: Dict, x: torch.Tensor, xs: torch.Tensor, cfg: ArchConfig):
    """r, k, v, w (B, H, T, hd) and the gate g (B, T, D) from x and its
    shifted version xs; w = exp(-exp(decay)) in (0, 1], in x's dtype."""
    dt = x.dtype
    b, t, d = x.shape
    h, hd = _heads(cfg)
    delta = xs - x
    base = x + delta * p["mu_x"].to(dt)[:, None, None]           # (5, B, T, D)
    lora = torch.tanh(delta @ p["ddlerp_a"].to(dt))
    mix = (lora @ p["ddlerp_b"].to(dt)).reshape(b, t, 5, d).permute(2, 0, 1, 3)
    xw, xk, xv, xr, xg = (base[i] + mix[i] for i in range(5))

    r = xr @ p["wr"].to(dt)
    k = xk @ p["wk"].to(dt)
    v = xv @ p["wv"].to(dt)
    g = F.silu(xg @ p["wg"].to(dt))
    decay = p["decay_base"].float() + (
        torch.tanh(xw @ p["w_decay_a"].to(dt)) @ p["w_decay_b"].to(dt)).float()
    w = torch.exp(-torch.exp(decay))

    def heads(z):
        return z.reshape(b, t, h, hd).transpose(1, 2)             # (B, H, T, hd)

    return heads(r), heads(k), heads(v), heads(w.to(dt)), g


def _time_out(p: Dict, x: torch.Tensor, o: torch.Tensor, g: torch.Tensor,
              cfg: ArchConfig) -> torch.Tensor:
    """x + the gated, group-normed wkv output o (B, T, D) through ``wo``."""
    o = rms_norm(o, p["ln_x"], cfg.norm_eps) * g
    return x + o @ p["wo"].to(o.dtype)


def _channel_mix(p: Dict, xn: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    dt = xn.dtype
    mu = p["mu_ffn"].to(dt)
    xk = xn + (xs - xn) * mu[0]
    xr = xn + (xs - xn) * mu[1]
    kf = torch.square(F.relu(xk @ p["wk_ffn"].to(dt)))
    vf = kf @ p["wv_ffn"].to(dt)
    return torch.sigmoid(xr @ p["wr_ffn"].to(dt)) * vf


def rwkv6_block_apply(p: Dict, x: torch.Tensor,
                      cfg: ArchConfig) -> Tuple[torch.Tensor, Dict]:
    """x (B, T, D) from a zero state -> (x, the decode state after it:
    ``{"wkv": (B, H, hd, hd) fp32, "shift_tm", "shift_cm": (B, D)}``)."""
    dt = cdtype(cfg)
    b, t, d = x.shape
    x = x.to(dt)
    zeros = torch.zeros((b, d), dtype=dt, device=x.device)

    xn = rms_norm(x, p["norm1"], cfg.norm_eps)
    r, k, v, w, g = _time_mix(p, xn, _token_shift(xn, zeros), cfg)
    o, wkv = rwkv6_scan(r, k, v, w, p["u"].to(dt))                # K7
    x = _time_out(p, x, o.transpose(1, 2).reshape(b, t, d).to(dt), g, cfg)

    xn2 = rms_norm(x, p["norm2"], cfg.norm_eps)
    x = x + _channel_mix(p, xn2, _token_shift(xn2, zeros))
    return x, {"wkv": wkv, "shift_tm": xn[:, -1], "shift_cm": xn2[:, -1]}


def rwkv6_init_cache(cfg: ArchConfig, n_layers: int, batch: int, dtype,
                     device) -> Dict:
    """Every layer's decode state, stacked: the fp32 wkv state and the two
    token-shift rows."""
    h, hd = _heads(cfg)
    d = cfg.d_model
    return {
        "wkv": torch.zeros((n_layers, batch, h, hd, hd), dtype=torch.float32,
                           device=device),
        "shift_tm": torch.zeros((n_layers, batch, d), dtype=dtype,
                                device=device),
        "shift_cm": torch.zeros((n_layers, batch, d), dtype=dtype,
                                device=device),
    }


def wkv_step(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             state: torch.Tensor) -> torch.Tensor:
    """One wkv step in fp32: r/k/w (B, H, Dk), v (B, H, Dv), u (H, Dk);
    ``state`` (B, H, Dk, Dv) fp32 is advanced in place -> o (B, H, Dv)
    fp32, as ``ref.rwkv6_decode_ref`` computes::

        o = r (S + diag(u) k^T v),   S <- diag(w) S + k^T v
    """
    r, k, v, w, u = (z.float() for z in (r, k, v, w, u))
    kv = k[..., :, None] * v[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", r, state + u[None, :, :, None] * kv)
    state.copy_(w[..., :, None] * state + kv)
    return o


def rwkv6_block_decode(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                       cache: Dict) -> torch.Tensor:
    """x (B, 1, D), one token against this layer's ``cache`` (views of the
    stacked cache), which is advanced in place."""
    dt = cdtype(cfg)
    b, _, d = x.shape
    x = x.to(dt)

    xn = rms_norm(x, p["norm1"], cfg.norm_eps)
    r, k, v, w, g = _time_mix(p, xn, cache["shift_tm"][:, None].to(dt), cfg)
    o = wkv_step(*(z[:, :, 0] for z in (r, k, v, w)), p["u"].to(dt),
                 cache["wkv"]).to(dt)                              # (B, H, hd)
    x = _time_out(p, x, o.reshape(b, 1, d), g, cfg)
    cache["shift_tm"].copy_(xn[:, 0])

    xn2 = rms_norm(x, p["norm2"], cfg.norm_eps)
    x = x + _channel_mix(p, xn2, cache["shift_cm"][:, None].to(dt))
    cache["shift_cm"].copy_(xn2[:, 0])
    return x
