"""Mamba-2 block (zamba2's backbone layer).

The twin of ``repro.models.mamba2``: ``in_proj -> [z | x | B | C | dt]``, a
short causal depthwise conv over ``(x, B, C)``, the SSD scan with a scalar
decay per head, the D skip, a gated RMS norm and ``out_proj``.  Parameter
names and shapes are the reference's::

    mamba2_block_init(gen, cfg, device)           -> params
    mamba2_block_apply(p, x, cfg)                 -> (x, state)  (prefill/forward)
    mamba2_block_decode(p, x, cfg, cache)         -> x           (one token)
    mamba2_init_cache(cfg, n_layers, batch, dtype, device)

The scan over a sequence goes through K8 (``mamba2_ssd``: the CUDA kernel
on a card, its plain version on the CPU).  The one-token step of decode
(the conv ring and one SSD step) is plain PyTorch, as it is jnp in the
reference (``kref.mamba2_decode_ref``).  Differences from the reference:

* ``mamba2_block_apply`` returns the block's decode state with its output
  (the reference's ``backbone._mamba2_prefill`` is a second copy of the
  block that does);
* decode writes the new state into the given cache **in place**;
* ``shard(...)`` annotations are dropped, and K8 takes no ``chunk``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.mamba2_ssd import mamba2_ssd

from .layers import _normal, cdtype, dense_init, ones, pdtype, rms_norm


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim, s.d_state, s.head_dim, s.conv_kernel


def mamba2_block_init(gen, cfg: ArchConfig, device) -> Dict:
    d = cfg.d_model
    d_inner, h, n, _p, k = _dims(cfg)
    dt = pdtype(cfg)
    conv_dim = d_inner + 2 * n
    return {
        "norm": ones(d, dt, device),
        "w_in": dense_init(gen, d, 2 * d_inner + 2 * n + h, dt, device),
        "conv_w": (_normal(gen, (k, conv_dim), device) / math.sqrt(k)).to(dt),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=device),
        # per-head decay rate
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=device)).to(dt),
        "dt_bias": torch.zeros((h,), dtype=dt, device=device),
        "D": ones(h, dt, device),
        "norm_gate": ones(d_inner, dt, device),
        "w_out": dense_init(gen, d_inner, d, dt, device),
    }


def _split_proj(zxbcdt: torch.Tensor, d_inner: int, n: int):
    return (zxbcdt[..., :d_inner], zxbcdt[..., d_inner:2 * d_inner],
            zxbcdt[..., 2 * d_inner:2 * d_inner + n],
            zxbcdt[..., 2 * d_inner + n:2 * d_inner + 2 * n],
            zxbcdt[..., 2 * d_inner + 2 * n:])


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d of kernel k over xbc (B, T, C), then silu."""
    k, t = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + t] * w[i] for i in range(k))
    return F.silu(out + b)


def _gated_out(p: Dict, x_in: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
               cfg: ArchConfig) -> torch.Tensor:
    y = rms_norm(y, p["norm_gate"], cfg.norm_eps) * F.silu(z)
    return x_in + y @ p["w_out"].to(y.dtype)


def mamba2_block_apply(p: Dict, x_in: torch.Tensor,
                       cfg: ArchConfig) -> Tuple[torch.Tensor, Dict]:
    """x (B, T, D) from a zero state -> (x, the decode state after it:
    ``{"conv": (B, k-1, conv_dim)`` the last ``k-1`` pre-conv rows (zero
    rows before a short prompt), ``"ssd": (B, H, N, P) fp32}``)."""
    dt_ = cdtype(cfg)
    d_inner, h, n, pdim, kk = _dims(cfg)
    b, t, _ = x_in.shape
    x_in = x_in.to(dt_)

    xn = rms_norm(x_in, p["norm"], cfg.norm_eps)
    z, xr, B, C, dt_raw = _split_proj(xn @ p["w_in"].to(dt_), d_inner, n)
    xbc_pre = torch.cat([xr, B, C], dim=-1)
    xbc = _causal_conv(xbc_pre, p["conv_w"].to(dt_), p["conv_b"].to(dt_))
    xr, B, C = (xbc[..., :d_inner], xbc[..., d_inner:d_inner + n],
                xbc[..., d_inner + n:])
    delta = F.softplus(dt_raw.float() + p["dt_bias"].float())     # (B, T, H)
    A = -torch.exp(p["A_log"].float())                             # (H,) < 0
    log_a = (delta * A).transpose(1, 2)                            # (B, H, T)
    xh = xr.reshape(b, t, h, pdim).transpose(1, 2)                 # (B, H, T, P)
    xh = xh * delta.transpose(1, 2)[..., None].to(dt_)             # dt-scaled
    y, ssd = mamba2_ssd(xh, log_a, B.float(), C.float())           # K8
    y = y + p["D"].to(y.dtype)[None, :, None, None] * xh
    y = y.transpose(1, 2).reshape(b, t, d_inner).to(dt_)
    out = _gated_out(p, x_in, y, z, cfg)
    conv = (xbc_pre[:, t - (kk - 1):] if t >= kk - 1
            else F.pad(xbc_pre, (0, 0, kk - 1 - t, 0)))
    return out, {"conv": conv, "ssd": ssd}


def mamba2_init_cache(cfg: ArchConfig, n_layers: int, batch: int, dtype,
                      device) -> Dict:
    """Every layer's decode state, stacked: the conv ring of the last
    ``k-1`` pre-conv rows and the fp32 SSD state."""
    d_inner, h, n, pdim, k = _dims(cfg)
    return {
        "conv": torch.zeros((n_layers, batch, k - 1, d_inner + 2 * n),
                            dtype=dtype, device=device),
        "ssd": torch.zeros((n_layers, batch, h, n, pdim), dtype=torch.float32,
                           device=device),
    }


def ssd_step(x: torch.Tensor, log_a: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, D: torch.Tensor,
             state: torch.Tensor) -> torch.Tensor:
    """One SSD step in fp32: x (B, H, P), log_a (B, H), Bm/Cm (B, N), D
    (H,); ``state`` (B, H, N, P) fp32 is advanced in place -> y (B, H, P)
    fp32, as ``ref.mamba2_decode_ref`` computes::

        H <- exp(a) H + B^T x,   y = C H + D x
    """
    x = x.float()
    state.copy_(torch.exp(log_a)[..., None, None] * state
                + torch.einsum("bn,bhp->bhnp", Bm.float(), x))
    return (torch.einsum("bn,bhnp->bhp", Cm.float(), state)
            + D.float()[None, :, None] * x)


def mamba2_block_decode(p: Dict, x_in: torch.Tensor, cfg: ArchConfig,
                        cache: Dict) -> torch.Tensor:
    """x (B, 1, D), one token against this layer's ``cache`` (views of the
    stacked cache), which is advanced in place."""
    dt_ = cdtype(cfg)
    d_inner, h, n, pdim, _k = _dims(cfg)
    b = x_in.shape[0]
    x_in = x_in.to(dt_)

    xn = rms_norm(x_in, p["norm"], cfg.norm_eps)
    z, xr, B, C, dt_raw = _split_proj(xn @ p["w_in"].to(dt_), d_inner, n)
    window = torch.cat([cache["conv"].to(dt_), torch.cat([xr, B, C], dim=-1)],
                       dim=1)                                      # (B, k, conv)
    out = F.silu((window * p["conv_w"].to(dt_)[None]).sum(dim=1, keepdim=True)
                 + p["conv_b"].to(dt_))
    xr, B, C = (out[..., :d_inner], out[..., d_inner:d_inner + n],
                out[..., d_inner + n:])
    delta = F.softplus(dt_raw.float() + p["dt_bias"].float())[:, 0]  # (B, H)
    log_a = delta * -torch.exp(p["A_log"].float())
    xh = xr.reshape(b, h, pdim) * delta[..., None].to(dt_)
    y = ssd_step(xh, log_a, B[:, 0], C[:, 0], p["D"], cache["ssd"])
    cache["conv"].copy_(window[:, 1:])
    return _gated_out(p, x_in, y.reshape(b, 1, d_inner).to(dt_), z, cfg)
