"""The serve and train kernels (K5, its backward, K6, K7, K8) on the
``meta`` device: the dry-run's stand-ins.

A wrapper given ``meta`` tensors calls the op of its name here instead of
its kernel: a ``torch.library.custom_op`` whose fake implementation only
allocates outputs of the right shapes and dtypes, with a FLOP formula
registered for ``torch.utils.flop_counter.FlopCounterMode``.  The ops
have no real implementation: nothing but a ``meta`` (or fake) tensor
reaches them, and a CUDA tensor still launches its kernel or raises in
its wrapper.  The ops are defined on first use, so importing this module
registers nothing.

The FLOP formulas count multiply-adds as 2 and the work this call's
shapes need: K5's visible (query, key) pairs under its causal mask and
window, K6 every cached position (its lengths are data), the scans'
state updates and read-outs.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

_lock = threading.Lock()
_ops = None


def visible_pairs(sq: int, sk: int, causal: bool,
                  window: Optional[int]) -> int:
    """(query, key) pairs K5 computes: query row ``i`` sits at position
    ``i + sk - sq`` and sees keys ``k <= pos`` (causal) and ``k > pos -
    window``."""
    pos = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(pos + 1, sk) if causal else np.full(sq, sk, np.int64)
    lo = (np.maximum(pos - window + 1, 0) if window is not None
          else np.zeros(sq, np.int64))
    return int(np.clip(hi - lo, 0, None).sum())


def _define():
    from torch.utils.flop_counter import register_flop_formula

    ns = "repro_torch_meta"

    @torch.library.custom_op(f"{ns}::flash_attention", mutates_args=())
    def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, window: int,
                        with_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
        raise RuntimeError("flash_attention: the meta op takes meta tensors")

    @flash_attention.register_fake
    def _(q, k, v, causal, window, with_lse):
        b, h, sq, _d = q.shape
        lse = q.new_empty((b, h, sq) if with_lse else (0,),
                          dtype=torch.float32)
        return q.new_empty((b, h, sq, v.shape[3])), lse

    @torch.library.custom_op(f"{ns}::flash_attention_bwd", mutates_args=())
    def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool, window: int
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
        raise RuntimeError("flash_attention_bwd: the meta op takes meta "
                           "tensors")

    @flash_attention_bwd.register_fake
    def _(q, k, v, causal, window):
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    @torch.library.custom_op(f"{ns}::decode_attention", mutates_args=())
    def decode_attention(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
        raise RuntimeError("decode_attention: the meta op takes meta tensors")

    @decode_attention.register_fake
    def _(q, k, v):
        return torch.empty_like(q)

    @torch.library.custom_op(f"{ns}::rwkv6_scan", mutates_args=())
    def rwkv6_scan(r: torch.Tensor, v: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        raise RuntimeError("rwkv6_scan: the meta op takes meta tensors")

    @rwkv6_scan.register_fake
    def _(r, v):
        b, h, t, dk = r.shape
        return (v.new_empty((b, h, t, v.shape[3])),
                v.new_empty((b, h, dk, v.shape[3]), dtype=torch.float32))

    @torch.library.custom_op(f"{ns}::mamba2_ssd", mutates_args=())
    def mamba2_ssd(x: torch.Tensor, bm: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        raise RuntimeError("mamba2_ssd: the meta op takes meta tensors")

    @mamba2_ssd.register_fake
    def _(x, bm):
        b, h, _t, p = x.shape
        return (torch.empty_like(x),
                x.new_empty((b, h, bm.shape[2], p), dtype=torch.float32))

    def win(w):
        return None if w <= 0 else w

    ops = torch.ops.repro_torch_meta

    @register_flop_formula(ops.flash_attention)
    def _(q_shape, k_shape, v_shape, causal, window, with_lse, *a, **kw):
        b, h, sq, d = q_shape
        pairs = visible_pairs(sq, k_shape[2], causal, win(window))
        return 2 * b * h * pairs * (d + v_shape[3])

    @register_flop_formula(ops.flash_attention_bwd)
    def _(q_shape, k_shape, v_shape, causal, window, *a, **kw):
        b, h, sq, d = q_shape
        pairs = visible_pairs(sq, k_shape[2], causal, win(window))
        # S = q k^T and dq, dk again; dP = dout v^T and dv
        return 2 * b * h * pairs * (3 * d + 2 * v_shape[3])

    @register_flop_formula(ops.decode_attention)
    def _(q_shape, k_shape, v_shape, *a, **kw):
        b, h, d = q_shape
        return 2 * b * h * k_shape[2] * (d + v_shape[3])

    @register_flop_formula(ops.rwkv6_scan)
    def _(r_shape, v_shape, *a, **kw):
        b, h, t, dk = r_shape
        # state decay + k v^T, and r (state + u k v^T)
        return 5 * b * h * t * dk * v_shape[3]

    @register_flop_formula(ops.mamba2_ssd)
    def _(x_shape, bm_shape, *a, **kw):
        b, h, t, p = x_shape
        return 5 * b * h * t * bm_shape[2] * p

    return ops


def ops():
    """The meta ops (``torch.ops.repro_torch_meta``), defined on first
    use."""
    global _ops
    with _lock:
        if _ops is None:
            _ops = _define()
    return _ops
