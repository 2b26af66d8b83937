"""The serve and train kernels (K5, K6, K7, K8 and the backwards of K5, K7
and K8) on the ``meta`` device: the dry-run's stand-ins.

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
state updates and read-outs; the scans' backwards also count the forward
state update they recompute.

The scans' backward kernels take a workspace for the launch (the stored
states and the partial sums): :func:`scan_bwd_workspace_bytes` is
its size as the dry-run counts it, the same formula as the C library's
``repro_rwkv6_scan_bwd_ws`` / ``repro_mamba2_ssd_bwd_ws`` (held equal on
the card), and the meta ops record the largest they were asked for
(:func:`workspace_peak`).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

_lock = threading.Lock()
_ops = None
#: the largest backward workspace the meta ops stood in for, in bytes
_workspace = [0]

#: the fp32 route's backward (``BwRoute<float>`` of ``csrc/ssm.cu``): the
#: state columns a block takes, the bytes of a stored state value, and the
#: steps between the states it stores (``BW_CHUNK``)
_SIMT_COLS, _SIMT_STATE_BYTES, _SIMT_CHUNK = 32, 8, 16
#: the bf16 route's: K7's sub-chunk and K8's chunk (the states stored),
#: the state columns a block takes (both), and the heads a K8 block sums
#: dB and dC over (``WT``, ``SQ``, ``WV`` = ``SP``, ``kBwHeads``)
_WKV_SUB, _SSD_CHUNK, _BF16_COLS, _SSD_HEADS = 16, 64, 64, 8


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def scan_bwd_workspace_bytes(kind: str, dtype, b: int, h: int, t: int,
                             rows: int, cols: int) -> int:
    """Bytes of the workspace of one K7 (``kind`` "wkv": rows Dk, cols Dv)
    or K8 ("ssd": rows N, cols P) backward launch on ``b`` x ``h``
    sequences of ``t`` steps, as ``repro_rwkv6_scan_bwd_ws`` /
    ``repro_mamba2_ssd_bwd_ws`` size it (in floats, padded to an even
    count).

    bf16 (the chunked kernels): K7 stores the state at the start of every
    16-step sub-chunk, and with more than one 64-column tile each tile's
    partial dr, dk, dw and v . dO of every step, then du of every
    (sequence, tile); K8 stores H_start and dH_end of every 64-step chunk,
    then dB and dC of every (group of 8 heads, P tile) and dlog_a of every
    P tile.  fp32 (the simt reverse scans): one
    state slice (fp64) per (sequence, 32-column tile, 16 steps), then the
    fp64 partial sums (K7: dr, dk, dw and v . dO of each tile and step, du
    of each sequence and tile; K8: dB, dC and the sum of G o H)."""
    bh = b * h
    if dtype == torch.bfloat16:
        tiles = _cdiv(cols, _BF16_COLS)
        if kind == "wkv":
            floats = (bh * _cdiv(t, _WKV_SUB) * rows * cols
                      + (tiles * bh * t * (3 * rows + 1) if tiles > 1 else 0)
                      + bh * tiles * rows)
        else:
            nch = _cdiv(t, _SSD_CHUNK)
            floats = (2 * bh * nch * rows * cols
                      + 2 * _cdiv(h, _SSD_HEADS) * tiles * b * t * rows
                      + tiles * bh * t)
        return 4 * (floats + floats % 2)
    tiles = _cdiv(cols, _SIMT_COLS)
    states = (bh * tiles * _cdiv(t, _SIMT_CHUNK) * _SIMT_COLS * rows
              * _SIMT_STATE_BYTES // 4)
    states += states % 2
    if kind == "wkv":
        part = tiles * bh * t * (3 * rows + 1) + bh * tiles * rows
    else:
        part = tiles * bh * t * (2 * rows + 1)
    return 4 * (states + 2 * part)


def workspace_peak(reset: bool = False) -> int:
    """The largest backward workspace (bytes) the meta ops stood in for
    since the last reset; ``reset`` starts again from 0."""
    peak = _workspace[0]
    if reset:
        _workspace[0] = 0
    return peak


def _note_workspace(nbytes: int) -> None:
    _workspace[0] = max(_workspace[0], nbytes)


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

    @torch.library.custom_op(f"{ns}::rwkv6_scan_bwd", mutates_args=())
    def rwkv6_scan_bwd(r: torch.Tensor, v: torch.Tensor, u: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor, torch.Tensor]:
        raise RuntimeError("rwkv6_scan_bwd: the meta op takes meta tensors")

    @rwkv6_scan_bwd.register_fake
    def _(r, v, u):
        b, h, t, dk = r.shape
        _note_workspace(scan_bwd_workspace_bytes("wkv", r.dtype, b, h, t, dk,
                                                 v.shape[3]))
        # dr, dk, dv, dw, du
        return (torch.empty_like(r), torch.empty_like(r), torch.empty_like(v),
                torch.empty_like(r), torch.empty_like(u))

    @torch.library.custom_op(f"{ns}::mamba2_ssd_bwd", mutates_args=())
    def mamba2_ssd_bwd(x: torch.Tensor, log_a: torch.Tensor, bm: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
        raise RuntimeError("mamba2_ssd_bwd: the meta op takes meta tensors")

    @mamba2_ssd_bwd.register_fake
    def _(x, log_a, bm):
        b, h, t, p = x.shape
        _note_workspace(scan_bwd_workspace_bytes("ssd", x.dtype, b, h, t,
                                                 bm.shape[2], p))
        # dx, dlog_a, dBm, dCm
        return (torch.empty_like(x), torch.empty_like(log_a),
                torch.empty_like(bm), torch.empty_like(bm))

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

    @register_flop_formula(ops.rwkv6_scan_bwd)
    def _(r_shape, v_shape, u_shape, *a, **kw):
        b, h, t, dk = r_shape
        # the recomputed S = w S + k v^T (3); dr, dk, dw, dv's k^T G and
        # the G update's r^T do (2 each); the decay of G (1); dv's u term (2)
        return 16 * b * h * t * dk * v_shape[3]

    @register_flop_formula(ops.mamba2_ssd_bwd)
    def _(x_shape, log_a_shape, bm_shape, *a, **kw):
        b, h, t, p = x_shape
        # the recomputed H = a H + B^T x (3); G's C^T dy, dx, dB, dC and
        # dlog_a's sum (2 each); the decay of G (1)
        return 14 * b * h * t * bm_shape[2] * p

    return ops


def ops():
    """The meta ops (``torch.ops.repro_torch_meta``), defined on first
    use."""
    global _ops
    with _lock:
        if _ops is None:
            _ops = _define()
    return _ops
