"""K5: flash attention of the serve path's prefill (and of ``forward``).

Replaces the Pallas ``flash_attention``
(``src/repro/kernels/flash_attention.py``): q ``(B, H, Sq, D)`` attends to
k ``(B, G, Sk, D)`` and v ``(B, G, Sk, Dv)`` with GQA grouping ``H // G``
into an output ``(B, H, Sq, Dv)``, query row ``i`` at
position ``i + Sk - Sq``, a causal mask and an optional sliding window;
softmax statistics and the accumulator in fp32, the output in the
inputs' dtype.  The CUDA kernels live in ``csrc/attention.cu``; on a CPU
tensor the wrapper runs the plain version (``ref.flash_attention_ref``),
on a ``meta`` tensor the dry-run's stand-in (``meta.py``: shapes and a
FLOP formula, at any head dims: the smoke configs' too), on a CUDA tensor
it launches the kernel of its dtype or raises:

- bfloat16 (the serve path): ``flash_fwd_wgmma``, both products on the
  tensor cores (``wgmma``, fp32 accumulators, P rounded to bf16 before
  ``P V``), K/V tiles streamed by TMA through a ring of shared-memory
  stages.  ``wgmma`` and ``setmaxnreg`` exist only for ``sm_90a``.
- float32: ``flash_fwd``, fp32 FMAs on the CUDA cores (a tensor-core
  route would be TF32, too coarse for the fp32 tolerance of 2e-5).

Both kernels take ``Dv = D`` at every head dim of ``HEAD_DIMS`` and the
narrow-v pairs of ``NARROW_V``: MLA's prefill (minicpm3-4b) runs q/k at
``d_nope + d_rope = 96`` and v at ``d_v = 64``.  There the bf16 kernel
reads q/k in a 64-wide block with the 128-byte swizzle and a 32-wide one
with the 64-byte swizzle, v in one 64-wide block, and its ``P V``
product and output are 64 wide.  Any other pair raises ``ValueError``
on the card (the plain version takes any).

Unlike the Pallas kernel, padded kv columns are masked (``k_pos < Sk``)
whether or not the call is causal, so non-causal calls equal the oracle.

**Gradients.**  Every call runs through ``FlashAttention``, a
``torch.autograd.Function`` (it records no graph under ``no_grad`` or when
no input requires grad) whose forward is the launch above and whose backward is
:func:`flash_attention_bwd`: on a CPU tensor ``ref.flash_attention_bwd_ref``,
on a CUDA tensor K5's backward (``csrc/attention_bwd.cu``, its own
library), two kernels a call counted as one launch of
``flash_attention_bwd``: dQ with each row's Delta, then dK and dV per kv
tile over the group's heads.  bf16 runs them on the tensor cores
(``wgmma`` fed by TMA, P and dS in two bf16 pieces; at head dim 256 the
dK/dV kernel splits the head dim over two warpgroups and an even group's
heads over two blocks, whose fp32 sums a third kernel adds), fp32 on the
CUDA cores (tiles of 32 rows at head dim 256).  Both take the forward's
pairs: every head dim of ``HEAD_DIMS`` with ``Dv = D`` and the narrow-v
pairs of ``NARROW_V`` (MLA's training: dQ and dK 96 wide, dV, dO, O and
Delta's rowsum 64).  When a graph will be recorded (grad mode on and an input that
requires grad) the forward launch also writes each query row's
log-sum-exp, LSE: ``(B, H, Sq)`` fp32, the natural log of the sum of
``exp(scale * q k^T)`` over the row's visible keys, ``-inf`` for a row that
sees none (``ref.flash_attention_lse_ref`` on the CPU).  It is saved with
q, k, v and the output, and the backward forms ``P = exp(scale * q k^T -
LSE)`` from it.  The serve path's calls (no graph) write no LSE.  The
reference has no backward kernel: its training differentiates whatever
its op entry runs.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build, meta, ref
from .ops import count_launch

#: head dims the CUDA kernels are built for (80: zamba2's shared attention)
HEAD_DIMS = (32, 64, 80, 128, 256)
#: (q/k, v) head dims of the forward kernels' narrow-v form (MLA prefill)
NARROW_V = ((96, 64),)
#: the kernels' dtype codes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_kernel_args(name: str, q: torch.Tensor, *rest: torch.Tensor,
                      window: Optional[int], dv: Optional[int] = None) -> None:
    """What the CUDA kernels take: one card, one dtype (fp32 or bf16), a
    built head dim (``dv``, v's head dim when it differs from q's: a pair
    of ``NARROW_V``), a window of at least 1 when given."""
    if any(t.device != q.device or t.dtype != q.dtype for t in rest):
        raise ValueError(f"{name}: q, k and v must share device and dtype")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    d = q.shape[-1]
    if dv is not None and dv != d:
        if (d, dv) not in NARROW_V:
            raise ValueError(f"{name}: head dim {d} with v {dv} is not a "
                             f"built pair {NARROW_V}")
    elif d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1, got {window}")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous), copied when its data does not start on 16
    bytes: TMA and 16-byte ``cp.async`` read from such addresses only."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_shapes(name: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> None:
    if (q.dim() != 4 or k.dim() != 4 or v.dim() != 4
            or k.shape[:3] != v.shape[:3]):
        raise ValueError(f"{name}: q (B,H,Sq,D), k (B,G,Sk,D), v (B,G,Sk,Dv)")
    b, h, _sq, d = q.shape
    g = k.shape[1]
    if k.shape[0] != b or k.shape[3] != d or g < 1 or h % g:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not group")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, H, Sq, D), k (B, G, Sk, D), v (B, G, Sk, Dv) -> (B, H, Sq, Dv);
    differentiable in q, k and v (see the module docstring)."""
    _check_shapes("flash_attention", q, k, v)
    # decided here: inside ``forward`` grad mode is off
    graph = torch.is_grad_enabled() and any(t.requires_grad
                                            for t in (q, k, v))
    return FlashAttention.apply(q, k, v, causal, window, scale, graph)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None):
    """K5's forward with its rows' log-sum-exp and no graph: ``(out,
    lse)``, ``lse`` ``(B, H, Sq)`` fp32 in natural log, ``-inf`` for a row
    that sees no key (what :func:`flash_attention_bwd` takes)."""
    _check_shapes("flash_attention", q, k, v)
    return _forward(q, k, v, causal, window, scale, with_lse=True)


class FlashAttention(torch.autograd.Function):
    """K5 under autograd: the forward launch, saved q/k/v/out and the rows'
    LSE when a graph is recorded, and :func:`flash_attention_bwd` for the
    gradients."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, graph):
        out, lse = _forward(q, k, v, causal, window, scale, with_lse=graph)
        if graph:
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.args = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
             window: Optional[int], scale: Optional[float], with_lse: bool):
    """-> (out, the rows' LSE or None)."""
    b, h, sq, d = q.shape
    g, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    if q.device.type == "cpu":
        if with_lse:
            return ref.flash_attention_with_lse_ref(
                q, k, v, causal=causal, window=window, scale=scale)
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale), None
    if q.device.type == "meta":  # the dry-run: shapes and FLOPs, any dims
        out, lse = meta.ops().flash_attention(q, k, v, causal, window or 0,
                                              with_lse)
        return out, lse if with_lse else None
    check_kernel_args("flash_attention", q, k, v, window=window, dv=dv)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    q, k, v = (aligned16(t.contiguous()) for t in (q, k, v))
    out = q.new_empty((b, h, sq, dv))
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    if sk == 0:
        return out.zero_(), None if lse is None else lse.fill_(float("-inf"))
    lib = _build.library("attention")
    guard, stream = _build.launch_args(q)
    with guard:
        rc = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, h, g, sq, sk, d, dv,
            DTYPE_CODES[q.dtype], int(causal),
            0 if window is None else int(window), float(scale), stream)
    _build.check(lib, rc, "flash_attention")
    count_launch("flash_attention", (b, h, g, sq, sk, d, dv))
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None):
    """K5's backward: ``(dq, dk, dv)`` of :func:`flash_attention` at
    ``dout``, given its output ``out`` and rows' log-sum-exp ``lse``
    (``(B, H, Sq)`` fp32, natural log, as :func:`flash_attention_lse`
    returns it); each in its input's dtype (fp32 accumulation).  On a CPU
    tensor ``ref.flash_attention_bwd_ref``; on a CUDA tensor the kernel of
    ``csrc/attention_bwd.cu`` (the forward's head-dim pairs) or a raise."""
    _check_shapes("flash_attention_bwd", q, k, v)
    o_shape = q.shape[:3] + v.shape[3:]
    if out.shape != o_shape or dout.shape != o_shape:
        raise ValueError("flash_attention_bwd: out and dout must be shaped "
                         f"(B, H, Sq, Dv) = {tuple(o_shape)}")
    if (lse is None or lse.shape != q.shape[:3]
            or lse.dtype != torch.float32 or lse.device != q.device):
        raise ValueError("flash_attention_bwd: lse must be the forward's "
                         f"(B, H, Sq) = {tuple(q.shape[:3])} float32 rows on "
                         f"{q.device}")
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                           causal=causal, window=window,
                                           scale=scale)
    if q.device.type == "meta":
        return meta.ops().flash_attention_bwd(q, k, v, causal, window or 0)
    check_kernel_args("flash_attention_bwd", q, k, v, out, dout,
                      window=window, dv=v.shape[3])
    b, h, sq, d = q.shape
    g, sk, dv_dim = k.shape[1], k.shape[2], v.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    q, k, v, out, dout = (aligned16(t.contiguous())
                          for t in (q, k, v, out, dout))
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if sq == 0 or sk == 0 or b * h == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty_like(lse)  # rowsum(dout * out), written by launch A
    # bf16 at D = 256: the fp32 sums of the two halves of a group's heads,
    # which the dK/dV launch adds up (it splits an even group's heads)
    part = (torch.empty(4 * k.numel(), dtype=torch.float32, device=q.device)
            if d == 256 and q.dtype == torch.bfloat16 else None)
    lib = _build.library("attention_bwd")
    guard, stream = _build.launch_args(q)
    with guard:
        rc = lib.repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(),
            None if part is None else part.data_ptr(), b, h, g, sq, sk, d,
            dv_dim, DTYPE_CODES[q.dtype], int(causal),
            0 if window is None else int(window), float(scale), stream)
    _build.check(lib, rc, "flash_attention_bwd")
    count_launch("flash_attention_bwd", (b, h, g, sq, sk, d))
    return dq, dk, dv
