"""K5: flash attention of the serve path's prefill (and of ``forward``).

Replaces the Pallas ``flash_attention``
(``src/repro/kernels/flash_attention.py``): q ``(B, H, Sq, D)`` attends to
k/v ``(B, G, Sk, D)`` with GQA grouping ``H // G``, query row ``i`` at
position ``i + Sk - Sq``, a causal mask and an optional sliding window;
softmax statistics and the accumulator in fp32, the output in the
inputs' dtype.  The CUDA kernels live in ``csrc/attention.cu``; on a CPU
tensor the wrapper runs the plain version (``ref.flash_attention_ref``),
on a CUDA tensor it launches the kernel of its dtype or raises:

- bfloat16 (the serve path): ``flash_fwd_wgmma``, both products on the
  tensor cores (``wgmma``, fp32 accumulators, P rounded to bf16 before
  ``P V``), K/V tiles streamed by TMA through a ring of shared-memory
  stages.  ``wgmma`` and ``setmaxnreg`` exist only for ``sm_90a``.
- float32: ``flash_fwd``, fp32 FMAs on the CUDA cores (a tensor-core
  route would be TF32, too coarse for the fp32 tolerance of 2e-5).

Unlike the Pallas kernel, padded kv columns are masked (``k_pos < Sk``)
whether or not the call is causal, so non-causal calls equal the oracle.

**Gradients.**  Every call runs through ``FlashAttention``, a
``torch.autograd.Function`` (it records no graph under ``no_grad`` or when
no input requires grad) whose forward is the launch above and whose backward is
:func:`flash_attention_bwd`: on a CPU tensor ``ref.flash_attention_bwd_ref``,
on a CUDA tensor K5's backward (``csrc/attention_bwd.cu``, its own
library), two kernels a call counted as one launch of
``flash_attention_bwd``: dQ with each row's LSE and Delta, then dK and dV
per kv tile over the group's heads.  bf16 runs them on the tensor cores
(``mma.sync``, P and dS in two bf16 pieces), fp32 on the CUDA cores.  The
reference has no backward kernel: its training differentiates whatever
its op entry runs.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build, ref
from .ops import count_launch

#: head dims the CUDA kernels are built for (80: zamba2's shared attention)
HEAD_DIMS = (32, 64, 80, 128, 256)
#: the kernels' dtype codes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_kernel_args(name: str, q: torch.Tensor, *rest: torch.Tensor,
                      window: Optional[int]) -> None:
    """What the CUDA kernels take: one card, one dtype (fp32 or bf16), a
    built head dim, a window of at least 1 when given."""
    if any(t.device != q.device or t.dtype != q.dtype for t in rest):
        raise ValueError(f"{name}: q, k and v must share device and dtype")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {q.shape[-1]} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1, got {window}")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous), copied when its data does not start on 16
    bytes: TMA and 16-byte ``cp.async`` read from such addresses only."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_shapes(name: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q (B,H,Sq,D), k/v (B,G,Sk,D)")
    b, h, _sq, d = q.shape
    g = k.shape[1]
    if k.shape[0] != b or k.shape[3] != d or g < 1 or h % g:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not group")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, H, Sq, D), k/v (B, G, Sk, D) -> (B, H, Sq, D); differentiable
    in q, k and v (see the module docstring)."""
    _check_shapes("flash_attention", q, k, v)
    return FlashAttention.apply(q, k, v, causal, window, scale)


class FlashAttention(torch.autograd.Function):
    """K5 under autograd: the forward launch, saved q/k/v/out, and
    :func:`flash_attention_bwd` for the gradients."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out = _forward(q, k, v, causal, window, scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.args = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, *ctx.args)
        return dq, dk, dv, None, None, None


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
             window: Optional[int], scale: Optional[float]) -> torch.Tensor:
    b, h, sq, d = q.shape
    g, sk = k.shape[1], k.shape[2]
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale)
    check_kernel_args("flash_attention", q, k, v, window=window)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    q, k, v = (aligned16(t.contiguous()) for t in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if sk == 0:
        return out.zero_()
    lib = _build.library("attention")
    guard, stream = _build.launch_args(q)
    with guard:
        rc = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, g,
            sq, sk, d, DTYPE_CODES[q.dtype], int(causal),
            0 if window is None else int(window), float(scale), stream)
    _build.check(lib, rc, "flash_attention")
    count_launch("flash_attention", (b, h, g, sq, sk, d))
    return out


#: head dims K5's backward is built for (four fp32 tiles of 64 rows at
#: D = 256 do not fit in shared memory)
BWD_HEAD_DIMS = (32, 64, 80, 128)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None):
    """K5's backward: ``(dq, dk, dv)`` of :func:`flash_attention` at
    ``dout``, given its output ``out``; each in its input's dtype (fp32
    accumulation).  On a CPU tensor ``ref.flash_attention_bwd_ref``; on a
    CUDA tensor the kernel of ``csrc/attention_bwd.cu`` or a raise."""
    _check_shapes("flash_attention_bwd", q, k, v)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError("flash_attention_bwd: out and dout must be shaped "
                         f"like q {tuple(q.shape)}")
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, out, dout, causal=causal,
                                           window=window, scale=scale)
    check_kernel_args("flash_attention_bwd", q, k, v, out, dout,
                      window=window)
    b, h, sq, d = q.shape
    g, sk = k.shape[1], k.shape[2]
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {d} not in "
                         f"{BWD_HEAD_DIMS}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    q, k, v, out, dout = (t.contiguous() for t in (q, k, v, out, dout))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if sq == 0 or sk == 0 or b * h == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    lib = _build.library("attention_bwd")
    guard, stream = _build.launch_args(q)
    with guard:
        rc = lib.repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), b, h, g, sq, sk, d,
            DTYPE_CODES[q.dtype], int(causal),
            0 if window is None else int(window), float(scale), stream)
    _build.check(lib, rc, "flash_attention_bwd")
    count_launch("flash_attention_bwd", (b, h, g, sq, sk, d))
    return dq, dk, dv
