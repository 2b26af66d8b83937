"""K8: the Mamba-2 SSD scan of the hybrid family's prefill (and ``forward``).

Replaces the Pallas ``mamba2_ssd`` (``src/repro/kernels/mamba2_ssd.py``):
per (batch, head), with an ``(N, P)`` state ``H`` starting at 0 and a
scalar decay per step::

    H_t = exp(a_t) H_{t-1} + B_t^T x_t
    y_t = C_t H_t                      (the D skip is the caller's)

x ``(B, H, T, P)`` fp32 or bf16, log_a ``(B, H, T)``, Bm/Cm ``(B, T, N)``
shared across heads, all three fp32 -> y ``(B, H, T, P)`` in x's dtype and
the final state ``(B, H, N, P)`` in fp32.  The CUDA kernel
(``csrc/ssm.cu``) takes its route by x's dtype, one kernel each:

* bf16 x (the serve dtype): the chunked form on the tensor cores, chunks
  of 64 steps, ``mma.sync`` bf16 with each fp32 operand (B, C, the state
  and the decays' products) split into two bf16 pieces, so outputs stay
  within 1e-2 and the final state within 1e-4 of the fp32 recurrence.
  A block serves several heads of a sequence and shares their B, C and
  C B^T.
* fp32 x: the state in registers, T walked step by step on the CUDA
  cores (outputs within 1e-4: no room for TF32 rounding).

Both take any T (the Pallas kernel asserts ``T % chunk == 0``) and give
finite results where a decay is exactly 0 (``log_a = -inf``; log_a <= 0,
as the model gives).  N is one of ``STATE_DIMS``, P at most
``MAX_COLS``.  On a CPU tensor the wrapper runs the plain version
(``ref.mamba2_ref``), on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build, ref
from .flash_attention import DTYPE_CODES
from .ops import count_launch, refuse_grad
from .rwkv6_scan import MAX_COLS, STATE_DIMS


def mamba2_ssd(x: torch.Tensor, log_a: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor):
    """-> (y (B, H, T, P) without the D skip, final state (B, H, N, P)
    fp32)."""
    if x.dim() != 4:
        raise ValueError("mamba2_ssd: x must be (B, H, T, P)")
    b, h, t, p = x.shape
    if tuple(log_a.shape) != (b, h, t):
        raise ValueError(f"mamba2_ssd: log_a must be ({b}, {h}, {t})")
    if Bm.dim() != 3 or tuple(Bm.shape[:2]) != (b, t) or Cm.shape != Bm.shape:
        raise ValueError(f"mamba2_ssd: Bm and Cm must be ({b}, {t}, N)")
    if x.device.type == "cpu":
        return ref.mamba2_ref(x, log_a, Bm, Cm)
    refuse_grad("mamba2_ssd", x, log_a, Bm, Cm)
    n = Bm.shape[2]
    if any(a.device != x.device for a in (log_a, Bm, Cm)):
        raise ValueError("mamba2_ssd: x, log_a, Bm and Cm must share a device")
    if x.dtype not in DTYPE_CODES or any(
            a.dtype != torch.float32 for a in (log_a, Bm, Cm)):
        raise TypeError("mamba2_ssd: the kernel takes x in float32 or "
                        "bfloat16 and log_a, Bm, Cm in float32")
    if n not in STATE_DIMS or not 1 <= p <= MAX_COLS:
        raise ValueError(f"mamba2_ssd: N {n} not in {STATE_DIMS} or P {p} "
                         f"not in [1, {MAX_COLS}]")
    if x.device.type != "cuda":
        raise ValueError(f"mamba2_ssd: unsupported device {x.device}")
    x, log_a, Bm, Cm = (a.contiguous() for a in (x, log_a, Bm, Cm))
    # the chunked kernel stages B and C rows with 16-byte copies
    Bm, Cm = (a if a.data_ptr() % 16 == 0 else a.clone() for a in (Bm, Cm))
    y = torch.empty_like(x)
    state = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    if b * h == 0:
        return y, state
    lib = _build.library("ssm")
    guard, stream = _build.launch_args(x)
    with guard:
        rc = lib.repro_mamba2_ssd(
            x.data_ptr(), log_a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), state.data_ptr(), b, h, t, n, p,
            DTYPE_CODES[x.dtype], stream)
    _build.check(lib, rc, "mamba2_ssd")
    count_launch("mamba2_ssd", (b, h, t, p, n))
    return y, state
