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
(``ref.mamba2_ref``), on a ``meta`` tensor the dry-run's stand-in
(``meta.py``), on a CUDA tensor it launches the kernel or raises.

**Gradients.**  Every call runs through ``Mamba2SSD``, a
``torch.autograd.Function`` that saves only the inputs: its backward,
:func:`mamba2_ssd_bwd`, recomputes the states.  On a CUDA tensor that is
K8's backward (``csrc/ssm.cu``; one launch counted as ``mamba2_ssd_bwd``
however many kernels it runs), by x's dtype:

* bf16 (the train path): the chunked form on the tensor cores.  A first
  kernel walks the 64-step chunks forward for the state and backward for
  its cotangent (in ``mma`` accumulators, as the forward carries the
  state) and stores both at every chunk boundary; a block per (chunk, 8
  heads) then takes dx, dB, dC and dlog_a of its chunk from them with
  ``mma.sync`` products (C B^T once for the heads; every fp32 operand in
  two bf16 pieces; dlog_a in its direct form, nothing divided); a last
  kernel sums dB and dC over the head groups and dlog_a over the column
  tiles in a fixed order.  Within 1e-2 (1 + |g|) of the fp32 plain
  version.
* fp32: one block per (b, h) and 32 state columns, a thread a state row,
  the state in fp64 stored every 16th step and each step's ``H_{t-1}``
  recomputed from it; fp64 sums; a second kernel sums dB and dC over the
  heads and dlog_a over the tiles in a fixed order.  Within 2e-5.

On the CPU it is ``ref.mamba2_bwd_ref``, on
``meta`` the dry-run's op.
"""

from __future__ import annotations

import torch

from . import _build, meta, ref
from .flash_attention import DTYPE_CODES
from .ops import count_launch
from .rwkv6_scan import MAX_COLS, STATE_DIMS


def _check_shapes(x, log_a, Bm, Cm) -> None:
    if x.dim() != 4:
        raise ValueError("mamba2_ssd: x must be (B, H, T, P)")
    b, h, t, p = x.shape
    if tuple(log_a.shape) != (b, h, t):
        raise ValueError(f"mamba2_ssd: log_a must be ({b}, {h}, {t})")
    if Bm.dim() != 3 or tuple(Bm.shape[:2]) != (b, t) or Cm.shape != Bm.shape:
        raise ValueError(f"mamba2_ssd: Bm and Cm must be ({b}, {t}, N)")


def _check_kernel_args(name: str, x, log_a, Bm, Cm) -> None:
    """What the CUDA kernels take: one device, x in fp32 or bf16 and the
    rest in fp32, a built state width."""
    n, p = Bm.shape[2], x.shape[3]
    if any(a.device != x.device for a in (log_a, Bm, Cm)):
        raise ValueError(f"{name}: x, log_a, Bm and Cm must share a device")
    if x.dtype not in DTYPE_CODES or any(
            a.dtype != torch.float32 for a in (log_a, Bm, Cm)):
        raise TypeError(f"{name}: the kernel takes x in float32 or "
                        "bfloat16 and log_a, Bm, Cm in float32")
    if n not in STATE_DIMS or not 1 <= p <= MAX_COLS:
        raise ValueError(f"{name}: N {n} not in {STATE_DIMS} or P {p} "
                         f"not in [1, {MAX_COLS}]")


def mamba2_ssd(x: torch.Tensor, log_a: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor):
    """-> (y (B, H, T, P) without the D skip, final state (B, H, N, P)
    fp32); differentiable in x, log_a, Bm and Cm (see the module
    docstring)."""
    _check_shapes(x, log_a, Bm, Cm)
    return Mamba2SSD.apply(x, log_a, Bm, Cm)


class Mamba2SSD(torch.autograd.Function):
    """K8 under autograd: the forward launch, the inputs saved, and
    :func:`mamba2_ssd_bwd` for the gradients."""

    @staticmethod
    def forward(ctx, x, log_a, Bm, Cm):
        ctx.save_for_backward(x, log_a, Bm, Cm)
        ctx.set_materialize_grads(False)
        return _forward(x, log_a, Bm, Cm)

    @staticmethod
    def backward(ctx, dy, dstate):
        return mamba2_ssd_bwd(*ctx.saved_tensors, dy, dstate)


def _forward(x, log_a, Bm, Cm):
    b, h, t, p = x.shape
    if x.device.type == "cpu":
        return ref.mamba2_ref(x, log_a, Bm, Cm)
    _check_kernel_args("mamba2_ssd", x, log_a, Bm, Cm)
    if x.device.type == "meta":  # the dry-run: shapes and FLOPs
        return meta.ops().mamba2_ssd(x, Bm)
    if x.device.type != "cuda":
        raise ValueError(f"mamba2_ssd: unsupported device {x.device}")
    n = Bm.shape[2]
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


def mamba2_ssd_bwd(x: torch.Tensor, log_a: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, dy, dstate=None):
    """K8's backward: ``(dx, dlog_a, dBm, dCm)`` of :func:`mamba2_ssd` at
    the cotangents ``dy`` (B, H, T, P) of the output and ``dstate`` (B, H,
    N, P) of the final state (None: zero), each in its input's dtype (fp32
    sums).  On a CPU tensor ``ref.mamba2_bwd_ref``; on a CUDA tensor the
    kernel of ``csrc/ssm.cu`` or a raise."""
    _check_shapes(x, log_a, Bm, Cm)
    b, h, t, p = x.shape
    n = Bm.shape[2]
    for name, a, shape in (("dy", dy, x.shape),
                           ("dstate", dstate, (b, h, n, p))):
        if a is not None and tuple(a.shape) != tuple(shape):
            raise ValueError(f"mamba2_ssd_bwd: {name} must be "
                             f"{tuple(shape)}, got {tuple(a.shape)}")
    if x.device.type == "cpu":
        return ref.mamba2_bwd_ref(x, log_a, Bm, Cm, dy, dstate)
    _check_kernel_args("mamba2_ssd_bwd", x, log_a, Bm, Cm)
    if x.device.type == "meta":
        return meta.ops().mamba2_ssd_bwd(x, log_a, Bm)
    if x.device.type != "cuda":
        raise ValueError(f"mamba2_ssd_bwd: unsupported device {x.device}")
    x, log_a, Bm, Cm = (a.contiguous() for a in (x, log_a, Bm, Cm))
    dy = (torch.zeros_like(x) if dy is None
          else dy.to(x.dtype).contiguous())
    if dstate is not None:
        dstate = dstate.to(device=x.device, dtype=torch.float32).contiguous()
    grads = tuple(torch.empty_like(a) for a in (x, log_a, Bm, Cm))
    if b * h * t == 0:
        return tuple(g.zero_() for g in grads)
    lib = _build.library("ssm")
    # the stored states and the partial sums, for this launch only
    n_ws = lib.repro_mamba2_ssd_bwd_ws(b, h, t, n, p, DTYPE_CODES[x.dtype])
    ws = torch.empty(n_ws, dtype=torch.float32, device=x.device)
    guard, stream = _build.launch_args(x)
    with guard:
        rc = lib.repro_mamba2_ssd_bwd(
            x.data_ptr(), log_a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            dy.data_ptr(), None if dstate is None else dstate.data_ptr(),
            *(g.data_ptr() for g in grads), ws.data_ptr(), n_ws, b, h, t, n,
            p, DTYPE_CODES[x.dtype], stream)
    _build.check(lib, rc, "mamba2_ssd_bwd")
    count_launch("mamba2_ssd_bwd", (b, h, t, p, n))
    return grads
