"""K7: the RWKV-6 wkv scan of the rwkv6 family's prefill (and ``forward``).

Replaces the Pallas ``rwkv6_scan`` (``src/repro/kernels/rwkv6_scan.py``):
per (batch, head), with a ``(Dk, Dv)`` state ``S`` starting at 0::

    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

r/k/w ``(B, H, T, Dk)``, v ``(B, H, T, Dv)``, u ``(H, Dk)``, all fp32 or
all bf16 -> the output ``(B, H, T, Dv)`` in v's dtype and the final state
``(B, H, Dk, Dv)`` in fp32.  The CUDA kernel (``csrc/ssm.cu``) takes its
route by the inputs' dtype, one kernel each:

* bf16 (the serve dtype): the chunked form on the tensor cores.  The
  state is carried every 16 steps; within them ``mma.sync`` bf16 products
  take the decay-scaled r and k, the state and the 16 x 16 block of
  step pairs (per-channel decays: its lower 8 x 8 quadrant a product on
  the tensor cores, the rest pairwise on the CUDA cores) as two bf16
  pieces each, so outputs stay within 1e-2 and the final state within
  1e-4 of the fp32 recurrence.
* fp32: the state in registers, T walked step by step on the CUDA cores
  (outputs within 1e-4: no room for bf16 pieces).

Every decay either route applies is a product of w, so any T works (the
Pallas kernel asserts ``T % chunk == 0``) and a decay of exactly 0 gives
finite output (the Pallas kernel's log-space ratios give NaN there).  Dk
is one of ``STATE_DIMS``, Dv at most ``MAX_COLS``.  On a CPU tensor the
wrapper runs the plain version (``ref.rwkv6_ref``), on a ``meta`` tensor
the dry-run's stand-in (``meta.py``), on a CUDA tensor it launches the
kernel or raises.

**Gradients.**  Every call runs through ``RWKV6Scan``, a
``torch.autograd.Function`` that saves only the inputs: its backward,
:func:`rwkv6_scan_bwd`, recomputes the states, so the graph holds no
per-step state (remat's memory stays the dry-run's).  On a CUDA tensor
that is K7's backward (``csrc/ssm.cu``; one launch counted as
``rwkv6_scan_bwd`` however many kernels it runs), by the inputs' dtype:

* bf16 (the train path): the chunked reverse scan on the tensor cores.
  A first kernel stores the state at the start of every 16-step
  sub-chunk (``mma.sync``, as the forward carries it); a block per (b, h)
  and 64 state columns then walks the sub-chunks last to first with the
  state's cotangent in ``mma`` accumulators and the forward's own
  operands of each sub-chunk (the decayed r and k, its decay, its block of
  step pairs): dv, the cotangent's update and the products over the
  block's columns on ``mma`` with every fp32 operand in two bf16 pieces,
  then dr, dk and dw per channel on the CUDA cores, each decay a running
  product of w (dw in its direct form: nothing divides by w); a last
  kernel adds du over b (and, past 64 columns, the column tiles'
  partials) in a fixed order.  Within 1e-2 (1 + |g|) of the fp32 plain
  version.
* fp32: one block per (b, h) and 32 state columns, a thread a state
  row, the state in fp64 stored every 16th step and each step's
  ``S_{t-1}`` recomputed from it; fp64 sums; a second kernel adds the
  blocks' partials in a fixed order.  Within 2e-5 (1 + |g|).

On the CPU it is ``ref.rwkv6_bwd_ref``, on ``meta`` the dry-run's op.
The reference has no backward kernel: its training
differentiates its jnp oracle.
"""

from __future__ import annotations

import torch

from . import _build, meta, ref
from .flash_attention import DTYPE_CODES
from .ops import count_launch

#: state widths (Dk) the CUDA kernel is built for
STATE_DIMS = (16, 32, 48, 64, 128)
#: the widest Dv
MAX_COLS = 1024
def _check_shapes(r, k, v, w, u) -> None:
    if r.dim() != 4 or k.shape != r.shape or w.shape != r.shape:
        raise ValueError("rwkv6_scan: r, k and w must be (B, H, T, Dk)")
    b, h, t, dk = r.shape
    if v.dim() != 4 or tuple(v.shape[:3]) != (b, h, t):
        raise ValueError(f"rwkv6_scan: v {tuple(v.shape)} is not "
                         f"({b}, {h}, {t}, Dv)")
    if tuple(u.shape) != (h, dk):
        raise ValueError(f"rwkv6_scan: u must be ({h}, {dk})")


def _check_kernel_args(name: str, r, k, v, w, u) -> None:
    """What the CUDA kernels take: one device, one dtype (fp32 or bf16), a
    built state width."""
    dk, dv = r.shape[3], v.shape[3]
    if any(x.device != r.device or x.dtype != r.dtype for x in (k, v, w, u)):
        raise ValueError(f"{name}: r, k, v, w and u must share device and "
                         "dtype")
    if r.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, "
                        f"got {r.dtype}")
    if dk not in STATE_DIMS or not 1 <= dv <= MAX_COLS:
        raise ValueError(f"{name}: Dk {dk} not in {STATE_DIMS} or Dv "
                         f"{dv} not in [1, {MAX_COLS}]")


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor):
    """-> (out (B, H, T, Dv), final state (B, H, Dk, Dv) fp32);
    differentiable in r, k, v, w and u (see the module docstring)."""
    _check_shapes(r, k, v, w, u)
    return RWKV6Scan.apply(r, k, v, w, u)


class RWKV6Scan(torch.autograd.Function):
    """K7 under autograd: the forward launch, the inputs saved, and
    :func:`rwkv6_scan_bwd` for the gradients (a cotangent autograd leaves
    out, of the state in training, is zero)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.save_for_backward(r, k, v, w, u)
        ctx.set_materialize_grads(False)
        return _forward(r, k, v, w, u)

    @staticmethod
    def backward(ctx, dout, dstate):
        return rwkv6_scan_bwd(*ctx.saved_tensors, dout, dstate)


def _forward(r, k, v, w, u):
    b, h, t, dk = r.shape
    if r.device.type == "cpu":
        return ref.rwkv6_ref(r, k, v, w, u)
    _check_kernel_args("rwkv6_scan", r, k, v, w, u)
    if r.device.type == "meta":  # the dry-run: shapes and FLOPs
        return meta.ops().rwkv6_scan(r, v)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: unsupported device {r.device}")
    dv = v.shape[3]
    r, k, v, w, u = (x.contiguous() for x in (r, k, v, w, u))
    out = torch.empty((b, h, t, dv), dtype=v.dtype, device=r.device)
    state = torch.empty((b, h, dk, dv), dtype=torch.float32, device=r.device)
    if b * h == 0:
        return out, state
    lib = _build.library("ssm")
    guard, stream = _build.launch_args(r)
    with guard:
        rc = lib.repro_rwkv6_scan(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), out.data_ptr(), state.data_ptr(), b, h, t, dk, dv,
            DTYPE_CODES[r.dtype], stream)
    _build.check(lib, rc, "rwkv6_scan")
    count_launch("rwkv6_scan", (b, h, t, dk, dv))
    return out, state


def rwkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, dout, dstate=None):
    """K7's backward: ``(dr, dk, dv, dw, du)`` of :func:`rwkv6_scan` at the
    cotangents ``dout`` (B, H, T, Dv) of the output and ``dstate`` (B, H,
    Dk, Dv) of the final state (None: zero), each in its input's dtype
    (fp32 sums).  On a CPU tensor ``ref.rwkv6_bwd_ref``; on a CUDA tensor
    the kernel of ``csrc/ssm.cu`` or a raise."""
    _check_shapes(r, k, v, w, u)
    b, h, t, dk = r.shape
    dv = v.shape[3]
    for name, x, shape in (("dout", dout, v.shape),
                           ("dstate", dstate, (b, h, dk, dv))):
        if x is not None and tuple(x.shape) != tuple(shape):
            raise ValueError(f"rwkv6_scan_bwd: {name} must be "
                             f"{tuple(shape)}, got {tuple(x.shape)}")
    if r.device.type == "cpu":
        return ref.rwkv6_bwd_ref(r, k, v, w, u, dout, dstate)
    _check_kernel_args("rwkv6_scan_bwd", r, k, v, w, u)
    if r.device.type == "meta":
        return meta.ops().rwkv6_scan_bwd(r, v, u)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan_bwd: unsupported device {r.device}")
    r, k, v, w, u = (x.contiguous() for x in (r, k, v, w, u))
    dout = (torch.zeros_like(v) if dout is None
            else dout.to(v.dtype).contiguous())
    if dstate is not None:
        dstate = dstate.to(device=r.device, dtype=torch.float32).contiguous()
    grads = tuple(torch.empty_like(x) for x in (r, k, v, w, u))
    if b * h * t == 0:
        return tuple(g.zero_() for g in grads)
    lib = _build.library("ssm")
    # the stored states and the partial sums, for this launch only
    n_ws = lib.repro_rwkv6_scan_bwd_ws(b, h, t, dk, dv, DTYPE_CODES[r.dtype])
    ws = torch.empty(n_ws, dtype=torch.float32, device=r.device)
    guard, stream = _build.launch_args(r)
    with guard:
        rc = lib.repro_rwkv6_scan_bwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), dout.data_ptr(),
            None if dstate is None else dstate.data_ptr(),
            *(g.data_ptr() for g in grads), ws.data_ptr(), n_ws, b, h, t,
            dk, dv, DTYPE_CODES[r.dtype], stream)
    _build.check(lib, rc, "rwkv6_scan_bwd")
    count_launch("rwkv6_scan_bwd", (b, h, t, dk, dv))
    return grads
