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
wrapper runs the plain version (``ref.rwkv6_ref``), on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build, ref
from .flash_attention import DTYPE_CODES
from .ops import count_launch, refuse_grad

#: state widths (Dk) the CUDA kernel is built for
STATE_DIMS = (16, 32, 48, 64, 128)
#: the widest Dv
MAX_COLS = 1024


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor):
    """-> (out (B, H, T, Dv), final state (B, H, Dk, Dv) fp32)."""
    if r.dim() != 4 or k.shape != r.shape or w.shape != r.shape:
        raise ValueError("rwkv6_scan: r, k and w must be (B, H, T, Dk)")
    b, h, t, dk = r.shape
    if v.dim() != 4 or tuple(v.shape[:3]) != (b, h, t):
        raise ValueError(f"rwkv6_scan: v {tuple(v.shape)} is not "
                         f"({b}, {h}, {t}, Dv)")
    if tuple(u.shape) != (h, dk):
        raise ValueError(f"rwkv6_scan: u must be ({h}, {dk})")
    if r.device.type == "cpu":
        return ref.rwkv6_ref(r, k, v, w, u)
    refuse_grad("rwkv6_scan", r, k, v, w, u)
    dv = v.shape[3]
    if any(x.device != r.device or x.dtype != r.dtype for x in (k, v, w, u)):
        raise ValueError("rwkv6_scan: r, k, v, w and u must share device "
                         "and dtype")
    if r.dtype not in DTYPE_CODES:
        raise TypeError(f"rwkv6_scan: the kernel takes float32 or bfloat16, "
                        f"got {r.dtype}")
    if dk not in STATE_DIMS or not 1 <= dv <= MAX_COLS:
        raise ValueError(f"rwkv6_scan: Dk {dk} not in {STATE_DIMS} or Dv "
                         f"{dv} not in [1, {MAX_COLS}]")
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: unsupported device {r.device}")
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
