"""The port's backward of the recurrent scans (K7 RWKV-6, K8 Mamba-2 SSD)
and of K5 at MLA's q/k 96, v 64, against the JAX package's, on the CPU.

The reference has no backward kernel: its training differentiates its
jnp oracles.  So the port's plain backwards (``ref.rwkv6_bwd_ref``,
``ref.mamba2_bwd_ref``, ``ref.flash_attention_bwd_ref``) are held against
``jax.vjp`` of ``repro.kernels.ref.rwkv6_ref`` / ``mamba2_ref`` (``D = 0``,
as ``repro.kernels.ops.mamba2`` calls it) / ``flash_attention_ref``, at
ragged T, two state widths, a decay of exactly 0 (``w = 0``, ``log_a =
-inf``) and a non-zero cotangent of the final state, within 1e-5 as
``|got - want| <= tol (1 + |want|)``; then against torch autograd
through the port's own plain forwards, and the autograd Functions' CPU
route (``rwkv6_scan``, ``mamba2_ssd``) against the plain backwards.  The
CUDA kernels are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba2_ssd import mamba2_ssd
from repro_torch.kernels.rwkv6_scan import rwkv6_scan

# six test workers share the cores: one thread each, not one per core
torch.set_num_threads(max(1, os.cpu_count() // 6))

TOL = 1e-5

#: (b, h, t, state width, columns, a zero decay, a final-state cotangent)
SCAN_CASES = [
    (2, 3, 37, 16, 20, True, True),    # ragged T, w = 0 / log_a = -inf
    (1, 2, 16, 32, 24, False, True),
    (2, 2, 1, 16, 8, False, False),    # one step, no state cotangent
    (1, 2, 29, 32, 40, True, False),
]


def _close(got, want, what):
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    assert np.isfinite(got).all(), what
    err = np.abs(got - want) / (TOL * (1 + np.abs(want)))
    assert err.max() <= 1, (what, float(err.max()))


def _t(a):
    return torch.from_numpy(np.array(a))


def rwkv6_case(case, seed):
    b, h, t, dk, dv, zero, with_state = case
    rng = np.random.default_rng(seed)
    r, k = (rng.standard_normal((b, h, t, dk)).astype(np.float32) * 0.5
            for _ in range(2))
    v, do = (rng.standard_normal((b, h, t, dv)).astype(np.float32)
             for _ in range(2))
    w = np.exp(-np.exp(rng.uniform(-4.0, 1.0, (b, h, t, dk)))).astype(
        np.float32)
    if zero:
        w[:, :, t // 2] = 0.0
    u = rng.standard_normal((h, dk)).astype(np.float32)
    ds = (rng.standard_normal((b, h, dk, dv)).astype(np.float32)
          if with_state else None)
    return (r, k, v, w, u), do, ds


def mamba2_case(case, seed):
    b, h, t, n, p, zero, with_state = case
    rng = np.random.default_rng(seed)
    x, dy = (rng.standard_normal((b, h, t, p)).astype(np.float32)
             for _ in range(2))
    log_a = -rng.uniform(0.0, 0.5, (b, h, t)).astype(np.float32)
    if zero:
        log_a[:, :, t // 3] = -np.inf
    bm, cm = (rng.standard_normal((b, t, n)).astype(np.float32) * 0.5
              for _ in range(2))
    ds = (rng.standard_normal((b, h, n, p)).astype(np.float32)
          if with_state else None)
    return (x, log_a, bm, cm), dy, ds


def _state_cot(ds, shape):
    return jnp.asarray(ds) if ds is not None else jnp.zeros(shape, jnp.float32)


@pytest.mark.parametrize("case", SCAN_CASES)
def test_rwkv6_bwd_ref_matches_jax_vjp_of_the_oracle(case):
    ins, do, ds = rwkv6_case(case, sum(case[:5]))
    (_o, s), vjp = jax.vjp(jref.rwkv6_ref, *(jnp.asarray(a) for a in ins))
    want = vjp((jnp.asarray(do), _state_cot(ds, s.shape)))
    got = ref.rwkv6_bwd_ref(*(_t(a) for a in ins), _t(do),
                            None if ds is None else _t(ds))
    for name, a, w in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        assert a.dtype == torch.float32 and a.shape == w.shape, name
        _close(a.numpy(), w, name)


@pytest.mark.parametrize("case", SCAN_CASES)
def test_mamba2_bwd_ref_matches_jax_vjp_of_the_oracle(case):
    ins, dy, ds = mamba2_case(case, 1 + sum(case[:5]))
    d0 = jnp.zeros((case[1],), jnp.float32)
    (_y, s), vjp = jax.vjp(lambda *a: jref.mamba2_ref(*a, d0),
                           *(jnp.asarray(a) for a in ins))
    want = vjp((jnp.asarray(dy), _state_cot(ds, s.shape)))
    got = ref.mamba2_bwd_ref(*(_t(a) for a in ins), _t(dy),
                             None if ds is None else _t(ds))
    for name, a, w in zip(("dx", "dlog_a", "dBm", "dCm"), got, want):
        assert a.dtype == torch.float32 and a.shape == w.shape, name
        _close(a.numpy(), w, name)


def _autograd(fn, ins, cots):
    leaves = [_t(a).requires_grad_(True) for a in ins]
    outs = fn(*leaves)
    pairs = [(o, _t(c)) for o, c in zip(outs, cots) if c is not None]
    torch.autograd.backward([o for o, _ in pairs], [c for _, c in pairs])
    # an input no cotangent reaches (w at T = 1 without a state's) has none
    return [torch.zeros_like(x) if x.grad is None else x.grad
            for x in leaves]


@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_bwd_refs_match_autograd_through_the_plain_forwards(case):
    ins, do, ds = rwkv6_case(case, 2 + sum(case[:5]))
    want = _autograd(ref.rwkv6_ref, ins, (do, ds))
    got = ref.rwkv6_bwd_ref(*(_t(a) for a in ins), _t(do),
                            None if ds is None else _t(ds))
    for name, a, w in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        _close(a.numpy(), w.numpy(), name)
    ins, dy, ds = mamba2_case(case, 3 + sum(case[:5]))
    want = _autograd(ref.mamba2_ref, ins, (dy, ds))
    got = ref.mamba2_bwd_ref(*(_t(a) for a in ins), _t(dy),
                             None if ds is None else _t(ds))
    for name, a, w in zip(("dx", "dlog_a", "dBm", "dCm"), got, want):
        _close(a.numpy(), w.numpy(), name)


@pytest.mark.parametrize("case", SCAN_CASES)
def test_the_autograd_functions_cpu_route_gives_the_plain_gradients(case):
    """``rwkv6_scan`` / ``mamba2_ssd`` record ``RWKV6Scan`` /
    ``Mamba2SSD``; on the CPU their backward is the plain one (no launch
    counted)."""
    before = ops.launch_counts()
    for fn, make, bwd, grad_fn in (
            (rwkv6_scan, rwkv6_case, ref.rwkv6_bwd_ref, "RWKV6ScanBackward"),
            (mamba2_ssd, mamba2_case, ref.mamba2_bwd_ref,
             "Mamba2SSDBackward")):
        ins, dout, ds = make(case, 4 + sum(case[:5]))
        leaves = [_t(a).requires_grad_(True) for a in ins]
        out, state = fn(*leaves)
        assert type(out.grad_fn).__name__ == grad_fn
        cots = [(out, _t(dout))] + ([(state, _t(ds))] if ds is not None
                                    else [])
        torch.autograd.backward([o for o, _ in cots], [c for _, c in cots])
        want = bwd(*(_t(a) for a in ins), _t(dout),
                   None if ds is None else _t(ds))
        for a, w in zip(leaves, want):
            np.testing.assert_array_equal(a.grad.numpy(), w.numpy())
    assert ops.launch_counts() == before


def test_scan_bwds_take_bf16_and_stay_finite_at_a_zero_decay():
    """bf16 inputs give gradients in bf16 (fp32 sums) within a bf16
    rounding of the fp32 gradients of the same values."""
    case = SCAN_CASES[0]
    for make, bwd in ((rwkv6_case, ref.rwkv6_bwd_ref),
                      (mamba2_case, ref.mamba2_bwd_ref)):
        ins, dout, ds = make(case, 5)
        bf = [_t(a).bfloat16() for a in ins]
        if bwd is ref.mamba2_bwd_ref:  # log_a, B and C stay fp32
            bf[1:] = [_t(a) for a in ins[1:]]
        got = bwd(*bf, _t(dout).bfloat16(), _t(ds))
        want = bwd(*(x.float() for x in bf), _t(dout).bfloat16().float(),
                   _t(ds))
        for a, x, w in zip(got, bf, want):
            assert a.dtype == x.dtype and bool(torch.isfinite(a).all())
            err = (a.float() - w).abs() / (1 + w.abs())
            assert float(err.max()) <= 2 ** -8


#: K5 at MLA's widths: (b, h, g, sq, sk, q/k 96, v 64, causal, window)
MLA_CASES = [
    (1, 4, 4, 21, 21, True, None),
    (2, 2, 2, 9, 30, True, 11),     # ragged Sq < Sk with a window
]


@pytest.mark.parametrize("case", MLA_CASES)
def test_k5_bwd_ref_at_96_64_matches_jax_vjp_of_the_oracle(case):
    b, h, g, sq, sk, causal, window = case
    rng = np.random.default_rng(sum(case[:5]))
    q = rng.standard_normal((b, h, sq, 96)).astype(np.float32)
    k = rng.standard_normal((b, g, sk, 96)).astype(np.float32)
    v = rng.standard_normal((b, g, sk, 64)).astype(np.float32)
    do = rng.standard_normal((b, h, sq, 64)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b_, c: jref.flash_attention_ref(
        a, b_, c, causal=causal, window=window), q, k, v)
    want = vjp(jnp.asarray(do))
    lse = ref.flash_attention_lse_ref(_t(q), _t(k), causal=causal,
                                      window=window)
    got = ref.flash_attention_bwd_ref(_t(q), _t(k), _t(v),
                                      _t(np.asarray(out)), lse, _t(do),
                                      causal=causal, window=window)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape, name
        _close(a.numpy(), w, name)
    # the autograd Function's CPU route: one pass for the output and LSE
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    y = flash_attention(*leaves, causal=causal, window=window)
    np.testing.assert_array_equal(
        y.detach().numpy(),
        ref.flash_attention_ref(*(_t(a) for a in (q, k, v)), causal=causal,
                                window=window).numpy())
    y.backward(_t(do))
    for name, a, w in zip(("dq", "dk", "dv"), leaves, want):
        _close(a.grad.numpy(), w, name)
