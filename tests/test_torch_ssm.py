"""The port's recurrent scans (K7 RWKV-6, K8 Mamba-2 SSD) against the JAX
package's, on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version
(``repro_torch.kernels.ref.rwkv6_ref`` / ``mamba2_ref``); here that is
held against the Pallas kernels in interpret mode (where ``T`` is a
multiple of their chunk, which they assert) and against the jnp oracles
of ``repro.kernels.ref`` at any ``T``, with an initial state, for strong
decay and for a decay of exactly 0, on the same numpy inputs made from a
seed.  Output and final state are both compared, as
``tests/test_kernels.py`` compares the Pallas kernels.  Tolerances:
fp32 within 1e-5 absolute and relative against the oracles (the same
step-by-step recurrence, sums over Dk or N in another order) and within
5e-4 / 1e-3 against the Pallas kernels (the bounds ``tests/test_kernels.py``
holds those to: their chunked matrix form sums in another order); bf16
inputs within 2e-2 (the output rounds to bf16 in both).  The CUDA
kernels are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.mamba2_ssd import mamba2_ssd as j_mamba2_ssd
from repro.kernels.rwkv6_scan import rwkv6_scan as j_rwkv6_scan

from repro_torch.kernels import ops, ref
from repro_torch.kernels.mamba2_ssd import mamba2_ssd
from repro_torch.kernels.rwkv6_scan import STATE_DIMS, rwkv6_scan

FP32_TOL = 1e-5
BF16_TOL = 2e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def rwkv6_inputs(seed, b, h, t, dk, dv, decay=(-4.0, 1.0)):
    """r, k, v, u normal; w = exp(-exp(x)), x uniform in ``decay`` (the
    reference's test range by default)."""
    rng = np.random.default_rng(seed)
    r, k = (rng.standard_normal((b, h, t, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, h, t, dv)).astype(np.float32)
    w = np.exp(-np.exp(rng.uniform(*decay, (b, h, t, dk)))).astype(np.float32)
    u = rng.standard_normal((h, dk)).astype(np.float32)
    return r, k, v, w, u


def mamba2_inputs(seed, b, h, t, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, t, p)).astype(np.float32)
    log_a = -np.exp(rng.uniform(-3, 0.5, (b, h, t))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((b, t, n)).astype(np.float32)
              for _ in range(2))
    return x, log_a, Bm, Cm


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


# ---------------------------------------------------------------------------
# K7 rwkv6_scan


@pytest.mark.parametrize("b,h,t,dk,dv,chunk", [
    (1, 2, 64, 32, 32, 16),
    (2, 2, 128, 64, 64, 32),     # rwkv6-7b's head dim and chunk
    (1, 4, 96, 48, 64, 32),
])
def test_rwkv6_plain_matches_pallas_and_oracle(b, h, t, dk, dv, chunk):
    arrs = rwkv6_inputs(t + dk, b, h, t, dk, dv)
    before = ops.launch_counts()["rwkv6_scan"]
    out, state = rwkv6_scan(*_torch(*arrs))
    assert ops.launch_counts()["rwkv6_scan"] == before  # the plain version
    assert out.dtype == torch.float32 and state.shape == (b, h, dk, dv)
    jarrs = [jnp.asarray(a) for a in arrs]
    p_out, p_state = j_rwkv6_scan(*jarrs, chunk=chunk, interpret=True)
    _close(out, p_out, 5e-4)
    _close(state, p_state, 5e-4)
    o_out, o_state = jref.rwkv6_ref(*jarrs)
    _close(out, o_out, FP32_TOL)
    _close(state, o_state, FP32_TOL)


@pytest.mark.parametrize("t", [1, 13, 31, 33, 100])
def test_rwkv6_plain_matches_oracle_at_ragged_t_with_a_state(t):
    b, h, dk, dv = 2, 3, 16, 16
    arrs = rwkv6_inputs(t, b, h, t, dk, dv)
    s0 = np.random.default_rng(t + 1).standard_normal(
        (b, h, dk, dv)).astype(np.float32)
    out, state = ref.rwkv6_ref(*_torch(*arrs), initial_state=torch.from_numpy(s0))
    o_out, o_state = jref.rwkv6_ref(*(jnp.asarray(a) for a in arrs),
                                    initial_state=jnp.asarray(s0))
    _close(out, o_out, FP32_TOL)
    _close(state, o_state, FP32_TOL)
    # the scan continues across a split of T, as decode continues prefill
    if t > 1:
        r, k, v, w, u = _torch(*arrs)
        o1, s1 = ref.rwkv6_ref(r[:, :, :t // 2], k[:, :, :t // 2],
                               v[:, :, :t // 2], w[:, :, :t // 2], u,
                               initial_state=torch.from_numpy(s0))
        o2, s2 = ref.rwkv6_ref(r[:, :, t // 2:], k[:, :, t // 2:],
                               v[:, :, t // 2:], w[:, :, t // 2:], u,
                               initial_state=s1)
        _close(torch.cat([o1, o2], dim=2), out, FP32_TOL)
        _close(s2, state, FP32_TOL)


def test_rwkv6_bf16_inputs_match_pallas():
    arrs = rwkv6_inputs(5, 1, 2, 64, 32, 32)
    out, state = rwkv6_scan(*_torch(*arrs, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16 and state.dtype == torch.float32
    p_out, p_state = j_rwkv6_scan(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrs), chunk=32,
        interpret=True)
    _close(out, p_out, BF16_TOL)
    _close(state, p_state, BF16_TOL)


def test_rwkv6_strong_decay_is_stable():
    """Near-zero decay (the reference's stability case), at a ragged T."""
    b, h, t, dk, dv = 1, 1, 70, 16, 16
    r = np.full((b, h, t, dk), 0.1, np.float32)
    k = np.full((b, h, t, dk), 0.1, np.float32)
    v = np.ones((b, h, t, dv), np.float32)
    w = np.full((b, h, t, dk), 1e-6, np.float32)
    u = np.zeros((h, dk), np.float32)
    out, state = rwkv6_scan(*_torch(r, k, v, w, u))
    assert torch.isfinite(out).all() and torch.isfinite(state).all()
    o_out, o_state = jref.rwkv6_ref(*(jnp.asarray(a) for a in (r, k, v, w, u)))
    _close(out, o_out, FP32_TOL)
    _close(state, o_state, FP32_TOL)


def test_rwkv6_zero_decay_is_finite_where_the_pallas_kernel_is_not():
    """w == 0 (exp(-exp(decay)) underflows once decay > ~4.6): the port
    equals the oracle and stays finite; the Pallas kernel takes log(0) and
    gives NaN (ROADMAP Queue 3)."""
    b, h, t, dk, dv = 1, 1, 64, 16, 16
    r, k, v, w, u = rwkv6_inputs(9, b, h, t, dk, dv)
    w[:] = 0.5
    w[:, :, 10] = 0.0
    w[:, :, 40, :5] = 0.0
    out, state = rwkv6_scan(*_torch(r, k, v, w, u))
    assert torch.isfinite(out).all() and torch.isfinite(state).all()
    jarrs = [jnp.asarray(a) for a in (r, k, v, w, u)]
    o_out, o_state = jref.rwkv6_ref(*jarrs)
    _close(out, o_out, FP32_TOL)
    _close(state, o_state, FP32_TOL)
    p_out, _ = j_rwkv6_scan(*jarrs, chunk=32, interpret=True)
    assert not np.isfinite(np.asarray(p_out)).all()


def test_rwkv6_wrapper_checks_shapes():
    r, k, v, w, u = _torch(*rwkv6_inputs(1, 1, 2, 5, 16, 8))
    with pytest.raises(ValueError):
        rwkv6_scan(r, k[:, :, :4], v, w, u)
    with pytest.raises(ValueError):
        rwkv6_scan(r, k, v[:, :1], w, u)
    with pytest.raises(ValueError):
        rwkv6_scan(r, k, v, w, u[:1])
    assert STATE_DIMS == (16, 32, 64, 128)


# ---------------------------------------------------------------------------
# K8 mamba2_ssd


@pytest.mark.parametrize("b,h,t,p,n,chunk", [
    (1, 2, 128, 32, 16, 32),
    (2, 4, 128, 64, 64, 64),     # zamba2's head dim, state and chunk
    (1, 2, 256, 64, 32, 64),
])
def test_mamba2_plain_matches_pallas_and_oracle(b, h, t, p, n, chunk):
    arrs = mamba2_inputs(t + n, b, h, t, p, n)
    before = ops.launch_counts()["mamba2_ssd"]
    y, state = mamba2_ssd(*_torch(*arrs))
    assert ops.launch_counts()["mamba2_ssd"] == before  # the plain version
    assert y.dtype == torch.float32 and state.shape == (b, h, n, p)
    jarrs = [jnp.asarray(a) for a in arrs]
    p_y, p_state = j_mamba2_ssd(*jarrs, chunk=chunk, interpret=True)
    _close(y, p_y, 1e-3)
    _close(state, p_state, 1e-3)
    o_y, o_state = jref.mamba2_ref(*jarrs, jnp.zeros((h,), jnp.float32))
    _close(y, o_y, FP32_TOL)
    _close(state, o_state, FP32_TOL)


@pytest.mark.parametrize("t", [1, 13, 63, 65, 100])
def test_mamba2_plain_matches_oracle_at_ragged_t_with_a_state(t):
    b, h, p, n = 2, 3, 16, 16
    arrs = mamba2_inputs(t, b, h, t, p, n)
    s0 = np.random.default_rng(t + 2).standard_normal(
        (b, h, n, p)).astype(np.float32)
    y, state = ref.mamba2_ref(*_torch(*arrs), initial_state=torch.from_numpy(s0))
    o_y, o_state = jref.mamba2_ref(*(jnp.asarray(a) for a in arrs),
                                   jnp.zeros((h,), jnp.float32),
                                   initial_state=jnp.asarray(s0))
    _close(y, o_y, FP32_TOL)
    _close(state, o_state, FP32_TOL)


def test_mamba2_bf16_inputs_match_pallas():
    x, log_a, Bm, Cm = mamba2_inputs(6, 1, 2, 128, 32, 16)
    y, state = mamba2_ssd(torch.from_numpy(x).bfloat16(),
                          *_torch(log_a, Bm, Cm))
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    p_y, p_state = j_mamba2_ssd(jnp.asarray(x, jnp.bfloat16),
                                *(jnp.asarray(a) for a in (log_a, Bm, Cm)),
                                chunk=64, interpret=True)
    _close(y, p_y, BF16_TOL)
    _close(state, p_state, BF16_TOL)


def test_mamba2_state_continuity():
    """The plain version equals the Pallas kernel at two chunk sizes, and
    a split of T carries the state across (as decode continues prefill)."""
    b, h, t, p, n = 1, 1, 192, 16, 8
    x, _, Bm, Cm = mamba2_inputs(7, b, h, t, p, n)
    log_a = np.full((b, h, t), -0.05, np.float32)
    y, state = mamba2_ssd(*_torch(x, log_a, Bm, Cm))
    jarrs = [jnp.asarray(a) for a in (x, log_a, Bm, Cm)]
    for chunk in (32, 64):
        _close(y, j_mamba2_ssd(*jarrs, chunk=chunk, interpret=True)[0], 1e-3)
    xt, lt, bt, ct = _torch(x, log_a, Bm, Cm)
    y1, s1 = ref.mamba2_ref(xt[:, :, :77], lt[:, :, :77], bt[:, :77],
                            ct[:, :77])
    y2, s2 = ref.mamba2_ref(xt[:, :, 77:], lt[:, :, 77:], bt[:, 77:],
                            ct[:, 77:], initial_state=s1)
    _close(torch.cat([y1, y2], dim=2), y, FP32_TOL)
    _close(s2, state, FP32_TOL)


def test_mamba2_wrapper_checks_shapes():
    x, log_a, Bm, Cm = _torch(*mamba2_inputs(2, 1, 2, 5, 8, 16))
    with pytest.raises(ValueError):
        mamba2_ssd(x, log_a[:, :, :4], Bm, Cm)
    with pytest.raises(ValueError):
        mamba2_ssd(x, log_a, Bm, Cm[:, :, :8])
    with pytest.raises(ValueError):
        mamba2_ssd(x[0], log_a, Bm, Cm)


# ---------------------------------------------------------------------------
# both: any T, where the Pallas kernels assert T % chunk == 0


def test_pallas_scans_refuse_a_serve_prompt_the_port_takes():
    """A 100-token prompt (the serve path's 1,000 is no multiple of 32 or
    64 either) trips the Pallas kernels' ``t % chunk`` assert; the port
    takes it and equals the oracle (ROADMAP Queue 3)."""
    arrs = rwkv6_inputs(3, 1, 2, 100, 16, 16)
    with pytest.raises(AssertionError):
        j_rwkv6_scan(*(jnp.asarray(a) for a in arrs), chunk=32, interpret=True)
    out, _ = rwkv6_scan(*_torch(*arrs))
    _close(out, jref.rwkv6_ref(*(jnp.asarray(a) for a in arrs))[0], FP32_TOL)
    arrs = mamba2_inputs(4, 1, 2, 100, 16, 16)
    with pytest.raises(AssertionError):
        j_mamba2_ssd(*(jnp.asarray(a) for a in arrs), chunk=64, interpret=True)
    y, _ = mamba2_ssd(*_torch(*arrs))
    _close(y, jref.mamba2_ref(*(jnp.asarray(a) for a in arrs),
                              jnp.zeros((2,), jnp.float32))[0], FP32_TOL)
