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
    assert STATE_DIMS == (16, 32, 48, 64, 128)


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


# ---------------------------------------------------------------------------
# K8's bf16 route: a plain emulation of the chunked tensor-core algorithm
# (csrc/ssm.cu, ssd_chunked), rounding where the kernel rounds, held
# against the JAX oracle.  The kernel itself runs only on the card
# (tests/test_torch_cuda.py); this shows on the CPU that its algorithm
# meets the card's tolerances (outputs 1e-2, final states 1e-4, as
# |got - want| <= tol (1 + |want|)) and that its split products are
# needed.

Q = 64                    # the kernel's chunk
LOG_DECAY_FLOOR = -128.0  # the kernel's floor of log_a (e^-128 is 0 in fp32)


def _pieces(x, k):
    """x as k bf16 pieces, each the rounding (to nearest even) of what
    the pieces before it leave: the kernel's ``split_bf16``."""
    out, rest = [], x
    for _ in range(k):
        p = rest.bfloat16().float()
        out.append(p)
        rest = rest - p
    return out


def _mma(a, b, split=True):
    """a @ b on bf16 operands with fp32 sums: two pieces a side and the
    three products hi hi + hi lo + lo hi, or one rounding a side."""
    if not split:
        return (_pieces(a, 1)[0].double() @ _pieces(b, 1)[0].double()).float()
    (a0, a1), (b0, b1) = _pieces(a, 2), _pieces(b, 2)
    return (a0.double() @ b0.double() + a0.double() @ b1.double()
            + a1.double() @ b0.double()).float()


def _mma_exact_b(a, b, k):
    """a @ b with b exact in bf16 (x): a in k pieces, a product each."""
    return sum(p.double() @ b.double() for p in _pieces(a, k)).float()


def chunked_ssd_emulation(x, log_a, Bm, Cm, split=True):
    """The bf16 route of K8 in plain PyTorch: x (B, H, T, P) with bf16
    values, log_a (B, H, T), Bm/Cm (B, T, N) fp32 -> (y rounded to bf16 as
    fp32, final state (B, H, N, P) fp32).  Per chunk of 64 steps: fp64
    sums of the floored log-decays, every decay from an fp64 difference
    of them; C B^T and C H (the state kept in two bf16 pieces) as three
    bf16 products of two pieces a side; (C B^T o L) x with two pieces of
    C B^T o L and the state update with two of B o decay (x is exact).
    ``split=False`` rounds every operand to bf16 once instead."""
    b, h, t, p = x.shape
    n = Bm.shape[-1]
    nc = -(-t // Q)
    pad = nc * Q - t
    x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    la = torch.nn.functional.pad(log_a, (0, pad))
    Bp = torch.nn.functional.pad(Bm, (0, 0, 0, pad))
    Cp = torch.nn.functional.pad(Cm, (0, 0, 0, pad))
    H = torch.zeros((b, h, n, p), dtype=torch.float32)
    y = torch.empty((b, h, nc * Q, p), dtype=torch.float32)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        xc, Bc, Cc = x[:, :, sl], Bp[:, sl], Cp[:, sl]
        cum = torch.cumsum(la[:, :, sl].double().clamp(min=LOG_DECAY_FLOOR), -1)
        G = _mma(Cc, Bc.transpose(1, 2), split)                  # (b, t, s)
        L = torch.where(causal, torch.exp(
            (cum[..., :, None] - cum[..., None, :]).float()), 0.0)
        y_intra = _mma_exact_b(G[:, None] * L, xc, 2 if split else 1)
        Hs = sum(_pieces(H, 2)) if split else H                   # stored
        y_state = _mma(Cc[:, None].expand(b, h, Q, n), Hs, split)
        y[:, :, sl] = torch.exp(cum.float())[..., None] * y_state + y_intra
        decay = torch.exp((cum[..., -1:] - cum).float())          # (b, h, s)
        Bd = Bc[:, None] * decay[..., None]                       # (b, h, s, n)
        H = (torch.exp(cum[..., -1].float())[..., None, None] * H
             + _mma_exact_b(Bd.transpose(-1, -2), xc, 2 if split else 1))
    return y[:, :, :t].bfloat16().float(), H


def _ssd_case(seed, b, h, t, p, n, decay):
    """numpy inputs: x with bf16 values; log_a -exp(uniform(-3, 0.5)),
    "-inf" with every 7th step -inf, "-1e4" -exp(uniform(-3, 9.2))."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, h, t, p)).astype(np.float32))
    x = x.bfloat16().float().numpy()
    hi = 9.2 if decay == "-1e4" else 0.5
    log_a = -np.exp(rng.uniform(-3, hi, (b, h, t))).astype(np.float32)
    if decay == "-inf":
        log_a[..., ::7] = -np.inf
    Bm, Cm = (rng.standard_normal((b, t, n)).astype(np.float32)
              for _ in range(2))
    return x, log_a, Bm, Cm


def _ratio(got, want, tol):
    """Largest |got - want| / (tol (1 + |want|)): <= 1 meets ``tol``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (tol * (1 + np.abs(want)))).max())


@pytest.mark.parametrize("decay", ["reference", "-inf", "-1e4"])
@pytest.mark.parametrize("t", [1, 65, 130])
@pytest.mark.parametrize("n", [16, 48])
def test_mamba2_chunked_emulation_matches_oracle(n, t, decay):
    b, h, p = 2, 3, 40
    arrs = _ssd_case(n + t, b, h, t, p, n, decay)
    y, state = chunked_ssd_emulation(*(torch.from_numpy(a) for a in arrs))
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    o_y, o_state = jref.mamba2_ref(*(jnp.asarray(a) for a in arrs),
                                   jnp.zeros((h,), jnp.float32))
    assert _ratio(y, o_y, 1e-2) <= 1.0
    assert _ratio(state, o_state, 1e-4) <= 1.0


def test_mamba2_chunked_emulation_needs_its_split_products():
    """At zamba2's head shape (P = N = 64) over 1,000 steps, rounding each
    fp32 operand to bf16 once misses both tolerances (outputs 1e-2, final
    states 1e-4); the kernel's split products meet them."""
    b, h, t, p, n = 1, 4, 1000, 64, 64
    arrs = _ssd_case(64, b, h, t, p, n, "reference")
    o_y, o_state = jref.mamba2_ref(*(jnp.asarray(a) for a in arrs),
                                   jnp.zeros((h,), jnp.float32))
    tensors = [torch.from_numpy(a) for a in arrs]
    y, state = chunked_ssd_emulation(*tensors)
    assert _ratio(y, o_y, 1e-2) <= 1.0
    assert _ratio(state, o_state, 1e-4) <= 1.0
    y1, state1 = chunked_ssd_emulation(*tensors, split=False)
    assert _ratio(y1, o_y, 1e-2) > 1.0
    assert _ratio(state1, o_state, 1e-4) > 1.0


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_state_width_48_passes_the_wrappers_checks(device):
    """Dk = 48 (the reference sweep's rwkv6 row) and N = 48 are built
    widths: the wrappers' shape checks take them, on CPU tensors (the
    plain versions) and up to the device check on meta tensors."""
    assert 48 in STATE_DIMS
    if device == "cpu":
        r, k, v, w, u = _torch(*rwkv6_inputs(1, 1, 4, 96, 48, 64))
        out, state = rwkv6_scan(r, k, v, w, u)
        assert out.shape == (1, 4, 96, 64) and state.shape == (1, 4, 48, 64)
        y, s = mamba2_ssd(*_torch(*mamba2_inputs(2, 1, 4, 96, 40, 48)))
        assert y.shape == (1, 4, 96, 40) and s.shape == (1, 4, 48, 40)
        return
    # on meta tensors a width passes every shape check and meets the
    # device check last; an unbuilt width (40) is refused before it
    meta = dict(device="meta")
    v = torch.empty((1, 4, 96, 64), **meta)
    x = torch.empty((1, 4, 96, 40), **meta)
    la = torch.empty((1, 4, 96), **meta)
    for width, msg in ((48, "unsupported device meta"), (40, "not in")):
        r = torch.empty((1, 4, 96, width), **meta)
        u = torch.empty((4, width), **meta)
        with pytest.raises(ValueError, match=msg):
            rwkv6_scan(r, r, v, r, u)
        bc = torch.empty((1, 96, width), **meta)
        with pytest.raises(ValueError, match=msg):
            mamba2_ssd(x, la, bc, bc)


# ---------------------------------------------------------------------------
# K7's bf16 route: a plain emulation of the chunked tensor-core algorithm
# (csrc/ssm.cu, wkv_chunked), rounding where the kernel rounds, held
# against the JAX oracle and the Pallas kernel.  The kernel itself runs
# only on the card (tests/test_torch_cuda.py); this shows on the CPU that
# its algorithm meets the card's tolerances (outputs 1e-2, final states
# 1e-4, as |got - want| <= tol (1 + |want|)), also where a decay is 0,
# and that its split products are needed.

WT = 16  # the kernel's sub-chunk: the state is carried every 16 steps


def _products(a, b, pieces):
    """a @ b with ``pieces`` bf16 pieces of each fp32 factor and fp32
    sums: two pieces take hi hi + hi lo + lo hi, one the rounding of
    each; b may be exact in bf16 (v), then its second piece is 0."""
    pa, pb = _pieces(a, pieces), _pieces(b, pieces)
    terms = [(0, 0)] + ([(0, 1), (1, 0)] if pieces == 2 else [])
    return sum(pa[i] @ pb[j] for i, j in terms)


def _lane_channels(dk):
    """(16, Dk / 16): the channels each of 16 lanes takes in the kernel's
    diagonal block, in its order (pairs 2 (lane + 16 j), 2 (lane + 16 j)
    + 1 where Dk / 16 is even, else lane + 16 j)."""
    nc = dk // 16
    if nc % 2 == 0:
        return torch.tensor([[2 * (g + 16 * (m // 2)) + m % 2
                              for m in range(nc)] for g in range(16)])
    return torch.tensor([[g + 16 * m for m in range(nc)] for g in range(16)])


def _channel_sum(a, b):
    """sum_c a_c b_c over the last axis as the kernel's diagonal block
    takes it: each of 16 lanes an fp32 fused multiply-add chain over its
    channels (the exact product plus the sum, rounded to fp32), then fp32
    adds across the lanes in the butterfly order of its shuffles."""
    idx = _lane_channels(a.shape[-1])
    ag, bg = a[..., idx].double(), b[..., idx].double()
    acc = torch.zeros(ag.shape[:-1], dtype=torch.float64)
    for m in range(idx.shape[1]):
        acc = (ag[..., m] * bg[..., m] + acc).float().double()
    acc = acc.float()
    lanes = torch.arange(16)
    for o in (8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ o]
    return acc[..., 0]


def chunked_wkv_emulation(r, k, v, w, u, split=True):
    """The bf16 route of K7 in plain PyTorch: r/k/w (B, H, T, Dk), v (B,
    H, T, Dv), u (H, Dk), all with bf16 values -> (out rounded to bf16 as
    fp32, final state (B, H, Dk, Dv) fp32).  Per sub-chunk of 16 steps,
    every decay a product of w in fp32 from a boundary of the sub-chunk
    or of its halves (so each is in [0, 1] and w = 0 gives exact zeros):
    rP_t = r_t o prod_{q<t} w_q, K'_s = k_s o prod_{q>s} w_q, W = prod w;
    the diagonal block A[t][s] (s < t): its quadrant t >= 8 > s as r'' k''^T
    with r''_t = r_t o prod_{8<=q<t} w_q and k''_s = k_s o prod_{s<q<8}
    w_q, the rest sum_c r_tc k_sc prod_{s<q<t} w_qc by running products,
    and A[t][t] = sum_c r_tc u_c k_tc; then o = rP S + A v and S <- diag(W)
    S + K'^T v.  Every product takes two bf16 pieces of each fp32 factor
    (r'', k'', rP, S, A, K'; v is exact), the state stays fp32.  Every
    sum is in fp32, the per-channel ones in the kernel's lanes and order
    (``_channel_sum``), the products' in PyTorch's order, not the mma's.
    ``split=False`` rounds every fp32 operand to bf16 once instead."""
    pieces = 2 if split else 1
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    ns = -(-t // WT)
    pad = ns * WT - t
    half = WT // 2
    r, k, v = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (r, k, v))
    w = torch.nn.functional.pad(w, (0, 0, 0, pad), value=1.0)
    S = torch.zeros((b, h, dk, dv), dtype=torch.float32)
    out = torch.empty((b, h, ns * WT, dv), dtype=torch.float32)
    for i in range(ns):
        sl = slice(i * WT, (i + 1) * WT)
        rc, kc, vc, wc = r[:, :, sl], k[:, :, sl], v[:, :, sl], w[:, :, sl]
        # forward products from the start and from step 8, backward ones
        # from the end and from step 8
        P, Q, P8, Q8 = (torch.empty_like(wc) for _ in range(4))
        p = q = p8 = q8 = torch.ones_like(wc[:, :, 0])
        for j in range(WT):
            jb = WT - 1 - j
            if j == half:
                p8 = q8 = torch.ones_like(p)
            P[:, :, j], P8[:, :, j] = p, p8
            Q[:, :, jb], Q8[:, :, jb] = q, q8
            p, p8 = p * wc[:, :, j], p8 * wc[:, :, j]
            q, q8 = q * wc[:, :, jb], q8 * wc[:, :, jb]
        A = torch.zeros((b, h, WT, WT), dtype=torch.float32)
        for s in range(WT):
            A[:, :, s, s] = _channel_sum(rc[:, :, s] * u, kc[:, :, s])
            kp = kc[:, :, s]
            for tt in range(s + 1, (s // half + 1) * half):
                A[:, :, tt, s] = _channel_sum(rc[:, :, tt], kp)
                kp = kp * wc[:, :, tt]
        A[:, :, half:, :half] = _products(
            (rc * P8)[:, :, half:], (kc * Q8)[:, :, :half].transpose(-1, -2),
            pieces)
        out[:, :, sl] = _products(rc * P, S, pieces) + _products(A, vc, pieces)
        S = p[..., None] * S + _products((kc * Q).transpose(-1, -2), vc,
                                         pieces)
    return out[:, :, :t].bfloat16().float(), S


def _wkv_case(seed, b, h, t, dk, dv, decay):
    """Inputs with bf16 values: r, k, v, u normal; w = exp(-exp(x)), x
    uniform in the reference's (-4, 1), "strong" (2, 4) or "zero" (2, 6),
    which also sets every 7th step to 0 (as chip_smoke.py's cases)."""
    lo, hi = {"reference": (-4.0, 1.0), "strong": (2.0, 4.0),
              "zero": (2.0, 6.0)}[decay]
    r, k, v, w, u = rwkv6_inputs(seed, b, h, t, dk, dv, decay=(lo, hi))
    if decay == "zero":
        w[:, :, ::7] = 0.0
    return [torch.from_numpy(a).bfloat16().float().numpy()
            for a in (r, k, v, w, u)]


@pytest.mark.parametrize("decay", ["reference", "strong", "zero"])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 128])
@pytest.mark.parametrize("dk", [48, 64])
def test_rwkv6_chunked_emulation_matches_oracle_and_pallas(dk, t, decay):
    b, h, dv = 1, 2, 40
    arrs = _wkv_case(dk + t, b, h, t, dk, dv, decay)
    out, state = chunked_wkv_emulation(*(torch.from_numpy(a) for a in arrs))
    assert torch.isfinite(out).all() and torch.isfinite(state).all()
    jarrs = [jnp.asarray(a) for a in arrs]
    o_out, o_state = jref.rwkv6_ref(*jarrs)
    assert _ratio(out, o_out, 1e-2) <= 1.0
    assert _ratio(state, o_state, 1e-4) <= 1.0
    if t % 32 == 0 and decay != "zero":  # the Pallas kernel: NaN at w = 0
        p_out, p_state = j_rwkv6_scan(*jarrs, chunk=32, interpret=True)
        assert _ratio(out, p_out, 1e-2) <= 1.0
        assert _ratio(state, p_state, 1e-4) <= 1.0


def test_rwkv6_chunked_emulation_needs_its_split_products():
    """At rwkv6-7b's head shape (Dk = Dv = 64) over 256 steps, rounding
    each fp32 operand to bf16 once misses both tolerances (outputs 1e-2,
    final states 1e-4); the kernel's split products meet them."""
    b, h, t, dk, dv = 1, 4, 256, 64, 64
    arrs = _wkv_case(17, b, h, t, dk, dv, "reference")
    o_out, o_state = jref.rwkv6_ref(*(jnp.asarray(a) for a in arrs))
    tensors = [torch.from_numpy(a) for a in arrs]
    out, state = chunked_wkv_emulation(*tensors)
    assert _ratio(out, o_out, 1e-2) <= 1.0
    assert _ratio(state, o_state, 1e-4) <= 1.0
    out1, state1 = chunked_wkv_emulation(*tensors, split=False)
    assert _ratio(out1, o_out, 1e-2) > 1.0
    assert _ratio(state1, o_state, 1e-4) > 1.0
