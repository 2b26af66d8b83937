"""The bf16 routes of K7's and K8's backward (``csrc/ssm.cu``: the chunked
reverse scans on the tensor cores) as plain PyTorch emulations of their
algorithms, on the CPU, held against the plain backwards and ``jax.vjp``
of the JAX package's oracles.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  These emulations round where the kernels round:
every fp32 operand of a tensor-core product as bf16 pieces (two, the
rounding and the rounding of what it leaves; x, dy, v and dO are exact in
bf16), fp32 sums, K8's decays from fp64 sums of log-decays floored at
-128, K7's as fp32 running products of w, and the gradients rounded to
their dtype (bf16, or fp32 for K8's dlog_a, dB and dC).  They show that
the algorithms meet the card's tolerance, ``|got - want| <= 1e-2 (1 +
|want|)``, at ragged T, every state width, with and without a final-state
cotangent, where a decay is exactly 0 (``w = 0``, ``log_a = -inf``) and
at ``log_a`` down to -1e4, and that they need their split products.
Change an emulation with its kernel.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

from repro_torch.kernels import ref

# six test workers share the cores: one thread each, not one per core
torch.set_num_threads(max(1, os.cpu_count() // 6))

TOL = 1e-2
SQ = 64                   # K8's chunk
WT = 16                   # K7's sub-chunk
LOG_DECAY_FLOOR = -128.0  # K8's floor of log_a


def _pieces(x, k):
    """x as k bf16 pieces (``split_bf16``): the rounding, then the
    rounding of what it leaves."""
    out, rest = [], x
    for _ in range(k):
        p = rest.bfloat16().float()
        out.append(p)
        rest = rest - p
    return out


def _mm(a, b, pa, pb):
    """a @ b on the tensor cores: ``pa`` / ``pb`` bf16 pieces of each
    factor (1 for a factor exact in bf16), the products hi hi + hi lo +
    lo hi, summed in fp32 (the fp64 sum of exact products, rounded)."""
    a_p, b_p = _pieces(a, pa), _pieces(b, pb)
    terms = [(0, 0)] + ([(0, 1)] if pb > 1 else []) + ([(1, 0)] if pa > 1 else [])
    return sum(a_p[i].double() @ b_p[j].double() for i, j in terms).float()


def _fma(a, b, c):
    """fmaf: a b + c rounded once."""
    return (a.double() * b.double() + c.double()).float()


def chunked_ssd_bwd_emulation(x, log_a, Bm, Cm, dy, dstate=None, pieces=2):
    """K8's bf16 backward in plain PyTorch: x, dy (B, H, T, P) with bf16
    values, log_a (B, H, T), Bm/Cm (B, T, N) fp32, dstate (B, H, N, P) or
    None -> (dx as bf16 values, dlog_a, dBm, dCm) fp32.  Per 64-step
    chunk, with cum the fp64 sums of the floored log-decays: the chunk's
    own state and cotangent parts (B o e^{cend-cum})^T x, (C o e^{cum})^T dy,
    which walks over the chunks add to H (from 0) and dH (from dstate),
    each first scaled by e^{cend}, storing H_start and dH_end; then
    dX = M^T dy + (B o e^{cend-cum}) dH_end, dC = (dM o L) B + diag(e^{cum})
    dy H_start^T, dB = (dM o L)^T C + diag(e^{cend-cum}) x dH_end^T with M =
    C B^T o L, dM = dy x^T, and dlog_a in its direct form (the box sums of
    M o dM, the reverse sums of z = C . dC's state part, the sums of w = B
    . dB's state part before t, e^{cend} <dH_end, H_start>).  ``pieces=1``
    rounds every fp32 operand to bf16 once instead."""
    b, h, t, p = x.shape
    n = Bm.shape[-1]
    nc = -(-t // SQ)
    pad = nc * SQ - t
    padt = lambda a: torch.nn.functional.pad(a, (0, 0, 0, pad))
    x4, dy4 = (padt(a).reshape(b, h, nc, SQ, p) for a in (x, dy))
    B4, C4 = (padt(a).reshape(b, 1, nc, SQ, n) for a in (Bm, Cm))
    la = torch.nn.functional.pad(log_a, (0, pad)).reshape(b, h, nc, SQ)
    cum = torch.cumsum(la.double().clamp(min=LOG_DECAY_FLOOR), -1)
    cend = cum[..., -1:]
    eL = torch.exp((cend - cum).float())[..., None]               # (.., SQ, 1)
    eT = torch.exp(cum.float())[..., None]
    dec = torch.exp(cend.float())[..., None]                       # (.., 1, 1)
    tr = lambda a: a.transpose(-1, -2)
    # the chunks' own parts, then H_start and dH_end by the walks
    h_loc = _mm(tr(B4 * eL), x4, pieces, 1)                        # (.., N, P)
    dh_loc = _mm(tr(C4 * eT), dy4, pieces, 1)
    H = torch.zeros((b, h, n, p))
    dH = (torch.zeros((b, h, n, p)) if dstate is None
          else dstate.float().clone())
    hs, dhs = [None] * nc, [None] * nc
    for c in range(nc):
        hs[c] = H
        H = dec[:, :, c] * H + h_loc[:, :, c]
    for c in range(nc - 1, -1, -1):
        dhs[c] = dH
        dH = dec[:, :, c] * dH + dh_loc[:, :, c]
    Hs, dHs = torch.stack(hs, 2), torch.stack(dhs, 2)
    causal = torch.tril(torch.ones((SQ, SQ), dtype=torch.bool))
    G = _mm(C4, tr(B4), pieces, pieces)                            # (b, 1, nc, t, s)
    dM = _mm(dy4, tr(x4), 1, 1)
    L = torch.where(causal, torch.exp((cum[..., :, None] - cum[..., None, :]).float()), 0.0)
    Ds, Ms = dM * L, G * L
    dx = _mm(tr(Ms), dy4, pieces, 1) + _mm(B4 * eL, dHs, pieces, pieces)
    dc_state = _mm(dy4, tr(Hs), 1, pieces) * eT
    db_state = _mm(x4, tr(dHs), 1, pieces) * eL
    z = (C4 * dc_state).sum(-1)                                    # (.., SQ)
    w = (B4 * db_state).sum(-1)
    dC = dc_state + _mm(Ds, B4, pieces, pieces)
    dB = db_state + _mm(tr(Ds), C4, pieces, pieces)
    E = (G * Ds).double()
    box = torch.flip(torch.cumsum(torch.flip(E, [-2]), -2), [-2])  # sum_{tau >= t}
    t1 = (box * torch.tril(torch.ones((SQ, SQ)), -1).double()).sum(-1)
    t2 = torch.flip(torch.cumsum(torch.flip(z.double(), [-1]), -1), [-1])
    t3 = torch.cumsum(w.double(), -1) - w.double()
    t4 = dec[..., 0].double() * (dHs.double() * Hs.double()).sum((-1, -2))[..., None]
    dla = (t1 + t2 + t3 + t4).float()
    un = lambda a, cols: a.reshape(*a.shape[:2], nc * SQ, cols)[:, :, :t]
    return (un(dx, p).bfloat16().float(), dla.reshape(b, h, nc * SQ)[:, :, :t],
            un(dB.sum(1, keepdim=True), n)[:, 0], un(dC.sum(1, keepdim=True), n)[:, 0])


def chunked_wkv_bwd_emulation(r, k, v, w, u, dout, dstate=None, pieces=2):
    """K7's bf16 backward in plain PyTorch: r/k/w (B, H, T, Dk), v/dout
    (B, H, T, Dv), u (H, Dk), all with bf16 values, dstate (B, H, Dk, Dv)
    or None -> (dr, dk, dv, dw, du) as bf16 values.  Per 16-step
    sub-chunk, every decay an fp32 running product of w: rP = r o prod_{q<t}
    w, K' = k o prod_{q>s} w, W = prod w, A (the forward's pair block with
    its u diagonal); the state before every sub-chunk (S <- W S + K'^T v),
    dS walked last to first (dS <- W dS + rP^T dO); per sub-chunk dv = A^T
    dO + K' dS_end, X = dO S_start^T, Y = V dS_end^T (dS_end in two bf16
    pieces), D = dO V^T, the row dots of S_start and dS_end; then per
    channel, fmaf by fmaf as the kernel: dr and dk in Horner form, dw in
    its direct form (four terms, each decay skipping w_q), the u terms
    and du.  ``pieces=1`` rounds every fp32 operand to bf16 once."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    ns = -(-t // WT)
    pad = ns * WT - t
    padt = lambda a, val=0.0: torch.nn.functional.pad(a, (0, 0, 0, pad), value=val)
    r5, k5 = (padt(a).reshape(b, h, ns, WT, dk) for a in (r, k))
    w5 = padt(w, 1.0).reshape(b, h, ns, WT, dk)
    v5, o5 = (padt(a).reshape(b, h, ns, WT, dv) for a in (v, dout))
    uu = u[None, :, None, None, :]
    one = torch.ones_like(w5[..., 0, :])
    pre, suf = [one], [one]
    for j in range(WT - 1):
        pre.append(pre[-1] * w5[..., j, :])
        suf.append(suf[-1] * w5[..., WT - 1 - j, :])
    pre = torch.stack(pre, -2)                        # prod_{q<t} w
    suf = torch.stack(suf[::-1], -2)                  # prod_{q>s} w
    W = pre[..., -1, :] * w5[..., -1, :]              # the forward order
    Ws = suf[..., 0, :] * w5[..., 0, :]               # the states launch's order
    rP, Kp = r5 * pre, k5 * suf
    # A[t][s] = sum_c r_tc k_sc prod_{s<q<t} w_qc (s < t), r_t . u k_t on t = s
    A = torch.zeros((b, h, ns, WT, WT))
    for s in range(WT):
        A[..., s, s] = (r5[..., s, :] * uu[..., 0, :] * k5[..., s, :]).sum(-1)
        kp = k5[..., s, :]
        for tt in range(s + 1, WT):
            A[..., tt, s] = (r5[..., tt, :] * kp).sum(-1)
            kp = kp * w5[..., tt, :]
    tr = lambda a: a.transpose(-1, -2)
    S = torch.zeros((b, h, dk, dv))
    starts = []
    for i in range(ns):
        starts.append(S)
        S = Ws[:, :, i, :, None] * S + _mm(tr(Kp[:, :, i]), v5[:, :, i], pieces, 1)
    dS = torch.zeros((b, h, dk, dv)) if dstate is None else dstate.float().clone()
    ends = [None] * ns
    for i in range(ns - 1, -1, -1):
        ends[i] = dS
        dS = W[:, :, i, :, None] * dS + _mm(tr(rP[:, :, i]), o5[:, :, i], pieces, 1)
    S0, dS1 = torch.stack(starts, 2), torch.stack(ends, 2)
    dSp = sum(_pieces(dS1, pieces))                   # dS_end as the planes hold it
    dv_ = _mm(Kp, dS1, pieces, pieces) + _mm(tr(A), o5, pieces, 1)
    X = _mm(o5, tr(S0), 1, pieces)                    # (t, c)
    Y = (v5.double() @ tr(dSp).double()).float()      # (s, c)
    D = (o5.double() @ tr(v5).double()).float()       # (t, s)
    rd = (S0.double() * dSp.double()).sum(-1).float()  # (c)
    zero = torch.zeros_like(w5[..., 0, :])
    Dts = lambda tt, s: D[..., tt, s, None]
    dr, dk_, dw = [None] * WT, [None] * WT, [None] * WT
    for tt in range(WT):
        acc = zero
        for s in range(tt):
            acc = _fma(acc, w5[..., s, :], Dts(tt, s) * k5[..., s, :])
        dr[tt] = _fma(pre[..., tt, :], X[..., tt, :], acc)
    for s in range(WT - 1, -1, -1):
        acc = zero
        for tt in range(WT - 1, s, -1):
            acc = _fma(acc, w5[..., tt, :], Dts(tt, s) * r5[..., tt, :])
        dk_[s] = _fma(suf[..., s, :], Y[..., s, :], acc)
    F = [zero] * WT                                   # sinks t > q of S_start
    for q in range(WT - 1, 0, -1):
        F[q - 1] = _fma(w5[..., q, :], F[q], r5[..., q, :] * X[..., q, :])
    Z, bq = [zero] * WT, zero
    for q in range(WT):
        a4 = zero
        for tt in range(WT - 1, q, -1):
            a4 = _fma(a4, w5[..., tt, :], r5[..., tt, :] * Z[tt])
        dw[q] = _fma(pre[..., q, :], _fma(suf[..., q, :], rd, F[q]),
                     _fma(suf[..., q, :], bq, a4))
        bq = _fma(w5[..., q, :], bq, k5[..., q, :] * Y[..., q, :])
        for tt in range(q + 2, WT):
            Z[tt] = _fma(w5[..., q, :], Z[tt], k5[..., q, :] * Dts(tt, q))
    diag = torch.diagonal(D, dim1=-2, dim2=-1)[..., None]        # v_t . dO_t
    dr = torch.stack(dr, -2) + uu * k5 * diag
    dk_ = torch.stack(dk_, -2) + r5 * uu * diag
    du = (r5 * k5 * diag).sum((0, 2, 3))
    un = lambda a: a.reshape(b, h, ns * WT, a.shape[-1])[:, :, :t].bfloat16().float()
    return un(dr), un(dk_), un(dv_), un(torch.stack(dw, -2)), du.bfloat16().float()


def _ratio(got, want):
    """Largest |got - want| / (1e-2 (1 + |want|)): <= 1 meets it."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all()
    return float((np.abs(got - want) / (TOL * (1 + np.abs(want)))).max())


def _bf16(a):
    return torch.from_numpy(a).bfloat16().float()


def ssd_case(seed, b, h, t, p, n, decay, with_state):
    """x, dy with bf16 values; log_a -exp(uniform(-3, 0.5)) ("-inf": every
    7th step -inf) or -exp(uniform(-3, 9.2)) ("-1e4"); B, C normal."""
    rng = np.random.default_rng(seed)
    x, dy = (_bf16(rng.standard_normal((b, h, t, p)).astype(np.float32))
             for _ in range(2))
    hi = 9.2 if decay == "-1e4" else 0.5
    la = -np.exp(rng.uniform(-3, hi, (b, h, t))).astype(np.float32)
    if decay == "-inf":
        la[..., ::7] = -np.inf
    Bm, Cm = (torch.from_numpy(rng.standard_normal((b, t, n)).astype(np.float32))
              for _ in range(2))
    ds = (torch.from_numpy(rng.standard_normal((b, h, n, p)).astype(np.float32))
          if with_state else None)
    return [x, torch.from_numpy(la), Bm, Cm], dy, ds


def wkv_case(seed, b, h, t, dk, dv, decay, with_state):
    """r, k, v, u, dO normal with bf16 values; w = exp(-exp(uniform)) over
    the reference's (-4, 1), "strong" (2, 4) or "zero" (2, 6) with every
    7th step 0, as chip_smoke.py's cases."""
    rng = np.random.default_rng(seed)
    r, k = (_bf16(rng.standard_normal((b, h, t, dk)).astype(np.float32))
            for _ in range(2))
    v, do = (_bf16(rng.standard_normal((b, h, t, dv)).astype(np.float32))
             for _ in range(2))
    u = _bf16(rng.standard_normal((h, dk)).astype(np.float32))
    lo, hi = {"reference": (-4.0, 1.0), "strong": (2.0, 4.0),
              "zero": (2.0, 6.0)}[decay]
    w = np.exp(-np.exp(rng.uniform(lo, hi, (b, h, t, dk)))).astype(np.float32)
    if decay == "zero":
        w[:, :, ::7] = 0.0
    ds = (torch.from_numpy(rng.standard_normal((b, h, dk, dv)).astype(np.float32))
          if with_state else None)
    return [r, k, v, _bf16(w), u], do, ds


def _vjp(fn, ins, cots, extra=()):
    """jax.vjp of a JAX oracle at the same values."""
    out, vjp = jax.vjp(lambda *a: fn(*a, *extra),
                       *(jnp.asarray(a.numpy()) for a in ins))
    return vjp(tuple(jnp.asarray(c.numpy()) if c is not None
                     else jnp.zeros(o.shape, jnp.float32)
                     for o, c in zip(out, cots)))


#: (b, h, t, P, N, decay, a final-state cotangent): T of 1, 31, 33, 65 and
#: 129, every state width, P not a multiple of 64 and above it, several
#: groups of 8 heads
SSD_CASES = [
    (2, 3, 1, 16, 16, "reference", True),
    (1, 2, 31, 32, 32, "reference", False),
    (1, 3, 33, 40, 48, "-inf", True),
    (1, 2, 65, 24, 64, "-1e4", False),
    (1, 2, 129, 72, 128, "-inf", True),
    (2, 9, 65, 16, 16, "reference", True),
    (1, 2, 129, 64, 64, "-1e4", True),
]

#: (b, h, t, Dk, Dv, decay, a final-state cotangent)
WKV_CASES = [
    (2, 2, 1, 16, 16, "reference", True),
    (1, 2, 31, 32, 40, "strong", False),
    (1, 2, 33, 48, 24, "zero", True),
    (1, 2, 65, 64, 64, "zero", False),
    (1, 1, 129, 128, 72, "reference", True),
    (2, 2, 129, 64, 64, "strong", True),
    (1, 2, 65, 16, 130, "zero", True),
]


@pytest.mark.parametrize("case", SSD_CASES)
def test_chunked_ssd_bwd_emulation_matches_the_plain_and_jax_gradients(case):
    ins, dy, ds = ssd_case(sum(case[:5]), *case)
    got = chunked_ssd_bwd_emulation(*ins, dy, ds)
    plain = ref.mamba2_bwd_ref(*ins, dy, ds)
    want = _vjp(jref.mamba2_ref, ins, (dy, ds),
                (jnp.zeros((case[1],), jnp.float32),))
    for name, g, pl, wj in zip(("dx", "dlog_a", "dB", "dC"), got, plain, want):
        assert g.shape == pl.shape, name
        assert _ratio(g, pl) <= 1.0, name
        assert _ratio(g, np.asarray(wj)) <= 1.0, name


@pytest.mark.parametrize("case", WKV_CASES)
def test_chunked_wkv_bwd_emulation_matches_the_plain_and_jax_gradients(case):
    ins, do, ds = wkv_case(sum(case[:5]), *case)
    got = chunked_wkv_bwd_emulation(*ins, do, ds)
    plain = ref.rwkv6_bwd_ref(*ins, do, ds)
    want = _vjp(jref.rwkv6_ref, ins, (do, ds))
    for name, g, pl, wj in zip(("dr", "dk", "dv", "dw", "du"), got, plain, want):
        assert g.shape == pl.shape, name
        assert _ratio(g, pl) <= 1.0, name
        assert _ratio(g, np.asarray(wj)) <= 1.0, name


def test_chunked_bwd_emulations_give_zero_decay_gradients_without_nan():
    """Where every decay is 0 (w = 0, log_a = -inf) the gradients of the
    decays are exactly those of a scan that forgets each step: no 0 * inf,
    no division by a decay."""
    ins, do, ds = wkv_case(3, 1, 2, 40, 32, 24, "zero", True)
    ins[3] = torch.zeros_like(ins[3])
    got = chunked_wkv_bwd_emulation(*ins, do, ds)
    plain = ref.rwkv6_bwd_ref(*ins, do, ds)
    for g, pl in zip(got, plain):
        assert _ratio(g, pl) <= 1.0
    ins, dy, ds = ssd_case(4, 1, 2, 70, 24, 16, "reference", True)
    ins[1] = torch.full_like(ins[1], -np.inf)
    got = chunked_ssd_bwd_emulation(*ins, dy, ds)
    plain = ref.mamba2_bwd_ref(*ins, dy, ds)
    for g, pl in zip(got, plain):
        assert _ratio(g, pl) <= 1.0
    assert torch.equal(got[1], torch.zeros_like(got[1]))


def test_chunked_ssd_bwd_emulation_needs_its_split_products():
    """At zamba2-2.7b's head shape (P = N = 64) over 1,000 steps, rounding
    each fp32 operand to bf16 once misses 1e-2; the split products meet
    it."""
    ins, dy, ds = ssd_case(5, 1, 2, 1000, 64, 64, "reference", True)
    plain = ref.mamba2_bwd_ref(*ins, dy, ds)
    split = chunked_ssd_bwd_emulation(*ins, dy, ds)
    once = chunked_ssd_bwd_emulation(*ins, dy, ds, pieces=1)
    assert max(_ratio(g, w) for g, w in zip(split, plain)) <= 1.0
    assert max(_ratio(g, w) for g, w in zip(once, plain)) > 1.0


def test_chunked_wkv_bwd_emulation_needs_its_split_products():
    """At rwkv6-7b's head shape (Dk = Dv = 64) over 256 steps, rounding
    each fp32 operand to bf16 once misses 1e-2; the split products meet
    it."""
    ins, do, ds = wkv_case(6, 1, 2, 256, 64, 64, "reference", True)
    plain = ref.rwkv6_bwd_ref(*ins, do, ds)
    split = chunked_wkv_bwd_emulation(*ins, do, ds)
    once = chunked_wkv_bwd_emulation(*ins, do, ds, pieces=1)
    assert max(_ratio(g, w) for g, w in zip(split, plain)) <= 1.0
    assert max(_ratio(g, w) for g, w in zip(once, plain)) > 1.0
