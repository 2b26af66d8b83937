"""The port's attention kernels (K5 flash, K6 decode) against the JAX
package's, on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version
(``repro_torch.kernels.ref``); here that is held against the jnp oracles
of ``repro.kernels.ref`` and against the Pallas kernels in interpret mode,
on the same numpy inputs made from a seed.  Tolerances: fp32 within
1e-5 absolute and relative (the two sum in different orders); bf16 within
2e-2, as ``tests/test_kernels.py`` holds the Pallas kernels (the products
round to bf16 at different places).  Non-causal K5 is held against the
oracle only: the Pallas kernel leaves padded kv columns unmasked when
``causal=False`` (ROADMAP Queue 3).  The CUDA kernels are held against
these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.flash_attention import flash_attention as j_flash

from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (
    MAX_CHUNKS, TILE_ROWS, chunking, decode_attention, heads_per_block,
    launch_shape,
)
from repro_torch.kernels.flash_attention import (
    HEAD_DIMS, NARROW_V, check_kernel_args, flash_attention,
    flash_attention_bwd,
)

# six test workers share the cores: one thread each, not one per core
torch.set_num_threads(max(1, os.cpu_count() // 6))

FP32_TOL = 1e-5
BF16_TOL = 2e-2
DTYPES = {"float32": (torch.float32, jnp.float32, FP32_TOL),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16_TOL)}


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays, dtype):
    tdt, jdt, _ = DTYPES[dtype]
    return ([torch.from_numpy(a).to(tdt) for a in arrays],
            [jnp.asarray(a, dtype=jdt) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# K5 flash_attention


@pytest.mark.parametrize("b,h,g,sq,sk,d,window", [
    (1, 4, 4, 64, 64, 32, None),      # MHA square
    (2, 6, 2, 100, 100, 64, None),    # GQA 3:1 (smollm's ratio), ragged
    (1, 8, 1, 40, 40, 256, None),     # MQA at gemma-2b's head dim
    (1, 4, 2, 37, 200, 64, None),     # Sq < Sk: ends aligned
    (2, 6, 2, 150, 150, 32, 16),      # sliding window
    (1, 3, 1, 70, 133, 64, 64),       # window, Sq < Sk, MQA
    (2, 4, 4, 90, 90, 80, None),      # zamba2's shared attention: MHA, D=80
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_oracle_and_pallas(b, h, g, sq, sk, d,
                                                   window, dtype):
    arrs = _inputs(sq * 1000 + sk + d, (b, h, sq, d), (b, g, sk, d),
                   (b, g, sk, d))
    (q, k, v), (jq, jk, jv) = _both(arrs, dtype)
    tol = DTYPES[dtype][2]
    before = ops.launch_counts()["flash_attention"]
    got = _np(flash_attention(q, k, v, causal=True, window=window))
    assert ops.launch_counts()["flash_attention"] == before  # plain version
    orc = _np(jref.flash_attention_ref(jq, jk, jv, causal=True, window=window))
    np.testing.assert_allclose(got, orc, atol=tol, rtol=tol)
    pal = _np(j_flash(jq, jk, jv, causal=True, window=window, block_q=64,
                      block_k=64, interpret=True))
    np.testing.assert_allclose(got, pal, atol=tol, rtol=tol)


@pytest.mark.parametrize("b,h,g,sq,sk,d,window", [
    (1, 4, 2, 50, 200, 64, None),     # kv not a multiple of any tile
    (2, 2, 2, 33, 33, 32, None),
    (1, 6, 3, 20, 90, 64, 30),        # window without the causal mask
])
def test_flash_attention_non_causal_matches_oracle(b, h, g, sq, sk, d, window):
    arrs = _inputs(7 + sk, (b, h, sq, d), (b, g, sk, d), (b, g, sk, d))
    (q, k, v), (jq, jk, jv) = _both(arrs, "float32")
    got = _np(flash_attention(q, k, v, causal=False, window=window))
    orc = _np(jref.flash_attention_ref(jq, jk, jv, causal=False, window=window))
    np.testing.assert_allclose(got, orc, atol=FP32_TOL, rtol=FP32_TOL)


def test_flash_attention_scale_and_ops_entry():
    arrs = _inputs(3, (1, 2, 16, 32), (1, 1, 16, 32), (1, 1, 16, 32))
    (q, k, v), (jq, jk, jv) = _both(arrs, "float32")
    got = _np(flash_attention(q, k, v, causal=True, scale=0.3))
    orc = _np(jref.flash_attention_ref(jq, jk, jv, causal=True, scale=0.3))
    np.testing.assert_allclose(got, orc, atol=FP32_TOL, rtol=FP32_TOL)


def test_flash_attention_rejects_bad_shapes():
    q = torch.zeros(1, 4, 8, 32)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 3, 8, 32), torch.zeros(1, 3, 8, 32))
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 2, 8, 16), torch.zeros(1, 2, 8, 16))


def test_kernel_argument_checks():
    """What the CUDA wrappers check before a launch (run here on CPU
    tensors: the checks are plain Python)."""
    q = torch.zeros(1, 2, 4, 64)
    check_kernel_args("k", q, q, q, window=None)
    check_kernel_args("k", q.bfloat16(), q.bfloat16(), window=5)
    with pytest.raises(TypeError):
        check_kernel_args("k", q.half(), q.half(), window=None)
    with pytest.raises(ValueError):
        check_kernel_args("k", q, q.bfloat16(), window=None)
    check_kernel_args("k", torch.zeros(1, 2, 4, 80), window=None)
    with pytest.raises(ValueError):
        check_kernel_args("k", torch.zeros(1, 2, 4, 96), window=None)
    with pytest.raises(ValueError):
        check_kernel_args("k", q, q, window=0)
    assert HEAD_DIMS == (32, 64, 80, 128, 256)
    # v narrower than q/k: MLA's (96, 64) only
    q96 = torch.zeros(1, 2, 4, 96)
    check_kernel_args("k", q96, q96, window=None, dv=64)
    check_kernel_args("k", q, q, window=None, dv=64)  # v as wide as q
    for d, dv in ((96, 96), (96, 32), (128, 64), (64, 32)):
        with pytest.raises(ValueError, match="head dim"):
            check_kernel_args("k", torch.zeros(1, 2, 4, d), window=None, dv=dv)
    assert NARROW_V == ((96, 64),)


# ---------------------------------------------------------------------------
# K5 with v narrower than q/k (MLA's prefill: q/k 96, v 64)


@pytest.mark.parametrize("b,h,g,sq,sk,window", [
    (1, 4, 4, 100, 100, None),        # MHA, as MLA runs it
    (2, 6, 2, 37, 150, None),         # GQA, Sq < Sk
    (1, 4, 4, 150, 150, 40),          # window
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_narrow_v_matches_oracle(b, h, g, sq, sk, window,
                                                 dtype):
    """q/k 96, v 64: the plain version against the JAX oracle (the Pallas
    kernel's blocks take v at q's width: ROADMAP Queue 3)."""
    arrs = _inputs(sq + sk + 96, (b, h, sq, 96), (b, g, sk, 96),
                   (b, g, sk, 64))
    (q, k, v), (jq, jk, jv) = _both(arrs, dtype)
    tol = DTYPES[dtype][2]
    scale = 1.0 / np.sqrt(96)
    got = flash_attention(q, k, v, causal=True, window=window, scale=scale)
    assert got.shape == (b, h, sq, 64)
    orc = _np(jref.flash_attention_ref(jq, jk, jv, causal=True, window=window,
                                       scale=scale))
    np.testing.assert_allclose(_np(got), orc, atol=tol, rtol=tol)


def test_flash_attention_narrow_v_gradients_on_the_cpu():
    """On the CPU a graph through K5 at q/k 96, v 64 takes the plain
    backward: the gradients equal ``jax.vjp`` of the oracle (on the card
    such a call raises: K5's backward is built for v as wide as q/k)."""
    arrs = _inputs(96, (1, 4, 50, 96), (1, 2, 70, 96), (1, 2, 70, 64),
                   (1, 4, 50, 64))
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs[:3])
    out = flash_attention(q, k, v, causal=True)
    out.backward(torch.from_numpy(arrs[3]))
    _o, vjp = jax.vjp(lambda a, b_, c: jref.flash_attention_ref(
        a, b_, c, causal=True), *(jnp.asarray(a) for a in arrs[:3]))
    for t, w in zip((q, k, v), vjp(jnp.asarray(arrs[3]))):
        np.testing.assert_allclose(_np(t.grad), _np(w), atol=FP32_TOL,
                                   rtol=FP32_TOL)
    with pytest.raises(ValueError, match="Dv"):  # out / dout at v's width
        flash_attention_bwd(q, k, v, q.detach(), torch.zeros(1, 4, 50),
                            q.detach())


# ---------------------------------------------------------------------------
# K5's bf16 numerics on the card, emulated tile by tile

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
#: the card's bf16 tolerance against the plain version in fp32 (chip_smoke
#: ``ATTN_TOL``), as ``|got - want| <= tol (1 + |want|)``
CARD_BF16_TOL = 1.6e-2
#: the same for K5's bf16 backward (chip_smoke ``BWD_TOL``)
CARD_BWD_TOL = 1e-2


def _k5_bf16_emulation(q, k, v, causal, window, bq=128, bk=128,
                       with_lse=False):
    """K5's bf16 kernel in plain PyTorch, one (query tile, kv tile) at a
    time: fp32 scores of the bf16 inputs, ``scale * log2(e)`` folded and
    ``exp2``, fp32 ``(m, l, acc)``, P rounded to bf16 per kv tile before
    ``P V``, the kv tiles a query tile cannot see skipped, a row that sees
    no key 0, the output rounded to bf16; with ``with_lse`` also the rows'
    LSE it writes, ``(m + log2 l) ln 2`` (``-inf`` where ``l`` is 0)."""
    b, h, sq, d = q.shape
    g, sk = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(h // g, dim=1)
    vf = v.float().repeat_interleave(h // g, dim=1)
    qf = q.float()
    c = LOG2E / np.sqrt(d)
    out = torch.zeros(b, h, sq, v.shape[-1])
    lse = torch.full((b, h, sq), float("-inf"))
    for q0 in range(0, sq, bq):
        rows = min(bq, sq - q0)
        qpos = torch.arange(q0, q0 + rows) + sk - sq
        k_end = min(sk, int(qpos[-1]) + 1) if causal else sk
        k_begin = max(0, int(qpos[0]) - window + 1) if window else 0
        m = torch.full((b, h, rows), -1e30)
        l = torch.zeros(b, h, rows)
        acc = torch.zeros(b, h, rows, v.shape[-1])
        for k0 in range(k_begin // bk * bk, k_end, bk):
            kpos = torch.arange(k0, min(k0 + bk, sk))
            s = qf[:, :, q0:q0 + rows] @ kf[:, :, kpos].transpose(-1, -2) * c
            ok = torch.ones(rows, len(kpos), dtype=torch.bool)
            if causal:
                ok &= kpos[None, :] <= qpos[:, None]
            if window:
                ok &= kpos[None, :] > qpos[:, None] - window
            s = s.masked_fill(~ok, float("-inf"))
            m_new = torch.maximum(m, s.amax(-1))
            a = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * a + p.sum(-1)
            acc = acc * a[..., None] + p.bfloat16().float() @ vf[:, :, kpos]
            m = m_new
        out[:, :, q0:q0 + rows] = torch.where(
            l[..., None] > 0, acc / l.clamp_min(1e-30)[..., None],
            torch.zeros(()))
        lse[:, :, q0:q0 + rows] = torch.where(
            l > 0, (m + torch.log2(l.clamp_min(1e-30))) * LN2,
            torch.tensor(float("-inf")))
    return (out.bfloat16(), lse) if with_lse else out.bfloat16()


@pytest.mark.parametrize("b,h,g,sq,sk,d,causal,window", [
    (1, 4, 2, 150, 200, 64, True, None),   # two query tiles, Sq < Sk
    (2, 3, 1, 77, 300, 64, True, 40),      # MQA, window, Sq < Sk
    (1, 4, 4, 130, 130, 80, True, None),   # D=80, a ragged second tile
    (1, 2, 2, 90, 260, 80, True, 70),      # D=80, window
    (1, 2, 1, 60, 140, 80, False, None),   # non-causal, padded kv tile
    (1, 2, 1, 70, 150, 256, True, None),   # D=256 takes kv tiles of 64
])
def test_k5_bf16_numerics_fit_the_card_tolerance(b, h, g, sq, sk, d, causal,
                                                 window):
    """Rounding P to bf16 per kv tile (what the tensor-core kernel does)
    stays within the tolerance the card holds K5 to, against the JAX
    oracle in fp32 on the same bf16 inputs."""
    arrs = _inputs(sq + sk + d, (b, h, sq, d), (b, g, sk, d), (b, g, sk, d))
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrs)
    got = _np(_k5_bf16_emulation(q, k, v, causal, window,
                                 bk=128 if d <= 128 else 64))
    jq, jk, jv = (jnp.asarray(_np(t)) for t in (q, k, v))
    want = _np(jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                        window=window))
    assert np.all(np.abs(got - want) <= CARD_BF16_TOL * (1 + np.abs(want)))


@pytest.mark.parametrize("b,h,g,sq,sk,window", [
    (1, 4, 4, 150, 150, None),        # MLA: MHA, two query tiles
    (1, 2, 2, 90, 260, 70),           # window, Sq < Sk
])
def test_k5_bf16_narrow_v_numerics_fit_the_card_tolerance(b, h, g, sq, sk,
                                                          window):
    """The bf16 kernel's rounding at q/k 96, v 64 (kv tiles of 128, P in
    bf16 before the 64-wide ``P V``) stays within the card's tolerance
    of the JAX oracle in fp32 on the same bf16 inputs."""
    arrs = _inputs(sq + sk, (b, h, sq, 96), (b, g, sk, 96), (b, g, sk, 64))
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrs)
    got = _np(_k5_bf16_emulation(q, k, v, True, window))
    jq, jk, jv = (jnp.asarray(_np(t)) for t in (q, k, v))
    want = _np(jref.flash_attention_ref(jq, jk, jv, causal=True,
                                        window=window))
    assert got.shape == want.shape == (b, h, sq, 64)
    assert np.all(np.abs(got - want) <= CARD_BF16_TOL * (1 + np.abs(want)))


def _pieces(x):
    """x in two bf16 pieces: the rounding, and the rounding of the rest."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _k5_bwd_bf16_emulation(q, k, v, out, lse, dout, causal, window, t=64):
    """K5's bf16 backward (``bwd_dq_wgmma``, then ``bwd_dkv_wgmma``) in
    plain PyTorch, one (query tile, kv tile) of 64 rows at a time in the
    kernels' order: fp32 products of the bf16 values, ``P = exp2(S scale
    log2(e) - LSE log2(e))`` from the forward's LSE, Delta from the stored
    output, P and dS in two bf16 pieces as the A operand of the products
    that accumulate dQ, dV and dK in fp32, the tiles a tile cannot see
    skipped, the gradients rounded to bf16.  At D = 256 the dK/dV kernel
    (``bwd_dkv_wgmma2``) is two warpgroups: warpgroup w forms S^T and dP^T
    for q columns [32 w, 32 w + 32) of the tile over all of D, and owns
    columns [128 w, 128 w + 128) of dK and dV, which it sums from the whole
    tile's pieces; an even group's heads split over two blocks, whose fp32
    sums are added at the end."""
    b, h, sq, d = q.shape
    g, sk = k.shape[1], k.shape[2]
    hg, off = h // g, sk - sq
    scale = 1.0 / np.sqrt(d)
    c = LOG2E * scale
    qf, kf, vf, dof = (x.float() for x in (q, k, v, dout))
    kx, vx = kf.repeat_interleave(hg, 1), vf.repeat_interleave(hg, 1)
    l2 = torch.where(lse > float("-inf"), lse * LOG2E,
                     torch.tensor(float("inf")))
    delta = (dof * out.float()).sum(-1)

    def p_ds(rows, cols, s, dp, lr, dr):  # s, dp (..., rows, cols)
        qpos, kpos = rows[:, None] + off, cols[None, :]
        ok = kpos < sk
        if causal:
            ok = ok & (kpos <= qpos)
        if window:
            ok = ok & (kpos > qpos - window)
        p = torch.where(ok, torch.exp2(s * c - lr[..., None]), torch.zeros(()))
        return p, p * (dp - dr[..., None])

    dq = torch.zeros(b, h, sq, d)
    for q0 in range(0, sq, t):  # launch A: a q tile over its kv tiles
        rows = torch.arange(q0, min(q0 + t, sq))
        k_end = min(sk, int(rows[-1]) + off + 1) if causal else sk
        k_begin = max(0, q0 + off - window + 1) if window else 0
        acc = torch.zeros(b, h, len(rows), d)
        for k0 in range(k_begin // t * t, k_end, t):
            cols = torch.arange(k0, min(k0 + t, sk))
            s = qf[:, :, rows] @ kx[:, :, cols].transpose(-1, -2)
            dp = dof[:, :, rows] @ vx[:, :, cols].transpose(-1, -2)
            _p, ds = p_ds(rows, cols, s, dp, l2[:, :, rows], delta[:, :, rows])
            for piece in _pieces(ds):
                acc = acc + piece @ kx[:, :, cols]
        dq[:, :, rows] = acc * scale
    dk, dv = torch.zeros(b, g, sk, d), torch.zeros(b, g, sk, d)
    qg, dog = (x.reshape(b, g, hg, sq, d) for x in (qf, dof))
    lg, dg = (x.reshape(b, g, hg, sq) for x in (l2, delta))
    wgs = 2 if d == 256 else 1  # warpgroups sharing a kv tile
    halves = 2 if d == 256 and hg % 2 == 0 else 1  # blocks sharing it
    for k0 in range(0, sk, t):  # launch B: a kv tile over heads, q tiles
        cols = torch.arange(k0, min(k0 + t, sk))
        i_begin = max(0, k0 - off) if causal else 0
        i_end = min(sq, int(cols[-1]) + window - off) if window else sq
        dka = torch.zeros(halves, b, g, len(cols), d)
        dva = torch.zeros(halves, b, g, len(cols), d)
        for hh in range(hg):
            hs = hh // (hg // halves)
            for i0 in range(i_begin, i_end, t):
                rows = torch.arange(i0, min(i0 + t, sq))
                qt, dot = qg[:, :, hh, rows], dog[:, :, hh, rows]
                # S^T and dP^T by q-column groups of t / wgs
                st = torch.cat([kf[:, :, cols] @ x.transpose(-1, -2) for x in
                                qt.split(t // wgs, dim=2)], -1)
                dpt = torch.cat([vf[:, :, cols] @ x.transpose(-1, -2) for x in
                                 dot.split(t // wgs, dim=2)], -1)
                p, ds = p_ds(rows, cols, st.transpose(-1, -2),
                             dpt.transpose(-1, -2), lg[:, :, hh, rows],
                             dg[:, :, hh, rows])
                for w in range(wgs):  # each warpgroup's columns of dK, dV
                    dc = slice(w * d // wgs, (w + 1) * d // wgs)
                    for piece in _pieces(p.transpose(-1, -2)):
                        dva[hs, ..., dc] += piece @ dot[..., dc]
                    for piece in _pieces(ds.transpose(-1, -2)):
                        dka[hs, ..., dc] += piece @ qt[..., dc]
        dk[:, :, cols] = dka.sum(0) * scale
        dv[:, :, cols] = dva.sum(0)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("b,h,g,sq,sk,d,causal,window", [
    (1, 6, 2, 130, 130, 64, True, None),   # GQA 3:1, a ragged third tile
    (1, 4, 2, 100, 160, 64, True, 40),     # window, Sq < Sk
    (2, 3, 1, 77, 200, 32, True, None),    # MQA, D=32, ragged Sq
    (1, 4, 4, 90, 90, 80, True, None),     # D=80
    (1, 2, 1, 60, 140, 80, False, None),   # non-causal, padded kv tile
    (1, 8, 1, 130, 130, 256, True, None),  # gemma-2b's MQA 8:1, D=256
    (1, 8, 1, 100, 160, 256, True, 40),    # D=256, window, Sq < Sk
])
def test_k5_bwd_bf16_numerics_fit_the_card_tolerance(b, h, g, sq, sk, d,
                                                     causal, window):
    """K5's bf16 backward route (P from the forward's LSE, P and dS in two
    bf16 pieces, fp32 accumulation, a bf16 store) on the bf16 forward's
    output and LSE stays within the card's backward tolerance, 1e-2 (1 +
    |g|), of ``jax.vjp`` of the JAX oracle in fp32 on the same bf16
    inputs."""
    arrs = _inputs(7 * sq + sk + d, (b, h, sq, d), (b, g, sk, d),
                   (b, g, sk, d), (b, h, sq, d))
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in arrs)
    out, lse = _k5_bf16_emulation(q, k, v, causal, window,
                                  bk=128 if d <= 128 else 64, with_lse=True)
    np.testing.assert_allclose(
        lse.numpy(), ref.flash_attention_lse_ref(q, k, causal=causal,
                                                 window=window).numpy(),
        atol=1e-5, rtol=1e-5)
    got = _k5_bwd_bf16_emulation(q, k, v, out, lse, do, causal, window)
    jq, jk, jv, jdo = (jnp.asarray(_np(t)) for t in (q, k, v, do))
    _out, vjp = jax.vjp(lambda a, b_, c: jref.flash_attention_ref(
        a, b_, c, causal=causal, window=window), jq, jk, jv)
    for name, a, w in zip(("dq", "dk", "dv"), got, vjp(jdo)):
        a, w = _np(a), _np(w)
        assert a.shape == w.shape, name
        err = np.abs(a - w) - CARD_BWD_TOL * (1 + np.abs(w))
        assert np.all(err <= 0), (name, float(err.max()))


@pytest.mark.parametrize("b,h,g,sq,sk,d,window", [
    (1, 4, 2, 203, 130, 64, None),   # a q tile wholly empty, one in part
    (1, 2, 1, 150, 40, 32, 16),      # window, Sq > Sk
])
def test_k5_bwd_bf16_numerics_zero_the_rows_that_see_no_key(b, h, g, sq, sk,
                                                            d, window):
    """Causal with Sq > Sk: the first Sq - Sk query rows see no key.  K5's
    bf16 route writes their LSE -inf and output 0; its backward gives them
    dq 0 and takes nothing from them into dk and dv, so its gradients
    equal, within 1e-2 (1 + |g|), ``jax.vjp`` of the oracle over the other
    rows alone (the oracle is NaN in an empty row)."""
    e = sq - sk
    arrs = _inputs(5 * sq + sk + d, (b, h, sq, d), (b, g, sk, d),
                   (b, g, sk, d), (b, h, sq, d))
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in arrs)
    out, lse = _k5_bf16_emulation(q, k, v, True, window, with_lse=True)
    assert bool(torch.isneginf(lse[:, :, :e]).all())
    assert not bool(torch.isneginf(lse[:, :, e:]).any())
    assert not bool(out[:, :, :e].any())
    got = _k5_bwd_bf16_emulation(q, k, v, out, lse, do, True, window)
    assert not bool(got[0][:, :, :e].any())
    jq, jk, jv, jdo = (jnp.asarray(_np(t)) for t in (q[:, :, e:], k, v,
                                                       do[:, :, e:]))
    _out, vjp = jax.vjp(lambda a, b_, c: jref.flash_attention_ref(
        a, b_, c, causal=True, window=window), jq, jk, jv)
    for name, a, w in zip(("dq", "dk", "dv"),
                          (got[0][:, :, e:], *got[1:]), vjp(jdo)):
        a, w = _np(a), _np(w)
        assert a.shape == w.shape, name
        err = np.abs(a - w) - CARD_BWD_TOL * (1 + np.abs(w))
        assert np.all(err <= 0), (name, float(err.max()))


# ---------------------------------------------------------------------------
# K6 decode_attention


@pytest.mark.parametrize("b,h,g,s,d", [
    (2, 4, 4, 256, 64),      # MHA
    (3, 15, 5, 300, 64),     # smollm's heads, ragged cache
    (2, 8, 1, 200, 256),     # gemma-2b's MQA and head dim
    (1, 6, 2, 777, 32),
    (2, 4, 4, 170, 80),      # zamba2's shared attention: MHA, D=80
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_oracle_and_pallas(b, h, g, s, d, dtype):
    arrs = _inputs(s + h, (b, h, d), (b, g, s, d), (b, g, s, d))
    (q, k, v), (jq, jk, jv) = _both(arrs, dtype)
    tol = DTYPES[dtype][2]
    length = np.random.default_rng(s).integers(1, s + 1, b).astype(np.int32)
    length[0] = s
    for window in (None, 48):
        before = ops.launch_counts()["decode_attention"]
        got = _np(decode_attention(q, k, v, length=torch.from_numpy(length),
                                   window=window))
        assert ops.launch_counts()["decode_attention"] == before
        jl = jnp.asarray(length)
        orc = _np(jref.decode_attention_ref(jq, jk, jv, length=jl,
                                            window=window))
        np.testing.assert_allclose(got, orc, atol=tol, rtol=tol)
        pal = _np(j_decode(jq, jk, jv, length=jl, window=window, block_k=128,
                           interpret=True))
        np.testing.assert_allclose(got, pal, atol=tol, rtol=tol)


def test_decode_attention_full_cache_and_ops_entry():
    arrs = _inputs(11, (2, 4, 32), (2, 2, 100, 32), (2, 2, 100, 32))
    (q, k, v), (jq, jk, jv) = _both(arrs, "float32")
    got = _np(decode_attention(q, k, v))
    orc = _np(jref.decode_attention_ref(jq, jk, jv))
    np.testing.assert_allclose(got, orc, atol=FP32_TOL, rtol=FP32_TOL)
    with pytest.raises(ValueError):
        decode_attention(q, k, v, length=torch.ones(3, dtype=torch.int32))


def test_decode_is_the_last_row_of_flash():
    """K6 at length L equals K5's last query row over the first L keys."""
    arrs = _inputs(5, (1, 6, 1, 64), (1, 2, 90, 64), (1, 2, 90, 64))
    q, k, v = (torch.from_numpy(a) for a in arrs)
    for n in (1, 17, 90):
        dec = decode_attention(q[:, :, 0], k, v,
                               length=torch.tensor([n], dtype=torch.int32))
        fl = flash_attention(q, k[:, :, :n], v[:, :, :n], causal=True)
        np.testing.assert_allclose(dec.numpy(), fl[:, :, 0].numpy(),
                                   atol=FP32_TOL, rtol=FP32_TOL)


@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("b,g,hg,s,d", [(16, 5, 3, 1064, 64), (16, 32, 1, 1064, 80),
                                        (1, 1, 1, 100_000, 64), (2, 1, 15, 700, 256),
                                        (1, 1, 8, 7, 256), (128, 8, 2, 33, 32)])
def test_decode_launch_shape(b, g, hg, s, d, sms):
    chunk, nch, warps = launch_shape(b, g, hg, s, d, sms)
    assert (nch - 1) * chunk < s <= nch * chunk and nch <= MAX_CHUNKS
    assert warps in (4, 8)
    if heads_per_block(hg) > 4:
        assert warps == 4   # 8 heads a block: the registers of 128 threads


def test_decode_launch_shape_at_the_serve_shapes():
    # smollm-360m: 80 (sequence, kv group) blocks, one chunk, 8 warps each;
    # zamba2-2.7b: 512 blocks of 4 warps
    assert launch_shape(16, 5, 3, 1064, 64, 132)[1:] == (1, 8)
    assert launch_shape(16, 32, 1, 1064, 80, 132)[1:] == (1, 4)


@pytest.mark.parametrize("target", [228, 264])   # two waves of 114 / 132 SMs
@pytest.mark.parametrize("b,g,s,d", [(16, 5, 1064, 64), (1, 1, 7, 256),
                                     (4, 1, 5000, 256), (128, 8, 33, 32),
                                     (16, 32, 1064, 80), (1, 1, 100_000, 64)])
def test_decode_chunking_covers_the_cache(b, g, s, d, target):
    chunk, nch = chunking(b, g, s, d, target)
    tile = {32: 128, 64: 64, 80: 48, 128: 32, 256: 16}[d]
    assert TILE_ROWS[d] == tile
    assert chunk % tile == 0 and chunk > 0
    assert (nch - 1) * chunk < s <= nch * chunk
    assert nch <= MAX_CHUNKS
