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

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (
    MAX_CHUNKS, MMA_WARPS, SLICE_ROWS, TILE_ROWS, chunking, decode_attention,
    decode_route, heads_per_block, launch_shape, mma_launch_shape,
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


@pytest.mark.parametrize("b,h,g,sq,d,dv,grid,by_head", [
    (16, 40, 40, 1000, 96, 64, 132, True),   # minicpm3-4b's prefill (MLA)
    (8, 40, 40, 1024, 96, 64, 132, True),    # its training shape
    (16, 32, 32, 1000, 80, 80, 132, True),   # zamba2-2.7b's prefill
    (8, 16, 16, 1024, 128, 128, 132, True),  # deepseek-moe-16b's training
    (8, 8, 1, 1024, 256, 256, 132, True),    # gemma-2b's: 3.9 rounds
    (5, 40, 40, 1100, 96, 64, 132, True),    # n_qt 9, a reversed partial round
    (3, 40, 40, 1000, 96, 64, 132, False),   # K, V 38 MB: in L2
    (16, 15, 5, 1000, 64, 64, 132, False),   # smollm-360m's: K, V in L2
    (8, 64, 8, 1024, 128, 128, 132, False),  # chameleon-34b's: 33.5 MB
    (1, 4, 4, 129, 96, 64, 5, True),         # a ragged last query tile
])
def test_k5_work_order_covers_each_tile_once_and_balances_the_blocks(
        b, h, g, sq, d, dv, grid, by_head):
    """The bf16 forward's work order (``work_tiles``, the mirror of
    ``flash_fwd_wgmma``'s and its launcher's): every (b h, query tile)
    exactly once, in either order; the head order where K and V outgrow
    the 50 MB L2 or the tiles make under four rounds, its blocks' tiles
    head by head (the n-th in round n: the blocks in flight hold about
    grid / n_qt heads); and wherever the grid is a multiple of n_qt / 2
    (132 blocks at n_qt = 8), a block's tiles of two full rounds 2m and
    2m + 1 read n_qt + 1 kv tiles of 128 rows together (causal: query
    tiles i and n_qt - 1 - i), so that no block reads more than n_qt such
    tiles more than the mean."""
    n_qt = -(-sq // fa.WORK_ROWS)
    got_by_head, order = fa.work_tiles(b, h, g, sq, sq, d, dv, grid)
    assert got_by_head == by_head
    seen = [(bh, q0) for mine in order for bh, q0, _n in mine]
    assert sorted(seen) == [(bh, q * fa.WORK_ROWS) for bh in range(b * h)
                            for q in range(n_qt)]
    if not by_head:
        return
    for mine in order:
        for n, (bh, _q0, _k) in enumerate(mine):
            assert n * grid <= bh * n_qt + n_qt - 1
            assert bh * n_qt < (n + 1) * grid
    per_tile = fa.WORK_ROWS // (128 if d <= 128 else 64)
    loads = [sum(k for _bh, _q0, k in mine) for mine in order]
    if (2 * grid) % n_qt == 0:
        full_rounds = b * h * n_qt // grid
        for mine in order:
            for n in range(0, min(len(mine), full_rounds) - 1, 2):
                assert mine[n][2] + mine[n + 1][2] == (n_qt + 1) * per_tile
        assert max(loads) <= sum(loads) / grid + n_qt * per_tile


@pytest.mark.parametrize("dtype,d,dv,route", [
    (torch.bfloat16, 256, 256, "split"),   # gemma-2b
    (torch.bfloat16, 128, 128, "split"),   # chameleon-34b, mixtral-8x22b,
                                           # deepseek-moe-16b
    (torch.bfloat16, 64, 64, "wgmma"),     # smollm-360m, musicgen-large
    (torch.bfloat16, 80, 80, "wgmma"),     # zamba2-2.7b
    (torch.bfloat16, 96, 64, "wgmma"),     # minicpm3-4b (MLA)
    (torch.bfloat16, 32, 32, "wgmma"),
    (torch.float32, 256, 256, "simt"),
    (torch.float32, 128, 128, "simt"),
    (torch.float32, 64, 64, "simt"),
])
def test_k5_forward_route_follows_dtype_and_head_dim(dtype, d, dv, route):
    """``fwd_route`` (the mirror of ``flash_by_dim``): the split route takes
    bf16 at head dims 128 and 256, the one-block wgmma route every other
    bf16 call, the CUDA cores fp32."""
    assert fa.fwd_route(dtype, d, dv) == route


@pytest.mark.parametrize("tiles", [
    [8],                       # one work tile of a causal row of 128-row tiles
    [16, 1, 9, 2],             # gemma-2b's: query tiles paired by the snake
    [4, 5, 6, 7, 8],           # chameleon-34b's: the stride order
    [1, 1, 1, 3],              # short work tiles: the ring runs across them
    [0, 5, 0, 2],              # query tiles that see no key
])
def test_k5_split_ring_loads_every_k_a_step_ahead(tiles):
    """``ring_lead`` (the mirror of the forward's barriers): in a ring of 2
    stages (head dim 256) the one-block route loads the K of a work tile's
    third and later kv tiles only once it is due (the stage it reuses frees
    at the end of the step before), so its load stalls the consumers; the
    split route, freeing
    each K a step before its stage's V, loads every K and V at least one
    consumer step ahead past the block's first stage, as the one-block
    route's ring of 3 (head dim 128) does, which the split route's ring of
    3 takes to two steps for K."""
    n = sum(tiles)
    one2, split2 = fa.ring_lead(tiles, 2, False), fa.ring_lead(tiles, 2, True)
    one3, split3 = fa.ring_lead(tiles, 3, False), fa.ring_lead(tiles, 3, True)
    assert len(one2) == len(split2) == len(one3) == len(split3) == n
    j = 0
    for m in tiles:  # one-block, ring of 2: a work tile's K past its second
        assert all(one2[j + i][0] == 0 for i in range(2, m))
        j += m
    for lead in (one2, split2, one3, split3):
        assert all(v >= 1 for _k, v in lead)
    assert all(k >= 1 for k, _v in split2[1:])
    assert all(k >= 1 for k, _v in one3[1:])
    assert all(k >= min(2, j) for j, (k, _v) in enumerate(split3))
    for a, b in zip(split2, one2):  # never later than the one-block route
        assert a[0] >= b[0] and a[1] >= b[1]


@pytest.mark.parametrize("b,h,g,sq,sk,grid,causal,window", [
    (8, 8, 1, 1024, 1024, 132, True, None),  # gemma-2b's training shape
    (1, 3, 1, 190, 190, 132, True, None),    # an odd group: no head split
    (1, 8, 1, 203, 130, 5, True, None),      # Sq > Sk, rounds past the grid
    (2, 8, 2, 300, 517, 7, True, 100),       # GQA 4:1, window, ragged
    (2, 4, 1, 200, 200, 132, False, None),   # non-causal
])
def test_k5_bwd_256_work_order_covers_each_tile_once_and_balances_the_blocks(
        b, h, g, sq, sk, grid, causal, window):
    """The bf16 backward's work items at head dim 256 (``bwd256_items``,
    the mirror of ``bwd_dq_wgmma256``'s and ``bwd_dkv_wgmma256``'s): dQ
    covers every (b h, 128-row query block) exactly once and dK/dV every
    (64-row kv tile, head), a dK/dV item's heads all of its group (half of
    them when the group is even); causal items (no window) run longest
    first; and at gemma-2b's shape the snake order gives no block more
    than 5 % above the mean load (32-row kv stages in dQ, tile pairs in
    dK/dV)."""
    n_qb, n_kt, hg = -(-sq // 128), -(-sk // 64), h // g
    dq, dkv = fa.bwd256_items(b, h, g, sq, sk, grid, causal, window)
    assert len(dq) <= grid and len(dkv) <= grid
    seen = sorted((bh, q0) for mine in dq for bh, q0, _n in mine)
    assert seen == [(bh, q * 128) for bh in range(b * h)
                    for q in range(n_qb)]
    seen = sorted((kt, hd) for mine in dkv for _bg, kt, h0, nh, _n in mine
                  for hd in range(h0, h0 + nh))
    assert seen == sorted((kt, bh) for kt in range(n_kt)
                          for bh in range(b * h))
    for mine in dkv:
        for bg, _kt, h0, nh, _n in mine:
            assert nh == (hg // 2 if hg % 2 == 0 else hg)
            assert all(hd // h == bg // g and hd % h // hg == bg % g
                       for hd in range(h0, h0 + nh))
    if causal and not window:  # items (by their place in the walk)
        # run longest first
        for blocks, size in ((dq, lambda it: it[2]),
                             (dkv, lambda it: it[3] * it[4])):
            by_item = {}
            for x, mine in enumerate(blocks):
                for n, it in enumerate(mine):
                    by_item[n * grid + (grid - 1 - x if n & 1 else x)] = it
            sizes = [size(by_item[i]) for i in sorted(by_item)]
            assert sizes == sorted(sizes, reverse=True)
    if (b, h, g, sq, sk, grid) == (8, 8, 1, 1024, 1024, 132):
        for loads in ([sum(n for *_x, n in mine) for mine in dq],
                      [sum(nh * n for *_x, nh, n in mine) for mine in dkv]):
            assert max(loads) <= 1.05 * sum(loads) / grid


def _pieces(x):
    """x in two bf16 pieces: the rounding, and the rounding of the rest."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _k5_bwd_bf16_emulation(q, k, v, out, lse, dout, causal, window, t=64):
    """K5's bf16 backward (a dQ launch, then a dK/dV launch) in plain
    PyTorch, one (query tile, kv tile) of 64 rows at a time in the
    kernels' order: fp32 products of the bf16 values, ``P = exp2(S scale
    log2(e) - LSE log2(e))`` from the forward's LSE, Delta from the stored
    output, P and dS in two bf16 pieces as the A operand of the products
    that accumulate dQ, dV and dK in fp32, the tiles a tile cannot see
    skipped, the gradients rounded to bf16.  At D = 80 and 128 and at
    MLA's q/k 96 with v 64 (the pair route: ``bwd_dq_wgmma_pair``,
    ``bwd_dkv_wgmma_pair``; dQ and dK 96 wide, dV, Delta 64) an item is a
    block of 128 rows (q rows for dQ, kv rows for dK/dV) whose warpgroups
    own 64 each: both walk the tiles the block streams (the kv tiles any of
    the block's q rows sees; the q tiles of 64 from the block's first
    visible q row, per head), and each skips those its own rows cannot
    see, its sums starting at its first visible tile and ending at its
    last; elsewhere an item is 64 rows.  At D = 256 (``bwd_dq_wgmma256``,
    ``bwd_dkv_wgmma256``) dQ walks as the pair route does, 128-row items
    of two warpgroups, over kv stages of 32 rows; dK/dV splits a 64-row
    kv tile's work by role over two warpgroups: warpgroup 0 forms S^T and
    P^T of the whole tile and sums dV, and hands P^T to warpgroup 1 in
    fp32 (no rounding), which forms dP^T and dS^T and sums dK; an even
    group's heads split over the two blocks of a kv tile (the first and
    the second half of them), and the second block to finish adds the
    first one's fp32 sums to its own before the scale and the bf16
    store."""
    b, h, sq, d = q.shape
    g, sk, dv = k.shape[1], k.shape[2], v.shape[-1]
    hg, off = h // g, sk - sq
    scale = 1.0 / np.sqrt(d)
    c = LOG2E * scale
    qf, kf, vf, dof = (x.float() for x in (q, k, v, dout))
    kx, vx = kf.repeat_interleave(hg, 1), vf.repeat_interleave(hg, 1)
    l2 = torch.where(lse > float("-inf"), lse * LOG2E,
                     torch.tensor(float("inf")))
    delta = (dof * out.float()).sum(-1)
    pair_route = (d, dv) in ((80, 80), (128, 128), (96, 64))
    item = 2 * t if pair_route else t  # rows of an item
    q_item = 2 * t if d == 256 else item  # dQ's
    kr = t // 2 if d == 256 else t  # kv rows of a dQ stage

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
    for qb in range(0, sq, q_item):  # launch A: a q block over its kv tiles
        last = min(qb + q_item, sq) - 1
        k_end_b = min(sk, last + off + 1) if causal else sk
        k_begin_b = max(0, qb + off - window + 1) if window else 0
        for q0 in range(qb, last + 1, t):  # each warpgroup's q rows
            rows = torch.arange(q0, min(q0 + t, sq))
            k_end = min(sk, int(rows[-1]) + off + 1) if causal else sk
            k_begin = max(0, q0 + off - window + 1) if window else 0
            acc = torch.zeros(b, h, len(rows), d)
            for k0 in range(k_begin_b // kr * kr, k_end_b, kr):
                if not (k0 < k_end and k0 + kr > k_begin):
                    continue  # this warpgroup's rows see none of the tile
                cols = torch.arange(k0, min(k0 + kr, sk))
                s = qf[:, :, rows] @ kx[:, :, cols].transpose(-1, -2)
                dp = dof[:, :, rows] @ vx[:, :, cols].transpose(-1, -2)
                _p, ds = p_ds(rows, cols, s, dp, l2[:, :, rows],
                              delta[:, :, rows])
                for piece in _pieces(ds):
                    acc = acc + piece @ kx[:, :, cols]
            dq[:, :, rows] = acc * scale
    dk, dvs = torch.zeros(b, g, sk, d), torch.zeros(b, g, sk, dv)
    qg = qf.reshape(b, g, hg, sq, d)
    dog = dof.reshape(b, g, hg, sq, dv)
    lg, dg = (x.reshape(b, g, hg, sq) for x in (l2, delta))
    halves = 2 if d == 256 and hg % 2 == 0 else 1  # blocks sharing a tile
    for kb in range(0, sk, item):  # launch B: a kv block over heads, q tiles
        kmax = min(kb + item, sk) - 1
        i_begin_b = max(0, kb - off) if causal else 0
        i_end_b = min(sq, kmax + window - off) if window else sq
        for k0 in range(kb, kmax + 1, t):  # each warpgroup's kv rows
            cols = torch.arange(k0, min(k0 + t, sk))
            i_begin = max(0, k0 - off) if causal else 0
            i_end = min(sq, int(cols[-1]) + window - off) if window else sq
            dka = torch.zeros(halves, b, g, len(cols), d)
            dva = torch.zeros(halves, b, g, len(cols), dv)
            for hh in range(hg):
                hs = hh // (hg // halves)
                for i0 in range(i_begin_b, i_end_b, t):
                    if not (i0 < i_end and i0 + t > i_begin):
                        continue  # no row of the tile sees these kv rows
                    rows = torch.arange(i0, min(i0 + t, sq))
                    qt, dot = qg[:, :, hh, rows], dog[:, :, hh, rows]
                    st = kf[:, :, cols] @ qt.transpose(-1, -2)    # S^T
                    dpt = vf[:, :, cols] @ dot.transpose(-1, -2)  # dP^T
                    p, ds = p_ds(rows, cols, st.transpose(-1, -2),
                                 dpt.transpose(-1, -2), lg[:, :, hh, rows],
                                 dg[:, :, hh, rows])
                    for piece in _pieces(p.transpose(-1, -2)):
                        dva[hs] += piece @ dot
                    for piece in _pieces(ds.transpose(-1, -2)):
                        dka[hs] += piece @ qt
            # a kv tile's two blocks: the second adds the first's fp32 sums
            dk[:, :, cols] = (dka[0] + dka[-1] if halves == 2
                              else dka[0]) * scale
            dvs[:, :, cols] = dva[0] + dva[-1] if halves == 2 else dva[0]
    return dq.bfloat16(), dk.bfloat16(), dvs.bfloat16()


@pytest.mark.parametrize("b,h,g,sq,sk,d,causal,window", [
    (1, 6, 2, 130, 130, 64, True, None),   # GQA 3:1, a ragged third tile
    (1, 4, 2, 100, 160, 64, True, 40),     # window, Sq < Sk
    (2, 3, 1, 77, 200, 32, True, None),    # MQA, D=32, ragged Sq
    (1, 4, 4, 90, 90, 80, True, None),     # D=80
    (1, 2, 1, 60, 140, 80, False, None),   # non-causal, padded kv tile
    (1, 4, 4, 170, 230, 80, True, None),   # D=80: two kv blocks, ragged
    (1, 8, 1, 200, 200, 128, True, None),  # chameleon-34b's GQA 8:1
    (1, 4, 4, 300, 300, 128, True, 100),   # D=128: MHA, window
    (1, 8, 1, 130, 130, 256, True, None),  # gemma-2b's MQA 8:1, D=256
    (1, 8, 1, 100, 160, 256, True, 40),    # D=256, window, Sq < Sk
    (1, 3, 1, 190, 190, 256, True, None),  # D=256, an odd group: no split
    (1, 4, 4, 256, 256, (96, 64), True, None),  # MLA: MHA, two kv blocks
    (1, 4, 4, 200, 200, (96, 64), True, 70),    # MLA: ragged Sq, window
    (1, 2, 2, 100, 230, (96, 64), True, None),  # MLA: Sq < Sk
])
def test_k5_bwd_bf16_numerics_fit_the_card_tolerance(b, h, g, sq, sk, d,
                                                     causal, window):
    """K5's bf16 backward route (P from the forward's LSE, P and dS in two
    bf16 pieces, fp32 accumulation, a bf16 store) on the bf16 forward's
    output and LSE stays within the card's backward tolerance, 1e-2 (1 +
    |g|), of ``jax.vjp`` of the JAX oracle in fp32 on the same bf16
    inputs.  ``d`` is a (q/k, v) pair at MLA's narrow v."""
    d, dv = d if isinstance(d, tuple) else (d, d)
    arrs = _inputs(7 * sq + sk + d, (b, h, sq, d), (b, g, sk, d),
                   (b, g, sk, dv), (b, h, sq, dv))
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
    (1, 8, 1, 203, 130, 128, None),  # D=128: a warpgroup's rows all empty
    (1, 4, 4, 260, 190, 80, 50),     # D=80: window, Sq > Sk
    (1, 4, 4, 230, 100, (96, 64), None),  # MLA: a q block wholly empty
    (1, 8, 1, 203, 130, 256, None),  # D=256: a q tile wholly empty
])
def test_k5_bwd_bf16_numerics_zero_the_rows_that_see_no_key(b, h, g, sq, sk,
                                                            d, window):
    """Causal with Sq > Sk: the first Sq - Sk query rows see no key.  K5's
    bf16 route writes their LSE -inf and output 0; its backward gives them
    dq 0 and takes nothing from them into dk and dv, so its gradients
    equal, within 1e-2 (1 + |g|), ``jax.vjp`` of the oracle over the other
    rows alone (the oracle is NaN in an empty row).  ``d`` is a (q/k, v)
    pair at MLA's narrow v."""
    d, dv = d if isinstance(d, tuple) else (d, d)
    e = sq - sk
    arrs = _inputs(5 * sq + sk + d, (b, h, sq, d), (b, g, sk, d),
                   (b, g, sk, dv), (b, h, sq, dv))
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
    """The ring's launch (fp32 at every shape, bf16 off the tensor-core
    route) and, where bf16 takes it, the tensor-core route's."""
    chunk, nch, warps = launch_shape(b, g, hg, s, d, sms)
    assert (nch - 1) * chunk < s <= nch * chunk and nch <= MAX_CHUNKS
    assert warps in (4, 8)
    if heads_per_block(hg) > 4:
        assert warps == 4   # 8 heads a block: the registers of 128 threads
    if decode_route(torch.bfloat16, d, hg) == "mma":
        chunk, nch = mma_launch_shape(b, g, s, d, sms)
        assert chunk % SLICE_ROWS == 0
        assert (nch - 1) * chunk < s <= nch * chunk and nch <= MAX_CHUNKS


def test_decode_launch_shape_at_the_serve_shapes():
    # smollm-360m: 80 (sequence, kv group) blocks, one chunk, 8 warps each;
    # zamba2-2.7b: 512 blocks of 4 warps (both on the ring)
    assert launch_shape(16, 5, 3, 1064, 64, 132)[1:] == (1, 8)
    assert launch_shape(16, 32, 1, 1064, 80, 132)[1:] == (1, 4)
    # the tensor-core route, one wave: gemma-2b 16 caches x 8 chunks of
    # 144 rows; chameleon-34b and mixtral-8x22b 128 (sequence, group) pairs
    # of one chunk
    assert mma_launch_shape(16, 1, 1064, 256, 132) == (144, 8)
    assert mma_launch_shape(16, 8, 1064, 128, 132) == (1072, 1)


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


def _k6_bf16_emulation(q, k, v, length, window, sms):
    """K6's tensor-core route in plain PyTorch, as the card runs it at
    ``mma_launch_shape(.., sms)``: per chunk, each of its warps takes the
    16-row slices ``w, w + warps, ...``: fp32 scores of the bf16 inputs
    (``scale * log2(e)`` folded, ``exp2``), rows past the chunk's visible
    end masked, the running max, P rounded to bf16 per slice before ``P
    V``, fp32 ``(m, l, acc)``; the warps' partials merged, then the
    chunks' (the fp32 combine), the output rounded to bf16."""
    b, h, d = q.shape
    g, s = k.shape[1], k.shape[2]
    hg = h // g
    (chunk, nch), warps = mma_launch_shape(b, g, s, d, sms), MMA_WARPS
    c = LOG2E / np.sqrt(d)

    def merge(parts):
        ms = torch.stack([m for m, _l, _a in parts])
        ls = torch.stack([l for _m, l, _a in parts])
        accs = torch.stack([a for _m, _l, a in parts])
        big = torch.where(ls > 0, ms, torch.tensor(-1e30)).amax(0)
        w = torch.where(ls > 0, torch.exp2(ms - big), torch.zeros(()))
        return big, (ls * w).sum(0), (accs * w[..., None]).sum(0)

    out = torch.zeros(b, h, d)
    for bi in range(b):
        n = min(int(length[bi]), s)
        lo = max(0, n - window) if window else 0
        for gi in range(g):
            qf = q[bi, gi * hg:(gi + 1) * hg].float()
            kf, vf = k[bi, gi].float(), v[bi, gi].float()
            chunks = []
            for ci in range(nch):
                c1, start = min((ci + 1) * chunk, s, n), max(ci * chunk, lo)
                if start >= c1:
                    continue  # an empty chunk: weight 0
                slices = -(-(c1 - start) // SLICE_ROWS)
                per_warp = []
                for w in range(warps):
                    m = torch.full((hg,), -1e30)
                    l = torch.zeros(hg)
                    acc = torch.zeros(hg, d)
                    for si in range(w, slices, warps):
                        rows = torch.arange(start + SLICE_ROWS * si,
                                            start + SLICE_ROWS * (si + 1))
                        ok = rows < c1
                        rows = rows.clamp(max=s - 1)
                        sc = (kf[rows] @ qf.T * c).masked_fill(
                            ~ok[:, None], float("-inf"))
                        m_new = torch.maximum(m, sc.amax(0))
                        p = torch.exp2(sc - m_new)
                        a = torch.exp2(m - m_new)
                        l = l * a + p.sum(0)
                        acc = acc * a[:, None] + p.bfloat16().float().T @ vf[rows]
                        m = m_new
                    per_warp.append((m, l, acc))
                chunks.append(merge(per_warp))
            if chunks:
                _m, l, acc = merge(chunks)
                out[bi, gi * hg:(gi + 1) * hg] = torch.where(
                    l[:, None] > 0, acc / l.clamp_min(1e-30)[:, None],
                    torch.zeros(()))
    return out.bfloat16()


@pytest.mark.parametrize("b,h,g,s,d,lengths,window", [
    (2, 8, 1, 300, 256, None, None),          # gemma-2b's group and head dim
    (2, 16, 2, 200, 128, None, None),         # H/G = 8 at 128 (chameleon-34b)
    (2, 12, 2, 170, 128, None, None),         # H/G = 6 (mixtral-8x22b)
    (4, 8, 1, 300, 256, [1, 16, 37, 300], None),   # ragged: 1, a slice, S
    (4, 12, 2, 170, 128, [1, 16, 37, 170], 50),    # a window, mid-slice ends
    (3, 8, 1, 7, 256, None, None),            # a cache under one slice
])
@pytest.mark.parametrize("sms", [132, 4])     # one slice a chunk; warps merge
def test_k6_bf16_numerics_fit_the_card_tolerance(b, h, g, s, d, lengths,
                                                 window, sms):
    """The tensor-core route's rounding (P in bf16 per 16-row slice
    against its warp's running max, the chunks and warps merged in fp32)
    stays within the tolerance the card holds K6 to, against the JAX
    oracle and the Pallas kernel in interpret mode, in fp32 on the same
    bf16 inputs."""
    assert decode_route(torch.bfloat16, d, h // g) == "mma"
    arrs = _inputs(s + h + d, (b, h, d), (b, g, s, d), (b, g, s, d))
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrs)
    length = (np.asarray(lengths, np.int32) if lengths else
              np.random.default_rng(s).integers(1, s + 1, b).astype(np.int32))
    got = _np(_k6_bf16_emulation(q, k, v, length, window, sms))
    jq, jk, jv = (jnp.asarray(_np(t)) for t in (q, k, v))
    jl = jnp.asarray(length)
    for want in (jref.decode_attention_ref(jq, jk, jv, length=jl, window=window),
                 j_decode(jq, jk, jv, length=jl, window=window, block_k=128,
                          interpret=True)):
        want = _np(want)
        assert np.all(np.abs(got - want) <= CARD_BF16_TOL * (1 + np.abs(want)))


def _c_route():
    """``decode_mma_route``'s condition in ``csrc/attention.cu`` as a
    Python expression of ``dtype``, ``D`` and ``hg``; checks on the way
    that the kernel runs ``MMA_WARPS`` warps a block."""
    import re
    from pathlib import Path

    src = (Path(fa.__file__).parent.parent / "csrc" / "attention.cu").read_text()
    body = re.search(r"constexpr bool decode_mma_route\(int dtype, int D, int hg\)"
                     r" \{\s*return (.*?);\s*\}", src, re.S).group(1)
    heads = re.search(r"constexpr int DM_HEADS = (\d+);", src).group(1)
    warps = re.search(r"constexpr int DM_WARPS = (\d+);", src).group(1)
    assert int(warps) == MMA_WARPS
    return (body.replace("&&", " and ").replace("||", " or ")
            .replace("DM_HEADS", heads))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k6_route_follows_the_cuda_entry(dtype):
    """``decode_route`` names the kernel the CUDA entry picks
    (``decode_mma_route``) at every built head dim and group size; fp32
    never takes the tensor-core route."""
    cond = _c_route()
    for d in HEAD_DIMS:
        for hg in range(1, 17):
            want = eval(cond, {}, {"dtype": 1 if dtype == torch.bfloat16 else 0,
                                   "D": d, "hg": hg})
            assert (decode_route(dtype, d, hg) == "mma") == want, (d, hg)
            if dtype == torch.float32:
                assert decode_route(dtype, d, hg) == "ring"
    assert decode_route(torch.bfloat16, 256, 8) == "mma"    # gemma-2b
    assert decode_route(torch.bfloat16, 128, 6) == "mma"    # mixtral-8x22b
    assert decode_route(torch.bfloat16, 64, 3) == "ring"    # smollm-360m


@pytest.mark.parametrize("sms", [114, 132, 16])
@pytest.mark.parametrize("b,g,s,d", [(16, 1, 1064, 256), (16, 8, 1064, 128),
                                     (1, 1, 100_000, 256), (3, 1, 7, 256),
                                     (40, 8, 300, 128), (2, 2, 2049, 128)])
def test_k6_mma_grid_covers_every_row_once(b, g, s, d, sms):
    """The tensor-core route's chunks, and the warps' 16-row slices in
    them, cover every cache row once; at most ``MAX_CHUNKS`` chunks."""
    (chunk, nch), warps = mma_launch_shape(b, g, s, d, sms), MMA_WARPS
    assert nch <= MAX_CHUNKS and chunk % SLICE_ROWS == 0
    seen = np.zeros(s, np.int64)
    for ci in range(nch):
        start, c1 = ci * chunk, min((ci + 1) * chunk, s)
        slices = -(-(c1 - start) // SLICE_ROWS)
        for w in range(warps):
            for si in range(w, slices, warps):
                r0 = start + SLICE_ROWS * si
                seen[r0:min(r0 + SLICE_ROWS, c1)] += 1
    assert np.all(seen == 1)


@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("b,g,s,d", [(16, 1, 1064, 256), (16, 8, 1064, 128),
                                     (2, 2, 2049, 128), (1, 1, 100_000, 256)])
def test_k6_mma_grid_fills_the_card_in_one_wave(b, g, s, d, sms):
    """The tensor-core route's grid is one wave of one block an SM, more
    than half full (whole slices a chunk round the split down): at
    gemma-2b's decode (16 caches of one kv group) 112 / 128 blocks on 114
    / 132 SMs, where the ring aimed for half of them (64 / 80)."""
    chunk, nch = mma_launch_shape(b, g, s, d, sms)
    slices = -(-s // SLICE_ROWS)
    assert b * g * nch <= max(sms, b * g)   # one chunk when the pairs overflow
    assert 2 * b * g * nch > min(sms, b * g * slices)
    if (b, g, s, d) == (16, 1, 1064, 256):
        assert 16 * nch >= sms - 16
        ring = 16 * launch_shape(16, 1, 8, 1064, 256, sms)[1]
        assert ring == {114: 64, 132: 80}[sms] < 16 * nch
