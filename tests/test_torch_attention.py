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

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.flash_attention import flash_attention as j_flash

from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import chunking, decode_attention
from repro_torch.kernels.flash_attention import (
    HEAD_DIMS, check_kernel_args, flash_attention,
)

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


@pytest.mark.parametrize("target", [228, 264])   # two waves of 114 / 132 SMs
@pytest.mark.parametrize("b,g,s,d", [(16, 5, 1064, 64), (1, 1, 7, 256),
                                     (4, 1, 5000, 256), (128, 8, 33, 32)])
def test_decode_chunking_covers_the_cache(b, g, s, d, target):
    chunk, nch = chunking(b, g, s, d, target)
    tile = {32: 64, 64: 64, 128: 64, 256: 32}[d]
    assert chunk % tile == 0 and chunk > 0
    assert (nch - 1) * chunk < s <= nch * chunk
