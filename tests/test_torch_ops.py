"""The port's kernel API (``repro_torch.kernels.ops``) and its codec kernels
K9 (single-buffer byteshuffle) and K10 (delta + zigzag) against the JAX
package's, on the CPU.

* K9's and K10's plain versions — what their wrappers run on a CPU
  tensor — against the Pallas kernels in interpret mode, the jnp oracles
  and the numpy host encoders, exactly, at the integer extremes too.
* Each of the nine op entries against the ``repro.kernels.ops`` entry of
  the same name on the same numpy inputs, made from a seed, at the
  shapes of the reference's own sweep (``tests/test_kernels.py``): the
  same dtype and shape, exact for the codec ops, within 1e-5 for
  attention and the scans in fp32.
* The new oracles ``flash_attention_chunked``, ``rwkv6_decode_ref`` and
  ``mamba2_decode_ref`` against their jnp twins, and the models'
  one-token recurrence steps against the decode oracles, within 1e-5.
* Launch counts and refusals.

The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro.core import encoding as E
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.byteshuffle import byteshuffle as j_byteshuffle
from repro.kernels.byteshuffle import byteshuffle_host as j_byteshuffle_host
from repro.kernels.delta_zigzag import delta_zigzag as j_delta_zigzag

from repro_torch.configs import smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.byteshuffle import byteshuffle, byteshuffle_host
from repro_torch.kernels.delta_zigzag import delta_zigzag
from repro_torch.models.mamba2 import ssd_step
from repro_torch.models.rwkv6 import wkv_step

# six test workers share the cores: one thread each, not one per core
torch.set_num_threads(max(1, os.cpu_count() // 6))

FP32_TOL = 1e-5


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want):
    """Exact: the same dtype, shape and values."""
    g, w = _np(got), _np(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, g.shape,
                                                        w.dtype, w.shape)
    np.testing.assert_array_equal(g, w)


def _close(got, want, tol=FP32_TOL):
    """The same dtype and shape, values within ``tol``."""
    g, w = _np(got), _np(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, g.shape,
                                                        w.dtype, w.shape)
    np.testing.assert_allclose(g.astype(np.float32), w.astype(np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# K9 byteshuffle


ITEMSIZES = [1, 2, 3, 4, 8, 16]


@pytest.mark.parametrize("nb", ITEMSIZES)
@pytest.mark.parametrize("n", [1, 100, 2048, 6000])
def test_byteshuffle_matches_pallas_oracle_and_host(nb, n):
    rng = np.random.default_rng(n * 17 + nb)
    planes = rng.integers(0, 256, (n, nb), dtype=np.uint8)
    got = byteshuffle(torch.from_numpy(planes))
    assert got.is_contiguous()
    _same(got, j_byteshuffle(jnp.asarray(planes), block=512, interpret=True))
    _same(got, jref.byteshuffle_ref(jnp.asarray(planes)))
    arr = np.frombuffer(planes.tobytes(), dtype=np.dtype((np.void, nb)))
    assert got.numpy().tobytes() == E.split_encode(arr)


@pytest.mark.parametrize("nb", [3, 8])
def test_byteshuffle_host_matches_reference_host_entry(nb):
    planes = np.random.default_rng(nb).integers(0, 256, (5000, nb),
                                                dtype=np.uint8)
    planes.flags.writeable = False  # callers may hand read-only views
    _same(byteshuffle_host(planes, "cpu"), j_byteshuffle_host(planes))


# ---------------------------------------------------------------------------
# K10 delta_zigzag


def _dz_input(kind, dtype, n, seed):
    """Offsets (a scan of Poisson sizes) or values over the full range of
    ``dtype`` with its extremes and their neighbours spread through."""
    rng = np.random.default_rng(seed)
    if kind == "offsets":
        return np.cumsum(rng.poisson(5, n)).astype(dtype)
    info = np.iinfo(dtype)
    x = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    edges = np.array([info.min, info.min + 1, info.max - 1, info.max, -1, 0,
                      1], dtype=dtype)
    idx = rng.integers(0, n, min(n, 3 * len(edges)))
    x[idx] = np.resize(edges, len(idx))
    return x


def _j_delta_zigzag(x, pallas):
    """The reference's K10 on a numpy array (int64 needs jax's x64)."""
    with jax.enable_x64(x.dtype == np.int64):
        xj = jnp.asarray(x)
        assert xj.dtype == x.dtype
        out = (j_delta_zigzag(xj, block=256, interpret=True) if pallas
               else jref.delta_zigzag_ref(xj))
        return np.asarray(out)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("kind", ["offsets", "full range"])
@pytest.mark.parametrize("n", [1, 2, 64, 999, 4096, 4097])
def test_delta_zigzag_matches_pallas_and_oracle(dtype, kind, n):
    x = _dz_input(kind, dtype, n, n)
    got = delta_zigzag(torch.from_numpy(x))
    assert got.dtype == {np.int32: torch.uint32, np.int64: torch.uint64}[dtype]
    _same(got, _j_delta_zigzag(x, pallas=True))
    _same(got, _j_delta_zigzag(x, pallas=False))
    if kind == "offsets":  # the writer's host encoder, widened
        host = E.zigzag_encode(E.delta_encode(x.astype(np.int64)))
        np.testing.assert_array_equal(got.numpy().astype(np.uint64), host)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_delta_zigzag_wraps_at_the_extremes(dtype):
    info = np.iinfo(dtype)
    x = np.array([info.min, info.max, info.min, info.min + 1, info.max - 1,
                  info.max, -1, 0, info.max, info.min], dtype=dtype)
    got = delta_zigzag(torch.from_numpy(x)).numpy()
    # by hand, in Python integers modulo 2**bits
    bits = 8 * x.itemsize
    mask = (1 << bits) - 1
    prev, want = 0, []
    for v in x.tolist():
        d = (v - prev) & mask
        d = d - (1 << bits) if d >> (bits - 1) else d  # back to signed
        want.append(((d << 1) ^ (d >> (bits - 1))) & mask)
        prev = v
    assert got.tolist() == want
    _same(got, _j_delta_zigzag(x, pallas=True))


@given(st.lists(st.integers(-2**31, 2**31 - 1), min_size=1, max_size=300))
@settings(max_examples=20, deadline=None)
def test_delta_zigzag_property(values):
    x = np.asarray(values, dtype=np.int32)
    _same(delta_zigzag(torch.from_numpy(x)), _j_delta_zigzag(x, pallas=False))


# ---------------------------------------------------------------------------
# the nine op entries against repro.kernels.ops


@pytest.mark.parametrize("n", [1, 7, 128, 1000, 5000])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_ops_offsets_scan_matches_reference(n, use_pallas):
    sizes = np.random.default_rng(n).poisson(5, n).astype(np.int32)
    got = ops.offsets_scan(torch.from_numpy(sizes))
    want = jops.offsets_scan(jnp.asarray(sizes), use_pallas=use_pallas,
                             block=128)
    _same(got, want)
    _same(ops.offsets_scan(torch.from_numpy(sizes.astype(np.int64))),
          np.cumsum(sizes, dtype=np.int64))


def test_ops_offsets_scan_int32_wraps_as_the_reference():
    sizes = np.full(6, 2**30, dtype=np.int32)  # the total passes 2**31
    _same(ops.offsets_scan(torch.from_numpy(sizes)),
          jops.offsets_scan(jnp.asarray(sizes), use_pallas=False))


@pytest.mark.parametrize("n", [1, 64, 999, 4096])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_ops_delta_zigzag_matches_reference(n, use_pallas):
    offs = np.cumsum(np.random.default_rng(n).poisson(5, n)).astype(np.int32)
    _same(ops.delta_zigzag(torch.from_numpy(offs)),
          jops.delta_zigzag(jnp.asarray(offs), use_pallas=use_pallas,
                            block=256))


@pytest.mark.parametrize("nb", [2, 4, 8])
@pytest.mark.parametrize("n", [1, 100, 2048, 6000])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_ops_byteshuffle_matches_reference(nb, n, use_pallas):
    planes = np.random.default_rng(n + nb).integers(0, 256, (n, nb),
                                                    dtype=np.uint8)
    _same(ops.byteshuffle(torch.from_numpy(planes)),
          jops.byteshuffle(jnp.asarray(planes), use_pallas=use_pallas,
                           block=512))


@pytest.mark.parametrize("shape", [(3, 8, 1000), (2, 4, 777), (4, 2, 2048),
                                   (2, 1, 16)])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_ops_unsplit_pages_matches_reference(shape, use_pallas):
    planes = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                        dtype=np.uint8)
    _same(ops.unsplit_pages(torch.from_numpy(planes)),
          jops.unsplit_pages(jnp.asarray(planes), use_pallas=use_pallas))


@pytest.mark.parametrize("n_pages,per", [(4, 2048), (3, 1000), (1, 5)])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_ops_decode_offset_pages_matches_reference(n_pages, per, use_pallas):
    rng = np.random.default_rng(n_pages * per)
    ends = rng.integers(0, 2**31, (n_pages, per), dtype=np.int64)
    d = np.diff(ends, axis=1, prepend=0)
    zz = ((d << 1) ^ (d >> 63)).astype(np.uint64)
    planes = np.ascontiguousarray(
        np.swapaxes(zz.view(np.uint8).reshape(n_pages, per, 8), 1, 2))
    got = ops.decode_offset_pages(torch.from_numpy(planes))
    _same(got, jops.decode_offset_pages(jnp.asarray(planes),
                                        use_pallas=use_pallas))
    np.testing.assert_array_equal(got.numpy().astype(np.int64), ends)


def _normal(rng, *shapes, dtype=np.float32):
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


def _torch(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _jax(*arrs):
    return [jnp.asarray(a) for a in arrs]


#: the reference sweep's flash attention shapes (b, h, g, sq, sk, d)
FLASH_SHAPES = [(1, 4, 4, 128, 128, 64), (2, 8, 2, 256, 256, 64),
                (1, 8, 1, 128, 128, 128), (1, 4, 4, 64, 256, 64),
                (1, 4, 2, 200, 200, 80)]


@pytest.mark.parametrize("b,h,g,sq,sk,d", FLASH_SHAPES)
@pytest.mark.parametrize("impl", ["ref", "chunked"])
def test_ops_flash_attention_matches_reference(b, h, g, sq, sk, d, impl):
    rng = np.random.default_rng(sq + sk + d)
    q, k, v = _normal(rng, (b, h, sq, d), (b, g, sk, d), (b, g, sk, d))
    got = ops.flash_attention(*_torch(q, k, v), causal=True, impl=impl,
                              block_q=128, block_k=128)
    want = jops.flash_attention(*_jax(q, k, v), causal=True, impl=impl,
                                use_pallas=False)
    _close(got, want)


@pytest.mark.parametrize("window", [64, 128, 1024])
@pytest.mark.parametrize("impl", ["ref", "chunked"])
def test_ops_flash_attention_window_matches_reference(window, impl):
    q, k, v = _normal(np.random.default_rng(window), (1, 4, 256, 64),
                      (1, 2, 256, 64), (1, 2, 256, 64))
    _close(ops.flash_attention(*_torch(q, k, v), window=window, impl=impl),
           jops.flash_attention(*_jax(q, k, v), window=window, impl=impl,
                                use_pallas=False))


def test_ops_flash_attention_bf16_keeps_the_reference_dtype():
    q, k, v = _normal(np.random.default_rng(5), (1, 4, 64, 32),
                      (1, 2, 64, 32), (1, 2, 64, 32))
    for impl in ("ref", "chunked"):
        got = ops.flash_attention(*(t.to(torch.bfloat16)
                                    for t in _torch(q, k, v)), impl=impl)
        want = jops.flash_attention(*(a.astype(jnp.bfloat16)
                                      for a in _jax(q, k, v)), impl=impl,
                                    use_pallas=False)
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("b,h,g,s,d", [(2, 4, 4, 512, 64), (2, 8, 2, 1024, 64),
                                       (1, 8, 1, 777, 128)])
def test_ops_decode_attention_matches_reference(b, h, g, s, d):
    q, k, v = _normal(np.random.default_rng(s), (b, h, d), (b, g, s, d),
                      (b, g, s, d))
    _close(ops.decode_attention(*_torch(q, k, v), block_k=256),
           jops.decode_attention(*_jax(q, k, v), use_pallas=False))


def test_ops_decode_attention_lengths_and_window_match_reference():
    q, k, v = _normal(np.random.default_rng(640), (3, 4, 64), (3, 2, 640, 64),
                      (3, 2, 640, 64))
    length = np.array([100, 640, 333], dtype=np.int32)
    for window in (None, 64):
        _close(ops.decode_attention(*_torch(q, k, v),
                                    length=torch.from_numpy(length),
                                    window=window),
               jops.decode_attention(*_jax(q, k, v),
                                     length=jnp.asarray(length),
                                     window=window, use_pallas=False))


def _rwkv6_arrays(rng, b, h, t, dk, dv):
    r, k = _normal(rng, (b, h, t, dk), (b, h, t, dk))
    (v,) = _normal(rng, (b, h, t, dv))
    w = np.exp(-np.exp(rng.uniform(-4, 1, (b, h, t, dk)))).astype(np.float32)
    (u,) = _normal(rng, (h, dk))
    return r, k, v, w, u


def _mamba2_arrays(rng, b, h, t, p, n):
    (x,) = _normal(rng, (b, h, t, p))
    log_a = -np.exp(rng.uniform(-3, 0.5, (b, h, t))).astype(np.float32)
    Bm, Cm = _normal(rng, (b, t, n), (b, t, n))
    return x, log_a, Bm, Cm


@pytest.mark.parametrize("b,h,t,dk,dv,chunk", [(1, 2, 64, 32, 32, 16),
                                               (2, 2, 128, 64, 64, 32),
                                               (1, 4, 96, 48, 64, 32)])
def test_ops_rwkv6_matches_reference(b, h, t, dk, dv, chunk):
    arrs = _rwkv6_arrays(np.random.default_rng(t + dk), b, h, t, dk, dv)
    out, state = ops.rwkv6(*_torch(*arrs), chunk=chunk)
    j_out, j_state = jops.rwkv6(*_jax(*arrs), use_pallas=False, chunk=chunk)
    _close(out, j_out)
    _close(state, j_state)


@pytest.mark.parametrize("b,h,t,p,n,chunk", [(1, 2, 128, 32, 16, 32),
                                             (2, 4, 128, 64, 64, 64),
                                             (1, 2, 256, 64, 32, 64)])
def test_ops_mamba2_matches_reference(b, h, t, p, n, chunk):
    arrs = _mamba2_arrays(np.random.default_rng(t + p + n), b, h, t, p, n)
    y, state = ops.mamba2(*_torch(*arrs), chunk=chunk)
    j_y, j_state = jops.mamba2(*_jax(*arrs), use_pallas=False, chunk=chunk)
    _close(y, j_y)
    _close(state, j_state)


# ---------------------------------------------------------------------------
# the new oracles and the models' one-token steps


@pytest.mark.parametrize("b,h,g,sq,sk,d,dv,window", [
    (1, 4, 2, 128, 128, 32, 32, None),
    (2, 2, 1, 64, 192, 16, 16, None),     # Sq < Sk
    (1, 2, 2, 100, 100, 32, 32, 48),      # window, ragged last block
    (1, 8, 8, 256, 256, 64, 64, None),
    (1, 4, 4, 96, 96, 24, 16, None),      # MLA: v's head dim differs
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_chunked_matches_jnp_twin(b, h, g, sq, sk, d, dv,
                                                  window, causal):
    q, k, v = _normal(np.random.default_rng(sq + d), (b, h, sq, d),
                      (b, g, sk, d), (b, g, sk, dv))
    got = ref.flash_attention_chunked(*_torch(q, k, v), causal=causal,
                                      window=window, block=32)
    _close(got, jref.flash_attention_chunked(*_jax(q, k, v), causal=causal,
                                             window=window, block=32))
    if dv == d:
        _close(got, ref.flash_attention_ref(*_torch(q, k, v), causal=causal,
                                            window=window), 3e-5)


def test_flash_attention_chunked_rows_without_keys_are_zero():
    """A query row that sees no key is 0, as in the reference's chunked
    oracle (the whole-softmax oracle gives NaN there)."""
    q, k, v = _normal(np.random.default_rng(9), (1, 2, 8, 16), (1, 2, 4, 16),
                      (1, 2, 4, 16))
    got = ref.flash_attention_chunked(*_torch(q, k, v), causal=True, window=1,
                                      block=2)
    want = jref.flash_attention_chunked(*_jax(q, k, v), causal=True, window=1,
                                        block=2)
    _close(got, want)


def _rwkv6_step_arrays(seed, b, h, dk, dv):
    rng = np.random.default_rng(seed)
    r, k, v, w, u = _rwkv6_arrays(rng, b, h, 1, dk, dv)
    (state,) = _normal(rng, (b, h, dk, dv))
    return r[:, :, 0], k[:, :, 0], v[:, :, 0], w[:, :, 0], u, state


def _mamba2_step_arrays(seed, b, h, p, n):
    rng = np.random.default_rng(seed)
    x, log_a, Bm, Cm = _mamba2_arrays(rng, b, h, 1, p, n)
    D, state = _normal(rng, (h,), (b, h, n, p))
    return x[:, :, 0], log_a[:, :, 0], Bm[:, 0], Cm[:, 0], D, state


@pytest.mark.parametrize("b,h,dk,dv", [(2, 8, 16, 16), (3, 4, 64, 32)])
def test_rwkv6_decode_ref_matches_jnp_twin(b, h, dk, dv):
    arrs = _rwkv6_step_arrays(dk + dv, b, h, dk, dv)
    ins = _torch(*arrs)
    out, state = ref.rwkv6_decode_ref(*ins)
    j_out, j_state = jref.rwkv6_decode_ref(*_jax(*arrs))
    _close(out, j_out)
    _close(state, j_state)
    _same(ins[-1], arrs[-1])  # the state given is left as it was


@pytest.mark.parametrize("b,h,p,n", [(2, 16, 16, 16), (3, 4, 64, 32)])
def test_mamba2_decode_ref_matches_jnp_twin(b, h, p, n):
    arrs = _mamba2_step_arrays(p + n, b, h, p, n)
    ins = _torch(*arrs)
    y, state = ref.mamba2_decode_ref(*ins)
    j_y, j_state = jref.mamba2_decode_ref(*_jax(*arrs))
    _close(y, j_y)
    _close(state, j_state)
    _same(ins[-1], arrs[-1])


def test_rwkv6_models_one_token_step_matches_decode_oracles():
    """The wkv recurrence of ``rwkv6_block_decode`` at the smoke config's
    heads, against ``rwkv6_decode_ref`` (the step the reference's decode
    computes), the state advanced in place."""
    cfg = smoke_config("rwkv6-7b")
    hd = cfg.ssm.head_dim
    arrs = _rwkv6_step_arrays(1, 2, cfg.d_model // hd, hd, hd)
    ins = _torch(*arrs)
    state = ins[-1].clone()
    o = wkv_step(*ins[:-1], state)
    want, want_state = ref.rwkv6_decode_ref(*ins)
    _close(o, want)
    _close(state, want_state)
    j_o, j_state = jref.rwkv6_decode_ref(*_jax(*arrs))
    _close(o, j_o)
    _close(state, j_state)


def test_mamba2_models_one_token_step_matches_decode_oracles():
    """The SSD recurrence of ``mamba2_block_decode`` at the smoke config's
    heads (with the D skip), against ``mamba2_decode_ref``, the state
    advanced in place."""
    cfg = smoke_config("zamba2-2.7b")
    s = cfg.ssm
    h = s.expand * cfg.d_model // s.head_dim
    arrs = _mamba2_step_arrays(2, 2, h, s.head_dim, s.d_state)
    ins = _torch(*arrs)
    state = ins[-1].clone()
    y = ssd_step(*ins[:-1], state)
    want, want_state = ref.mamba2_decode_ref(*ins)
    _close(y, want)
    _close(state, want_state)
    j_y, j_state = jref.mamba2_decode_ref(*_jax(*arrs))
    _close(y, j_y)
    _close(state, j_state)


# ---------------------------------------------------------------------------
# launch counts and refusals


def test_op_entries_on_the_cpu_count_no_launch():
    rng = np.random.default_rng(0)
    q, k, v = _torch(*_normal(rng, (1, 2, 8, 32), (1, 2, 8, 32),
                              (1, 2, 8, 32)))
    ops.reset_launch_counts()
    ops.offsets_scan(torch.arange(10, dtype=torch.int32))
    ops.delta_zigzag(torch.arange(10, dtype=torch.int64))
    ops.byteshuffle(torch.zeros((9, 3), dtype=torch.uint8))
    byteshuffle_host(np.zeros((9, 3), dtype=np.uint8), "cpu")
    ops.unsplit_pages(torch.zeros((1, 4, 8), dtype=torch.uint8))
    ops.decode_offset_pages(torch.zeros((1, 8, 8), dtype=torch.uint8))
    ops.flash_attention(q, k, v)
    ops.flash_attention(q, k, v, impl="chunked")
    ops.decode_attention(q[:, :, 0], k, v)
    ops.rwkv6(q, k, v, torch.rand_like(q), torch.zeros(2, 32))
    ops.mamba2(q, torch.zeros(1, 2, 8), q[:, 0], q[:, 0])
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    assert ops.CODEC_KERNELS == ("byteshuffle", "delta_zigzag")
    assert set(ops.KERNELS) == set(ops.WRITE_READ_KERNELS
                                   + ops.SERVE_KERNELS + ops.CODEC_KERNELS
                                   + ops.TRAIN_KERNELS)


@pytest.mark.parametrize("call", [
    lambda: byteshuffle(torch.zeros((4, 8), dtype=torch.int8)),
    lambda: byteshuffle(torch.zeros((1, 4, 8), dtype=torch.uint8)),
    lambda: byteshuffle(torch.zeros(8, dtype=torch.uint8)),
    lambda: byteshuffle(torch.zeros((4, 8), dtype=torch.uint8,
                                    device="meta")),
    lambda: delta_zigzag(torch.zeros(4, dtype=torch.uint32)),
    lambda: delta_zigzag(torch.zeros(4, dtype=torch.uint64)),
    lambda: delta_zigzag(torch.zeros(4, dtype=torch.float32)),
    lambda: delta_zigzag(torch.zeros(4, dtype=torch.int16)),
    lambda: delta_zigzag(torch.zeros((2, 2), dtype=torch.int32)),
    lambda: delta_zigzag(torch.zeros(4, dtype=torch.int64, device="meta")),
    lambda: ops.offsets_scan(torch.zeros(4, dtype=torch.float32)),
    lambda: ops.offsets_scan(torch.zeros((2, 2), dtype=torch.int32)),
    lambda: ops.flash_attention(*[torch.zeros(1, 1, 4, 32)] * 3,
                                impl="pallas"),
])
def test_codec_wrappers_refuse_what_the_kernels_do_not_take(call):
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("op,args", [
    ("offsets_scan", lambda: (torch.ones(4, dtype=torch.int32),)),
    ("delta_zigzag", lambda: (torch.ones(4, dtype=torch.int32),)),
    ("byteshuffle", lambda: (torch.ones((4, 2), dtype=torch.uint8),)),
    ("flash_attention", lambda: [torch.zeros(1, 1, 4, 32)] * 3),
    ("rwkv6", lambda: [torch.zeros(1, 1, 2, 16)] * 4 + [torch.zeros(1, 16)]),
])
def test_op_entries_refuse_use_pallas_and_accept_tuning_keywords(op, args):
    fn = getattr(ops, op)
    with pytest.raises(TypeError, match="use_pallas"):
        fn(*args(), use_pallas=True)
    fn(*args(), chunk=16, block=8, block_q=32, block_k=32)
