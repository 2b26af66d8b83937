"""The port's kernels (K1-K4) against the JAX package's, on the CPU.

For each kernel the port's plain PyTorch version — what its wrapper runs
on a CPU tensor — is compared with the JAX Pallas kernel in interpret mode
and with the jnp oracle of ``repro.kernels.ref``, on the same numpy inputs
made from a seed.  Every comparison is exact (bytes and integers).  The
CUDA kernels themselves are compared with these plain versions on the card
by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.byteshuffle import byteshuffle_pages as j_byteshuffle_pages
from repro.kernels.byteshuffle import byteshuffle_pages_host as j_shuffle_host
from repro.kernels.decode_pages import (
    decode_offset_pages as j_decode_offset_pages,
    device_decode_none as j_decode_none,
    device_decode_offsets as j_decode_offsets,
    device_decode_split as j_decode_split,
    unsplit_pages as j_unsplit_pages,
)
from repro.kernels.offsets_scan import offsets_scan as j_offsets_scan
from repro.kernels.offsets_scan import offsets_scan_host as j_scan_host
from repro.core.encoding import precondition_column_pages

from repro_torch.kernels import ops, ref
from repro_torch.kernels.byteshuffle import (
    byteshuffle_pages, byteshuffle_pages_host,
)
from repro_torch.kernels.decode_pages import (
    decode_offset_pages, device_decode_none, device_decode_offsets,
    device_decode_split, unsplit_pages,
)
from repro_torch.kernels.offsets_scan import offsets_scan, offsets_scan_host

CPU = torch.device("cpu")


def _offset_planes(rng, n_pages, per):
    """(P, 8, per) byte planes of per-page restarted zigzag deltas.

    The end offsets are uniform below 2**31, so the signed deltas fill
    all four low bytes at every position (the writer's first delta of a
    page is such a large absolute offset); planes 4..7 stay zero."""
    ends = rng.integers(0, 2**31, (n_pages, per), dtype=np.int64)
    d = np.diff(ends, axis=1, prepend=0)
    zz = ((d << 1) ^ (d >> 63)).astype(np.uint64)
    planes = zz.view(np.uint8).reshape(n_pages, per, 8)
    return np.ascontiguousarray(np.swapaxes(planes, 1, 2)), ends


# ---------------------------------------------------------------------------
# K1 offsets_scan


@pytest.mark.parametrize("n", [1, 300, 4096, 4097, 10_000])
def test_offsets_scan_matches_pallas_and_oracle(n):
    rng = np.random.default_rng(n)
    sizes = rng.poisson(5, n).astype(np.int64)
    got = offsets_scan(torch.from_numpy(sizes)).numpy()
    assert got.dtype == np.int64
    pal = np.asarray(j_offsets_scan(jnp.asarray(sizes, jnp.int32),
                                    interpret=True)).astype(np.int64)
    orc = np.asarray(jref.offsets_scan_ref(jnp.asarray(sizes, jnp.int32)))
    np.testing.assert_array_equal(got, pal)
    np.testing.assert_array_equal(got, orc.astype(np.int64))
    np.testing.assert_array_equal(got, np.cumsum(sizes, dtype=np.int64))


def test_offsets_scan_host_matches_reference_host_entry():
    rng = np.random.default_rng(11)
    sizes = rng.poisson(5, 5000).astype(np.int64)
    sizes.flags.writeable = False  # fill batches may hand read-only views
    got = offsets_scan_host(sizes, CPU)
    want = j_scan_host(sizes)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# K2 byteshuffle_pages / K3 unsplit_pages


SHUFFLE_SHAPES = [(3, 1000, 8), (2, 777, 4), (4, 2048, 2), (1, 3000, 4),
                  (2, 16, 1)]


@pytest.mark.parametrize("shape", SHUFFLE_SHAPES)
def test_byteshuffle_pages_matches_pallas_and_oracle(shape):
    rng = np.random.default_rng(sum(shape))
    pages = rng.integers(0, 256, shape, dtype=np.uint8)
    got = byteshuffle_pages(torch.from_numpy(pages)).numpy()
    pal = np.asarray(j_byteshuffle_pages(jnp.asarray(pages), interpret=True))
    orc = np.stack([np.asarray(jref.byteshuffle_ref(jnp.asarray(p)))
                    for p in pages])
    np.testing.assert_array_equal(got, pal)
    np.testing.assert_array_equal(got, orc)
    np.testing.assert_array_equal(
        byteshuffle_pages_host(pages, CPU), j_shuffle_host(pages))


@pytest.mark.parametrize("shape", [(p, nb, per) for p, per, nb in SHUFFLE_SHAPES])
def test_unsplit_pages_matches_pallas_and_oracle(shape):
    rng = np.random.default_rng(sum(shape) + 1)
    planes = rng.integers(0, 256, shape, dtype=np.uint8)
    got = unsplit_pages(torch.from_numpy(planes)).numpy()
    pal = np.asarray(j_unsplit_pages(jnp.asarray(planes), interpret=True))
    orc = np.asarray(jref.unsplit_pages_ref(jnp.asarray(planes)))
    np.testing.assert_array_equal(got, pal)
    np.testing.assert_array_equal(got, orc)
    # and it inverts K2
    back = byteshuffle_pages(torch.from_numpy(got)).numpy()
    np.testing.assert_array_equal(back, planes)


# ---------------------------------------------------------------------------
# K4 decode_offset_pages and unzigzag


@pytest.mark.parametrize("n_pages,per", [(4, 2048), (3, 1000), (2, 3000),
                                         (1, 5)])
def test_decode_offset_pages_matches_pallas_and_oracle(n_pages, per):
    rng = np.random.default_rng(n_pages * per)
    planes, ends = _offset_planes(rng, n_pages, per)
    got = decode_offset_pages(torch.from_numpy(planes)).numpy()
    assert got.dtype == np.int32
    pal = np.asarray(j_decode_offset_pages(jnp.asarray(planes),
                                           interpret=True))
    orc = np.asarray(jref.decode_offset_pages_ref(jnp.asarray(planes)))
    np.testing.assert_array_equal(got, pal)
    np.testing.assert_array_equal(got, orc)
    np.testing.assert_array_equal(got.astype(np.int64), ends)


def test_unzigzag_matches_oracle_at_the_edges():
    z = np.array([0, 1, 2, 3, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1,
                  123456789], dtype=np.uint32)
    got = ref.unzigzag_ref(torch.from_numpy(z.astype(np.int64))).numpy()
    want = np.asarray(jref.unzigzag_ref(jnp.asarray(z)))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the decode drivers against the reference's drivers


@pytest.mark.parametrize("dtype", ["int32", "uint16", "uint32", "float32",
                                   "uint8"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_device_decode_split_matches_reference_driver(dtype, use_pallas):
    rng = np.random.default_rng(2)
    n, per = 10_000, 4096  # 2 full pages + a partial tail page
    arr = rng.integers(0, 1 << 15, n).astype(dtype)
    raw = np.asarray(precondition_column_pages(arr, "split", per), np.uint8)
    got = device_decode_split(torch.from_numpy(raw.copy()), n, per, dtype)
    want = np.asarray(j_decode_split(jnp.asarray(raw), n, per, dtype,
                                     use_pallas=use_pallas,
                                     interpret=use_pallas))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), arr)


@pytest.mark.parametrize("n,per", [(9_000, 4096), (4096, 4096), (100, 4096)])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_device_decode_offsets_matches_reference_driver(n, per, use_pallas):
    rng = np.random.default_rng(3)
    ends = np.cumsum(rng.poisson(6, n)).astype(np.int64)
    raw = np.asarray(precondition_column_pages(ends, "dzs", per), np.uint8)
    got = device_decode_offsets(torch.from_numpy(raw.copy()), n, per)
    want = np.asarray(j_decode_offsets(jnp.asarray(raw), n, per,
                                       use_pallas=use_pallas,
                                       interpret=use_pallas))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), ends)


@pytest.mark.parametrize("dtype", ["float32", "uint16", "uint32", "uint8"])
def test_device_decode_none_matches_reference_and_never_aliases(dtype):
    rng = np.random.default_rng(4)
    arr = rng.integers(0, 200, 5000).astype(dtype)
    raw = torch.from_numpy(arr.view(np.uint8).copy())
    got = device_decode_none(raw, 5000, 4096, dtype)
    want = np.asarray(j_decode_none(jnp.asarray(arr.view(np.uint8)), 5000,
                                    4096, dtype))
    np.testing.assert_array_equal(got.numpy(), want)
    raw.zero_()  # the staging buffer is recycled: the column must survive
    np.testing.assert_array_equal(got.numpy(), arr)


def test_tail_only_split_never_aliases_staging():
    """A column shorter than one page decodes through the tail path only;
    its result must not be a view of the staging bytes either."""
    arr = np.arange(33, dtype=np.uint8)
    raw = torch.from_numpy(arr.copy())
    got = device_decode_split(raw, 33, 4096, "uint8")
    raw.zero_()
    np.testing.assert_array_equal(got.numpy(), arr)


# ---------------------------------------------------------------------------
# wrapper contracts


def test_plain_versions_on_the_cpu_count_no_launch():
    ops.reset_launch_counts()
    offsets_scan(torch.arange(10, dtype=torch.int64))
    byteshuffle_pages(torch.zeros((1, 8, 4), dtype=torch.uint8))
    unsplit_pages(torch.zeros((1, 4, 8), dtype=torch.uint8))
    decode_offset_pages(torch.zeros((1, 8, 8), dtype=torch.uint8))
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


@pytest.mark.parametrize("call", [
    lambda: offsets_scan(torch.zeros(4, dtype=torch.int32)),
    lambda: offsets_scan(torch.zeros((2, 2), dtype=torch.int64)),
    lambda: byteshuffle_pages(torch.zeros((4, 8), dtype=torch.uint8)),
    lambda: unsplit_pages(torch.zeros((1, 4, 8), dtype=torch.float32)),
    lambda: decode_offset_pages(torch.zeros((1, 4, 8), dtype=torch.uint8)),
    lambda: offsets_scan(torch.zeros(4, dtype=torch.int64, device="meta")),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(call):
    with pytest.raises(ValueError):
        call()
