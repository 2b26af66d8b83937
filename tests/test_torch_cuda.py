"""The port's CUDA kernels on the card: each against its plain PyTorch
version, bit for bit, and the write -> read path with ``device="cuda"``.

Marked ``cuda``: without a card every test skips.  On the card:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.kernels import ops, ref
from repro_torch.kernels.byteshuffle import byteshuffle_pages
from repro_torch.kernels.decode_pages import decode_offset_pages, unsplit_pages
from repro_torch.kernels.offsets_scan import offsets_scan

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 4095, 4097, 100_000, 1_100_003])
def test_offsets_scan_on_the_card(card, n):
    sizes = torch.from_numpy(np.random.default_rng(n).poisson(5, n)).to(card)
    got = offsets_scan(sizes)
    assert torch.equal(got, ref.offsets_scan_ref(sizes))


@pytest.mark.parametrize("shape", [(36, 8192, 8), (91, 16384, 4), (3, 1000, 8),
                                   (2, 777, 4), (5, 4099, 2), (2, 33, 1)])
def test_byte_planes_on_the_card(card, shape):
    x = torch.from_numpy(np.random.default_rng(sum(shape)).integers(
        0, 256, shape, dtype=np.uint8)).to(card)
    planes = byteshuffle_pages(x)
    assert torch.equal(planes, ref.byteshuffle_pages_ref(x))
    back = unsplit_pages(planes)
    assert torch.equal(back, ref.unsplit_pages_ref(planes))
    assert torch.equal(back, x)
    # a misaligned view takes the scalar path and agrees too
    flat = torch.empty(x.numel() + 1, dtype=torch.uint8, device=card)
    flat[1:] = x.reshape(-1)
    odd = flat[1:].reshape(shape)
    assert torch.equal(byteshuffle_pages(odd), planes)


@pytest.mark.parametrize("n_pages,per", [(36, 8192), (3, 1000), (2, 1027),
                                         (4, 2)])
def test_decode_offset_pages_on_the_card(card, n_pages, per):
    # end offsets uniform below 2**31: the signed deltas fill all four low
    # bytes at every lane of the vector path, planes 4..7 stay zero
    ends = np.random.default_rng(per).integers(0, 2**31, (n_pages, per),
                                               dtype=np.int64)
    d = np.diff(ends, axis=1, prepend=0)
    zz = (d << 1) ^ (d >> 63)
    planes = np.ascontiguousarray(
        zz.view(np.uint8).reshape(n_pages, per, 8).transpose(0, 2, 1))
    x = torch.from_numpy(planes).to(card)
    got = decode_offset_pages(x)
    assert torch.equal(got, ref.decode_offset_pages_ref(x))
    np.testing.assert_array_equal(got.cpu().numpy(), ends)


def test_write_and_read_back_on_the_card(card, tmp_path):
    from repro_torch.configs.rntj_writer import (
        PAPER_WRITE_OPTIONS as O, SYNTH_EVENT_SCHEMA as S,
    )

    rng = np.random.default_rng(0)
    n = 300_000
    sizes = rng.poisson(5, n).astype(np.int64)
    vals = rng.standard_normal(int(sizes.sum()), dtype=np.float32)
    ops.reset_launch_counts()
    path = str(tmp_path / "card.rntj")
    ends = np.cumsum(sizes)
    with T.SequentialWriter(S, path, O) as w:
        for s in range(0, n, 100_000):
            e = s + 100_000
            a = 0 if s == 0 else ends[s - 1]
            w.fill_batch(T.ColumnBatch.from_arrays(S, e - s, {
                "id": np.arange(s, e, dtype=np.int64), "vals": sizes[s:e],
                "vals._0": vals[a:ends[e - 1]]}))
    with T.RNTJReader(path) as r:
        got = [c for _, c in r.iter_clusters_device()]
    np.testing.assert_array_equal(
        np.concatenate([c[2].cpu().numpy() for c in got]), vals)
    assert all(v > 0 for v in ops.launch_counts().values())
