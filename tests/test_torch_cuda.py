"""The port's CUDA kernels on the card: each against its plain PyTorch
version (bit for bit for K1-K4, K9 and K10, within stated tolerances for
K5-K8 and K5's backward), the op entries of ``repro_torch.kernels.ops``,
the write -> read path with ``device="cuda"``, a multi-writer
participant and merge on the card, a checkpoint round trip, the packing
loader's device engine, and one train step.

Marked ``cuda``: without a card every test skips.  On the card:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import os

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.kernels import ops, ref
from repro_torch.kernels.byteshuffle import byteshuffle_pages
from repro_torch.kernels.decode_pages import decode_offset_pages, unsplit_pages
from repro_torch.kernels.offsets_scan import offsets_scan

# six test workers share the cores: one thread each, not one per core
torch.set_num_threads(max(1, os.cpu_count() // 6))

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _sizes(rng, n, kind="poisson"):
    """Poisson(5) collection sizes, or int64 values over the whole range
    (negative ones too), whose sums wrap as ``torch.cumsum``'s do."""
    if kind == "poisson":
        return rng.poisson(5, n).astype(np.int64)
    return rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64, endpoint=True)


@pytest.mark.parametrize("kind", ["poisson", "wrapping"])
@pytest.mark.parametrize("n", [1, 4095, 4097, 100_000, 1_100_003, 2**20 + 3,
                               2**24])
def test_offsets_scan_on_the_card(card, n, kind):
    sizes = torch.from_numpy(_sizes(np.random.default_rng(n), n, kind)).to(card)
    before = ops.launch_counts()["offsets_scan"]
    got = offsets_scan(sizes)
    assert ops.launch_counts()["offsets_scan"] == before + 1
    assert torch.equal(got, ref.offsets_scan_ref(sizes))


def test_offsets_scan_many_calls_on_the_card(card):
    """200 calls in a row at lengths from 1 to 300,000: each call's epoch
    and tickets follow the last one's on the same workspace."""
    rng = np.random.default_rng(200)
    for i in range(200):
        n = int(rng.integers(1, 300_000)) if i % 3 else int(rng.integers(1, 5000))
        sizes = _sizes(rng, n, "wrapping" if i % 5 == 0 else "poisson")
        got = offsets_scan(torch.from_numpy(sizes).to(card)).cpu().numpy()
        np.testing.assert_array_equal(got, np.cumsum(sizes, dtype=np.int64))


@pytest.mark.parametrize("mode", ["default stream", "stream per thread",
                                  "host entry"])
def test_offsets_scan_concurrent_callers_on_the_card(card, mode):
    """4 threads x 50 calls at once, on the default stream (one workspace
    shared by all), on a stream per thread (a workspace each), and
    through the write path's host entry: all bit-identical."""
    import threading

    from repro_torch.kernels.offsets_scan import offsets_scan_host

    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            stream = (torch.cuda.Stream(card) if mode == "stream per thread"
                      else torch.cuda.current_stream(card))
            with torch.cuda.stream(stream):
                for _ in range(50):
                    sizes = _sizes(rng, int(rng.integers(1, 200_000)))
                    want = np.cumsum(sizes, dtype=np.int64)
                    if mode == "host entry":
                        got = offsets_scan_host(sizes, card)
                    else:
                        got = offsets_scan(torch.from_numpy(sizes).to(card))
                        got = got.cpu().numpy()
                    if not np.array_equal(got, want):
                        errors.append(seed)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive(), "a caller did not finish"
    assert not errors, errors


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


# K2's register form and K4's cluster form: every case
# bit for bit against the plain version, and one launch each.

#: the write path's K2 page counts and widths (64 KiB pages of 8- and
#: 4-byte columns)
WRITE_PAGES = [(36, 8192), (91, 16384), (12, 8192), (30, 16384)]


def _shuffle_case(card, n_pages, per, nb, seed):
    x = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (n_pages, per, nb), dtype=np.uint8)).to(card)
    before = ops.launch_counts()["byteshuffle_pages"]
    got = byteshuffle_pages(x)
    assert ops.launch_counts()["byteshuffle_pages"] == before + 1
    want = ref.byteshuffle_pages_ref(x)
    assert torch.equal(got, want)
    return x, want


@pytest.mark.parametrize("nb", [1, 2, 4, 8])
@pytest.mark.parametrize("n_pages,per", WRITE_PAGES)
def test_byteshuffle_pages_register_form_on_the_card(card, n_pages, per, nb):
    x, want = _shuffle_case(card, n_pages, per, nb, n_pages * per + nb)
    # the same pages through an unaligned view take the scalar kernel
    assert torch.equal(byteshuffle_pages(_unaligned(x)), want)


@pytest.mark.parametrize("nb", [1, 2, 4, 8])
@pytest.mark.parametrize("per", [16 * 5 + 1, 16 * 64 + 8, 16 * 512 + 15, 4])
def test_byteshuffle_pages_ragged_and_unaligned_on_the_card(card, per, nb):
    """A per that is no multiple of 16 and unaligned views take the
    scalar kernel; both agree bit for bit."""
    x, want = _shuffle_case(card, 3, per, nb, per + nb)
    assert torch.equal(byteshuffle_pages(_unaligned(x)), want)


#: K3's read-path shapes (the float32 and int64 columns' 64 KiB pages)
READ_PAGES = [(91, 16384), (36, 8192), (3, 1024), (1, 16)]


def _unsplit_case(card, n_pages, per, nb, seed):
    planes = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (n_pages, nb, per), dtype=np.uint8)).to(card)
    before = ops.launch_counts()["unsplit_pages"]
    got = unsplit_pages(planes)
    assert ops.launch_counts()["unsplit_pages"] == before + 1
    want = ref.unsplit_pages_ref(planes)
    assert torch.equal(got, want)
    return planes, want


@pytest.mark.parametrize("nb", [1, 2, 4, 8])
@pytest.mark.parametrize("n_pages,per", READ_PAGES)
def test_unsplit_pages_register_form_on_the_card(card, n_pages, per, nb):
    planes, want = _unsplit_case(card, n_pages, per, nb, n_pages * per + nb)
    # the same planes through an unaligned view take the scalar kernel
    assert torch.equal(unsplit_pages(_unaligned(planes)), want)


@pytest.mark.parametrize("nb", [1, 2, 4, 8])
@pytest.mark.parametrize("per", [16 * 5 + 1, 16 * 64 + 8, 16 * 512 + 15, 4])
def test_unsplit_pages_ragged_and_unaligned_on_the_card(card, per, nb):
    """A per that is no multiple of 16 and unaligned views take the
    scalar kernel; both agree bit for bit."""
    planes, want = _unsplit_case(card, 3, per, nb, per + 3 * nb)
    assert torch.equal(unsplit_pages(_unaligned(planes)), want)


def _decode_planes(card, n_pages, per, seed):
    """(P, 8, per) planes of end offsets uniform below 2**31 (the signed
    deltas fill all four low bytes), with the ends."""
    ends = np.random.default_rng(seed).integers(0, 2**31, (n_pages, per),
                                                dtype=np.int64)
    d = np.diff(ends, axis=1, prepend=0)
    zz = (d << 1) ^ (d >> 63)
    planes = np.ascontiguousarray(
        zz.view(np.uint8).reshape(n_pages, per, 8).transpose(0, 2, 1))
    return torch.from_numpy(planes).to(card), ends


@pytest.mark.parametrize("n_pages,per", [(36, 8192), (12, 8192), (1, 8192),
                                         (3, 1000), (1, 5), (2, 9000),
                                         (3, 8 * 1024 + 4), (1, 1 << 20)])
def test_decode_offset_pages_cluster_form_on_the_card(card, n_pages, per):
    """The read path's shapes, small pages (one block), a per that is no
    multiple of C x tile (a ragged second round), and one page of 2^20
    (128 rounds of the carry loop)."""
    from repro_torch.kernels.decode_pages import launch_shape

    x, ends = _decode_planes(card, n_pages, per, per + n_pages)
    before = ops.launch_counts()["decode_offset_pages"]
    got = decode_offset_pages(x)
    assert ops.launch_counts()["decode_offset_pages"] == before + 1
    assert torch.equal(got, ref.decode_offset_pages_ref(x))
    np.testing.assert_array_equal(got.cpu().numpy(), ends)
    c, tile = launch_shape(per)
    assert c <= 8
    assert torch.equal(decode_offset_pages(_unaligned(x)), got)


def test_decode_offset_pages_zigzag_extremes_on_the_card(card):
    """uint32 zigzag values over the whole range with the extremes: the
    sums wrap as the CPU plain version's int32 cumsum does."""
    rng = np.random.default_rng(18)
    z = rng.integers(0, 2**32, (3, 8192), dtype=np.uint64)
    z[:, ::5] = np.resize(np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2,
                                    2**32 - 1], dtype=np.uint64),
                          z[:, ::5].shape)
    planes = np.ascontiguousarray(
        z.view(np.uint8).reshape(3, 8192, 8).transpose(0, 2, 1))
    x = torch.from_numpy(planes)
    assert torch.equal(decode_offset_pages(x.to(card)).cpu(),
                       ref.decode_offset_pages_ref(x))


@pytest.mark.parametrize("shape", [(16, 1024), (8, 512)])
def test_decode_offset_pages_refused_launch_raises(card, monkeypatch, shape):
    """A cluster or tile the kernel does not take is refused, and the
    wrapper raises with the CUDA error string: no fallback."""
    from repro_torch.kernels import decode_pages

    monkeypatch.setattr(decode_pages, "launch_shape", lambda per: shape)
    x, _ = _decode_planes(card, 2, 8192, 3)
    with pytest.raises(RuntimeError, match="decode_offset_pages failed: "):
        decode_pages.decode_offset_pages(x)


#: K9's shapes in chip_smoke's phases 5 and 6 (it runs K2's code)
K9_SHAPES = [(n, nb) for nb in (2, 4, 8) for n in (1, 100, 2048, 6000)]
K9_SHAPES += [(250_000, 8), (1 << 24, 8)]


@pytest.mark.parametrize("n,nb", K9_SHAPES)
def test_byteshuffle_at_the_op_and_timed_shapes_on_the_card(card, n, nb):
    from repro_torch.kernels.byteshuffle import byteshuffle

    x = torch.randint(0, 256, (n, nb), dtype=torch.uint8, device=card,
                      generator=torch.Generator(device=card).manual_seed(n))
    assert torch.equal(byteshuffle(x), ref.byteshuffle_ref(x))


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
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in ops.WRITE_READ_KERNELS)


def _paper_batches(rng, n, batch=100_000):
    from repro_torch.configs.rntj_writer import SYNTH_EVENT_SCHEMA as S

    sizes = rng.poisson(5, n).astype(np.int64)
    vals = rng.standard_normal(int(sizes.sum()), dtype=np.float32)
    ends = np.cumsum(sizes)
    out = []
    for s in range(0, n, batch):
        e = min(n, s + batch)
        a = 0 if s == 0 else ends[s - 1]
        out.append(T.ColumnBatch.from_arrays(S, e - s, {
            "id": np.arange(s, e, dtype=np.int64), "vals": sizes[s:e],
            "vals._0": vals[a:ends[e - 1]]}))
    return out, vals


def test_participant_writes_on_the_card(card, tmp_path):
    from repro_torch.configs.rntj_writer import (
        PAPER_WRITE_OPTIONS as O, SYNTH_EVENT_SCHEMA as S,
    )

    batches, vals = _paper_batches(np.random.default_rng(1), 300_000)
    path = str(tmp_path / "mp.rntj")
    coord = T.MultiWriterCoordinator(S, path, O)
    ops.reset_launch_counts()
    w = T.join_container(path)  # device="cuda", the default
    ctx = w.create_fill_context()
    for b in batches:
        ctx.fill_batch(b)
    ctx.close()
    w.close()
    counts = ops.launch_counts()
    report = coord.seal(expect_writers=1)
    coord.close()
    assert counts["offsets_scan"] > 0 and counts["byteshuffle_pages"] > 0
    assert report["entries"] == 300_000 and not report["fenced"]
    with T.RNTJReader(path) as r:
        got = np.concatenate([c[2].cpu().numpy()
                              for _, c in r.iter_clusters_device()])
    np.testing.assert_array_equal(got, vals)


def test_merge_reencode_on_the_card_equals_numpy(card, tmp_path, monkeypatch):
    from repro_torch.configs.rntj_writer import (
        PAPER_WRITE_OPTIONS as O, SYNTH_EVENT_SCHEMA as S,
    )

    batches, _vals = _paper_batches(np.random.default_rng(2), 200_000)
    src = str(tmp_path / "in.rntj")
    with T.SequentialWriter(S, src, O) as w:
        for b in batches:
            w.fill_batch(b)
    outs = []
    for backend in ("auto", "numpy"):
        monkeypatch.setenv("REPRO_TORCH_KERNEL_BACKEND", backend)
        ops.reset_launch_counts()
        out = str(tmp_path / f"{backend}.rntj")
        T.merge_files([src], out, O, recompress=True)
        counts = ops.launch_counts()
        assert (counts["offsets_scan"] > 0) == (backend == "auto")
        assert (counts["byteshuffle_pages"] > 0) == (backend == "auto")
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("processes", [0, 2])
def test_checkpoint_round_trip_on_the_card(card, tmp_path, processes):
    from repro_torch.ckpt import CheckpointManager

    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    tree = {
        "params": {"w": torch.randn(300, 64, device=card, generator=gen),
                   "b": torch.randn(64, device=card,
                                    generator=gen).to(torch.bfloat16)},
        "opt": {"step": torch.tensor(5, dtype=torch.int32, device=card)},
        "loader": {"entry_cursor": np.asarray(12),
                   "leftover": np.arange(7, dtype=np.int32)},
    }
    mgr = CheckpointManager(str(tmp_path), processes=processes)
    stats = mgr.save(3, tree, {"loss": 1.5})
    assert not stats.get("degraded")
    back, meta = mgr.restore(target_tree=tree)
    assert meta["step"] == 3 and meta["loss"] == 1.5
    for k in ("w", "b"):
        got, want = back["params"][k], tree["params"][k]
        assert got.is_cuda and got.dtype == want.dtype
        assert torch.equal(got.view(torch.int16) if k == "b" else got,
                           want.view(torch.int16) if k == "b" else want)
    assert back["opt"]["step"].is_cuda and int(back["opt"]["step"]) == 5
    assert np.array_equal(back["loader"]["leftover"].cpu().numpy(),
                          tree["loader"]["leftover"])


# ---------------------------------------------------------------------------
# K5 / K6 against their plain versions.  Tolerances: fp32 within 2e-5
# (sums in another order); bf16 kernels against the plain version computed
# in fp32 from the same bf16 inputs, within 1.6e-2 (the output rounds to
# bf16: 2^-8 relative, and the kernel's fp32 sums differ in order).

ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 1.6e-2}


def _attn_inputs(card, seed, dtype, *shapes):
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    return [torch.randn(s, generator=g, device=card).to(dtype) for s in shapes]


@pytest.mark.parametrize("b,h,g,sq,sk,d,causal,window", [
    (1, 4, 4, 64, 64, 32, True, None),
    (2, 15, 5, 1000, 1000, 64, True, None),   # smollm's prefill heads
    (1, 8, 1, 100, 100, 256, True, None),     # gemma-2b's MQA
    (1, 4, 2, 37, 200, 64, True, None),       # Sq < Sk
    (2, 6, 2, 150, 150, 128, True, 16),       # window
    (1, 4, 2, 50, 200, 64, False, None),      # non-causal, padded kv tile
    (1, 6, 3, 20, 90, 256, False, 30),
    (2, 32, 32, 300, 300, 80, True, None),   # zamba2's shared attention
    (1, 4, 4, 70, 133, 80, False, 50),
    (1, 4, 2, 17, 17, 64, True, None),        # Sk under one kv tile
    (1, 4, 2, 9, 17, 32, False, None),
    (1, 6, 2, 1, 1000, 64, True, None),       # Sq = 1: q_offset 999
    (1, 6, 2, 129, 1000, 64, True, None),     # q_offset no tile multiple
    (1, 4, 4, 300, 300, 80, True, 100),       # D=80 with a window
    (1, 4, 1, 1000, 1000, 256, True, None),   # D=256 at the prefill length
    (2, 8, 1, 200, 300, 128, True, None),     # MQA at D=128
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_on_the_card(card, b, h, g, sq, sk, d, causal,
                                     window, dtype):
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = _attn_inputs(card, sq + sk + d, dtype, (b, h, sq, d),
                           (b, g, sk, d), (b, g, sk, d))
    before = ops.launch_counts()["flash_attention"]
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal, window=window)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("b,h,g,sq,sk,causal,window", [
    (2, 40, 40, 1000, 1000, True, None),    # minicpm3-4b's MLA prefill heads
    (1, 4, 4, 129, 129, True, None),        # a ragged second query tile
    (1, 6, 2, 77, 300, True, 50),           # GQA, Sq < Sk, window
    (1, 4, 4, 50, 200, False, None),        # non-causal, padded kv tile
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_narrow_v_on_the_card(card, b, h, g, sq, sk, causal,
                                              window, dtype):
    """K5 at q/k 96, v 64 (MLA's prefill) against its plain version; its
    LSE too."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_lse,
    )

    q, k, v = _attn_inputs(card, sq + sk + 96, dtype, (b, h, sq, 96),
                           (b, g, sk, 96), (b, g, sk, 64))
    scale = 96 ** -0.5
    before = ops.launch_counts()["flash_attention"]
    got = flash_attention(q, k, v, causal=causal, window=window, scale=scale)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert ops.launch_shapes()["flash_attention"][(b, h, g, sq, sk, 96, 64)]
    assert got.dtype == dtype and got.shape == (b, h, sq, 64)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal, window=window, scale=scale)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)
    out, lse = flash_attention_lse(q, k, v, causal=causal, window=window,
                                   scale=scale)
    assert torch.equal(out, got)
    torch.testing.assert_close(
        lse, ref.flash_attention_lse_ref(q, k, causal=causal, window=window,
                                         scale=scale), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dv", [96, 32])
def test_flash_attention_unbuilt_pairs_raise_on_the_card(card, dv):
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = _attn_inputs(card, 3, torch.bfloat16, (1, 2, 16, 96),
                           (1, 2, 16, 96), (1, 2, 16, dv))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, k, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_narrow_v_backward_refuses_on_the_card(card, dtype):
    """K5's backward is built for the forward's pairs: at q/k 96 with a v
    of 32 the backward raises before a launch; at MLA's 96 / 64 a graph is
    recorded and its backward launches once."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd,
    )

    q, k, v = _attn_inputs(card, 5, dtype, (1, 4, 64, 96), (1, 4, 64, 96),
                           (1, 4, 64, 64))
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bwd(q, k, v[..., :32], v[..., :32],
                            torch.zeros((1, 4, 64), device=card),
                            v[..., :32])
    assert ops.launch_counts() == before
    q.requires_grad_()
    flash_attention(q, k, v).backward(torch.ones((1, 4, 64, 64), dtype=dtype,
                                                 device=card))
    counts = ops.launch_counts()
    assert counts["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    assert q.grad.shape == q.shape and bool(torch.isfinite(q.grad).all())


#: MLA's K5 backward: b, h, g, sq, sk, causal, window (q/k 96, v 64)
BWD_NARROW_CASES = [
    (2, 40, 40, 1024, 1024, True, None),   # minicpm3-4b's training heads
    (1, 4, 4, 129, 300, True, None),       # ragged Sq
    (1, 4, 4, 300, 300, True, 33),         # window
    (1, 2, 2, 77, 130, False, None),       # non-causal, padded kv tile
]


@pytest.mark.parametrize("b,h,g,sq,sk,causal,window", BWD_NARROW_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_narrow_v_on_the_card(card, b, h, g, sq, sk,
                                                  causal, window, dtype):
    """K5's backward at q/k 96, v 64 against the plain version: dq and dk
    96 wide, dv 64."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_lse,
    )

    q, k, v, do = _attn_inputs(card, sq + sk + 96, dtype, (b, h, sq, 96),
                               (b, g, sk, 96), (b, g, sk, 64), (b, h, sq, 64))
    out, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
    before = ops.launch_counts()["flash_attention_bwd"]
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                              window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention_bwd"] == before + 1
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                       out.float(), lse, do.float(),
                                       causal=causal, window=window)
    for a, x, w in zip(got, (q, k, v), want):
        assert a.dtype == dtype and a.shape == x.shape
        _bwd_close(a, w, dtype)


@pytest.mark.parametrize("b,h,g,s,d", [
    (16, 15, 5, 1064, 64),    # smollm's decode
    (2, 8, 1, 700, 256),      # gemma-2b's MQA
    (3, 6, 6, 333, 32),       # MHA
    (4, 12, 4, 2000, 128),
    (16, 32, 32, 1064, 80),   # zamba2's shared attention decode
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_on_the_card(card, b, h, g, s, d, dtype):
    from repro_torch.kernels.decode_attention import decode_attention

    q, k, v = _attn_inputs(card, s + d, dtype, (b, h, d), (b, g, s, d),
                           (b, g, s, d))
    length = torch.linspace(1, s, b, device=card).round().to(torch.int32)
    tol = ATTN_TOL[dtype]
    for window in (None, 40):
        got = decode_attention(q, k, v, length=length, window=window)
        torch.cuda.synchronize()
        want = ref.decode_attention_ref(q.float(), k.float(), v.float(),
                                        length=length, window=window)
        torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("hg", [1, 3, 8])
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_lengths_and_groups_on_the_card(card, hg, d, dtype):
    """K6 with lengths 1, S and between, H / G of 1, 3 and 8."""
    from repro_torch.kernels.decode_attention import decode_attention

    b, g, s = 3, 2, 517
    q, k, v = _attn_inputs(card, hg * d, dtype, (b, g * hg, d), (b, g, s, d),
                           (b, g, s, d))
    length = torch.tensor([1, s, 250], dtype=torch.int32, device=card)
    tol = ATTN_TOL[dtype]
    for window in (None, 7):
        before = ops.launch_counts()["decode_attention"]
        got = decode_attention(q, k, v, length=length, window=window)
        torch.cuda.synchronize()
        assert ops.launch_counts()["decode_attention"] == before + 1
        want = ref.decode_attention_ref(q.float(), k.float(), v.float(),
                                        length=length, window=window)
        torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# K7 / K8 against their plain versions.  Tolerances, as
# ``|got - want| <= tol * (1 + |want|)``: fp32 within 1e-4 (the same
# step-by-step recurrence, fused multiply-adds and sums over the state
# rows in another order, compounding over up to 1,000 steps), and so are
# the fp32 states from bf16 inputs; bf16 outputs against the plain version
# computed in fp32 from the same bf16 inputs, within 1e-2 (the output
# rounds to bf16: 2^-9 relative).

SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _scan_close(got, want):
    """The tolerance follows ``got``'s dtype: a bf16 output rounds, an
    fp32 state from bf16 inputs does not."""
    tol = SCAN_TOL[got.dtype]
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= tol * (1 + want.float().abs())).all()), \
        float(diff.max())


@pytest.mark.parametrize("b,h,t,dk,dv", [
    (2, 3, 1, 16, 16), (2, 3, 31, 32, 32), (1, 4, 32, 64, 64),
    (2, 4, 100, 64, 64), (1, 2, 70, 128, 96), (16, 64, 1000, 64, 64),
    (1, 4, 96, 48, 64), (1, 4, 64, 64, 64), (2, 3, 65, 48, 40),
    (1, 2, 129, 128, 1024), (1, 3, 129, 32, 1024),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decay", ["reference", "strong", "zero"])
def test_rwkv6_scan_on_the_card(card, b, h, t, dk, dv, dtype, decay):
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan

    g = torch.Generator(device=card)
    g.manual_seed(t + dk)
    r, k = (torch.randn((b, h, t, dk), generator=g, device=card)
            for _ in range(2))
    v = torch.randn((b, h, t, dv), generator=g, device=card)
    u = torch.randn((h, dk), generator=g, device=card)
    x = torch.rand((b, h, t, dk), generator=g, device=card)
    lo, hi = {"reference": (-4.0, 1.0), "strong": (2.0, 4.0),
              "zero": (2.0, 6.0)}[decay]
    w = torch.exp(-torch.exp(lo + (hi - lo) * x))
    if decay == "zero":  # exp(-exp(6)) underflows: exact zeros, finite out
        w[..., ::7, :] = 0.0
    r, k, v, w, u = (a.to(dtype) for a in (r, k, v, w, u))
    before = ops.launch_counts()["rwkv6_scan"]
    out, state = rwkv6_scan(r, k, v, w, u)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rwkv6_scan"] == before + 1
    assert out.dtype == dtype and state.dtype == torch.float32
    assert torch.isfinite(out.float()).all() and torch.isfinite(state).all()
    want, want_s = ref.rwkv6_ref(*(a.float() for a in (r, k, v, w, u)))
    _scan_close(out, want)
    _scan_close(state, want_s)


def _mamba2_inputs(card, b, h, t, p, n, dtype, decay="reference"):
    """x, log_a, B, C on the card.  log_a: -exp(uniform(-3, 0.5)); "-inf"
    also sets every 7th step to -inf (a decay of exactly 0); "-1e4" draws
    -exp(uniform(-3, 9.2)), down to -1e4."""
    g = torch.Generator(device=card)
    g.manual_seed(t + n)
    x = torch.randn((b, h, t, p), generator=g, device=card).to(dtype)
    hi = 9.2 if decay == "-1e4" else 0.5
    log_a = -torch.exp(-3 + (hi + 3) * torch.rand((b, h, t), generator=g,
                                                  device=card))
    if decay == "-inf":
        log_a[..., ::7] = -float("inf")
    Bm, Cm = (torch.randn((b, t, n), generator=g, device=card)
              for _ in range(2))
    return x, log_a, Bm, Cm


@pytest.mark.parametrize("b,h,t,p,n", [
    (2, 3, 1, 16, 16), (2, 3, 31, 32, 32), (1, 4, 64, 64, 64),
    (2, 4, 100, 64, 64), (1, 2, 70, 96, 128), (16, 80, 1000, 64, 64),
    (1, 4, 96, 64, 48), (2, 3, 65, 40, 48), (1, 2, 129, 1024, 32),
    (2, 5, 129, 64, 64), (1, 3, 64, 40, 16), (2, 3, 70, 33, 16),
    (1, 2, 65, 1024, 128),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_ssd_on_the_card(card, b, h, t, p, n, dtype):
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd

    x, log_a, Bm, Cm = _mamba2_inputs(card, b, h, t, p, n, dtype)
    before = ops.launch_counts()["mamba2_ssd"]
    y, state = mamba2_ssd(x, log_a, Bm, Cm)
    torch.cuda.synchronize()
    assert ops.launch_counts()["mamba2_ssd"] == before + 1
    assert y.dtype == dtype and state.dtype == torch.float32
    want, want_s = ref.mamba2_ref(x.float(), log_a, Bm, Cm)
    _scan_close(y, want)
    _scan_close(state, want_s)


@pytest.mark.parametrize("decay", ["-inf", "-1e4"])
@pytest.mark.parametrize("b,h,t,p,n", [(2, 3, 130, 64, 64),
                                       (1, 4, 100, 40, 48)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_ssd_extreme_decay_on_the_card(card, b, h, t, p, n, dtype,
                                              decay):
    """Decays of exactly 0 and log-decays down to -1e4: finite, and
    within the tolerances of the plain version."""
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd

    x, log_a, Bm, Cm = _mamba2_inputs(card, b, h, t, p, n, dtype, decay)
    y, state = mamba2_ssd(x, log_a, Bm, Cm)
    torch.cuda.synchronize()
    assert torch.isfinite(y.float()).all() and torch.isfinite(state).all()
    want, want_s = ref.mamba2_ref(x.float(), log_a, Bm, Cm)
    _scan_close(y, want)
    _scan_close(state, want_s)


# ---------------------------------------------------------------------------
# K9 byteshuffle and K10 delta_zigzag: bit for bit against the plain
# versions, at ragged lengths and on views that start one element into
# their storage (unaligned pointers take the scalar paths)


def _unaligned(x):
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = flat[1:].view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16
    return y


@pytest.mark.parametrize("nb", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("n", [1, 7, 4097, 250_000])
def test_byteshuffle_on_the_card(card, nb, n):
    from repro_torch.kernels.byteshuffle import byteshuffle

    x = torch.from_numpy(np.random.default_rng(n + nb).integers(
        0, 256, (n, nb), dtype=np.uint8)).to(card)
    before = ops.launch_counts()["byteshuffle"]
    got = byteshuffle(x)
    assert ops.launch_counts()["byteshuffle"] == before + 1
    want = ref.byteshuffle_ref(x)
    assert torch.equal(got, want)
    assert torch.equal(byteshuffle(_unaligned(x)), want)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n", [1, 2, 3, 4097, 1_000_003])
def test_delta_zigzag_on_the_card(card, dtype, n):
    from repro_torch.kernels.delta_zigzag import delta_zigzag

    info = np.iinfo(dtype)
    rng = np.random.default_rng(n)
    a = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    a[::5] = np.resize(np.array([info.min, info.max, info.min + 1,
                                 info.max - 1, 0], dtype=dtype),
                       len(a[::5]))
    x = torch.from_numpy(a).to(card)
    before = ops.launch_counts()["delta_zigzag"]
    got = delta_zigzag(x)
    assert ops.launch_counts()["delta_zigzag"] == before + 1
    want = ref.delta_zigzag_ref(x)
    assert got.dtype == want.dtype
    signed = x.dtype
    assert torch.equal(got.view(signed), want.view(signed))
    assert torch.equal(delta_zigzag(_unaligned(x)).view(signed),
                       want.view(signed))
    # and the host's numpy, bit for bit
    cpu = ref.delta_zigzag_ref(torch.from_numpy(a))
    np.testing.assert_array_equal(got.cpu().numpy(), cpu.numpy())


def test_op_entries_on_the_card(card):
    """Each of the nine op entries on CUDA tensors launches its kernel and
    agrees with the plain version (exact for the codec ops)."""
    g = torch.Generator(device=card)
    g.manual_seed(5)
    ops.reset_launch_counts()
    sizes = torch.randint(0, 9, (5000,), dtype=torch.int32, device=card,
                          generator=g)
    got = ops.offsets_scan(sizes, block=128)
    assert got.dtype == torch.int32
    assert torch.equal(got, ref.offsets_scan_ref(sizes.long()).int())
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    assert torch.equal(ops.delta_zigzag(offs).view(torch.int32),
                       ref.delta_zigzag_ref(offs).view(torch.int32))
    planes = torch.randint(0, 256, (6000, 8), dtype=torch.uint8, device=card,
                           generator=g)
    assert torch.equal(ops.byteshuffle(planes, block=512), planes.t())
    pages = torch.randint(0, 256, (3, 8, 1000), dtype=torch.uint8,
                          device=card, generator=g)
    assert torch.equal(ops.unsplit_pages(pages), ref.unsplit_pages_ref(pages))
    assert torch.equal(ops.decode_offset_pages(torch.zeros_like(pages)),
                       torch.zeros((3, 1000), dtype=torch.int32, device=card))
    q, k, v = _attn_inputs(card, 6, torch.float32, (1, 4, 200, 80),
                           (1, 2, 200, 80), (1, 2, 200, 80))
    want = ref.flash_attention_ref(q, k, v)
    for impl in ("ref", "chunked"):
        torch.testing.assert_close(ops.flash_attention(q, k, v, impl=impl),
                                   want, atol=2e-5, rtol=2e-5)
    length = torch.tensor([77], dtype=torch.int32, device=card)
    torch.testing.assert_close(
        ops.decode_attention(q[:, :, 0], k, v, length=length, block_k=256),
        ref.decode_attention_ref(q[:, :, 0], k, v, length=length),
        atol=2e-5, rtol=2e-5)
    r, kk, vv, u = (torch.randn(s, generator=g, device=card) for s in
                    ((1, 2, 64, 32), (1, 2, 64, 32), (1, 2, 64, 32), (2, 32)))
    w = torch.rand((1, 2, 64, 32), generator=g, device=card)
    out, state = ops.rwkv6(r, kk, vv, w, u, chunk=16)
    want, want_s = ref.rwkv6_ref(r, kk, vv, w, u)
    _scan_close(out, want)
    _scan_close(state, want_s)
    x = torch.randn((1, 2, 128, 32), generator=g, device=card)
    log_a = -torch.rand((1, 2, 128), generator=g, device=card)
    Bm, Cm = (torch.randn((1, 128, 16), generator=g, device=card)
              for _ in range(2))
    y, state = ops.mamba2(x, log_a, Bm, Cm, chunk=32)
    want, want_s = ref.mamba2_ref(x, log_a, Bm, Cm)
    _scan_close(y, want)
    _scan_close(state, want_s)
    counts = ops.launch_counts()
    assert counts["byteshuffle_pages"] == 0
    assert all(counts[k] >= 1 for k in ops.KERNELS
               if k not in ("byteshuffle_pages", "flash_attention_bwd",
                            "rwkv6_scan_bwd", "mamba2_ssd_bwd")), counts


# ---------------------------------------------------------------------------
# K5's backward, the loader and the train step

#: K5's backward against its plain version, as |got - want| <= tol (1 +
#: |want|): fp32 within 2e-5 (the same sums in another order, over up to
#: 1,024 keys); bf16 gradients (rounded once to bf16 at the store: 2^-9
#: relative) against the plain version in fp32 on the same bf16 inputs
#: and output, within 1e-2
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
#: K5's LSE against ``ref.flash_attention_lse_ref`` (fp32 scores of the same
#: values), as |got - want| <= tol (1 + |want|): the same sums in another
#: order and ``exp2`` / ``log2`` in place of ``exp`` / ``log``
LSE_TOL = 2e-5


def _bwd_close(got, want, dtype):
    diff = (got.float() - want.float()).abs()
    bound = BWD_TOL[dtype] * (1 + want.float().abs())
    assert bool((diff <= bound).all()), float(diff.max())


BWD_CARD_CASES = [  # b, h, g, sq, sk, d, causal, window
    (2, 15, 5, 1024, 1024, 64, True, None),   # smollm-360m's training heads
    (1, 6, 2, 300, 300, 64, True, 33),        # window
    (2, 6, 2, 129, 1000, 64, True, None),     # ragged Sq
    (1, 4, 4, 77, 130, 32, False, None),      # non-causal, padded kv tile
    (1, 4, 1, 200, 200, 80, True, None),      # D=80, MQA
    (1, 4, 2, 150, 150, 128, True, 40),       # D=128 with a window
    (1, 4, 2, 203, 130, 64, True, None),      # Sq > Sk: 73 rows see no key
    (8, 8, 1, 1024, 1024, 256, True, None),   # gemma-2b's training shape
    (1, 8, 1, 300, 517, 256, True, 100),      # D=256: ragged, window
    (1, 8, 1, 203, 130, 256, True, None),     # D=256: 73 rows see no key
    (1, 4, 2, 77, 130, 256, False, None),     # D=256: non-causal, GQA
]


def _empty_rows(sq, sk, causal):
    """How many first query rows see no key (row i sits at position i + Sk
    - Sq; the causal mask shows it no key below position 0)."""
    return max(0, sq - sk) if causal else 0


@pytest.mark.parametrize("b,h,g,sq,sk,d,causal,window", BWD_CARD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_lse_on_the_card(card, b, h, g, sq, sk, d, causal,
                                         window, dtype):
    """K5's forward with its LSE: the output as without it, the LSE within
    ``LSE_TOL`` of the plain version and -inf exactly where the plain
    version's is (a row that sees no key)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_lse,
    )

    q, k, v = _attn_inputs(card, sq + sk + d + 2, dtype, (b, h, sq, d),
                           (b, g, sk, d), (b, g, sk, d))
    before = ops.launch_counts()["flash_attention"]
    out, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert torch.equal(out, flash_attention(q, k, v, causal=causal,
                                            window=window))
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    want = ref.flash_attention_lse_ref(q, k, causal=causal, window=window)
    empty = torch.isneginf(want)
    assert int(empty.sum()) == b * h * _empty_rows(sq, sk, causal)
    assert torch.equal(torch.isneginf(lse), empty)
    diff = (lse[~empty] - want[~empty]).abs()
    assert bool((diff <= LSE_TOL * (1 + want[~empty].abs())).all()), \
        float(diff.max())


@pytest.mark.parametrize("b,h,g,sq,sk,d,causal,window", BWD_CARD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_on_the_card(card, b, h, g, sq, sk, d, causal,
                                         window, dtype):
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_lse,
    )

    q, k, v, do = _attn_inputs(card, sq + sk + d + 1, dtype, (b, h, sq, d),
                               (b, g, sk, d), (b, g, sk, d), (b, h, sq, d))
    out, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
    before = ops.launch_counts()["flash_attention_bwd"]
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                              window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention_bwd"] == before + 1
    for a, x in zip(got, (q, k, v)):
        assert a.dtype == dtype and a.shape == x.shape
    # a row that sees no key: dq 0, nothing to dk or dv; the plain version
    # (NaN there) takes the other rows
    e = _empty_rows(sq, sk, causal)
    assert not bool(got[0][:, :, :e].any())
    want = ref.flash_attention_bwd_ref(q[:, :, e:].float(), k.float(),
                                       v.float(), out[:, :, e:].float(),
                                       lse[:, :, e:], do[:, :, e:].float(),
                                       causal=causal, window=window)
    for a, w in zip((got[0][:, :, e:], *got[1:]), want):
        _bwd_close(a, w, dtype)


def test_flash_attention_bwd_is_deterministic_on_the_card(card):
    """Two launches, no atomics: the same inputs give the same bits."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_lse,
    )

    q, k, v, do = _attn_inputs(card, 11, torch.bfloat16, (2, 15, 1024, 64),
                               (2, 5, 1024, 64), (2, 5, 1024, 64),
                               (2, 15, 1024, 64))
    out, lse = flash_attention_lse(q, k, v)
    first = flash_attention_bwd(q, k, v, out, lse, do)
    for a, b in zip(first, flash_attention_bwd(q, k, v, out, lse, do)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_at_head_dim_256_is_deterministic_on_the_card(
        card, dtype):
    """gemma-2b's training shape, both routes (bf16: two warpgroups split
    dK and dV by columns; fp32: 32-row tiles): the same inputs give the
    same bits, run to run."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_lse,
    )

    q, k, v, do = _attn_inputs(card, 256, dtype, (8, 8, 1024, 256),
                               (8, 1, 1024, 256), (8, 1, 1024, 256),
                               (8, 8, 1024, 256))
    out, lse = flash_attention_lse(q, k, v)
    first = flash_attention_bwd(q, k, v, out, lse, do)
    for a, b in zip(first, flash_attention_bwd(q, k, v, out, lse, do)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_flash_attention_bwd_fp32_at_gemma_shape_on_the_card(card, seed):
    """The fp32 route at gemma-2b's training shape, where dk and dv sum
    8 heads x 1,024 rows, within ``BWD_TOL`` on more than one draw of
    inputs (one draw once took dv to 1.03x the tolerance)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_lse,
    )

    q, k, v, do = _attn_inputs(card, seed, torch.float32, (8, 8, 1024, 256),
                               (8, 1, 1024, 256), (8, 1, 1024, 256),
                               (8, 8, 1024, 256))
    out, lse = flash_attention_lse(q, k, v)
    got = flash_attention_bwd(q, k, v, out, lse, do)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do)
    for a, w in zip(got, want):
        _bwd_close(a, w, torch.float32)


def test_flash_attention_bwd_refuses_an_unbuilt_head_dim_on_the_card(card):
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    q = torch.zeros((1, 1, 4, 96), device=card)
    lse = torch.zeros((1, 1, 4), device=card)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bwd(q, q, q, q, lse, q)


def test_kernels_without_backward_refuse_grad_on_the_card(card):
    """K6 (one-token decode) is the one kernel with no backward."""
    from repro_torch.kernels.decode_attention import decode_attention

    q = torch.zeros((1, 2, 64), device=card, requires_grad=True)
    kv = torch.zeros((1, 2, 8, 64), device=card)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        decode_attention(q, kv, kv)


#: K7's and K8's backward: b, h, t, state width (Dk or N), columns (Dv or
#: P), decays ("zero": w = 0 / log_a = -inf every 7th step), and whether
#: the final state gets a cotangent
SCAN_BWD_CASES = [
    (2, 3, 1, 16, 16, "reference", True),
    (2, 3, 31, 32, 32, "zero", True),
    (1, 4, 100, 48, 40, "reference", False),
    (2, 2, 129, 64, 70, "zero", True),      # two column tiles
    (1, 2, 70, 128, 96, "reference", True),
    (1, 2, 33, 32, 1024, "reference", False),
    (8, 64, 1024, 64, 64, "reference", True),  # rwkv6-7b's / zamba2's
]


def _wide(dtype):
    """The plain backward's dtype for a route: the bf16 route against the
    plain version in fp32, the fp32 route in fp64 (the kernels carry their
    sums in fp64; an fp32 plain version's own rounding, where sums cancel,
    uses most of 2e-5 (1 + |g|))."""
    return torch.float64 if dtype == torch.float32 else torch.float32


def _scan_bwd_close(got, want, dtype):
    """``dtype``: the route's (the tolerance's); every gradient finite."""
    assert bool(torch.isfinite(got.float()).all())
    diff = (got.to(want.dtype) - want).abs()
    bound = BWD_TOL[dtype] * (1 + want.abs())
    assert bool((diff <= bound).all()), float(diff.max())


@pytest.mark.parametrize("b,h,t,dk,dv,decay,with_state", SCAN_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_bwd_on_the_card(card, b, h, t, dk, dv, decay,
                                    with_state, dtype):
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_bwd

    g = torch.Generator(device=card)
    g.manual_seed(t + dk + dv)
    r, k = (0.5 * torch.randn((b, h, t, dk), generator=g, device=card)
            for _ in range(2))
    v, do = (torch.randn((b, h, t, dv), generator=g, device=card)
             for _ in range(2))
    u = torch.randn((h, dk), generator=g, device=card)
    w = torch.exp(-torch.exp(-4 + 5 * torch.rand((b, h, t, dk), generator=g,
                                                 device=card)))
    if decay == "zero":
        w[..., ::7, :] = 0.0
    ds = (torch.randn((b, h, dk, dv), generator=g, device=card)
          if with_state else None)
    r, k, v, w, u, do = (a.to(dtype) for a in (r, k, v, w, u, do))
    before = ops.launch_counts()["rwkv6_scan_bwd"]
    got = rwkv6_scan_bwd(r, k, v, w, u, do, ds)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rwkv6_scan_bwd"] == before + 1
    want = ref.rwkv6_bwd_ref(*(a.to(_wide(dtype)) for a in (r, k, v, w, u, do)),
                             None if ds is None else ds.to(_wide(dtype)))
    for a, x in zip(got, want):
        assert a.dtype == dtype
        _scan_bwd_close(a, x, dtype)


@pytest.mark.parametrize("b,h,t,n,p,decay,with_state", SCAN_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_ssd_bwd_on_the_card(card, b, h, t, n, p, decay, with_state,
                                    dtype):
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd_bwd

    x, log_a, Bm, Cm = _mamba2_inputs(card, b, h, t, p, n, dtype,
                                      "-inf" if decay == "zero" else decay)
    g = torch.Generator(device=card)
    g.manual_seed(t + n + p)
    dy = torch.randn((b, h, t, p), generator=g, device=card).to(dtype)
    ds = (torch.randn((b, h, n, p), generator=g, device=card)
          if with_state else None)
    before = ops.launch_counts()["mamba2_ssd_bwd"]
    got = mamba2_ssd_bwd(x, log_a, Bm, Cm, dy, ds)
    torch.cuda.synchronize()
    assert ops.launch_counts()["mamba2_ssd_bwd"] == before + 1
    wide = _wide(dtype)
    want = ref.mamba2_bwd_ref(x.to(wide), log_a.to(wide), Bm.to(wide),
                              Cm.to(wide), dy.to(wide),
                              None if ds is None else ds.to(wide))
    assert got[0].dtype == dtype  # dlog_a, dB and dC: fp32, as their inputs
    assert all(a.dtype == torch.float32 for a in got[1:])
    for a, x_ in zip(got, want):
        _scan_bwd_close(a, x_, dtype)


def test_scan_bwds_are_deterministic_on_the_card(card):
    """No float atomics: the same inputs give the same bits."""
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd_bwd
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_bwd

    x, log_a, Bm, Cm = _mamba2_inputs(card, 2, 8, 300, 70, 64,
                                      torch.bfloat16)
    dy = torch.ones_like(x)
    first = mamba2_ssd_bwd(x, log_a, Bm, Cm, dy)
    for a, b_ in zip(first, mamba2_ssd_bwd(x, log_a, Bm, Cm, dy)):
        assert torch.equal(a, b_)
    r = torch.rand((2, 8, 300, 64), device=card)
    v = torch.randn((2, 8, 300, 70), device=card)
    u = torch.randn((8, 64), device=card)
    first = rwkv6_scan_bwd(r, r, v, r, u, v)
    for a, b_ in zip(first, rwkv6_scan_bwd(r, r, v, r, u, v)):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("kind", ["wkv", "ssd"])
def test_chunked_scan_bwds_give_the_same_bits_twice_on_the_card(card, kind):
    """The bf16 routes (the chunked kernels) with a final-state cotangent,
    several column tiles and, for K8, several groups of 8 heads whose dB
    and dC partials a last launch adds: two calls give the same bits."""
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd_bwd
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_bwd

    g = torch.Generator(device=card)
    g.manual_seed(97)
    rnd = lambda *s: torch.randn(s, generator=g, device=card)
    if kind == "ssd":
        x, log_a, Bm, Cm = _mamba2_inputs(card, 2, 20, 300, 130, 64,
                                          torch.bfloat16)
        args = (x, log_a, Bm, Cm, rnd(2, 20, 300, 130).bfloat16(),
                rnd(2, 20, 64, 130))
        fn = mamba2_ssd_bwd
    else:
        w = torch.exp(-torch.exp(-4 + 5 * torch.rand(
            (2, 8, 300, 64), generator=g, device=card)))
        args = tuple(a.bfloat16() for a in (
            rnd(2, 8, 300, 64), rnd(2, 8, 300, 64), rnd(2, 8, 300, 130), w,
            rnd(8, 64), rnd(2, 8, 300, 130))) + (rnd(2, 8, 64, 130),)
        fn = rwkv6_scan_bwd
    first = fn(*args)
    for a, b_ in zip(first, fn(*args)):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("kind", ["wkv", "ssd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,rows,cols", [
    (1, 1, 1, 16, 1), (2, 3, 17, 48, 70), (8, 64, 1024, 64, 64),
    (8, 80, 1024, 64, 64), (1, 2, 1000, 128, 1024)])
def test_scan_bwd_workspace_is_the_dryruns_on_the_card(card, kind, dtype, b,
                                                       h, t, rows, cols):
    """The workspace a K7 or K8 backward launch takes, as the C library
    sizes it, is what the dry-run counts (``meta.scan_bwd_workspace_bytes``)."""
    from repro_torch.kernels import _build, meta
    from repro_torch.kernels.flash_attention import DTYPE_CODES

    lib = _build.library("ssm")
    query = (lib.repro_rwkv6_scan_bwd_ws if kind == "wkv"
             else lib.repro_mamba2_ssd_bwd_ws)
    floats = query(b, h, t, rows, cols, DTYPE_CODES[dtype])
    assert 4 * floats == meta.scan_bwd_workspace_bytes(kind, dtype, b, h, t,
                                                       rows, cols)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_autograd_on_the_card(card, dtype):
    """``backward`` through K7 and K8 launches each backward kernel once
    and gives what the backward entry gives (the final state's cotangent
    left out: zero)."""
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd, mamba2_ssd_bwd
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_bwd

    g = torch.Generator(device=card)
    g.manual_seed(7)
    ins = [torch.rand((2, 4, 50, 32), generator=g, device=card).to(dtype)
           for _ in range(2)]
    ins += [torch.randn((2, 4, 50, 48), generator=g, device=card).to(dtype),
            torch.rand((2, 4, 50, 32), generator=g, device=card).to(dtype),
            torch.randn((4, 32), generator=g, device=card).to(dtype)]
    leaves = [a.clone().requires_grad_(True) for a in ins]
    out, _state = rwkv6_scan(*leaves)
    do = torch.randn(out.shape, generator=g, device=card).to(dtype)
    before = ops.launch_counts()["rwkv6_scan_bwd"]
    out.backward(do)
    assert ops.launch_counts()["rwkv6_scan_bwd"] == before + 1
    for a, w in zip(leaves, rwkv6_scan_bwd(*ins, do)):
        assert torch.equal(a.grad, w)
    x, log_a, Bm, Cm = _mamba2_inputs(card, 2, 4, 50, 48, 32, dtype)
    leaves = [a.clone().requires_grad_(True) for a in (x, log_a, Bm, Cm)]
    y, _state = mamba2_ssd(*leaves)
    before = ops.launch_counts()["mamba2_ssd_bwd"]
    y.backward(torch.ones_like(y))
    assert ops.launch_counts()["mamba2_ssd_bwd"] == before + 1
    for a, w in zip(leaves, mamba2_ssd_bwd(x, log_a, Bm, Cm,
                                           torch.ones_like(y))):
        assert torch.equal(a.grad, w)


def test_flash_attention_autograd_on_the_card(card):
    """``backward`` through K5 launches the backward kernel and gives the
    plain version's gradients (fp32)."""
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v, do = _attn_inputs(card, 3, torch.float32, (2, 6, 200, 64),
                               (2, 2, 200, 64), (2, 2, 200, 64),
                               (2, 6, 200, 64))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(ops.launch_counts())
    flash_attention(*leaves, window=50).backward(do)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == before["flash_attention"] + 1
    assert counts["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    want = ref.flash_attention_bwd_ref(
        q, k, v, ref.flash_attention_ref(q, k, v, window=50),
        ref.flash_attention_lse_ref(q, k, window=50), do, window=50)
    for t, w in zip(leaves, want):
        _bwd_close(t.grad, w, torch.float32)


def test_loader_device_engine_on_the_card(card, tmp_path):
    """The device engine on the card (K3/K4 decode, torch packing) emits
    the host engine's stream over two epochs and across a resume."""
    from repro_torch.pipeline import PackedLoader, ingest_corpus, synth_corpus

    p = str(tmp_path / "c.rntj")
    ingest_corpus(synth_corpus(400, seed=9, mean_len=60), p, n_workers=2,
                  options=T.WriteOptions(codec="zlib", level=1,
                                         cluster_bytes=64 * 1024),
                  device=card)
    ops.reset_launch_counts()
    ld = PackedLoader(p, batch=4, seq_len=96, device=card)
    lh = PackedLoader(p, batch=4, seq_len=96, engine="host", device=card)
    gd, gh = ld.batches(), lh.batches()
    for i in range(160):
        bd, bh = next(gd), next(gh)
        assert bd["tokens"].device.type == "cuda"
        np.testing.assert_array_equal(bd["tokens"].cpu().numpy(),
                                      bh["tokens"], err_msg=str(i))
        np.testing.assert_array_equal(bd["labels"].cpu().numpy(),
                                      bh["labels"], err_msg=str(i))
    counts = ops.launch_counts()
    assert counts["decode_offset_pages"] > 0 and counts["unsplit_pages"] > 0
    state = ld.state()
    cont = [next(gd)["tokens"].cpu().numpy() for _ in range(10)]
    l2 = PackedLoader(p, batch=4, seq_len=96, state=state, device=card)
    g2 = l2.batches()
    for want in cont:
        np.testing.assert_array_equal(next(g2)["tokens"].cpu().numpy(), want)
    ld.close(), lh.close(), l2.close()


def test_train_step_on_the_card(card, monkeypatch):
    """One train step of the smollm-360m smoke config in fp32 compute on
    the card against the same step with the plain attention forward and
    backward: losses within 1e-5, parameters within 2e-4 absolute (Adam's
    first step moves a weight by about lr whatever its gradient's size)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import attention as TA
    from repro_torch.models import build
    from repro_torch.train import (
        init_train_state, make_optimizer, make_train_step,
    )

    cfg = smoke_config("smollm-360m").with_(compute_dtype="float32",
                                            remat=True)
    bundle = build(cfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (4, 65)).astype(np.int32)
    batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}

    def run():
        opt = make_optimizer(peak_lr=3e-3, warmup=1, total=20)
        params, opt_state, err = init_train_state(bundle, seed=0, device=card,
                                                  optimizer=opt)
        step = make_train_step(bundle, optimizer=opt)
        params, _o, _e, m = step(params, opt_state, err, batch)
        return float(m["loss"]), params

    ops.reset_launch_counts()
    loss, params = run()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 2 * cfg.n_layers  # remat: twice
    assert counts["flash_attention_bwd"] == cfg.n_layers
    monkeypatch.setattr(TA, "flash_attention", ref.flash_attention_ref)
    loss2, params2 = run()
    assert abs(loss - loss2) <= 1e-5
    for k in params["layers"]["attn"]:
        torch.testing.assert_close(params["layers"]["attn"][k],
                                   params2["layers"]["attn"][k], atol=2e-4,
                                   rtol=0)
