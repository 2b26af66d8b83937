"""The port's merging baselines: hadd analog and TBufferMerger analog
(paper §2, §6.2), on the CPU.

The cases of ``tests/test_merge.py`` run on ``repro_torch.core`` with
``device="cpu"``; then both packages merge the same input bytes and the
outputs must be byte-identical: the raw cluster copy, the re-encode path
(with the port's kernel floors at 0, so every fill and seal runs the
plain versions of K1 and K2), and one ``BufferMerger`` producer.
"""

import threading
from collections import Counter

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
import repro_torch.kernels.byteshuffle as t_shuffle
import repro_torch.kernels.offsets_scan as t_scan
from repro_torch.core import (
    BufferMerger, Collection, ColumnBatch, Leaf, RNTJReader, Schema,
    SequentialWriter, WriteOptions, merge_files,
)


def schema():
    return Schema([Leaf("id", "int64"), Collection("vals", Leaf("_0", "float32"))])


def write_one(path, seed, n=300):
    s = schema()
    rng = np.random.default_rng(seed)
    sizes = rng.poisson(5, n).astype(np.int64)
    vals = rng.uniform(0, 100, int(sizes.sum())).astype(np.float32)
    batch = ColumnBatch.from_arrays(
        s, n, {"id": np.arange(seed * 10_000, seed * 10_000 + n),
               "vals": sizes, "vals._0": vals})
    with SequentialWriter(s, path, WriteOptions(cluster_bytes=4096), device="cpu") as w:
        w.fill_batch(batch)
    return batch


def test_merge_files_preserves_everything(tmp_path):
    paths = [str(tmp_path / f"in{i}.rntj") for i in range(3)]
    batches = [write_one(p, i) for i, p in enumerate(paths)]
    out = str(tmp_path / "merged.rntj")
    merge_files(paths, out, device="cpu")
    r = RNTJReader(out, device="cpu")
    assert r.n_entries == 900
    ids = np.sort(r.read_column("id"))
    expect = np.sort(np.concatenate([b.data[0] for b in batches]))
    np.testing.assert_array_equal(ids, expect)
    vals = r.read_column("vals._0")
    assert len(vals) == sum(int(b.data[1].sum()) for b in batches)


def test_merge_rejects_schema_mismatch(tmp_path):
    p1 = str(tmp_path / "a.rntj")
    write_one(p1, 0)
    s2 = Schema([Leaf("other", "int32")])
    p2 = str(tmp_path / "b.rntj")
    with SequentialWriter(s2, p2, device="cpu") as w:
        w.fill({"other": 1})
    with pytest.raises(ValueError):
        merge_files([p1, p2], str(tmp_path / "out.rntj"), device="cpu")


def test_merge_is_byte_verbatim(tmp_path):
    """Relocatability means merged clusters keep identical compressed bytes."""
    p = str(tmp_path / "in.rntj")
    write_one(p, 1)
    out = str(tmp_path / "out.rntj")
    merge_files([p], out, device="cpu")
    rin, rout = RNTJReader(p, device="cpu"), RNTJReader(out, device="cpu")
    for cin, cout in zip(rin.clusters, rout.clusters):
        bin_ = rin.sink.pread(cin.byte_offset, cin.byte_size)
        bout = rout.sink.pread(cout.byte_offset, cout.byte_size)
        assert bin_ == bout


def test_merge_auto_recompresses_on_codec_mismatch(tmp_path):
    """Asking for zlib output from a codec-none input takes the re-encode
    slow path: values survive, pages come out in the target codec."""
    s = schema()
    p = str(tmp_path / "raw.rntj")
    rng = np.random.default_rng(4)
    n = 3000
    sizes = rng.poisson(5, n).astype(np.int64)
    vals = rng.uniform(0, 100, int(sizes.sum())).astype(np.float32)
    batch = ColumnBatch.from_arrays(
        s, n, {"id": np.arange(n), "vals": sizes, "vals._0": vals})
    with SequentialWriter(s, p, WriteOptions(codec="none",
                                             cluster_bytes=64 * 1024), device="cpu") as w:
        w.fill_batch(batch)
    out = str(tmp_path / "zl.rntj")
    merge_files([p], out, WriteOptions(codec="zlib", level=1,
                                       cluster_bytes=64 * 1024), device="cpu")
    r = RNTJReader(out, device="cpu")
    np.testing.assert_array_equal(r.read_column("id"), np.arange(n))
    np.testing.assert_array_equal(r.read_column("vals._0"), vals)
    # the compressible id/offset pages really were transcoded to zlib
    assert any(pg.codec == 1 for cm in r.clusters for pg in cm.pages)
    import os
    assert os.path.getsize(out) < os.path.getsize(p)


def test_merge_recompress_false_forces_raw_copy(tmp_path):
    """recompress=False keeps byte-verbatim clusters even when the
    requested codec differs from the input's."""
    s = schema()
    p = str(tmp_path / "raw.rntj")
    write_one(p, 2)  # zlib input
    out = str(tmp_path / "none.rntj")
    merge_files([p], out, WriteOptions(codec="none"), recompress=False, device="cpu")
    rin, rout = RNTJReader(p, device="cpu"), RNTJReader(out, device="cpu")
    for cin, cout in zip(rin.clusters, rout.clusters):
        assert (rin.sink.pread(cin.byte_offset, cin.byte_size)
                == rout.sink.pread(cout.byte_offset, cout.byte_size))


def test_merge_missing_input_leaks_nothing(tmp_path):
    """A failed open mid-list must close the readers already opened."""
    import os
    p1 = str(tmp_path / "a.rntj")
    write_one(p1, 0)
    fds_before = len(os.listdir("/proc/self/fd"))
    for _ in range(5):
        with pytest.raises(FileNotFoundError):
            merge_files([p1, str(tmp_path / "missing.rntj")],
                        str(tmp_path / "o.rntj"), device="cpu")
    assert len(os.listdir("/proc/self/fd")) <= fds_before


def test_buffer_merger_threads(tmp_path):
    s = schema()
    out = str(tmp_path / "bm.rntj")
    bm = BufferMerger(s, out, WriteOptions(cluster_bytes=2048), device="cpu")
    N, T = 150, 6
    def worker(tid):
        rng = np.random.default_rng(tid)
        f = bm.get_file()
        sizes = rng.poisson(5, N).astype(np.int64)
        vals = rng.uniform(0, 100, int(sizes.sum())).astype(np.float32)
        batch = ColumnBatch.from_arrays(
            s, N, {"id": np.arange(tid * 1000, tid * 1000 + N),
                   "vals": sizes, "vals._0": vals})
        f.fill_batch(batch)
        f.commit()
        f.close()
    ts = [threading.Thread(target=worker, args=(t,)) for t in range(T)]
    for t in ts: t.start()
    for t in ts: t.join()
    bm.close()
    r = RNTJReader(out, device="cpu")
    assert r.n_entries == N * T
    ids = np.sort(r.read_column("id"))
    expect = np.sort(np.concatenate([np.arange(t * 1000, t * 1000 + N) for t in range(T)]))
    np.testing.assert_array_equal(ids, expect)


# ---------------------------------------------------------------------------
# both packages merge the same input bytes


def _ref_inputs(tmp_path, codec="zlib", n=2):
    s = R.Schema([R.Leaf("id", "int64"),
                  R.Collection("vals", R.Leaf("_0", "float32"))])
    paths = []
    for seed in range(n):
        rng = np.random.default_rng(seed)
        k = 2000
        sizes = rng.poisson(5, k).astype(np.int64)
        vals = rng.uniform(0, 100, int(sizes.sum())).astype(np.float32)
        p = str(tmp_path / f"in{seed}.rntj")
        with R.SequentialWriter(s, p, R.WriteOptions(
                codec=codec, cluster_bytes=16 * 1024)) as w:
            w.fill_batch(R.ColumnBatch.from_arrays(s, k, {
                "id": np.arange(seed * 10_000, seed * 10_000 + k),
                "vals": sizes, "vals._0": vals}))
        paths.append(p)
    return paths


MERGE_ROUTES = {
    # name: (input codec, output options, recompress)
    "raw": ("zlib", None, None),
    "codec_mismatch": ("none", dict(codec="zlib", level=1, page_size=4096,
                                    cluster_bytes=32 * 1024), None),
    "recompress": ("zlib", dict(codec="zlib", level=1, page_size=4096), True),
    "raw_forced": ("zlib", dict(codec="none"), False),
}


@pytest.mark.parametrize("kernels", ["plain_kernels", "numpy"])
@pytest.mark.parametrize("route", list(MERGE_ROUTES))
def test_merge_files_is_byte_identical_to_the_reference(tmp_path, monkeypatch,
                                                        route, kernels):
    calls = Counter()
    if kernels == "plain_kernels":
        monkeypatch.setenv("REPRO_TORCH_OFFSETS_MIN", "0")
        monkeypatch.setenv("REPRO_TORCH_SHUFFLE_MIN", "0")
        for mod, name in ((t_scan, "offsets_scan_host"),
                          (t_shuffle, "byteshuffle_pages_host")):
            entry = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _e=entry, _n=name, **k: (
                calls.update([_n]), _e(*a, **k))[1])
    else:
        monkeypatch.setenv("REPRO_TORCH_KERNEL_BACKEND", "numpy")
    codec, opts, recompress = MERGE_ROUTES[route]
    inputs = _ref_inputs(tmp_path, codec)
    ref_out, port_out = str(tmp_path / "ref.rntj"), str(tmp_path / "port.rntj")
    R.merge_files(inputs, ref_out,
                  R.WriteOptions(**opts) if opts is not None else None,
                  recompress=recompress)
    T.merge_files(inputs, port_out,
                  T.WriteOptions(**opts) if opts is not None else None,
                  recompress=recompress, device="cpu")
    a, b = open(ref_out, "rb").read(), open(port_out, "rb").read()
    assert a == b
    with R.RNTJReader(ref_out) as r:
        assert r.n_entries == 4000
    # the re-encode routes fill and seal through K1 and K2 (their plain
    # versions here); the raw copies run neither
    reencodes = route in ("codec_mismatch", "recompress")
    assert (calls["offsets_scan_host"] > 0) == (
        reencodes and kernels == "plain_kernels")
    assert (calls["byteshuffle_pages_host"] > 0) == (
        reencodes and kernels == "plain_kernels")


def test_buffer_merger_one_producer_is_byte_identical(tmp_path):
    rng = np.random.default_rng(7)
    k = 1500
    sizes = rng.poisson(5, k).astype(np.int64)
    vals = rng.uniform(0, 100, int(sizes.sum())).astype(np.float32)
    arrays = {"id": np.arange(k), "vals": sizes, "vals._0": vals}
    outs = []
    for pkg, kw in ((R, {}), (T, {"device": "cpu"})):
        s = pkg.Schema([pkg.Leaf("id", "int64"),
                        pkg.Collection("vals", pkg.Leaf("_0", "float32"))])
        out = str(tmp_path / f"{pkg.__name__}.rntj")
        bm = pkg.BufferMerger(s, out, pkg.WriteOptions(cluster_bytes=4096),
                              **kw)
        f = bm.get_file()
        f.fill_batch(pkg.ColumnBatch.from_arrays(s, k, arrays))
        f.close()
        bm.close()
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1]


def test_merge_refuses_without_a_card(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inputs = _ref_inputs(tmp_path, n=1)
    out = tmp_path / "never.rntj"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.merge_files(inputs, str(out))
    assert not out.exists()
    with pytest.raises(RuntimeError):
        T.BufferMerger(T.Schema([T.Leaf("id", "int64")]), str(out))
