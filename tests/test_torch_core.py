"""The port's write -> read path against the JAX package's, on the CPU.

* Byte identity: one producer, the same schema, batches and options — the
  port (``device="cpu"``, size floors 0, so the plain versions of K1 and
  K2 run inside fill and seal) and the reference (its offsets scan and
  byteshuffle forced to the Pallas kernels in interpret mode) write
  byte-identical files.
* Cross-read: each package reads the other's files.
* Device read-back: the port's ``iter_clusters_device`` equals the
  reference's and its host ``read_cluster``.

The schema and the options travel as plain data (``Schema.to_json`` and
``dataclasses.asdict``): this system has no weights, only the schema, the
options and the file.
"""

import dataclasses
import os
from collections import Counter

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import encoding as R_enc
from repro.kernels.byteshuffle import byteshuffle_pages_host as r_shuffle_host
from repro.kernels.offsets_scan import offsets_scan_host as r_scan_host

import repro_torch.core as T
import repro_torch.kernels.byteshuffle as t_shuffle
import repro_torch.kernels.offsets_scan as t_scan
from repro_torch.kernels import ops

# six test workers share the cores: one thread each, not one per core
torch.set_num_threads(max(1, os.cpu_count() // 6))

REF_SCHEMA = R.Schema([
    R.Leaf("id", "int64"),
    R.Leaf("x", "float32"),
    R.Leaf("h", "uint16"),
    R.Collection("v", R.Leaf("_0", "int32")),
    R.Collection("f", R.Leaf("_0", "uint8")),
    R.Collection("js", R.Record("_0", [R.Leaf("pt", "float32"),
                                       R.Leaf("q", "uint32")])),
])


def _port_schema():
    return T.Schema.from_json(REF_SCHEMA.to_json())


def _make_data(n, seed=0):
    rng = np.random.default_rng(seed)
    sv, sf, sj = (rng.poisson(lam, n).astype(np.int64) for lam in (4, 2, 1.5))
    return {
        "id": np.arange(n, dtype=np.int64),
        "x": rng.uniform(0, 1, n).astype(np.float32),
        "h": rng.integers(0, 1 << 16, n).astype(np.uint16),
        "v": sv, "v._0": rng.integers(-(1 << 20), 1 << 20,
                                      int(sv.sum())).astype(np.int32),
        "f": sf, "f._0": rng.integers(0, 256, int(sf.sum())).astype(np.uint8),
        "js": sj,
        "js._0.pt": rng.standard_normal(int(sj.sum())).astype(np.float32),
        "js._0.q": rng.integers(0, 1 << 32, int(sj.sum()),
                                dtype=np.uint64).astype(np.uint32),
    }


def _batches(mod, schema, data, n, step):
    ends = {k: np.cumsum(data[k]) for k in ("v", "f", "js")}
    for s in range(0, n, step):
        e = min(s + step, n)
        arrays = {}
        for path, arr in data.items():
            top = path.split(".")[0]
            if path == top:
                arrays[path] = arr[s:e]
            else:  # a collection's elements of entries [s, e)
                end = ends[top]
                arrays[path] = arr[(0 if s == 0 else end[s - 1]):end[e - 1]]
        yield mod.ColumnBatch.from_arrays(schema, e - s, arrays)


def _write(mod, schema, path, opts, data, n, kind, step=1500, **kw):
    if kind == "seq":
        with mod.SequentialWriter(schema, path, opts, **kw) as w:
            for b in _batches(mod, schema, data, n, step):
                w.fill_batch(b)
    else:
        with mod.ParallelWriter(schema, path, opts, **kw) as w:
            ctx = w.create_fill_context()
            for b in _batches(mod, schema, data, n, step):
                ctx.fill_batch(b)
            ctx.close()


def _counting(calls, name, fn):
    def run(*args):
        calls[name] += 1
        return fn(*args)
    return run


@pytest.fixture
def kernels_everywhere(monkeypatch):
    """Both packages route every fill and seal through their kernels: the
    port's floors at 0 (plain versions on the CPU), the reference's
    dispatch forced to its Pallas kernels in interpret mode.  Yields the
    count of host-entry calls per package and kernel."""
    calls = Counter()
    monkeypatch.setenv("REPRO_TORCH_OFFSETS_MIN", "0")
    monkeypatch.setenv("REPRO_TORCH_SHUFFLE_MIN", "0")
    monkeypatch.delenv("REPRO_TORCH_KERNEL_BACKEND", raising=False)
    monkeypatch.setattr(t_scan, "offsets_scan_host", _counting(
        calls, "port_offsets", t_scan.offsets_scan_host))
    monkeypatch.setattr(t_shuffle, "byteshuffle_pages_host", _counting(
        calls, "port_shuffle", t_shuffle.byteshuffle_pages_host))
    for d, name, entry in ((R_enc._OFFSETS, "ref_offsets", r_scan_host),
                           (R_enc._SHUFFLE, "ref_shuffle", r_shuffle_host)):
        monkeypatch.setattr(d, "backend", "pallas")
        monkeypatch.setattr(d, "_kernel", _counting(calls, name, entry))
    yield calls


N = 6000


@pytest.mark.parametrize("kind", ["seq", "par"])
@pytest.mark.parametrize("codec", ["none", "zlib"])
@pytest.mark.parametrize("buffered", [True, False])
@pytest.mark.parametrize("imt_workers", [0, 2])
def test_one_producer_files_are_byte_identical(tmp_path, kernels_everywhere,
                                               kind, codec, buffered,
                                               imt_workers):
    data = _make_data(N)
    opts = R.WriteOptions(codec=codec, buffered=buffered,
                          imt_workers=imt_workers, zone_maps=True,
                          page_size=4096, cluster_bytes=96 * 1024)
    ref_path, port_path = tmp_path / "ref.rntj", tmp_path / "port.rntj"
    _write(R, REF_SCHEMA, str(ref_path), opts, data, N, kind)
    _write(T, _port_schema(), str(port_path),
           T.write_options_from_dict(dataclasses.asdict(opts)), data, N, kind,
           device="cpu")
    a, b = ref_path.read_bytes(), port_path.read_bytes()
    assert len(a) == len(b)
    assert a == b
    # every fill batch went through K1 in both packages, every cluster
    # seal through K2 (the parallel writer's unbuffered pages drain
    # without the batched split; the sequential writer always seals)
    calls = kernels_everywhere
    assert calls["port_offsets"] == calls["ref_offsets"] > 0
    assert calls["port_shuffle"] == calls["ref_shuffle"]
    assert (calls["port_shuffle"] > 0) == (buffered or kind == "seq")
    with R.RNTJReader(str(ref_path)) as r:
        assert r.n_clusters >= 3  # several seals, each through K2


def test_write_options_round_trip_as_plain_data():
    opts = R.WriteOptions(codec="zlib", level=3, imt_workers=2,
                          retry_policy=R.RetryPolicy(max_attempts=7),
                          column_codecs={"x": ("zlib", 1)})
    back = T.write_options_from_dict(dataclasses.asdict(opts))
    assert dataclasses.asdict(back) == dataclasses.asdict(opts)
    assert isinstance(back.retry_policy, T.RetryPolicy)
    assert back.as_dict() == opts.as_dict()


def test_the_numpy_backend_writes_the_same_file(tmp_path, monkeypatch):
    data = _make_data(N)
    opts = T.WriteOptions(page_size=4096, cluster_bytes=96 * 1024)
    monkeypatch.setenv("REPRO_TORCH_OFFSETS_MIN", "0")
    monkeypatch.setenv("REPRO_TORCH_SHUFFLE_MIN", "0")
    _write(T, _port_schema(), str(tmp_path / "k.rntj"), opts, data, N, "seq",
           device="cpu")
    monkeypatch.setenv("REPRO_TORCH_KERNEL_BACKEND", "numpy")
    _write(T, _port_schema(), str(tmp_path / "n.rntj"), opts, data, N, "seq",
           device="cpu")
    assert (tmp_path / "k.rntj").read_bytes() == (tmp_path / "n.rntj").read_bytes()


# ---------------------------------------------------------------------------
# cross-read


def _assert_same_clusters(a_reader, b_reader):
    assert a_reader.n_clusters == b_reader.n_clusters
    assert a_reader.n_entries == b_reader.n_entries
    for i in range(a_reader.n_clusters):
        ca, cb = a_reader.read_cluster(i), b_reader.read_cluster(i)
        assert set(ca) == set(cb)
        for ci in ca:
            assert ca[ci].dtype == cb[ci].dtype
            np.testing.assert_array_equal(ca[ci], cb[ci])


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_package_reads_the_others_files(tmp_path, writer):
    n = 4000
    data = _make_data(n, seed=7)
    opts = R.WriteOptions(codec="zlib", page_size=4096,
                          cluster_bytes=64 * 1024)
    path = str(tmp_path / f"{writer}.rntj")
    if writer == "ref":
        _write(R, REF_SCHEMA, path, opts, data, n, "par")
    else:
        _write(T, _port_schema(), path,
               T.write_options_from_dict(dataclasses.asdict(opts)), data, n,
               "par", device="cpu")
    with R.RNTJReader(path) as rr, T.RNTJReader(path, device="cpu") as tr:
        assert tr.schema.to_json() == rr.schema.to_json()
        _assert_same_clusters(rr, tr)
        np.testing.assert_array_equal(tr.read_column("js._0.q"),
                                      data["js._0.q"])
        np.testing.assert_array_equal(tr.read_column("x"), data["x"])
        assert list(tr.iter_entries())[:50] == list(rr.iter_entries())[:50]


# ---------------------------------------------------------------------------
# device read-back


def _write_mixed(tmp_path, codec, n=25_000):
    """The reference's device-decode fixture: an 8-byte leaf (host
    fallback), a float leaf, a split int32 collection and a uint8 ("none")
    collection, several clusters."""
    schema = R.Schema([
        R.Leaf("id", "int64"),
        R.Leaf("x", "float32"),
        R.Collection("v", R.Leaf("_0", "int32")),
        R.Collection("f", R.Leaf("_0", "uint8")),
    ])
    rng = np.random.default_rng(5)
    sv = rng.poisson(4, n).astype(np.int64)
    sf = rng.poisson(2, n).astype(np.int64)
    x = rng.uniform(0, 1, n).astype(np.float32)
    vv = rng.integers(0, 1 << 20, int(sv.sum())).astype(np.int32)
    fv = rng.integers(0, 256, int(sf.sum())).astype(np.uint8)
    ev, ef = np.cumsum(sv), np.cumsum(sf)
    path = str(tmp_path / f"mix_{codec}.rntj")
    with R.SequentialWriter(schema, path, R.WriteOptions(
            codec=codec, cluster_bytes=128 * 1024, page_size=16 * 1024)) as w:
        for s in range(0, n, 3000):
            e = min(s + 3000, n)
            w.fill_batch(R.ColumnBatch.from_arrays(schema, e - s, {
                "id": np.arange(s, e, dtype=np.int64),
                "x": x[s:e],
                "v": sv[s:e], "v._0": vv[(0 if not s else ev[s-1]):ev[e-1]],
                "f": sf[s:e], "f._0": fv[(0 if not s else ef[s-1]):ef[e-1]],
            }))
    return path


def _as_numpy(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


@pytest.mark.parametrize("codec", ["none", "zlib"])
def test_device_read_back_equals_reference_and_host(tmp_path, codec):
    path = _write_mixed(tmp_path, codec)
    with R.RNTJReader(path) as r:
        host = [r.read_cluster(i) for i in range(r.n_clusters)]
        ref_dev = {i: {ci: np.asarray(a) for ci, a in cols.items()}
                   for i, cols in r.iter_clusters_device()}
    assert len(host) >= 3
    for _trial in range(3):
        with T.RNTJReader(path, device="cpu", options=T.ReadOptions(
                prefetch_clusters=2, decode_workers=2)) as r:
            i_id = r.schema.column_of_path["id"]
            i_f = r.schema.column_of_path["f._0"]
            # hold every cluster until the end: a column that aliased the
            # recycled staging buffer would be clobbered by later clusters
            seen = list(r.iter_clusters_device())
            assert [i for i, _ in seen] == list(range(r.n_clusters))
            assert r.stats.device_clusters == r.n_clusters
        for i, cols in seen:
            assert set(cols) == set(host[i])
            # the 8-byte leaf comes back through the host fallback
            assert isinstance(cols[i_id], np.ndarray)
            assert torch.is_tensor(cols[i_f]) and cols[i_f].dtype == torch.uint8
            for ci, a in cols.items():
                a = _as_numpy(a)
                assert a.dtype == ref_dev[i][ci].dtype
                np.testing.assert_array_equal(a, ref_dev[i][ci])
                np.testing.assert_array_equal(a.astype(host[i][ci].dtype),
                                              host[i][ci])


def test_read_cluster_device_matches_reference_routes(tmp_path):
    path = _write_mixed(tmp_path, "zlib", n=8000)
    with R.RNTJReader(path) as rr, T.RNTJReader(path, device="cpu") as tr:
        for i in range(rr.n_clusters):
            want = rr.read_cluster_device(i)
            got = tr.read_cluster_device(i)
            assert set(got) == set(want)
            for ci in want:
                # same route: device columns are tensors where the
                # reference's are device arrays, host fallbacks numpy
                assert isinstance(got[ci], np.ndarray) == isinstance(
                    want[ci], np.ndarray)
                np.testing.assert_array_equal(_as_numpy(got[ci]),
                                              np.asarray(want[ci]))


def test_device_decode_modes(tmp_path):
    path = _write_mixed(tmp_path, "none", n=2_000)
    with T.RNTJReader(path, device="cpu",
                      options=T.ReadOptions(device_decode="off")) as r:
        with pytest.raises(RuntimeError):
            r.read_cluster_device(0)
        with pytest.raises(RuntimeError):
            next(r.iter_clusters_device())
        r.read_cluster(0)  # the host path never consults the knob
    with pytest.raises(ValueError):
        T.RNTJReader(path, device="cpu",
                     options=T.ReadOptions(device_decode="pallas"))


def test_launch_counts_stay_zero_on_the_cpu(tmp_path, monkeypatch):
    """The plain versions run on the CPU; only a CUDA launch counts."""
    monkeypatch.setenv("REPRO_TORCH_OFFSETS_MIN", "0")
    monkeypatch.setenv("REPRO_TORCH_SHUFFLE_MIN", "0")
    ops.reset_launch_counts()
    path = str(tmp_path / "c.rntj")
    _write(T, _port_schema(), path, T.WriteOptions(page_size=4096), _make_data(2000),
           2000, "seq", device="cpu")
    with T.RNTJReader(path, device="cpu") as r:
        list(r.iter_clusters_device())
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
