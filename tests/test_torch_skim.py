"""The port's skim application (``repro_torch.skim``) on the CPU.

* The cases of ``tests/test_skim.py`` on the port: every strategy keeps
  the same events as ``imt``, the kept events satisfy the cuts, a worker
  that fails releases every pool, writer and merger, and the skim shrinks
  the data.
* Against ``repro.skim`` on one dataset (the inputs themselves are
  byte-identical): for all five strategies, with pushdown on and off,
  ``kept_events`` are equal and each partition's events, sorted by
  ``event_id``, are equal column by column.  Files are byte-identical
  wherever the reference's own output is deterministic, which is:
  ``imt`` at any thread count (one sequential writer per partition, fed
  its files in order; its page-compression pool keeps page order), and
  every writing strategy with one thread.  With more threads
  ``separate`` merges its per-file outputs in the order they finish,
  and ``buffermerger`` and ``parallel`` commit clusters in the order the
  workers reach the lock, so two reference runs differ in cluster order.
* The same bytes with ``REPRO_TORCH_SHUFFLE_MIN=0`` and
  ``REPRO_TORCH_OFFSETS_MIN=0``: every seal through the kernels' host
  entries (their plain versions on the CPU).
"""

import os
import threading
import time

import numpy as np
import pytest

from repro.skim import make_agc_dataset as j_make_agc_dataset
from repro.skim import skim_partitions as j_skim_partitions

from repro_torch.core import RNTJReader
from repro_torch.skim import (
    Cuts, STRATEGIES, make_agc_dataset, skim_partitions,
)

CPU = "cpu"
WRITING = [s for s in STRATEGIES if s != "separate-null"]
LAYOUT = dict(n_partitions=3, files_per_partition=3, events_per_file=3000,
              seed=11)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("agc")
    return make_agc_dataset(str(d), device=CPU, **LAYOUT)


@pytest.fixture(scope="module")
def j_dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("agc_ref")
    return j_make_agc_dataset(str(d), **LAYOUT)


def _partition_content(out_dir, part):
    with RNTJReader(f"{out_dir}/skim_{part}.rntj", device=CPU) as r:
        ids = np.asarray(r.read_column("event_id"))
        jets = r.read_column("jets_pt._0")
    order = np.argsort(ids)
    return ids[order], len(jets)


def _events(path):
    """A skim output's events sorted by ``event_id``: one tuple per event
    of its columns (the collections as tuples of float32 values)."""
    with RNTJReader(path, device=CPU) as r:
        rows = [(e["event_id"], *(tuple(np.float32(x) for x in e[c])
                                  for c in ("electrons_pt", "muons_pt",
                                            "jets_pt")))
                for e in r.iter_entries()]
    return sorted(rows)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# the reference's cases


@pytest.mark.parametrize("strategy", WRITING)
def test_strategy_equivalence(dataset, tmp_path, strategy):
    base = skim_partitions(dataset, str(tmp_path / "base"), "imt",
                           n_threads=2, device=CPU)
    res = skim_partitions(dataset, str(tmp_path / strategy), strategy,
                          n_threads=6, device=CPU)
    assert res["kept_events"] == base["kept_events"]
    for part in dataset:
        ids_a, nj_a = _partition_content(str(tmp_path / "base"), part)
        ids_b, nj_b = _partition_content(str(tmp_path / strategy), part)
        np.testing.assert_array_equal(ids_a, ids_b)
        assert nj_a == nj_b


def test_skim_semantics(dataset, tmp_path):
    """Kept events satisfy the cuts; dropped elements are below threshold."""
    cuts = Cuts()
    skim_partitions(dataset, str(tmp_path / "o"), "parallel", n_threads=4,
                    cuts=cuts, device=CPU)
    r = RNTJReader(str(tmp_path / "o" / "skim_0.rntj"), device=CPU)
    # horizontal skim: met column is gone
    assert "met" not in r.schema.column_of_path
    for e in r.iter_entries():
        assert len(e["electrons_pt"]) >= cuts.min_electrons
        assert len(e["muons_pt"]) >= cuts.min_muons
        assert len(e["jets_pt"]) >= cuts.min_jets
        for coll in ("electrons_pt", "muons_pt", "jets_pt"):
            assert all(pt > cuts.pt_cut for pt in e[coll])  # nested skim
        if r.n_entries > 500:
            break
    r.close()


@pytest.mark.parametrize("strategy", WRITING)
def test_skim_cleanup_on_worker_failure(tmp_path, strategy):
    """A corrupt input makes a worker raise: the exception propagates and
    every pool/writer/merger is shut down instead of leaking threads."""
    parts = make_agc_dataset(str(tmp_path / "in"), n_partitions=2,
                             files_per_partition=2, events_per_file=400,
                             seed=7, device=CPU)
    bad = parts[1][1]
    size = os.path.getsize(bad)
    with open(bad, "r+b") as f:  # smash the anchor
        f.seek(size - 64)
        f.write(b"\x00" * 64)
    before = threading.active_count()
    with pytest.raises(Exception):
        skim_partitions(parts, str(tmp_path / f"o_{strategy}"), strategy,
                        n_threads=4, device=CPU)
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before  # no leaked pool threads


def test_skim_reduces_size(dataset, tmp_path):
    skim_partitions(dataset, str(tmp_path / "o"), "parallel", n_threads=4,
                    device=CPU)
    in_bytes = sum(os.path.getsize(f) for fs in dataset.values() for f in fs)
    out_bytes = sum(os.path.getsize(tmp_path / "o" / f"skim_{p}.rntj")
                    for p in dataset)
    assert out_bytes < in_bytes * 0.6  # horizontal+vertical+nested skims bite


# ---------------------------------------------------------------------------
# against the reference


def test_inputs_are_byte_identical_to_the_reference(dataset, j_dataset):
    assert dataset.keys() == j_dataset.keys()
    for part in dataset:
        for a, b in zip(dataset[part], j_dataset[part], strict=True):
            assert _bytes(a) == _bytes(b), a


@pytest.mark.parametrize("pushdown", [True, False], ids=["pushdown", "scan"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_skim_matches_the_reference(dataset, j_dataset, tmp_path, strategy,
                                    pushdown):
    kw = dict(n_threads=6, pushdown=pushdown)
    want = j_skim_partitions(j_dataset, str(tmp_path / "ref"), strategy, **kw)
    got = skim_partitions(dataset, str(tmp_path / "port"), strategy,
                          device=CPU, **kw)
    assert got["kept_events"] == want["kept_events"] > 0
    if strategy == "separate-null":
        return
    for part in dataset:
        a = str(tmp_path / "port" / f"skim_{part}.rntj")
        b = str(tmp_path / "ref" / f"skim_{part}.rntj")
        assert _events(a) == _events(b), part
        if strategy == "imt":  # the one strategy deterministic at 6 threads
            assert _bytes(a) == _bytes(b), part


@pytest.mark.parametrize("floors", [False, True],
                         ids=["default", "kernel-host-entries"])
@pytest.mark.parametrize("strategy", WRITING)
def test_one_thread_skim_is_byte_identical_to_the_reference(
        j_dataset, tmp_path, monkeypatch, strategy, floors):
    """With one thread every writing strategy's output is deterministic:
    the port's files equal the reference's byte for byte, also when every
    fill and seal goes through the kernels' host entries."""
    if floors:
        monkeypatch.setenv("REPRO_TORCH_SHUFFLE_MIN", "0")
        monkeypatch.setenv("REPRO_TORCH_OFFSETS_MIN", "0")
    parts = make_agc_dataset(str(tmp_path / "in"), device=CPU, **LAYOUT)
    for part in parts:
        for a, b in zip(parts[part], j_dataset[part], strict=True):
            assert _bytes(a) == _bytes(b), a
    want = j_skim_partitions(j_dataset, str(tmp_path / "ref"), strategy,
                             n_threads=1)
    got = skim_partitions(parts, str(tmp_path / "port"), strategy,
                          n_threads=1, device=CPU)
    assert got["kept_events"] == want["kept_events"]
    for part in parts:
        assert (_bytes(tmp_path / "port" / f"skim_{part}.rntj")
                == _bytes(tmp_path / "ref" / f"skim_{part}.rntj")), part
