"""The port's data pipeline against the JAX package's, on the CPU.

Mirrors ``tests/test_pipeline.py``: ingest (one worker: byte-identical to
``repro.pipeline.ingest_corpus``'s file; several: the same documents),
the packing loader's two engines (the port's device engine runs the
reader's device decode with K3/K4's plain versions on ``device="cpu"``),
exact resume mid-stream, and the ``(entry_cursor, leftover)`` state
carried across the packages in both directions.  Token streams are
compared exactly: they are integers.
"""

import os

import numpy as np
import pytest
import torch

from repro.core import WriteOptions as JWriteOptions
from repro.pipeline import PackedLoader as JPackedLoader
from repro.pipeline import ingest_corpus as j_ingest_corpus
from repro.pipeline import synth_corpus as j_synth_corpus

from repro_torch.core import ReadOptions, RNTJReader, WriteOptions
from repro_torch.pipeline import (
    DOC_SCHEMA, PackedLoader, docs_to_batch, ingest_corpus, synth_corpus,
)

# six test workers share the cores: one thread each, not one per core
torch.set_num_threads(max(1, os.cpu_count() // 6))

CPU = "cpu"
ENGINES_BOTH = ("host", "device")


def _np(b):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in b.items()}


def test_synth_corpus_is_the_references():
    for (i, t), (j, u) in zip(synth_corpus(40, seed=3, mean_len=50),
                              j_synth_corpus(40, seed=3, mean_len=50)):
        assert i == j
        np.testing.assert_array_equal(t, u)


def test_docs_to_batch_schema_matches_the_reference():
    from repro.pipeline.tokens import DOC_SCHEMA as J_SCHEMA
    assert [c.path for c in DOC_SCHEMA.columns] == [
        c.path for c in J_SCHEMA.columns]
    b = docs_to_batch(np.arange(2), [np.arange(3), np.arange(5)])
    assert b.n_entries == 2


@pytest.mark.parametrize("batch_docs", [7, 256])
def test_one_worker_ingest_is_byte_identical_to_the_reference(tmp_path,
                                                              batch_docs):
    p, q = str(tmp_path / "port.rntj"), str(tmp_path / "ref.rntj")
    opts = dict(codec="zlib", level=1, cluster_bytes=64 * 1024)
    ingest_corpus(synth_corpus(300, seed=2, mean_len=60), p, n_workers=1,
                  batch_docs=batch_docs, options=WriteOptions(**opts),
                  device=CPU)
    j_ingest_corpus(j_synth_corpus(300, seed=2, mean_len=60), q, n_workers=1,
                    batch_docs=batch_docs, options=JWriteOptions(**opts))
    assert open(p, "rb").read() == open(q, "rb").read()


def test_default_options_one_worker_ingest_is_byte_identical(tmp_path):
    """The default WriteOptions (zlib 1, 4 MiB clusters) on both sides."""
    p, q = str(tmp_path / "port.rntj"), str(tmp_path / "ref.rntj")
    ingest_corpus(synth_corpus(120, seed=5), p, n_workers=1, device=CPU)
    j_ingest_corpus(j_synth_corpus(120, seed=5), q, n_workers=1)
    assert open(p, "rb").read() == open(q, "rb").read()


def test_four_worker_ingest_holds_the_same_documents(tmp_path):
    p = str(tmp_path / "par.rntj")
    stats = ingest_corpus(synth_corpus(300, seed=1, mean_len=64), p,
                          n_workers=4, batch_docs=17, device=CPU)
    assert stats["entries"] == 300
    with RNTJReader(p, device=CPU) as r:
        got = {e["doc_id"]: tuple(e["tokens"]) for e in r.iter_entries()}
    want = {i: tuple(t.tolist()) for i, t in synth_corpus(300, seed=1,
                                                          mean_len=64)}
    assert got == want


def test_ingest_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ingest_corpus(synth_corpus(3), str(tmp_path / "x.rntj"))


# ---------------------------------------------------------------------------
# the loader


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """400 documents in several 64 KiB clusters, written by the reference."""
    p = str(tmp_path_factory.mktemp("data") / "eq.rntj")
    j_ingest_corpus(j_synth_corpus(400, seed=9, mean_len=60), p, n_workers=2,
                    options=JWriteOptions(codec="zlib", level=1,
                                          cluster_bytes=64 * 1024))
    return p


def test_loader_defaults_to_the_card(corpus):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PackedLoader(corpus, batch=2, seq_len=8)


def test_loader_refuses_an_unknown_engine(corpus):
    with pytest.raises(ValueError, match="engine"):
        PackedLoader(corpus, batch=2, seq_len=8, engine="auto", device=CPU)


def test_loader_shapes_and_labels(corpus):
    ld = PackedLoader(corpus, batch=8, seq_len=32, device=CPU)
    b = next(ld.batches())
    assert isinstance(b["tokens"], torch.Tensor)
    assert b["tokens"].shape == (8, 32) and b["tokens"].dtype == torch.int32
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    ld.close()


@pytest.mark.parametrize("engine", ["device", "host"])
def test_loader_stream_equals_the_references_host_engine(corpus, engine):
    """Over more than two epochs (the file holds ~24,500 tokens; 160
    batches of 4 x 97 take ~62,000)."""
    jl = JPackedLoader(corpus, batch=4, seq_len=96, device="host")
    tl = PackedLoader(corpus, batch=4, seq_len=96, engine=engine, device=CPU)
    assert tl.reader.n_clusters >= 2
    tokens = sum(len(t) + 1 for _i, t in j_synth_corpus(400, seed=9,
                                                        mean_len=60))
    assert 160 * 4 * 97 > 2 * tokens
    gj, gt = jl.batches(), tl.batches()
    for k in range(160):
        bj, bt = _np(next(gj)), _np(next(gt))
        np.testing.assert_array_equal(bt["tokens"], bj["tokens"], err_msg=str(k))
        np.testing.assert_array_equal(bt["labels"], bj["labels"], err_msg=str(k))
    jl.close(), tl.close()


def test_device_engine_reads_through_the_device_decode(corpus):
    """The device engine's columns come from ``iter_clusters_device``;
    ``device_decode="off"`` pins the host engine."""
    ld = PackedLoader(corpus, batch=4, seq_len=64, device=CPU)
    next(ld.batches())
    assert ld.reader.stats.device_clusters >= 1
    off = PackedLoader(corpus, batch=4, seq_len=64, device=CPU,
                       read_options=ReadOptions(device_decode="off"))
    assert isinstance(next(off.batches())["tokens"], np.ndarray)
    ld.close(), off.close()


@pytest.mark.parametrize("engine", ENGINES_BOTH)
@pytest.mark.parametrize("n_warm", [3, 11])
def test_loader_exact_resume_mid_stream(corpus, engine, n_warm):
    """Save at a batch boundary — mid-cluster (n_warm 3) and
    mid-leftover (n_warm 11) — and resume on either engine."""
    ld = PackedLoader(corpus, batch=4, seq_len=64, engine=engine, device=CPU)
    it = ld.batches()
    for _ in range(n_warm):
        next(it)
    state = ld.state()
    assert isinstance(state["leftover"], np.ndarray)
    cont = [_np(next(it)) for _ in range(20)]
    ld.close()
    for resume in ENGINES_BOTH:
        l2 = PackedLoader(corpus, batch=4, seq_len=64, state=state,
                          engine=resume, device=CPU)
        g2 = l2.batches()
        for k, want in enumerate(cont):
            got = _np(next(g2))
            np.testing.assert_array_equal(got["tokens"], want["tokens"],
                                          err_msg=f"{resume}:{k}")
            np.testing.assert_array_equal(got["labels"], want["labels"],
                                          err_msg=f"{resume}:{k}")
        l2.close()


@pytest.mark.parametrize("engine", ENGINES_BOTH)
@pytest.mark.parametrize("n_warm", [3, 11])
def test_state_from_the_reference_restores_in_the_port(corpus, engine, n_warm):
    jl = JPackedLoader(corpus, batch=4, seq_len=64, device="host")
    it = jl.batches()
    for _ in range(n_warm):
        next(it)
    state = jl.state()
    cont = [_np(next(it)) for _ in range(15)]
    tl = PackedLoader(corpus, batch=4, seq_len=64, state=state,
                      engine=engine, device=CPU)
    gt = tl.batches()
    for k, want in enumerate(cont):
        np.testing.assert_array_equal(_np(next(gt))["tokens"], want["tokens"],
                                      err_msg=str(k))
    jl.close(), tl.close()


@pytest.mark.parametrize("engine", ENGINES_BOTH)
@pytest.mark.parametrize("n_warm", [3, 11])
def test_state_from_the_port_restores_in_the_reference(corpus, engine, n_warm):
    tl = PackedLoader(corpus, batch=4, seq_len=64, engine=engine, device=CPU)
    it = tl.batches()
    for _ in range(n_warm):
        next(it)
    state = tl.state()
    assert state["leftover"].dtype == np.int32
    cont = [_np(next(it)) for _ in range(15)]
    jl = JPackedLoader(corpus, batch=4, seq_len=64, state=state, device="host")
    gj = jl.batches()
    for k, want in enumerate(cont):
        np.testing.assert_array_equal(_np(next(gj))["tokens"], want["tokens"],
                                      err_msg=str(k))
    jl.close(), tl.close()


def test_pack_cluster_matches_a_python_loop():
    from repro_torch.pipeline.loader import _pack_cluster

    rng = np.random.default_rng(0)
    sizes = rng.integers(0, 6, 30)
    sizes[[0, 7, 29]] = 0  # empty documents too
    vals = rng.integers(1, 100, int(sizes.sum())).astype(np.int32)
    offs = np.cumsum(sizes).astype(np.int32)
    got = _pack_cluster(torch.from_numpy(vals), torch.from_numpy(offs),
                        len(sizes), eos_id=-1).numpy()
    want, start = [], 0
    for end in offs:
        want += list(vals[start:end]) + [-1]
        start = end
    np.testing.assert_array_equal(got, np.array(want, np.int32))
    empty = _pack_cluster(torch.zeros(0, dtype=torch.int32),
                          torch.zeros(3, dtype=torch.int32), 3, eos_id=7)
    np.testing.assert_array_equal(empty.numpy(), [7, 7, 7])
