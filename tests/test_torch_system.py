"""End-to-end behaviour of the port, the twin of ``tests/test_system.py``.

One test drives the port the way a user would, on the CPU: parallel
columnar ingest -> training with checkpoints -> crash-restart -> batched
serving with parallel output logging -> the generations read back.
Every storage artifact in the chain is a single RNT-J file written with
the paper's parallel protocol.  Then every launcher of
``repro_torch.launch`` that wraps the chain (the quickstart, ``train_lm``,
the skim, the checkpoint demo, batched serving, the recovery tool) runs
through its ``main(argv)`` with ``--device cpu`` at a small size.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core import ColumnBatch, ParallelWriter, RNTJReader
from repro_torch.launch.serve import GEN_SCHEMA, generate
from repro_torch.models import build
from repro_torch.pipeline import PackedLoader, ingest_corpus, synth_corpus
from repro_torch.train import LoopConfig, TrainLoop, make_optimizer
from repro_torch.train.optimizer import tree_leaves

# six test workers share the cores: one thread each, not one per core
torch.set_num_threads(max(1, os.cpu_count() // 6))

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tiny_bundle():
    cfg = get_arch("smollm-360m").with_(
        name="sys-tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, remat=False,
    )
    return build(cfg)


def test_full_system_pipeline(tiny_bundle, tmp_path):
    data = str(tmp_path / "corpus.rntj")
    ckpt = str(tmp_path / "ckpt")

    # 1. parallel ingest -> ONE file
    stats = ingest_corpus(synth_corpus(200, seed=1, mean_len=60, vocab=256),
                          data, n_workers=3, device=CPU)
    assert stats["entries"] == 200
    assert stats["clusters"] >= 1

    # 2. train with checkpoints
    loader = PackedLoader(data, batch=4, seq_len=32, device=CPU)
    loop = TrainLoop(
        tiny_bundle, loader, ckpt,
        config=LoopConfig(steps=24, ckpt_every=8, log_every=1000,
                          ckpt_async=False),
        optimizer=make_optimizer(peak_lr=5e-3, warmup=4, total=100),
        device=CPU,
    )
    hist = loop.run()
    assert len(hist) == 24
    assert all(np.isfinite(h.loss) for h in hist)
    assert loop.mgr.steps() == [8, 16, 24]

    # 3. crash-restart resumes at the last committed step
    loader2 = PackedLoader(data, batch=4, seq_len=32, device=CPU)
    loop2 = TrainLoop(tiny_bundle, loader2, ckpt,
                      config=LoopConfig(steps=4, ckpt_every=8,
                                        log_every=1000, ckpt_async=False),
                      device=CPU)
    assert loop2.step == 24
    for x, y in zip(tree_leaves(loop2.params), tree_leaves(loop.params),
                    strict=True):
        assert torch.equal(x, y)
    loop2.run()
    assert loop2.step == 28

    # 4. serve a batch and log generations through the parallel writer
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, 256, (4, 8)).astype(np.int32))
    gen = generate(tiny_bundle, loop2.params, prompts, max_new=8)
    assert gen.shape == (4, 8)
    out = str(tmp_path / "gen.rntj")
    w = ParallelWriter(GEN_SCHEMA, out, device=CPU)
    ctx = w.create_fill_context()
    ctx.fill_batch(ColumnBatch.from_arrays(GEN_SCHEMA, 4, {
        "request_id": np.arange(4, dtype=np.int64),
        "prompt_len": np.full(4, 8, np.int32),
        "tokens": np.full(4, 8, np.int64),
        "tokens._0": gen.reshape(-1).astype(np.int32),
    }))
    ctx.close()
    w.close()

    # 5. the served output is an ordinary columnar dataset: read it back
    with RNTJReader(out, device=CPU) as r:
        assert r.n_entries == 4
        toks = r.read_column("tokens._0")
    np.testing.assert_array_equal(np.sort(toks), np.sort(gen.reshape(-1)))
    for ld in (loader, loader2):
        ld.close()


def test_training_learns_structure(tiny_bundle, tmp_path):
    """Loss must drop well below ln(vocab) on the phrase corpus."""
    data = str(tmp_path / "c.rntj")
    ingest_corpus(synth_corpus(400, seed=3, mean_len=80, vocab=256,
                               n_phrases=32), data, n_workers=2, device=CPU)
    loader = PackedLoader(data, batch=4, seq_len=48, device=CPU)
    loop = TrainLoop(
        tiny_bundle, loader, str(tmp_path / "ck"),
        config=LoopConfig(steps=80, ckpt_every=1000, log_every=1000,
                          ckpt_async=False),
        optimizer=make_optimizer(peak_lr=8e-3, warmup=8, total=300),
        device=CPU,
    )
    hist = loop.run()
    first = np.mean([h.loss for h in hist[:8]])
    last = np.mean([h.loss for h in hist[-8:]])
    assert last < first - 0.8, (first, last)


# ---------------------------------------------------------------------------
# the launchers, each through ``main(argv)`` on the CPU at a small size


def test_quickstart_runs_on_the_cpu(tmp_path):
    from repro_torch.launch import quickstart

    res = quickstart.main(["--device", "cpu", "--workdir", str(tmp_path)])
    assert res["ingest"]["entries"] == 400
    assert [h.step for h in res["history"]] == list(range(1, 31))
    assert res["restored_at"] == 30 and res["resumed"][-1].step == 40
    served = res["serve"]
    with RNTJReader(served.out, device=CPU) as r:
        toks = np.asarray(r.read_column("tokens._0"))
    np.testing.assert_array_equal(toks, served.tokens.reshape(-1))


def test_train_lm_tiny_runs(tmp_path):
    from repro_torch.launch import train_lm

    argv = ["--tiny", "--steps", "3", "--batch", "2", "--seq", "32",
            "--device", "cpu", "--workdir", str(tmp_path)]
    loop = train_lm.main(argv)
    assert loop.bundle.cfg.name == "smollm-10m"
    assert loop.step == 3 and all(np.isfinite(h.loss) for h in loop.history)


def test_skim_launcher_strategies_agree(tmp_path):
    from repro_torch.launch import skim

    res = skim.main(["--events", "1500", "--partitions", "2", "--threads",
                     "3", "--device", "cpu", "--workdir", str(tmp_path)])
    assert len({r["kept_events"] for r in res.values()}) == 1
    assert res["separate-null"]["out_mb"] == 0.0
    assert all(r["out_mb"] > 0 for k, r in res.items()
               if k != "separate-null")


def test_parallel_checkpoint_launcher(tmp_path):
    from repro_torch.launch import parallel_checkpoint

    res = parallel_checkpoint.main(["--layers", "2", "--device", "cpu",
                                    "--workdir", str(tmp_path)])
    assert res["bytes"] == 2 * (512 * 2048 + 2048) * 4
    assert sorted(res["paths"]) == [1, 2, 4, 8]


def test_serve_batch_launcher(tmp_path):
    from repro_torch.launch import serve_batch

    res = serve_batch.main(["--device", "cpu", "--workdir", str(tmp_path)])
    ids = sorted(res["tokens"])
    assert ids == [w * 100 + i for w in range(serve_batch.N_WORKERS)
                   for i in range(serve_batch.BATCH)]
    with RNTJReader(res["out"], device=CPU) as r:
        got = dict(zip(np.asarray(r.read_column("request_id")).tolist(),
                       np.asarray(r.read_column("tokens._0")).reshape(
                           r.n_entries, -1)))
    for i in ids:
        np.testing.assert_array_equal(got[i], res["tokens"][i])


def test_recover_launcher_exit_codes(tmp_path, capsys):
    from repro_torch.launch import recover

    path = tmp_path / "g.rntj"
    w = ParallelWriter(GEN_SCHEMA, str(path), device=CPU)
    ctx = w.create_fill_context()
    ctx.fill_batch(ColumnBatch.from_arrays(GEN_SCHEMA, 3, {
        "request_id": np.arange(3, dtype=np.int64),
        "prompt_len": np.full(3, 2, np.int32),
        "tokens": np.full(3, 2, np.int64),
        "tokens._0": np.arange(6, dtype=np.int32),
    }))
    ctx.close()
    w.close()
    assert recover.main([str(path)]) == 0
    assert "nothing to do" in capsys.readouterr().out
    torn = tmp_path / "torn.rntj"
    data = path.read_bytes()
    torn.write_bytes(data[:-40])  # the anchor is gone
    out = tmp_path / "rec.rntj"
    assert recover.main([str(torn), "-o", str(out)]) == 0
    with RNTJReader(str(out), device=CPU) as r:
        assert r.n_entries == 3
    (tmp_path / "stub.rntj").write_bytes(data[:100])
    assert recover.main([str(tmp_path / "stub.rntj")]) == 1
    with pytest.raises(SystemExit) as e:
        recover.main([])
    assert e.value.code == 2
