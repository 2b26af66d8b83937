"""Rules of the PyTorch/CUDA port, checked on the CPU.

* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports jax,
  anything of the ``repro`` package, or ``ml_dtypes`` (the card's machine
  lacks it) (an AST scan).
* ``import repro_torch``, ``import repro_torch.ckpt``, a write -> read
  round trip and a multi-process checkpoint save work in a process in
  which neither jax, ``repro`` nor ``ml_dtypes`` can be imported.
* Without a card, writers, the reader, multi-process participants, the
  checkpoint restore, the models, the training loop, the skim and every
  launcher refuse to run unless the caller asked for ``device="cpu"``; the
  JAX package's backend variables do not change the port's dispatch.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.kernels import ops

# six test workers share the cores: one thread each, not one per core
torch.set_num_threads(max(1, os.cpu_count() // 6))

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "ml_dtypes")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_repro(path):
    # nor ml_dtypes: bf16 leaves move through integer views
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_port_runs_where_jax_and_repro_cannot_import(tmp_path):
    code = f"""
import sys
sys.modules["jax"] = None      # any import of jax now raises ImportError
sys.modules["repro"] = None
sys.modules["ml_dtypes"] = None
import numpy as np
import torch
import repro_torch, repro_torch.core as T, repro_torch.kernels
import repro_torch.ckpt
from repro_torch.ckpt import load_checkpoint, save_checkpoint_mp
from repro_torch.configs.rntj_writer import SYNTH_EVENT_SCHEMA, PAPER_WRITE_OPTIONS


def main():
    n = 2000
    sizes = np.random.default_rng(0).poisson(5, n)
    vals = np.arange(int(sizes.sum()), dtype=np.float32)
    path = {str(tmp_path / "x.rntj")!r}
    with T.SequentialWriter(SYNTH_EVENT_SCHEMA, path, PAPER_WRITE_OPTIONS,
                            device="cpu") as w:
        w.fill_batch(T.ColumnBatch.from_arrays(SYNTH_EVENT_SCHEMA, n, {{
            "id": np.arange(n, dtype=np.int64), "vals": sizes,
            "vals._0": vals}}))
    with T.RNTJReader(path, device="cpu") as r:
        got = np.concatenate([c[2].numpy()
                              for _, c in r.iter_clusters_device()])
    assert np.array_equal(got, vals)
    # a multi-process save: spawn runs this file's imports, with their
    # guards, in each child before the worker, which then needs neither
    # jax nor ml_dtypes (a child that fails degrades the save)
    tree = {{"w": torch.arange(12.0).reshape(3, 4),
            "b": torch.ones(4).bfloat16()}}
    ck = {str(tmp_path / "ck.rntj")!r}
    rep = save_checkpoint_mp(ck, tree, n_processes=2, device="cpu")
    assert not rep["degraded"], rep
    back, _ = load_checkpoint(ck, target_tree=tree, device="cpu")
    assert all(torch.equal(back[k], tree[k]) for k in tree)
    assert not [m for m, mod in sys.modules.items()
                if mod is not None and (m == "repro" or m.startswith("repro.")
                                        or m in ("jax", "ml_dtypes"))]
    print("ok")


if __name__ == "__main__":
    main()
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    # spawn re-runs the main script in each child: a file, not ``-c``
    script = tmp_path / "jax_free.py"
    script.write_text(code)
    out = subprocess.run([sys.executable, str(script)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_writers_and_reader_refuse_without_a_card(tmp_path, no_card):
    from repro_torch.configs.rntj_writer import SYNTH_EVENT_SCHEMA as S

    path = tmp_path / "never.rntj"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.ParallelWriter(S, str(path))
    with pytest.raises(RuntimeError):
        T.SequentialWriter(S, str(path), device="cuda")
    assert not path.exists()  # refused before anything was opened
    with T.SequentialWriter(S, str(path), device="cpu"):
        pass
    with pytest.raises(RuntimeError):
        T.RNTJReader(str(path))
    with T.RNTJReader(str(path), device="cpu") as r:
        assert r.n_entries == 0


def test_serving_refuses_without_a_card(tmp_path, no_card):
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import build, make_batch

    out = tmp_path / "never.rntj"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke", "--requests", "1", "--out", str(out)])
    assert not out.exists()
    bundle = build(smoke_config("smollm-360m"))
    with pytest.raises(RuntimeError):
        bundle.init(torch.Generator())
    with pytest.raises(RuntimeError):
        bundle.init_cache(1, 8)
    with pytest.raises(RuntimeError):
        make_batch(bundle, np.random.default_rng(0), 1, 4)
    # the meta device builds shapes without a card
    assert bundle.init(None, "meta")["embedding"]["embed"].is_meta


def test_reference_backend_variables_do_not_change_the_port(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "numpy")
    monkeypatch.setenv("REPRO_OFFSETS_BACKEND", "pallas")
    monkeypatch.setenv("REPRO_SHUFFLE_PALLAS_MIN", "0")
    monkeypatch.delenv("REPRO_TORCH_KERNEL_BACKEND", raising=False)
    k = ops.encode_kernels(torch.device("cpu"))
    assert (k.offsets.backend, k.offsets.min) == ("auto", 65536)
    assert (k.shuffle.backend, k.shuffle.min) == ("auto", 256 * 1024)
    monkeypatch.setenv("REPRO_TORCH_OFFSETS_MIN", "7")
    k = ops.encode_kernels(torch.device("cpu"))
    assert (k.offsets.backend, k.offsets.min) == ("auto", 7)
    assert k.offsets.want(7) and not k.offsets.want(6)
    assert k.shuffle.want(256 * 1024) and not k.shuffle.want(256 * 1024 - 1)
    monkeypatch.setenv("REPRO_TORCH_KERNEL_BACKEND", "numpy")
    k = ops.encode_kernels(torch.device("cpu"))
    assert (k.offsets.backend, k.offsets.min) == ("numpy", 7)
    assert not k.offsets.want(10**9)
    assert k.shuffle.backend == "numpy" and not k.shuffle.want(10**9)
    monkeypatch.setenv("REPRO_TORCH_KERNEL_BACKEND", "pallas")
    with pytest.raises(ValueError):
        ops.encode_kernels(torch.device("cpu"))


def test_remote_sinks_are_refused():
    # a scheme with no registered transport is refused; mem-s3 opens
    with pytest.raises(ValueError, match="no transport registered"):
        T.open_sink("s3://bucket/file.rntj")
    sink = T.open_sink("mem-s3://rules/file.rntj")
    assert isinstance(sink, T.ObjectStoreSink)
    sink.close()


def test_participants_and_restore_refuse_without_a_card(tmp_path, no_card):
    from repro_torch.ckpt import (
        CheckpointManager, load_checkpoint, save_checkpoint,
        save_checkpoint_mp,
    )
    from repro_torch.configs.rntj_writer import SYNTH_EVENT_SCHEMA as S

    path = str(tmp_path / "mp.rntj")
    coord = T.MultiWriterCoordinator(S, path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.join_container(path)
    with pytest.raises(RuntimeError):
        coord.participant()
    with T.join_container(path, device="cpu"):
        pass
    assert coord.seal()["writers"] == 1  # the refusals registered nobody
    coord.close()

    ck = str(tmp_path / "ck.rntj")
    tree = {"w": torch.ones(2, 3)}
    with pytest.raises(RuntimeError):
        save_checkpoint(ck, tree)
    with pytest.raises(RuntimeError):
        save_checkpoint_mp(ck, tree)
    assert not os.path.exists(ck)
    save_checkpoint(ck, tree, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_checkpoint(ck)
    back, _ = load_checkpoint(ck, device="cpu")
    assert torch.equal(back["w"], tree["w"])
    with pytest.raises(RuntimeError):
        CheckpointManager(str(tmp_path / "mgr"))


def test_the_scan_covers_the_skim_and_every_launcher():
    scanned = {p.relative_to(ROOT / "src").as_posix() for p in PORT_FILES
               if p.name != "chip_smoke.py"}
    for mod in ("skim/__init__", "skim/engine", "train/loop", "launch/train",
                "launch/quickstart", "launch/train_lm", "launch/skim",
                "launch/parallel_checkpoint", "launch/serve_batch",
                "launch/recover", "launch/chaos"):
        assert f"repro_torch/{mod}.py" in scanned, mod


def test_the_scan_covers_distributed_and_the_mesh_launchers():
    scanned = {p.relative_to(ROOT / "src").as_posix() for p in PORT_FILES
               if p.name != "chip_smoke.py"}
    for mod in ("distributed/__init__", "distributed/sharding",
                "distributed/collectives", "distributed/pipeline_parallel",
                "distributed/elastic", "launch/mesh", "launch/dryrun",
                "launch/hlo_analysis", "kernels/meta"):
        assert f"repro_torch/{mod}.py" in scanned, mod


def test_the_mesh_refuses_without_a_card(no_card):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    started = dist.is_initialized()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_local_mesh()
    assert dist.is_initialized() == started  # refused before a group


def test_the_loop_and_its_launchers_refuse_without_a_card(tmp_path, no_card):
    from repro_torch.configs import smoke_config
    from repro_torch.launch import (
        parallel_checkpoint, quickstart, serve_batch, train, train_lm,
    )
    from repro_torch.launch import skim as launch_skim
    from repro_torch.models import build
    from repro_torch.pipeline import PackedLoader, ingest_corpus, synth_corpus
    from repro_torch.train import TrainLoop

    data = str(tmp_path / "c.rntj")
    ingest_corpus(synth_corpus(20, mean_len=40, vocab=512), data,
                  n_workers=1, device="cpu")
    bundle = build(smoke_config("smollm-360m"))
    loader = PackedLoader(data, batch=1, seq_len=16, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainLoop(bundle, loader, str(tmp_path / "never"))
    assert not (tmp_path / "never").exists()
    loop = TrainLoop(bundle, loader, str(tmp_path / "ck"), device="cpu")
    assert loop.step == 0 and loop.mgr.device.type == "cpu"
    loader.close()
    argv = ["--smoke", "--steps", "1", "--data", str(tmp_path / "t.rntj"),
            "--ckpt-dir", str(tmp_path / "tck")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(argv)
    assert not (tmp_path / "t.rntj").exists()
    work = ["--workdir", str(tmp_path / "w")]
    for launcher in (quickstart, train_lm, launch_skim, serve_batch,
                     parallel_checkpoint):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launcher.main(work)
    assert not (tmp_path / "w").exists()


def test_the_skim_refuses_without_a_card(tmp_path, no_card):
    from repro_torch.skim import make_agc_dataset, skim_partitions

    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_agc_dataset(str(tmp_path / "never"), 1, 1, 10)
    assert not (tmp_path / "never").exists()
    parts = make_agc_dataset(str(tmp_path / "in"), 1, 1, 200, device="cpu")
    for strategy in ("imt", "parallel"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            skim_partitions(parts, str(tmp_path / "out"), strategy, 2)
        assert not (tmp_path / "out").exists()
    res = skim_partitions(parts, str(tmp_path / "out"), "parallel", 2,
                          device="cpu")
    assert res["kept_events"] >= 0
