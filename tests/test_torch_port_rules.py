"""Rules of the PyTorch/CUDA port, checked on the CPU.

* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports jax
  or anything of the ``repro`` package (an AST scan).
* ``import repro_torch`` and a write -> read round trip work in a process
  in which neither jax nor ``repro`` can be imported.
* Without a card, writers, the reader, the models and the serving
  launcher refuse to run unless the caller asked for ``device="cpu"``;
  the JAX package's backend variables do not change the port's dispatch.
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

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_repro(path):
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
import numpy as np
import repro_torch, repro_torch.core as T, repro_torch.kernels
from repro_torch.configs.rntj_writer import SYNTH_EVENT_SCHEMA, PAPER_WRITE_OPTIONS
n = 2000
sizes = np.random.default_rng(0).poisson(5, n)
vals = np.arange(int(sizes.sum()), dtype=np.float32)
path = {str(tmp_path / "x.rntj")!r}
with T.SequentialWriter(SYNTH_EVENT_SCHEMA, path, PAPER_WRITE_OPTIONS,
                        device="cpu") as w:
    w.fill_batch(T.ColumnBatch.from_arrays(SYNTH_EVENT_SCHEMA, n, {{
        "id": np.arange(n, dtype=np.int64), "vals": sizes, "vals._0": vals}}))
with T.RNTJReader(path, device="cpu") as r:
    got = np.concatenate([c[2].numpy() for _, c in r.iter_clusters_device()])
assert np.array_equal(got, vals)
assert not [m for m, mod in sys.modules.items()
            if mod is not None and (m == "repro" or m.startswith("repro."))]
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
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
    with pytest.raises(NotImplementedError):
        T.open_sink("mem-s3://bucket/file.rntj")
