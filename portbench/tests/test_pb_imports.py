"""What the benchmark may load: no JAX, no JAX package, nothing of
``benchmarks/``; the reference nothing of the program."""

import ast
import subprocess
import sys

import pytest

from smoke_cells import CHECKOUT

from portbench import harness

BENCH_DIR = CHECKOUT / "portbench"


def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_barred_names_are_compared_whole():
    assert harness.barred_modules(["repro_torch", "repro_torch.core", "numpy"]) == []
    assert harness.barred_modules(["repro.core", "jaxlib.xla_client", "jax",
                                   "flax.linen", "reprox"]) == [
        "flax", "jax", "jaxlib", "repro"]


@pytest.mark.parametrize("path", sorted(BENCH_DIR.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_source_imports_jax_or_the_jax_package(path):
    for name in imports(path):
        assert name.split(".")[0] not in harness.BARRED, (path, name)


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    for name in imports(path):
        assert name.split(".")[0] not in ("repro_torch", "repro"), name
        if name.startswith("portbench"):
            assert name.startswith(("portbench.reference", "portbench.yardstick")), name


def test_nothing_reads_the_jax_benchmarks():
    me = __file__
    for path in BENCH_DIR.rglob("*.py"):
        if str(path) != me:
            assert "benchmarks" not in path.read_text(), path


def test_a_run_loads_no_barred_module(tmp_path):
    """A smoke run in a fresh process: what it loaded, the program's
    modules with it, holds no barred name."""
    code = f"""
import sys, time
sys.path[:0] = [{str(CHECKOUT / 'portbench' / 'tests')!r}]
from pathlib import Path
from smoke_cells import make_root
from portbench import harness
line = harness.run_cell("tiny-moe.train", 1, 0.1, False, time.perf_counter(),
                        device="cpu", root=make_root(Path({str(tmp_path)!r})))
assert line["correct"], line
print(harness.barred_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
