"""The port's chaos driver (``repro_torch.launch.chaos``) against the JAX
package's ``tools/chaos.py``, on the CPU.

The reference driver is loaded from its path, unchanged.  Each of the ten
single-process scenarios runs in the port (``device="cpu"``) and in the
reference on the same ``make_entries(800, 0)`` and seed, at the write
path's default size floors and again with both floors at 0 (every fill's
offsets and every seal's pages through the kernels' plain versions); the
scenarios' results must be equal field for field, but for the fields set
by thread timing (``TIMED``), which are held to the reference's own
invariant.  Then the command line (one scenario, and ``mprecover`` with
its participant processes), an N = 2 subset of the ``mpkill`` matrix in
participant processes (forked by the driver's fork server), a broken
invariant (exit 1 and a ``FAIL`` line), and the refusal without a card.
The whole matrix runs on the card (``chip_smoke.py`` phase 8 (f)).
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.launch import chaos

ROOT = Path(__file__).resolve().parents[1]

#: the scenarios that run in one process
SINGLE = ("transient", "seeded", "enospc", "fsync", "stripe", "ring",
          "latency", "kill", "skim", "remote")
#: result fields set by thread timing, each with the reference's invariant
#: for it: the write-behind ring's retries, and the hedged GETs that won
#: their race
TIMED = {("ring", "retries"): lambda v: v >= 1,
         ("remote", "hedge_wins"): lambda v: v >= 1}
FLOORS = {"default": {},
          "zero": {"REPRO_TORCH_OFFSETS_MIN": "0",
                   "REPRO_TORCH_SHUFFLE_MIN": "0"}}
ENTRIES = chaos.make_entries(800, 0)


def _load_reference():
    spec = importlib.util.spec_from_file_location(
        "reference_chaos", ROOT / "tools" / "chaos.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load_reference()
_REF_INFO = {}


def reference(name: str):
    """The reference's result of scenario ``name``, run once."""
    if name not in _REF_INFO:
        _REF_INFO[name] = REF.SCENARIOS[name](REF.make_entries(800, 0), 0)
    return _REF_INFO[name]


def test_the_workload_is_the_reference_s():
    assert ENTRIES == REF.make_entries(800, 0)
    assert chaos.make_entries(2000, 3) == REF.make_entries(2000, 3)


@pytest.mark.parametrize("floors", FLOORS)
@pytest.mark.parametrize("name", SINGLE)
def test_scenario_matches_the_reference(name, floors, monkeypatch):
    for k, v in FLOORS[floors].items():
        monkeypatch.setenv(k, v)
    calls = []
    entry = ops.KernelDispatch.__call__

    def counted(self, arr):
        calls.append(self.name)
        return entry(self, arr)

    monkeypatch.setattr(ops.KernelDispatch, "__call__", counted)
    got = chaos.run(name, ENTRIES, 0, "cpu")
    want = reference(name)
    assert set(got) == set(want)
    for key, value in want.items():
        held = TIMED.get((name, key))
        if held is not None:
            assert held(got[key]), (name, key, got[key])
        else:
            assert got[key] == value, (name, key, got[key], value)
    # the floors decide whether the kernels' entries run: clusters of 2-16
    # KiB filled one entry at a time stay below the default ones
    if floors == "zero":
        assert {"offsets", "shuffle"} <= set(calls), calls
    else:
        assert not calls, calls


def _cli(*argv, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [
        str(ROOT / "src"), os.environ.get("PYTHONPATH")])))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.chaos", "--device", "cpu",
         *argv], capture_output=True, text=True, timeout=timeout, env=env)


def test_chaos_cli_single_scenario():
    out = _cli("--scenario", "transient", "--entries", "300")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ok   transient" in out.stdout


def test_chaos_cli_mp_scenarios():
    out = _cli("--scenario", "mprecover", "--entries", "200")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ok   mprecover" in out.stdout


#: the N = 2 subset: (fault, point) -> (exit codes, writers fenced)
MP_SUBSET = {("eio", 0): ([0, 0], 0), ("fsync", 0): ([2, 2], 2),
             ("kill", 1400): ([3, 3], 2)}


@pytest.fixture(scope="module")
def mp_rows():
    """The subset's rows and the straggler's, their participants all
    started at once (as ``scenario_mpkill`` starts cells ahead)."""
    cells = [chaos._Cell(ENTRIES[:320], 2, f, p, "cpu") for f, p in MP_SUBSET]
    straggler = chaos._Cell(ENTRIES[:320], *chaos.STRAGGLER, "cpu")
    rows = {c: chaos.mp_cell(ENTRIES, 2, *c, "cpu", cell=cell)
            for c, cell in zip(MP_SUBSET, cells)}
    rows["straggler"] = chaos.mp_straggler(ENTRIES, "cpu", cell=straggler)
    return rows


@pytest.mark.parametrize("cell", MP_SUBSET, ids=lambda c: f"{c[0]}@{c[1]}")
def test_mpkill_cell_in_processes(cell, mp_rows):
    codes, fenced = MP_SUBSET[cell]
    n, fault, point, salvaged, info = mp_rows[cell]
    assert (n, fault, point) == ("N=2",) + cell
    assert info["codes"] == codes and len(info["fenced"]) == fenced
    if fault == "kill":  # both died past their first cluster: a prefix each
        assert 0 < salvaged < 320
    else:
        assert salvaged == 320


def test_mpkill_straggler_in_processes(mp_rows):
    n, fault, _point, salvaged, info = mp_rows["straggler"]
    assert (n, fault) == ("N=2", "straggler")
    assert info["codes"] == [0, 4] and len(info["fenced"]) == 1
    assert 160 <= salvaged < 320  # the clean writer whole, the straggler's half


def test_a_broken_invariant_fails_the_run(monkeypatch, capsys):
    # values that float32 cannot hold read back rounded: not lossless
    monkeypatch.setattr(chaos, "make_entries", lambda n, seed: [
        {"id": i, "vals": [0.1]} for i in range(n)])
    assert chaos.main(["--device", "cpu", "--scenario", "transient",
                       "--entries", "50"]) == 1
    out = capsys.readouterr().out
    assert "FAIL transient: transient: entries differ after faults" in out
    assert "1 scenario(s) failed: transient" in out


def test_the_driver_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chaos.main(["--scenario", "transient"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chaos.run("kill", ENTRIES, 0)
