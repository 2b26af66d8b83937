"""One run of one cell: its traffic kind's run, its per-layer metrics, the
correctness check, and the result line."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, Optional

from portbench import spec
from portbench.reference import compare

#: top-level module names that no run may hold once its window has closed
BARRED = ("jax", "jaxlib", "flax", "repro")


def barred_modules(modules=None) -> list:
    """Loaded modules whose top-level name is barred, compared whole (so
    ``repro_torch`` is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(BARRED))


def card() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", root: Path = spec.ROOT
             ) -> Dict:
    """-> the result line's object (before the jax check)."""
    import torch

    cell, cfg, traffic = spec.load_cell(name, root)
    out = spec.driver(traffic["driver"]).run(
        cell, cfg, traffic, seed, seconds, trace, device, t_start)
    checks = compare.checks(out["numbers"], cell["limits"])
    if trace:
        metrics = {}
        for metric, reader in spec.metric_readers(root).items():
            value = reader.read(out["ctx"])
            if value is not None:
                metrics[metric] = {"value": value, "unit": reader.UNIT}
    else:
        metrics = out["e2e"]
    on_card = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": compare.passed(checks), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace and out["trace"] is not None:
        from portbench.yardstick.trace import breakdown

        dev["busy_s"] = out["trace"]["busy_s"]
        dev["window_s"] = out["trace"]["window_s"]
        line["breakdown"] = breakdown(out["trace"])
    line["checks"] = checks
    return line


def print_result(line: Dict) -> None:
    """The checks as the last lines of standard error, the result as the
    last line of standard output."""
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
