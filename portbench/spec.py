"""The benchmark's parts, found by name in files of their own.

``<root>/workloads/<cell>.json`` names a cell's configuration and traffic
mix, its chips, why it exists and its correctness limits;
``<root>/configs/<config>.json`` holds a configuration as it is run;
``<root>/traffic/<traffic>.json`` a traffic mix's parameters, with the
driver (``portbench/drivers/<driver>.py``) that runs it;
``<root>/metrics/<metric>.py`` a per-layer metric's reader.  A later
change adds a part by adding its file.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, Tuple

ROOT = Path(__file__).resolve().parent


def _load(root: Path, kind: str, name: str) -> Dict:
    path = Path(root) / kind / f"{name}.json"
    with open(path) as f:
        data = json.load(f)
    if data.get("name") != name:
        raise ValueError(f"{path}: its name is {data.get('name')!r}, not {name!r}")
    return data


def load_cell(name: str, root: Path = ROOT) -> Tuple[Dict, Dict, Dict]:
    """-> (cell, configuration, traffic mix) of workload ``name``."""
    cell = _load(root, "workloads", name)
    return (cell, _load(root, "configs", cell["config"]),
            _load(root, "traffic", cell["traffic"]))


def driver(name: str):
    """The module that runs a traffic mix's kind (``train``, ...)."""
    return importlib.import_module(f"portbench.drivers.{name}")


def metric_readers(root: Path = ROOT) -> Dict[str, object]:
    """{metric name: reader module} of every ``metrics/*.py``; a reader
    has ``UNIT`` and ``read(ctx)``, which returns the metric's value or
    None where the run has nothing for it to read."""
    readers = {}
    for path in sorted((Path(root) / "metrics").glob("*.py")):
        if path.name.startswith("_"):
            continue
        name = path.name[: -len(".py")]
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{len(readers)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        readers[name] = mod
    return readers
