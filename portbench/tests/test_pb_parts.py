"""Every part of the benchmark loads and is found by name; a part added
as files is found without an edit."""

import json
import time

import pytest

from smoke_cells import CHECKOUT, make_root

from portbench import harness, spec

BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_as_benchmark_json_says(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl, cfg, traffic = spec.load_cell(cell)
    assert (wl["config"], wl["traffic"], wl["chips"], wl["why"]) == (
        entry["config"], entry["traffic"], entry["chips"], entry["why"])
    conf = next(c for c in BENCH["configs"] if c["name"] == wl["config"])
    assert conf["file"] == f"portbench/configs/{cfg['name']}.json"
    assert conf["reduced"] == cfg["reduced"] and conf["source"] == cfg["source"]
    assert spec.driver(traffic["driver"]).run
    if traffic["driver"] == "train":
        base = {"loader_tokens_wrong", "loss_gap", "grad_gap", "change_gap"}
        assert base <= set(wl["limits"]) <= base | {"grad_diff"}
    else:
        assert set(wl["limits"]) == {"answers_missing", "log_tokens_wrong",
                                     "served_logit_gap"}


def test_every_per_layer_metric_has_a_reader():
    readers = spec.metric_readers()
    for m in BENCH["per_layer"]:
        assert m["name"] in readers, m["name"]
        assert readers[m["name"]].UNIT == m["unit"]
    for m in BENCH["end_to_end"]:
        assert m["name"] not in readers


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    root = make_root(tmp_path)
    (root / "metrics" / "tokens_a_step.py").write_text(
        'UNIT = "tokens"\n\n\ndef read(ctx):\n'
        '    w = ctx["window"]\n    return w["tokens"] / w["steps"]\n')
    cell, cfg, traffic = spec.load_cell("tiny-dense.train", root)
    assert cfg["d_model"] == 64 and traffic["driver"] == "train"
    assert "tokens_a_step" in spec.metric_readers(root)


def test_a_file_whose_name_differs_is_refused(tmp_path):
    root = make_root(tmp_path)
    path = root / "workloads" / "tiny-dense.train.json"
    data = json.loads(path.read_text())
    data["name"] = "other"
    path.write_text(json.dumps(data))
    with pytest.raises(ValueError):
        spec.load_cell("tiny-dense.train", root)


def test_added_metric_reads_in_a_smoke_run(tmp_path, monkeypatch):
    """The reader of an added file is called with the run's context: a
    traced run on the CPU raises (no kernel to read), so the readers are
    called on the context of a run without trace."""
    root = make_root(tmp_path)
    (root / "metrics" / "tokens_a_step.py").write_text(
        'UNIT = "tokens"\n\n\ndef read(ctx):\n'
        '    w = ctx["window"]\n    return w["tokens"] / w["steps"]\n')
    from portbench.drivers import train

    ran = {}
    real = train.run

    def spy(*a, **k):
        ran["out"] = real(*a, **k)
        return ran["out"]

    monkeypatch.setattr(train, "run", spy)
    harness.run_cell("tiny-dense.train", 11, 0.2, False, time.perf_counter(),
                     device="cpu", root=root)
    readers = spec.metric_readers(root)
    assert readers["tokens_a_step"].read(ran["out"]["ctx"]) == 4 * 64
