"""Runs of the smoke cells on the CPU through the program's plain kernels:
the result line, the planted faults, the control, the profiler guard."""

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from smoke_cells import CHECKOUT, make_root

from portbench import faults, harness
from portbench.drivers import serve, train
from portbench.reference import compare
from portbench.reference.model import fp8_mm, served_gaps, train_readings
from portbench.yardstick import trace as ytrace

CELLS = ["tiny-dense.train", "tiny-moe.train"]
E2E = {"train": {"train_tokens_per_s", "setup_s"},
       "serve": {"serve_tokens_per_s", "ttft_p95_ms", "setup_s"}}
DEVICE_METRICS = {"card_idle.train", "gemm_ms.train", "elementwise_ms.train",
                  "k5_fwd_roofline.train", "k5_bwd_roofline.train"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("smoke"))


@pytest.mark.parametrize("cell", CELLS + ["tiny-dense.serve"])
def test_result_line(root, cell):
    line = harness.run_cell(cell, 2 ** 31 + 9, 0.3, False, time.perf_counter(),
                            device="cpu", root=root)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["metrics"]) == E2E[cell.split(".")[1]]
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"] in ("tokens/s", "ms", "s")
    assert line["metrics"]["setup_s"]["value"] > 0
    # a CPU run writes no device metric
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                              "memory_peak_bytes": 0}
    assert not DEVICE_METRICS & set(line["metrics"])
    assert list(line["checks"]) == list(json.loads(
        (root / "workloads" / f"{cell}.json").read_text())["limits"])
    json.dumps(line)


@pytest.mark.parametrize("cell,fault",
                         [(c, f) for c in CELLS for f in faults.TRAIN]
                         + [("tiny-dense.serve", f) for f in faults.SERVE])
def test_a_planted_fault_is_not_correct(root, cell, fault):
    """The timed path broken underneath: training, a step that returns its
    state unchanged, half of the batch left out, a token altered where the
    loader produces it; serving, a token altered where a decode step
    produces it, half of each batch never answered."""
    with faults.planted(cell.split(".")[1], fault):
        line = harness.run_cell(cell, 77, 0.2, False, time.perf_counter(),
                                device="cpu", root=root)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("kind,fault", [("train", f) for f in faults.TRAIN]
                         + [("serve", f) for f in faults.SERVE])
def test_a_planted_fault_is_taken_out_after_its_run(kind, fault):
    """The program's classes and entries are its own again once the
    fault's context has closed."""
    import repro_torch.launch.serve as S
    import repro_torch.pipeline as P
    import repro_torch.train as T
    from repro_torch.models.registry import ModelBundle

    def program():
        return (T.TrainLoop, P.PackedLoader, S.generate,
                ModelBundle.prefill, ModelBundle.decode_step)

    before = program()
    with faults.planted(kind, fault):
        assert program() != before
    assert program() == before


@pytest.mark.parametrize("cell", CELLS)
def test_the_float8_control_reads_farther_than_the_program(root, tmp_path, cell):
    """The control (the reference with float8 products in the program's
    place) on the batches of a sound run reads worse than the program on
    some number, and fails the smoke limits."""
    import torch

    from portbench import spec

    wl, cfg, traffic = spec.load_cell(cell, root)
    dev = torch.device("cpu")
    loop, loader, readings, docs = train.setup(cfg, traffic, 5, dev, tmp_path,
                                               keep_grad=True)
    kept = loader.kept
    del loop, loader
    wrong, batches = train.reference_batches(traffic, docs, kept)
    assert wrong == 0
    opt = traffic["optimizer"]
    ref = train_readings(cfg, opt, 5, batches, dev,
                         first_grad=readings["first_grad"], keep_first=True,
                         first_scale=1 / (1 - opt["b1"]))
    ctl = train_readings(cfg, opt, 5, batches, dev, fp8_mm,
                         first_grad=ref.pop("first_grad"))
    prog = compare.train_numbers(readings, ref)
    control = compare.train_numbers(ctl, dict(ref, grad_diff=ctl["grad_diff"]))
    if "grad_diff" not in wl["limits"]:
        del prog["grad_diff"], control["grad_diff"]
    assert compare.passed(compare.checks({**prog, "loader_tokens_wrong": 0},
                                         wl["limits"]))
    assert not compare.passed(compare.checks({**control, "loader_tokens_wrong": 0},
                                             wl["limits"]))
    assert max(control[k] / prog[k] for k in prog) > 2


def test_the_float8_control_serves_farther_than_the_program(root):
    """Serving's control: at the served positions, the token the float8
    logits put first lies farther below the reference's best than the
    served token does, and past the smoke limit."""
    import torch

    from portbench import spec

    wl, cfg, traffic = spec.load_cell("tiny-dense.serve", root)
    dev = torch.device("cpu")
    for seed in (1, 2, 3):
        params = serve.draw_params(serve.build_bundle(cfg), cfg, seed, dev)
        rec = serve.serve_batches(serve.build_bundle(cfg), params, traffic, cfg,
                                  seed, dev, 0.0, str(root / f"g{seed}.rntj"),
                                  n_batches=len(serve.lengths_cycle(traffic)))
        gaps = served_gaps(cfg, seed, serve.checked(rec["served"], traffic, seed),
                           dev, fp8_mm)
        limit = wl["limits"]["served_logit_gap"]
        assert max(gaps["served"]) <= limit < max(gaps["control"])


def test_a_trace_without_device_kernels_fails(root):
    """The profiler guard: on the CPU the traced steps hold no device
    kernel, and the run fails rather than read an idle card."""
    with pytest.raises(ytrace.TraceMissed):
        harness.run_cell("tiny-dense.train", 3, 0.1, True, time.perf_counter(),
                         device="cpu", root=root)


def _ev(name, a, b, cuda=True, annotation=False):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b),
                           device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
                           is_user_annotation=annotation)


def test_trace_summary_arithmetic():
    events = [
        _ev("portbench.traced", 0, 1000, cuda=False),
        _ev("portbench.traced", 0, 1000, annotation=True),   # its mirror
        _ev("aten::mm", 50, 400, cuda=False),
        _ev("nvjet_tst_192x192", 100, 300),
        _ev("void flash_fwd_wgmma_split<128>(...)", 250, 500),
        _ev("void at::native::vectorized_elementwise_kernel<4>", 700, 800),
        _ev("some_new_kernel", 850, 900),
    ]
    s = ytrace.summarize(events, "portbench.traced", {"k5_fwd": 1})
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx((400 + 100 + 50) / 1e6)
    assert s["by_class"]["gemm"] == pytest.approx(200e-6)
    assert s["by_class"]["unclassified"] == pytest.approx(50e-6)
    assert s["idle_gaps"][0] == ["aten::mm", pytest.approx(100e-6)] or \
        s["idle_gaps"][0][1] == pytest.approx(200e-6)
    rows = ytrace.breakdown(s)["device_ops"]
    assert rows[-1] == ["unclassified kernels (all)", pytest.approx(50e-6)]
    with pytest.raises(ytrace.TraceMissed, match="missed launches"):
        ytrace.summarize(events, "portbench.traced", {"k5_fwd": 2})
    with pytest.raises(ytrace.TraceMissed, match="no device kernel"):
        ytrace.summarize(events[:3], "portbench.traced", {})


def test_the_command_refuses_a_machine_without_a_card():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "chameleon-34b.train", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=CHECKOUT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_the_reference_attention_by_group_is_the_whole_softmax():
    """The reference's attention, a kv group at a time (recomputed in the
    backward pass), gives the values and gradients of one causal softmax
    over the whole (B, H, T, T) scores."""
    import math

    import torch

    from portbench.reference import model

    torch.manual_seed(0)
    cfg = {"n_heads": 4, "n_kv_heads": 2, "head_dim": 8, "norm_eps": 1e-6,
           "rope_theta": 10000.0, "qk_norm": False}
    w = {k: torch.randn(16, n, dtype=torch.float64, requires_grad=True)
         for k, n in (("attn.wq", 32), ("attn.wk", 16), ("attn.wv", 16))}
    w["attn.wo"] = torch.randn(32, 16, dtype=torch.float64, requires_grad=True)
    x = torch.randn(2, 11, 16, dtype=torch.float64)

    def whole(x):
        q = (x @ w["attn.wq"]).view(2, 11, 4, 8)
        k = (x @ w["attn.wk"]).view(2, 11, 2, 8)
        v = (x @ w["attn.wv"]).view(2, 11, 2, 8)
        q, k = model.rope(q, 10000.0), model.rope(k, 10000.0)
        q, k, v = (t.permute(0, 2, 1, 3) for t in (q, k, v))
        k, v = k.repeat_interleave(2, 1), v.repeat_interleave(2, 1)
        s = q @ k.transpose(-1, -2) / math.sqrt(8)
        s = s.masked_fill(torch.ones(11, 11, dtype=torch.bool).triu(1), float("-inf"))
        y = torch.softmax(s, -1) @ v
        return y.permute(0, 2, 1, 3).reshape(2, 11, 32) @ w["attn.wo"]

    got, want = model.attention(x, w, cfg, model.plain_mm), whole(x)
    assert torch.allclose(got, want, atol=1e-12)
    g1 = torch.autograd.grad(got.square().sum(), list(w.values()))
    g2 = torch.autograd.grad(want.square().sum(), list(w.values()))
    assert all(torch.allclose(a, b, atol=1e-10) for a, b in zip(g1, g2))


def test_the_serve_mix_is_the_same_cycle_for_every_seed():
    """The image-to-text mix: 4 caption and 4 question batches, each of one
    1,024-token image and a text length in its task's range, drawn from
    the mix's own seed; ``--seed`` only orders them."""
    from portbench import spec

    _, _, traffic = spec.load_cell("chameleon-34b.serve")
    cycle = serve.lengths_cycle(traffic)
    assert cycle == serve.lengths_cycle(traffic)
    assert sorted(s[2] for s in cycle) == [8] * 4 + [32] * 4
    for text, images, new in cycle:
        task = next(t for t in traffic["tasks"] if t["max_new"] == new)
        assert task["text"][0] <= text <= task["text"][1] and images == 1
        assert serve.prompt_len(traffic, (text, images, new)) == 1024 + text


def test_the_calibration_detail_gives_grad_diff_leaf_by_leaf():
    """The worst leaf of the whole first gradient's difference is named in
    the calibration's detail, and its reading is the compared number."""
    prog = {"loss": [2.0], "grad": {"a": 1.0, "b": 2.0, "c": 4.0},
            "change": {"a": 1.0, "b": 1.0, "c": 1.0}}
    ref = dict(prog, loss=[2.001], grad_diff={"a": 0.1, "b": 0.6, "c": 0.8})
    detail = compare.train_detail(prog, ref)
    numbers = compare.train_numbers(prog, ref)
    # over each leaf's norm or the median leaf's (2.0), whichever is larger
    assert detail["grad_diff"] == pytest.approx({"a": 0.05, "b": 0.3, "c": 0.2})
    assert max(detail["grad_diff"], key=detail["grad_diff"].get) == "b"
    assert numbers["grad_diff"] == pytest.approx(0.3)
    assert "grad_diff" not in compare.train_detail(prog, prog)
