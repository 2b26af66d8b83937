"""On the card: a smoke cell's traced run reads the device (``python -m
pytest -m cuda portbench/tests`` on a machine with one)."""

import time

import pytest

from smoke_cells import make_root

from portbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny-dense.train", "tiny-moe.train",
                                  "tiny-dense.serve"])
def test_a_traced_smoke_run_on_the_card(tmp_path, cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    line = harness.run_cell(cell, 123, 1.0, True, time.perf_counter(),
                            device="cuda", root=make_root(tmp_path, head_dim=64))
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    kind = cell.split(".")[1]
    names = {"train": ("card_idle.train", "gemm_ms.train", "k5_fwd_roofline.train",
                       "k5_bwd_roofline.train"),
             "serve": ("card_idle.serve", "k5_fwd_roofline.serve",
                       "k6_roofline.serve", "serve_mfu")}[kind]
    for name in names:
        assert name in line["metrics"], name
    assert 0 < line["metrics"][f"k5_fwd_roofline.{kind}"]["value"] <= 105
    assert line["breakdown"]["device_ops"]
