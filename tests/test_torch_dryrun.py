"""The port's dry-run (``repro_torch.launch.dryrun``) on the ``meta``
device, against the JAX package's, on the CPU.

* ``model_flops`` equals ``repro.launch.dryrun.model_flops`` for all ten
  archs x four cells;
* a rank's parameter bytes equal the sum over leaves of the local shard
  sizes under the reference's specs, on both production meshes;
* a meta run of smollm-360m's ``train_4k`` completes, runs K5 and its
  backward through their meta ops (FLOPs counted), and creates no tensor
  off the ``meta`` device;
* ``skipped`` records carry ``bundle.runnable``'s reasons, and the train
  cells of the archs whose training needs MLA's K5 backward or K7's and
  K8's (minicpm3-4b, rwkv6-7b, zamba2-2.7b) are ``ok``, their backwards
  counted through their meta ops;
* the kernels' FLOP formulas count K5's visible pairs;
* ``launch.train`` prints the dry-run's state bytes for its mesh.
"""

import json
import math
import os

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_arch as j_get_arch
from repro.distributed.sharding import _leaf_spec as j_leaf_spec
from repro.models import build as j_build

from repro_torch.configs import (
    ARCHS, SHAPES, SHAPES_BY_NAME, get_arch, smoke_config,
)
from repro_torch.kernels import meta
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import production_mesh_shape

# six test workers share the cores: one thread each, not one per core
torch.set_num_threads(max(1, os.cpu_count() // 6))


def reference_dryrun():
    """``repro.launch.dryrun`` imported with the environment as it was: the
    module sets ``XLA_FLAGS`` to 512 host devices when imported."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as JD
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return JD


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_match_the_reference(arch):
    JD = reference_dryrun()
    for cell, jcell in zip(SHAPES, J_SHAPES, strict=True):
        assert cell.name == jcell.name
        assert D.model_flops(get_arch(arch), cell) == JD.model_flops(
            j_get_arch(arch), jcell)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["singlepod", "multipod"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_bytes_are_the_reference_specs_shards(arch, multi_pod):
    ms = production_mesh_shape(multi_pod)
    sizes = ms.shape
    fsdp = tuple(a for a in ("pod", "data") if a in ms.axis_names)

    class FakeMesh:
        axis_names, shape = ms.axis_names, sizes

    want = 0
    shapes = j_build(j_get_arch(arch)).param_shapes()
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        stacked = any(getattr(k, "key", None) in ("layers", "groups")
                      for k in path)
        spec = j_leaf_spec(tuple(leaf.shape), FakeMesh(), fsdp, "model",
                           stacked)
        n = 1
        for dim, part in zip(leaf.shape, tuple(spec)):
            axes = () if part is None else (
                (part,) if isinstance(part, str) else part)
            n *= dim // math.prod(sizes[a] for a in axes)
        want += n * leaf.dtype.itemsize
    got = D._param_bytes(get_arch(arch), ms, None, False)
    assert got["params"] == want
    assert got["adamw"] == 2 * want  # fp32 parameters: two fp32 moments
    assert D.state_bytes(get_arch(arch), ms) == 3 * want


class OnlyMeta(TorchDispatchMode):
    """Fails on any op whose result lies off the ``meta`` device."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if torch.is_tensor(t) and t.device.type != "meta":
                raise AssertionError(f"{func} made a tensor on {t.device}")
        return out


def test_a_meta_train_cell_allocates_nothing():
    with OnlyMeta():
        rec = D.lower_cell("smollm-360m", "train_4k", False)
    assert rec["status"] == "ok" and rec["mesh"] == "data=16 x model=16"
    assert rec["rows_per_rank"] == 16 and rec["row_axes"] == ["data"]
    ops = rec["flops_by_op"]
    assert ops["repro_torch_meta.flash_attention"] > 0
    assert ops["repro_torch_meta.flash_attention_bwd"] > 0
    assert rec["flops"] == pytest.approx(sum(ops.values()))
    mem = rec["memory"]
    assert mem["state"] == mem["params"] + mem["adamw"]
    assert 0 < mem["remat_input_bytes"] < mem["activation_bytes"]
    assert mem["peak_bytes"] == (
        mem["state"] + mem["grads"] + mem["gathered_params"]
        + max(mem["activation_bytes"], mem["update_temp_bytes"]))
    # the embedding and one layer gathered at a time (remat), not the model
    full = sum(t.numel() * t.element_size() for _p, t in D._leaves(
        D.build(get_arch("smollm-360m")).param_shapes()))
    assert 0 < mem["gathered_params"] < full
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    json.dumps(rec)


@pytest.mark.parametrize("arch,kind", [("rwkv6-7b", "wkv"),
                                       ("zamba2-2.7b", "ssd"),
                                       ("smollm-360m", None)])
def test_the_scan_backwards_workspace_is_in_the_activations(arch, kind):
    """A recurrent layer's backward launch takes a workspace (stored states
    and partial sums) for as long as it runs: the train step's activation
    bytes count the largest, at the step's (rows x heads, seq, state)."""
    cfg = smoke_config(arch)
    mem = D.meta_train(cfg, 2, 64)
    if kind is None:
        assert mem["bwd_workspace_bytes"] == 0
        return
    s = cfg.ssm
    rows, cols = ((s.head_dim, s.head_dim) if kind == "wkv"
                  else (s.d_state, s.head_dim))
    heads = (cfg.d_model if kind == "wkv" else s.expand * cfg.d_model
             ) // s.head_dim
    want = meta.scan_bwd_workspace_bytes(
        kind, getattr(torch, cfg.compute_dtype), 2, heads, 64, rows, cols)
    assert mem["bwd_workspace_bytes"] == want > 0
    assert mem["activation_bytes"] == (
        mem["saved_bytes"] + mem["remat_input_bytes"]
        + mem["recompute_layer_bytes"] + want)


@pytest.mark.parametrize("arch,shape,reason", [
    ("smollm-360m", "long_500k", "SKIP(full-attn)"),
])
def test_skipped_records_carry_the_reason(arch, shape, reason):
    rec = D.lower_cell(arch, shape, True)
    assert rec["status"] == "skipped" and reason in rec["reason"]
    ok, why = D.build(get_arch(arch)).runnable(SHAPES_BY_NAME[shape])
    if not ok:
        assert rec["reason"] == why


@pytest.mark.parametrize("arch,backwards", [
    ("minicpm3-4b", ("flash_attention_bwd",)),
    ("rwkv6-7b", ("rwkv6_scan_bwd",)),
    ("zamba2-2.7b", ("mamba2_ssd_bwd", "flash_attention_bwd")),
])
def test_the_last_three_archs_train_cells_are_ok(arch, backwards):
    rec = D.lower_cell(arch, "train_4k", False)
    assert rec["status"] == "ok", rec.get("reason")
    assert math.isfinite(rec["flops"]) and rec["flops"] > 0
    ops = rec["flops_by_op"]
    for name in backwards:
        assert ops[f"repro_torch_meta.{name}"] > 0, name
    mem = rec["memory"]
    assert 0 < mem["state"] < mem["peak_bytes"]


def test_serve_cells_count_the_serve_kernels(tmp_path):
    rec = D.run_one("zamba2-2.7b", "long_500k", False, out_dir=tmp_path)
    assert rec["status"] == "ok" and rec["rows_per_rank"] == 1
    assert rec["flops_by_op"]["repro_torch_meta.decode_attention"] > 0
    assert rec["memory"]["cache_bytes"] > 0
    assert json.loads(D.result_path("zamba2-2.7b", "long_500k", False,
                                    out_dir=tmp_path).read_text()) == rec
    pre = D.lower_cell("rwkv6-7b", "prefill_32k", False)
    assert pre["flops_by_op"]["repro_torch_meta.rwkv6_scan"] > 0


@pytest.mark.parametrize("sq,sk,causal,window", [
    (7, 7, True, None), (5, 9, True, None), (9, 5, True, None),
    (6, 6, False, None), (12, 12, True, 4), (4, 10, True, 3)])
def test_visible_pairs_count_the_mask(sq, sk, causal, window):
    pos = np.arange(sq)[:, None] + (sk - sq)
    k = np.arange(sk)[None, :]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask &= k <= pos
    if window is not None:
        mask &= k > pos - window
    assert meta.visible_pairs(sq, sk, causal, window) == int(mask.sum())


def test_launch_train_prints_the_state_bytes(tmp_path, capsys):
    from repro_torch.launch import train as launch_train

    launch_train.main(["--smoke", "--device", "cpu", "--steps", "1",
                       "--batch", "2", "--seq", "16", "--data",
                       str(tmp_path / "c.rntj"), "--ckpt-dir",
                       str(tmp_path / "ck")])
    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import MeshShape

    want = D.state_bytes(smoke_config("smollm-360m"),
                         MeshShape(("data", "model"), (1, 1)))
    assert (f"mesh data=1 x model=1: train state {want / 2**30:.3f} GiB"
            in capsys.readouterr().out)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "rwkv6-7b", "zamba2-2.7b"])
def test_launch_train_takes_the_last_three_archs(tmp_path, capsys, arch):
    """``launch.train --arch`` trains MLA, RWKV-6 and the Mamba-2 hybrid
    (smoke configs on the CPU; the dry-run's estimate runs first, on
    ``meta``, at their head dims)."""
    from repro_torch.launch import train as launch_train

    loop = launch_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--steps", "2", "--batch", "2", "--seq", "16",
                              "--data", str(tmp_path / "c.rntj"),
                              "--ckpt-dir", str(tmp_path / "ck")])
    assert loop.step == 2
    assert all(math.isfinite(h.loss) for h in loop.history)
    assert "(dry-run)" in capsys.readouterr().out


@pytest.mark.parametrize("card_gib,refused", [(1, True), (80, False)])
def test_launch_train_refuses_a_step_larger_than_the_card(monkeypatch,
                                                         card_gib, refused):
    """``launch.train`` holds the dry-run's peak of a rank's step on its
    mesh against the card's memory before it draws anything (the card's
    size faked here: no card, no allocation)."""
    import argparse

    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import MeshShape

    class Props:
        total_memory = card_gib * 2 ** 30

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda _dev: Props)
    cfg = get_arch("smollm-360m")
    args = argparse.Namespace(batch=8, microbatches=1, seq=1024,
                              grad_compression=False)
    mesh = MeshShape(("data", "model"), (1, 1))
    check = lambda: T.check_fits(cfg, D.build(cfg), mesh, args,
                                 torch.device("cuda"))
    if refused:
        with pytest.raises(RuntimeError, match="train step at .* GiB"):
            check()
    else:
        check()
