"""The port's training loop (``repro_torch.train.TrainLoop``) and its
launcher, on the CPU.

* The cases of ``tests/test_train_loop.py``, one for one, on the port:
  the loss decreases, a restart is exact (20 straight steps equal 10
  steps, a crash and 10 resumed steps, here bit for bit), a slow step
  fires the straggler hook, grad compression runs, and microbatched
  accumulation matches the plain step.
* Against ``repro.train.TrainLoop`` on that file's tiny config in fp32
  compute, on one corpus file: the reference loop saves its step-0 state
  through ``repro.ckpt.CheckpointManager``; the port's loop restores it
  (every leaf equal) and both run 10 steps.  Losses agree within
  ``LOSS_TOL`` and parameters within ``PARAM_TOL`` absolute, the bounds
  of ``tests/test_torch_train.py``'s ``test_three_steps_match_the_reference``
  for this family (whose noise-floor rule covers gemma-2b only).  Each
  loop's step-10 checkpoint is resumed by the other package's loop for 5
  more steps, within the same tolerances of the reference's own
  continuation.
* ``repro_torch.launch.train.main`` runs with ``--device cpu`` and a
  second call resumes from the first's checkpoint.
"""

import shutil
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.launch.mesh import make_local_mesh
from repro.models import build as j_build
from repro.pipeline import PackedLoader as JLoader
from repro.pipeline import ingest_corpus as j_ingest
from repro.pipeline import synth_corpus as j_synth
from repro.train import LoopConfig as JLoopConfig
from repro.train import TrainLoop as JTrainLoop
from repro.train import make_optimizer as j_make_optimizer

from repro_torch.configs import get_arch
from repro_torch.launch import train as launch_train
from repro_torch.models import build
from repro_torch.models.weights import to_numpy_tree
from repro_torch.pipeline import PackedLoader, ingest_corpus, synth_corpus
from repro_torch.train import LoopConfig, TrainLoop, make_optimizer

CPU = torch.device("cpu")
TINY = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=256, remat=False)
#: losses of the two packages' loops from one state, relative and
#: absolute: the three-step test's 1e-5 holds over 10 and 15 steps (the
#: largest difference seen is 1.4e-6), so it is not loosened
LOSS_TOL = 1e-5
#: parameters after 10 or 15 steps, absolute: the three-step test's 2e-4
#: (the largest difference seen is 8.5e-6)
PARAM_TOL = 2e-4
#: peak lr of the loops' schedules (``tests/test_train_loop.py``)
LR = 5e-3


def tiny_cfg(**over):
    return get_arch("smollm-360m").with_(**TINY, **over)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("data") / "c.rntj")
    ingest_corpus(synth_corpus(300, seed=0, mean_len=80, vocab=256), p,
                  n_workers=2, device=CPU)
    return p


def make_loop(corpus, ckpt_dir, steps=20, cfg=None, **cfg_kw):
    bundle = build(cfg or tiny_cfg())
    loader = PackedLoader(corpus, batch=4, seq_len=32, device=CPU)
    return TrainLoop(
        bundle, loader, ckpt_dir,
        config=LoopConfig(**{"steps": steps, "ckpt_every": 10,
                             "log_every": 1000, "ckpt_async": False,
                             **cfg_kw}),
        optimizer=make_optimizer(peak_lr=LR, warmup=5, total=200),
        device=CPU,
    )


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flat(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def _leaves(tree):
    return [x for _n, x in _flat(tree)]


# ---------------------------------------------------------------------------
# the reference's cases


def test_loss_decreases(corpus, tmp_path):
    loop = make_loop(corpus, str(tmp_path / "ck"), steps=60)
    hist = loop.run()
    first = np.mean([h.loss for h in hist[:5]])
    last = np.mean([h.loss for h in hist[-5:]])
    assert last < first - 0.05, (first, last)


def test_restart_is_exact(corpus, tmp_path):
    """20 straight steps == 10 steps + crash + 10 resumed steps, bit for
    bit: parameters, moments, the optimizer's step and the losses."""
    a = make_loop(corpus, str(tmp_path / "a"), steps=20)
    a.run()

    b1 = make_loop(corpus, str(tmp_path / "b"), steps=10)
    b1.run()
    del b1  # "crash" after the step-10 checkpoint
    b2 = make_loop(corpus, str(tmp_path / "b"), steps=10)
    assert b2.step == 10  # restored
    assert b2.opt_state.step.dtype == torch.int32
    b2.run()
    assert [h.loss for h in b2.history] == [h.loss for h in a.history[10:]]
    assert int(b2.opt_state.step) == int(a.opt_state.step) == 20
    for tree_a, tree_b in ((a.params, b2.params), (a.opt_state.m, b2.opt_state.m),
                           (a.opt_state.v, b2.opt_state.v)):
        for (n, x), (_n, y) in zip(_flat(tree_a), _flat(tree_b)):
            assert torch.equal(x, y), n


def test_straggler_detection(corpus, tmp_path):
    events = []
    loop = make_loop(corpus, str(tmp_path / "s"), steps=10)
    loop.on_straggler = events.append
    loop.run()                       # warm: builds timing baseline
    orig = loop._step_fn

    def slow(*a):
        time.sleep(max(0.2, 10 * np.median(loop._step_times)))
        return orig(*a)

    loop._step_fn = slow
    loop.run(steps=1)
    assert events and events[-1].straggler


def test_grad_compression_runs(corpus, tmp_path):
    loop = make_loop(corpus, str(tmp_path / "g"), steps=10,
                     grad_compression=True)
    hist = loop.run()
    assert all(np.isfinite(h.loss) for h in hist)
    # the error state is a tree and restores as one
    again = make_loop(corpus, str(tmp_path / "g"), steps=1,
                      grad_compression=True)
    assert again.step == 10
    for (n, x), (_n, y) in zip(_flat(loop.err_state), _flat(again.err_state)):
        assert torch.equal(x, y), n


def test_microbatched_matches_plain(corpus, tmp_path):
    """Gradient accumulation matches the single-batch step (absolute tol:
    bf16 reduction-order differences pass through Adam's 1/sqrt(v) early)."""
    a = make_loop(corpus, str(tmp_path / "m1"), steps=3)
    a.run()
    b = make_loop(corpus, str(tmp_path / "m2"), steps=3, microbatches=2)
    b.run()
    for x, y in zip(_leaves(a.params), _leaves(b.params)):
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(),
                                   atol=2e-2)
    assert abs(a.history[-1].loss - b.history[-1].loss) < 0.05


def test_async_save_records_its_hand_off(corpus, tmp_path):
    loop = make_loop(corpus, str(tmp_path / "h"), steps=10, ckpt_async=True)
    loop.run()
    assert [s.step for s in loop.saves] == [10]
    assert loop.saves[0].block_s > 0 and loop.wait_s >= 0
    assert loop.mgr.steps() == [10]


# ---------------------------------------------------------------------------
# against the reference's loop


def _j_cfg():
    return j_get_arch("smollm-360m").with_(**TINY, compute_dtype="float32")


def _j_loop(corpus, ckpt_dir, steps):
    return JTrainLoop(
        j_build(_j_cfg()), make_local_mesh(),
        JLoader(corpus, batch=4, seq_len=32), ckpt_dir,
        config=JLoopConfig(steps=steps, ckpt_every=10, log_every=1000,
                           ckpt_async=False),
        optimizer=j_make_optimizer(peak_lr=LR, warmup=5, total=200),
    )


def _p_loop(corpus, ckpt_dir, steps):
    return make_loop(corpus, ckpt_dir, steps=steps,
                     cfg=tiny_cfg(compute_dtype="float32"))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """The reference's corpus, its step-0 checkpoint restored by the port,
    and 10 steps of each loop from it; each loop's directory holds its
    step-10 checkpoint."""
    d = tmp_path_factory.mktemp("parity")
    corpus = str(d / "c.rntj")
    j_ingest(j_synth(300, seed=0, mean_len=80, vocab=256), corpus,
             n_workers=2)
    ref = _j_loop(corpus, str(d / "ref"), steps=10)
    ref._save()  # the reference's step-0 state
    shutil.copytree(d / "ref", d / "port")
    port = _p_loop(corpus, str(d / "port"), steps=10)
    assert port.step == 0
    restored = {"params": to_numpy_tree(port.params),
                "m": to_numpy_tree(port.opt_state.m),
                "v": to_numpy_tree(port.opt_state.v)}
    start = {"params": _np_tree(ref.params), "m": _np_tree(ref.opt_state.m),
             "v": _np_tree(ref.opt_state.v)}
    ref.run()
    port.run()
    return {"dir": d, "corpus": corpus, "ref": ref, "port": port,
            "restored": restored, "start": start}


def _assert_params_close(got, want):
    for (n, a), (_n, w) in zip(_flat(got), _flat(want)):
        assert n == _n and a.shape == w.shape
        np.testing.assert_allclose(a, w, atol=PARAM_TOL, rtol=0, err_msg=n)


def test_port_loop_restores_the_reference_step_0(parity):
    for key in ("params", "m", "v"):
        got, want = _flat(parity["restored"][key]), _flat(parity["start"][key])
        assert [n for n, _ in got] == [n for n, _ in want]
        for (n, a), (_n, w) in zip(got, want):
            np.testing.assert_array_equal(a, w, err_msg=f"{key}{n}")


def test_port_loop_matches_the_reference_loop(parity):
    ref, port = parity["ref"], parity["port"]
    assert port.step == ref.step == 10
    np.testing.assert_allclose([h.loss for h in port.history],
                               [h.loss for h in ref.history],
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    _assert_params_close(to_numpy_tree(port.params), _np_tree(ref.params))
    assert int(port.opt_state.step) == int(ref.opt_state.step) == 10


@pytest.mark.parametrize("resumer", ["port", "reference"])
def test_step_10_checkpoints_cross_between_the_packages(parity, resumer,
                                                        tmp_path):
    """The port resumes the reference's step-10 checkpoint, and the
    reference the port's; each continues 5 steps within the tolerances of
    the reference's own continuation of its checkpoint."""
    d = parity["dir"]
    own = tmp_path / "own"
    shutil.copytree(d / "ref", own)
    cont = _j_loop(parity["corpus"], str(own), steps=5)
    assert cont.step == 10
    cont.run()
    cross = tmp_path / "cross"
    if resumer == "port":
        shutil.copytree(d / "ref", cross)
        loop = _p_loop(parity["corpus"], str(cross), steps=5)
    else:
        shutil.copytree(d / "port", cross)
        loop = _j_loop(parity["corpus"], str(cross), steps=5)
    assert loop.step == 10
    loop.run()
    assert loop.step == 15
    np.testing.assert_allclose([h.loss for h in loop.history],
                               [h.loss for h in cont.history],
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    got = (to_numpy_tree(loop.params) if resumer == "port"
           else _np_tree(loop.params))
    _assert_params_close(got, _np_tree(cont.params))


# ---------------------------------------------------------------------------
# the launcher


def test_launch_train_runs_and_resumes(tmp_path, capsys):
    argv = ["--smoke", "--device", "cpu", "--steps", "4", "--ckpt-every", "2",
            "--batch", "2", "--seq", "32", "--data", str(tmp_path / "c.rntj"),
            "--ckpt-dir", str(tmp_path / "ck")]
    first = launch_train.main(argv)
    assert first.step == 4 and len(first.history) == 4
    assert all(np.isfinite(h.loss) for h in first.history)
    assert first.mgr.steps() == [2, 4]
    second = launch_train.main(argv)
    assert "restored from checkpoint at step 4" in capsys.readouterr().out
    assert second.step == 8 and [h.step for h in second.history] == [5, 6, 7, 8]
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        launch_train.main(argv + ["--production-mesh"])
