"""The port's checkpoint layer on the CPU: parallel single-file
save/restore of torch trees, fault tolerance, elastic restart (different
writer counts), async saves and multi-process saves.

The cases of ``tests/test_checkpoint.py`` run on ``repro_torch.ckpt`` with
``device="cpu"`` and torch trees (a ``bfloat16`` leaf included); then the
two packages share files: the port's leaf names are ``jax.tree_util``'s
key strings, a one-writer save is byte-identical to the reference's, and
a checkpoint saved by either package (threads or processes) restores in
the other bit for bit.
"""

import os
import stat
import threading
from typing import NamedTuple

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.ckpt as RC
from repro_torch.ckpt import (
    CKPT_SCHEMA,
    CheckpointManager,
    load_checkpoint,
    save_checkpoint,
    save_checkpoint_mp,
)
from repro_torch.ckpt.checkpoint import _flatten_with_names
from repro_torch.core import RNTJReader, WriteOptions

MP_OPTS = WriteOptions(codec="zlib", level=1, cluster_bytes=1 << 20,
                       lease_interval=0.5, rendezvous_timeout=15.0,
                       mpw_log_fsync=False)


def make_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "embed": torch.from_numpy(rng.normal(size=(256, 64)).astype(np.float32)),
        "layers": {
            "w": torch.from_numpy(
                rng.normal(size=(4, 64, 64)).astype(np.float32)),
            "b": torch.zeros((4, 64), dtype=torch.bfloat16),
        },
        "step": torch.tensor(123, dtype=torch.int32),
    }


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16) if x.dtype == torch.bfloat16 else x


def assert_trees_equal(a, b):
    fa, _ = _flatten_with_names(a)
    fb, _ = _flatten_with_names(b)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (_n, x), (_m, y) in zip(fa, fb):
        assert isinstance(y, torch.Tensor) and y.device.type == "cpu"
        assert (x.dtype, x.shape) == (y.dtype, y.shape)
        assert torch.equal(_bits(x), _bits(y))


@pytest.mark.parametrize("n_writers", [1, 2, 7])
def test_save_restore_roundtrip(tmp_path, n_writers):
    tree = make_tree()
    p = str(tmp_path / "c.rntj")
    save_checkpoint(p, tree, n_writers=n_writers, row_block_bytes=4096,
                    device="cpu")
    back, meta = load_checkpoint(p, target_tree=tree, device="cpu")
    assert_trees_equal(tree, back)


def test_restore_without_target_tree(tmp_path):
    tree = make_tree()
    p = str(tmp_path / "c.rntj")
    save_checkpoint(p, tree, n_writers=2, device="cpu")
    back, _ = load_checkpoint(p, device="cpu")
    assert_trees_equal(tree, back)


def test_elastic_restart_across_writer_counts(tmp_path):
    """File written by N writers restores identically regardless of N —
    the paper's reader-compatibility guarantee enables elastic rescale."""
    tree = make_tree(1)
    paths = []
    for n in (1, 3, 8):
        p = str(tmp_path / f"c{n}.rntj")
        save_checkpoint(p, tree, n_writers=n, row_block_bytes=2048,
                        device="cpu")
        paths.append(p)
    restored = [load_checkpoint(p, target_tree=tree, device="cpu")[0]
                for p in paths]
    for r in restored:
        assert_trees_equal(tree, r)
    # logical equality even though cluster layouts differ
    layouts = {RNTJReader(p, device="cpu").n_clusters for p in paths}
    assert len(layouts) > 1  # genuinely different parallel layouts


def test_manager_rotation_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, device="cpu")
    tree = make_tree()
    for step in (10, 20, 30):
        mgr.save(step, tree, {"loss": float(step)})
    assert mgr.steps() == [20, 30]
    back, meta = mgr.restore(target_tree=tree)
    assert meta["step"] == 30 and meta["loss"] == 30.0


def test_crash_mid_write_is_invisible(tmp_path):
    """A .tmp left by a crash is ignored and GC'd; committed ckpts survive."""
    mgr = CheckpointManager(str(tmp_path), keep=3, device="cpu")
    tree = make_tree()
    mgr.save(10, tree)
    # simulate a crash: partial uncommitted file
    (tmp_path / "step_0000000020.rntj.tmp").write_bytes(b"partial garbage")
    mgr2 = CheckpointManager(str(tmp_path), keep=3, device="cpu")
    assert mgr2.latest_step() == 10
    assert not list(tmp_path.glob("*.tmp"))
    back, meta = mgr2.restore(target_tree=tree)
    assert meta["step"] == 10


def test_corrupt_committed_checkpoint_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, device="cpu")
    tree = make_tree()
    mgr.save(10, tree)
    p = mgr.path_for(10)
    data = bytearray(p.read_bytes())
    data[len(data) // 2] ^= 0xFF
    p.write_bytes(bytes(data))
    with pytest.raises(IOError):
        mgr.restore(target_tree=tree)


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, device="cpu")
    tree = make_tree()
    mgr.save_async(5, tree)
    mgr.wait()
    assert mgr.latest_step() == 5
    back, _ = mgr.restore(target_tree=tree)
    assert_trees_equal(tree, back)


def test_async_save_snapshots_before_it_returns(tmp_path, monkeypatch):
    """The step may overwrite the tensors the moment ``save_async``
    returns: the file holds the values of the call."""
    import repro_torch.ckpt.manager as mgr_mod

    release = threading.Event()
    real_save = mgr_mod.save_checkpoint

    def slow_save(path, tree, **kw):
        assert release.wait(timeout=30)
        return real_save(path, tree, **kw)

    monkeypatch.setattr(mgr_mod, "save_checkpoint", slow_save)
    mgr = CheckpointManager(str(tmp_path), keep=3, device="cpu")
    tree = make_tree()
    want = make_tree()
    mgr.save_async(3, tree)
    for _n, x in _flatten_with_names(tree)[0]:
        x.add_(1)  # in place, while the save waits
    release.set()
    back, _ = mgr.restore(target_tree=tree)
    assert_trees_equal(want, back)


def test_concurrent_writers_thread_safety(tmp_path):
    """Many writers, small row blocks: stress the critical section."""
    rng = np.random.default_rng(3)
    tree = {f"p{i}": torch.from_numpy(
        rng.normal(size=(64, 32)).astype(np.float32)) for i in range(20)}
    p = str(tmp_path / "big.rntj")
    save_checkpoint(p, tree, n_writers=8, row_block_bytes=512, device="cpu")
    back, _ = load_checkpoint(p, target_tree=tree, device="cpu")
    assert_trees_equal(tree, back)


# ---------------------------------------------------------------------------
# durability of the directory (commit/prune are rename/unlink, not writes)


def test_manager_fsyncs_directory_after_commit_and_prune(tmp_path, monkeypatch):
    import repro_torch.ckpt.manager as mgr_mod

    events = []
    real_fsync, real_replace = os.fsync, os.replace

    def spy_fsync(fd):
        if stat.S_ISDIR(os.fstat(fd).st_mode):
            events.append("dirsync")
        return real_fsync(fd)

    def spy_replace(a, b):
        events.append("replace")
        return real_replace(a, b)

    monkeypatch.setattr(mgr_mod.os, "fsync", spy_fsync)
    monkeypatch.setattr(mgr_mod.os, "replace", spy_replace)

    mgr = CheckpointManager(str(tmp_path), keep=1, device="cpu")
    tree = make_tree()
    mgr.save(10, tree)
    # the rename is durable only once the directory entry is: a dirsync
    # must FOLLOW the replace (crash between them loses the commit)
    assert "replace" in events
    assert "dirsync" in events[events.index("replace"):], (
        f"no directory fsync after rename: {events}")

    events.clear()
    mgr.save(20, tree)  # prunes step 10
    assert mgr.steps() == [20]
    assert events.count("dirsync") >= 2, (
        f"prune's unlink needs its own directory fsync: {events}")

    # gc of crash leftovers is also a directory mutation
    (tmp_path / "step_0000000099.rntj.tmp").write_bytes(b"junk")
    events.clear()
    mgr.gc_tmp()
    assert "dirsync" in events


# ---------------------------------------------------------------------------
# async-save synchronization (restore/steps vs in-flight save)


def test_restore_and_steps_wait_for_async_save(tmp_path, monkeypatch):
    import repro_torch.ckpt.manager as mgr_mod

    started = threading.Event()
    release = threading.Event()
    real_save = mgr_mod.save_checkpoint

    def slow_save(path, tree, **kw):
        started.set()
        assert release.wait(timeout=30)
        return real_save(path, tree, **kw)

    monkeypatch.setattr(mgr_mod, "save_checkpoint", slow_save)
    mgr = CheckpointManager(str(tmp_path), keep=3, device="cpu")
    tree = make_tree()
    mgr.save_async(7, tree)
    assert started.wait(timeout=30)
    # un-synchronized, these would race the rename and miss step 7
    threading.Timer(0.05, release.set).start()
    assert mgr.steps() == [7]
    back, meta = mgr.restore(target_tree=tree)
    assert meta["step"] == 7
    assert_trees_equal(tree, back)


def test_restore_surfaces_async_save_error(tmp_path, monkeypatch):
    import repro_torch.ckpt.manager as mgr_mod

    def boom(path, tree, **kw):
        raise RuntimeError("injected save failure")

    monkeypatch.setattr(mgr_mod, "save_checkpoint", boom)
    mgr = CheckpointManager(str(tmp_path), keep=3, device="cpu")
    mgr.save_async(7, make_tree())
    with pytest.raises(RuntimeError, match="injected save failure"):
        mgr.restore()


def test_wait_self_join_guard(tmp_path):
    # save() -> _prune() -> steps() runs ON the async thread: wait() must
    # detect it and return instead of self-joining (deadlock)
    mgr = CheckpointManager(str(tmp_path), keep=3, device="cpu")
    mgr._async_thread = threading.current_thread()
    mgr.wait()  # returns immediately; a join here would deadlock
    assert mgr._async_thread is threading.current_thread()
    mgr._async_thread = None

    # and the integration: back-to-back async saves with prune enabled
    mgr2 = CheckpointManager(str(tmp_path / "x"), keep=1, device="cpu")
    tree = make_tree()
    mgr2.save_async(1, tree)
    mgr2.save_async(2, tree)
    mgr2.wait()
    assert mgr2.steps() == [2]


# ---------------------------------------------------------------------------
# multi-process saves (the DESIGN.md §8.6 proof workload)


def test_mp_save_restore_roundtrip(tmp_path):
    tree = make_tree()
    p = str(tmp_path / "mp.rntj")
    report = save_checkpoint_mp(p, tree, n_processes=2,
                                row_block_bytes=4096, options=MP_OPTS,
                                metadata={"step": 1}, device="cpu")
    assert not report["degraded"], report
    assert report["worker_exitcodes"] == [0, 0]
    assert not os.path.exists(p + ".mpwlog")
    back, meta = load_checkpoint(p, target_tree=tree, device="cpu")
    assert_trees_equal(tree, back)
    assert meta["step"] == 1


def test_mp_save_worker_killed_restore_succeeds(tmp_path):
    """Kill one of N writer processes mid-save: the seal degrades, strict
    restore refuses, strict=False restores every surviving parameter."""
    tree = make_tree(2)
    p = str(tmp_path / "mp.rntj")
    report = save_checkpoint_mp(p, tree, n_processes=2,
                                row_block_bytes=4096, options=MP_OPTS,
                                metadata={"step": 2},
                                crash_worker=1, crash_after_units=2,
                                device="cpu")
    assert report["degraded"]
    assert report["worker_exitcodes"][1] != 0
    assert len(report["fenced"]) == 1

    with pytest.raises(IOError, match="incomplete"):
        load_checkpoint(p, device="cpu")

    back, meta = load_checkpoint(p, target_tree=tree, strict=False,
                                 device="cpu")
    missing = set(meta.get("restore_missing", []))
    assert missing, "a killed writer must leave at least one gap"
    flat_src, _ = _flatten_with_names(tree)
    flat_got, _ = _flatten_with_names(back)
    for (name, src), (_n, got) in zip(flat_src, flat_got):
        if name not in missing:
            assert torch.equal(_bits(src), _bits(got))


def test_manager_refuses_degraded_mp_save(tmp_path, monkeypatch):
    import repro_torch.ckpt.manager as mgr_mod

    real = mgr_mod.save_checkpoint_mp

    def crashing(path, tree, **kw):
        return real(path, tree, crash_worker=0, crash_after_units=1, **kw)

    monkeypatch.setattr(mgr_mod, "save_checkpoint_mp", crashing)
    mgr = CheckpointManager(str(tmp_path), keep=3, processes=2,
                            mp_options=MP_OPTS, device="cpu")
    tree = make_tree()
    with pytest.raises(IOError, match="degraded"):
        mgr.save(5, tree)
    assert mgr.steps() == []  # nothing committed
    assert not list(tmp_path.glob("*.tmp"))      # tmp dropped
    assert not list(tmp_path.glob("*.mpwlog"))   # side-car dropped

    # explicit opt-in commits the salvaged file; restore needs strict=False
    mgr2 = CheckpointManager(str(tmp_path), keep=3, processes=2,
                             mp_options=MP_OPTS, allow_degraded=True,
                             device="cpu")
    stats = mgr2.save(6, tree)
    assert stats["degraded"]
    assert mgr2.steps() == [6]
    back, meta = mgr2.restore(target_tree=tree, strict=False)
    assert meta.get("restore_missing")


def test_manager_mp_save_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, processes=2,
                            mp_options=MP_OPTS, device="cpu")
    tree = make_tree()
    stats = mgr.save(11, tree, {"loss": 0.5})
    assert not stats["degraded"]
    back, meta = mgr.restore(target_tree=tree)
    assert meta["step"] == 11 and meta["loss"] == 0.5
    assert_trees_equal(tree, back)


# ---------------------------------------------------------------------------
# both packages on the same files


class _State(NamedTuple):
    step: object
    m: object


def _ref_twin(tree):
    """The same tree with numpy leaves, as the reference saves a host copy
    (``bfloat16`` through ml_dtypes; int64 stays int64, which jax arrays
    without x64 would narrow)."""
    def walk(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, _State):
            return _State(*[walk(v) for v in x])
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        if isinstance(x, torch.Tensor):
            if x.dtype == torch.bfloat16:
                return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
            return x.numpy()
        return x
    return walk(tree)


def _train_like_tree(seed=0):
    """The train loop's state shape: params, a NamedTuple optimizer state,
    lists, tuples, an empty leaf position and the loader's numpy state."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(size=(40, 16)).astype(np.float32))
    return {
        "params": {"w": w, "b16": w[:3].to(torch.bfloat16),
                   "blocks": [torch.arange(6, dtype=torch.int64),
                              (torch.tensor(True), torch.ones(2, 2))]},
        "opt": _State(torch.tensor(7, dtype=torch.int32),
                      {"w": torch.zeros(40, 16)}),
        "err": None,
        "loader": {"entry_cursor": torch.tensor(17),
                   "leftover": torch.arange(5, dtype=torch.int32)},
    }


def _ref_leaf_bits(x):
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def test_leaf_names_are_jax_key_strings():
    tree = _train_like_tree()
    names = [n for n, _ in _flatten_with_names(tree)[0]]
    flat, _ = jax.tree_util.tree_flatten_with_path(_ref_twin(tree))
    assert names == [jax.tree_util.keystr(p) for p, _ in flat]
    assert ".step" in names[names.index("['opt'].m['w']") - 1]


@pytest.mark.parametrize("route", ["threads", "processes"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, route):
    tree = _train_like_tree(1)
    p = str(tmp_path / "port.rntj")
    if route == "threads":
        save_checkpoint(p, tree, n_writers=3, row_block_bytes=256,
                        metadata={"step": 4}, device="cpu")
    else:
        rep = save_checkpoint_mp(p, tree, n_processes=2, row_block_bytes=256,
                                 options=MP_OPTS, metadata={"step": 4},
                                 device="cpu")
        assert not rep["degraded"], rep
    back, meta = RC.load_checkpoint(p, target_tree=_ref_twin(tree))
    assert meta["step"] == 4
    flat_t, _ = _flatten_with_names(tree)
    flat_r, _ = jax.tree_util.tree_flatten_with_path(back)
    assert [n for n, _ in flat_t] == [jax.tree_util.keystr(q)
                                       for q, _ in flat_r]
    for (_n, t), (_q, r) in zip(flat_t, flat_r):
        assert str(np.asarray(r).dtype) == str(t.dtype).removeprefix("torch.")
        assert np.array_equal(_ref_leaf_bits(r), _bits(t).numpy())


@pytest.mark.parametrize("route", ["threads", "processes"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, route):
    tree = _train_like_tree(2)
    jtree = _ref_twin(tree)
    p = str(tmp_path / "ref.rntj")
    if route == "threads":
        RC.save_checkpoint(p, jtree, n_writers=3, row_block_bytes=256,
                           metadata={"step": 9})
    else:
        rep = RC.save_checkpoint_mp(p, jtree, n_processes=2,
                                    row_block_bytes=256, metadata={"step": 9},
                                    options=RC.checkpoint.WriteOptions(
                                        codec="zlib", level=1,
                                        cluster_bytes=1 << 20,
                                        lease_interval=0.5,
                                        rendezvous_timeout=15.0,
                                        mpw_log_fsync=False))
        assert not rep["degraded"], rep
    back, meta = load_checkpoint(p, target_tree=tree, device="cpu")
    assert meta["step"] == 9
    assert type(back["opt"]) is _State
    assert_trees_equal(tree, back)
    # without a target: nested dicts keyed by the key strings' parts
    loose, _ = load_checkpoint(p, device="cpu")
    assert torch.equal(_bits(loose["params"]["b16"]),
                       _bits(tree["params"]["b16"]))
    assert torch.equal(loose["params"]["blocks"]["1"]["1"],
                       tree["params"]["blocks"][1][1])


def test_one_writer_save_is_byte_identical_to_the_reference(tmp_path):
    tree = _train_like_tree(3)
    a, b = str(tmp_path / "ref.rntj"), str(tmp_path / "port.rntj")
    RC.save_checkpoint(a, _ref_twin(tree), n_writers=1, row_block_bytes=512,
                       metadata={"step": 1})
    save_checkpoint(b, tree, n_writers=1, row_block_bytes=512,
                    metadata={"step": 1}, device="cpu")
    assert open(a, "rb").read() == open(b, "rb").read()
    assert ([(c.path, c.dtype) for c in RC.CKPT_SCHEMA.columns]
            == [(c.path, c.dtype) for c in CKPT_SCHEMA.columns])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_an_empty_leaf_restores_in_both_packages(tmp_path, writer):
    """A leaf with no elements (the loader's leftover in a step-0 train
    state) restores with its dtype and shape, whichever package wrote it."""
    tree = {"leftover": np.empty(0, np.int32), "cursor": np.asarray(0),
            "w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    p = str(tmp_path / "empty.rntj")
    if writer == "port":
        save_checkpoint(p, tree, n_writers=2, device="cpu")
    else:
        RC.save_checkpoint(p, {**tree, "w": tree["w"].numpy()}, n_writers=2)
    back, _ = load_checkpoint(p, device="cpu")
    assert back["leftover"].dtype == torch.int32
    assert back["leftover"].shape == (0,)
    assert int(back["cursor"]) == 0 and torch.equal(back["w"], tree["w"])
    ref, _ = RC.load_checkpoint(p)
    assert np.asarray(ref["leftover"]).dtype == np.int32
    assert np.asarray(ref["leftover"]).shape == (0,)
