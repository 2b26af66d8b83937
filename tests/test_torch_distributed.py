"""``repro_torch.distributed``, ``launch.mesh`` and the meshed steps
against the JAX package's, on the CPU.

* Sharding logic: ``AxisRules.spec`` and ``auto_param_sharding`` give the
  reference's specs for every parameter leaf of all ten archs at full
  size, on meshes (16, 16), (2, 16, 16), (2, 2) and (4, 1), and for
  activations and caches with the divisibility fallback (gemma's 8 and
  smollm's 15 heads over model = 16); the reference's ``_leaf_spec`` and
  ``AxisRules.spec`` take a mesh description, as
  ``tests/test_distributed.py`` calls them.  Specs compare as tuples and
  through ``to_placements``.
* ``replan``'s dp degree and per-device bytes equal the reference's.
* Multi-rank semantics run as spawned gloo processes (``file://`` store
  under ``tmp_path``, each run failed after ``SPAWN_TIMEOUT_S``):
  ``hierarchical_psum`` on (pod = 2, data = 2) equals a flat all-reduce,
  ``reduce_scatter_grads`` the sum's shard, ``ring_permute`` the ring;
  ``pipelined`` on 4 stages and 4 microbatches equals the sequential loop
  within 1e-5; the meshed train step on (data = 2) and (data = 2, model =
  2) matches ``repro.train.make_train_step`` on one device (losses, ``ce``
  and ``aux`` within 1e-5, parameters within 2e-4, ``test_torch_train_families``) for
  smollm-360m and deepseek-moe-16b, with labels whose ``ignore_index``
  falls unevenly on the ranks (the global cross-entropy) and MoE ranks that
  route different tokens (the global balance loss); the prefill and serve
  steps on (data = 2) equal the one-card prefill and decode; a
  ``TrainLoop`` saves on a 2-rank mesh and restores on one rank bit for
  bit, and its next step matches the 2-rank run's.
* On a one-rank mesh the meshed step equals the one-card step bit for bit
  (every collective is an identity).
* The production mesh refuses a world of another size.
"""

import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_arch as j_get_arch
from repro.distributed.sharding import AxisRules as JAxisRules
from repro.distributed.sharding import _leaf_spec as j_leaf_spec
from repro.models import build as j_build

from test_torch_train_families import (
    CPU, assert_metrics_close, assert_params_close, configs, family_batches,
    flat, initial_params, reference_run,
)
from repro_torch.configs import smoke_config
from repro_torch.distributed import AxisRules, auto_param_sharding, to_placements
from repro_torch.distributed.elastic import replan, validate_batch_divisibility
from repro_torch.launch.mesh import MeshShape, make_production_mesh
from repro_torch.models import build
from repro_torch.train import init_train_state

# six test workers share the cores: one thread each, not one per core
torch.set_num_threads(max(1, os.cpu_count() // 6))

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 120
MESHES = {"16x16": MeshShape(("data", "model"), (16, 16)),
          "2x16x16": MeshShape(("pod", "data", "model"), (2, 16, 16)),
          "2x2": MeshShape(("data", "model"), (2, 2)),
          "4x1": MeshShape(("data", "model"), (4, 1))}


# ---------------------------------------------------------------------------
# spawned gloo ranks

PRELUDE = """
import logging, sys, warnings
warnings.filterwarnings("ignore")
logging.disable(logging.WARNING)
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD, OUT = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{OUT}/store",
                        rank=RANK, world_size=WORLD)


def save(obj):
    torch.save(obj, f"{OUT}/rank{RANK}.pt")


def load(name):
    return torch.load(f"{OUT}/{name}", weights_only=False)
"""


def run_ranks(n: int, body: str, out: Path) -> list:
    """Run ``body`` (after ``PRELUDE``) in ``n`` gloo ranks; -> what each
    rank ``save``d.  A rank that fails or outlives ``SPAWN_TIMEOUT_S``
    fails the test (every rank is killed)."""
    out.mkdir(parents=True, exist_ok=True)
    script = out / "rank.py"
    script.write_text(PRELUDE + textwrap.dedent(body)
                      + "\ndist.destroy_process_group()\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(n),
                               str(out)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"{n} gloo ranks outlived {SPAWN_TIMEOUT_S} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(n)]


# ---------------------------------------------------------------------------
# sharding logic against the reference


class FakeMesh:
    """A mesh description the reference's rules read (``axis_names``,
    ``shape``), as ``tests/test_distributed.py`` builds one."""

    def __init__(self, ms: MeshShape):
        self.axis_names = ms.axis_names
        self.shape = ms.shape


def j_rules(ms: MeshShape, mapping=None):
    from repro.distributed.sharding import DEFAULT_RULES

    rules = JAxisRules.__new__(JAxisRules)
    rules.mesh = FakeMesh(ms)
    rules.mapping = {k: tuple(a for a in v if a in ms.axis_names)
                     for k, v in dict(mapping or DEFAULT_RULES).items()}
    return rules


def same_spec(port, ref, ms):
    ref = tuple(ref)
    assert port == ref, (port, ref)
    assert to_placements(port, ms) == to_placements(ref, ms)


def j_param_specs(arch: str, ms: MeshShape) -> dict:
    """{path: the reference's spec} over its ``param_shapes`` at full
    size, with ``auto_param_sharding``'s stacked-dim rule."""
    shapes = j_build(j_get_arch(arch)).param_shapes()
    fsdp = tuple(a for a in ("pod", "data") if a in ms.axis_names)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [getattr(k, "key", None) for k in path]
        stacked = any(k in ("layers", "groups") for k in keys)
        out["/" + "/".join(map(str, keys))] = j_leaf_spec(
            tuple(leaf.shape), FakeMesh(ms), fsdp, "model", stacked)
    return out


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_param_specs_match_the_reference(arch, mesh):
    ms = MESHES[mesh]
    want = j_param_specs(arch, ms)
    got = dict(flat(auto_param_sharding(build(arch).param_shapes(), ms)))
    assert sorted(got) == sorted(want)
    for path, sh in got.items():
        same_spec(sh.spec, want[path], ms)


#: (logical axes, shape) of activations and caches, with the divisibility
#: fallback: smollm-360m's 15 heads and gemma-2b's 8 over model = 16
ACTIVATIONS = [
    (("dp", "sp", None), (256, 4096, 960)),
    (("dp", "tp", None, None), (256, 15, 4096, 64)),      # smollm q heads
    (("dp", "tp", "sp_attn", None), (256, 15, 4096, 64)),  # q-seq takes it
    (("dp", "tp", None, None), (256, 8, 4096, 256)),       # gemma q heads
    (("dp", "tp", None, None), (256, 64, 4096, 128)),      # heads divide
    ((None, "dp", "tp_kv", "sp_kv", None), (95, 128, 8, 32768, 128)),
    ((None, "dp", "tp_kv", "sp_kv", None), (95, 128, 64, 32768, 128)),
    ((None, "dp", "tp_kv", "sp_kv", None), (95, 128, 5, 1001, 3)),
    ((None, "dp", "tp_kv", "sp_kv", None), (32, 1, 5, 524288, 64)),
    (("ep", None, "ep2", None), (8, 256, 320, 6144)),
    (("ep", None, "ep2", None), (3, 256, 320, 6144)),      # capacity takes it
    ((("fsdp", "tp"), None), (4096, 960)),                # one dim, all axes
    (("fsdp", "tp"), (49152, 960)),
]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("dp_wide", [False, True])
def test_axis_rules_match_the_reference(mesh, dp_wide):
    from repro.distributed.sharding import DEFAULT_RULES

    ms = MESHES[mesh]
    mapping = ({**DEFAULT_RULES, "dp": ("pod", "data", "model")} if dp_wide
               else None)
    port, ref = AxisRules(ms, mapping), j_rules(ms, mapping)
    for logical, shape in ACTIVATIONS:
        same_spec(port.spec(logical, shape), ref.spec(logical, shape), ms)
    for name in ref.mapping:
        assert port.axis_size(name) == ref.axis_size(name)


def test_the_fallback_replicates_heads_that_do_not_divide():
    rules = AxisRules(MESHES["16x16"])
    assert rules.spec(("dp", "tp", None, None), (256, 15, 4096, 64)) == (
        "data", None, None, None)
    assert rules.spec(("dp", "tp", "sp_attn", None), (256, 8, 4096, 256)) == (
        "data", None, "model", None)


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-moe-16b"])
@pytest.mark.parametrize("mesh", MESHES)
def test_replan_matches_the_reference(arch, mesh, monkeypatch):
    import repro.distributed.elastic as JE

    ms = MESHES[mesh]
    # the reference's plan reads only shapes for its numbers; its
    # shardings need live devices
    monkeypatch.setattr(JE, "auto_param_sharding", lambda shapes, mesh: None)
    want = JE.replan(j_build(j_get_arch(arch)).param_shapes(), FakeMesh(ms))
    got = replan(build(arch).param_shapes(), ms)
    assert (got.dp_degree, got.per_device_param_bytes) == (
        want.dp_degree, want.per_device_param_bytes)
    assert validate_batch_divisibility(256, got) == JE.validate_batch_divisibility(256, want)
    assert validate_batch_divisibility(33, got)[0] == (got.dp_degree == 1)


def test_the_production_mesh_refuses_another_world_size():
    with pytest.raises(RuntimeError, match="needs 256 ranks, this world has 1"):
        make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")


# ---------------------------------------------------------------------------
# collectives and the pipeline on gloo ranks


def test_collectives_on_four_ranks(tmp_path):
    got = run_ranks(4, """
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.distributed.collectives import (
            hierarchical_psum, reduce_scatter_grads, ring_permute)
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
        x = torch.arange(32.0).reshape(8, 4) * (RANK + 1) + RANK
        flat = x.clone()
        dist.all_reduce(flat)
        hier = hierarchical_psum(x, mesh)
        tree = {"a": x, "b": {"c": torch.arange(3.0) + RANK}}
        rs = reduce_scatter_grads(tree, mesh, "data")
        ring = ring_permute(torch.tensor([float(RANK)]), mesh, "data")
        save({"flat": flat, "hier": hier, "rs": rs, "ring": ring,
              "coord": mesh.get_coordinate()})
    """, tmp_path)
    xs = [torch.arange(32.0).reshape(8, 4) * (r + 1) + r for r in range(4)]
    for r, g in enumerate(got):
        torch.testing.assert_close(g["hier"], g["flat"], rtol=1e-6, atol=0)
        torch.testing.assert_close(g["flat"], sum(xs))
        pod, data = g["coord"]
        # the data group of this rank: ranks pod*2 + {0, 1}
        group = [pod * 2, pod * 2 + 1]
        total = xs[group[0]] + xs[group[1]]
        torch.testing.assert_close(g["rs"]["a"], total[data * 4:(data + 1) * 4])
        # dim 0 of 3 does not divide over 2: the whole sum
        torch.testing.assert_close(
            g["rs"]["b"]["c"], 2 * torch.arange(3.0) + sum(group))
        assert float(g["ring"]) == group[(data - 1) % 2]


def test_pipelined_equals_the_sequential_loop(tmp_path):
    got = run_ranks(4, """
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.distributed.pipeline_parallel import pipelined
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("stage",))
        g = torch.Generator().manual_seed(0)
        L, D = 8, 16
        params = {"w": torch.randn(L, D, D, generator=g) * 0.2}
        x = torch.randn(8, D, generator=g)
        layer = lambda p, h: torch.tanh(h @ p["w"])
        want = x
        for i in range(L):
            want = layer({"w": params["w"][i]}, want)
        out = pipelined(layer, mesh, "stage", n_microbatches=4)(params, x)
        save({"out": out, "want": want})
    """, tmp_path)
    for g in got:
        torch.testing.assert_close(g["out"], g["want"], atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the meshed train step against the reference


MESHED_ARCHS = ("smollm-360m", "deepseek-moe-16b")


def uneven_batches(cfg, seed):
    """Three (4, 16) batches whose first two rows (rank 0's on data = 2)
    carry ``ignore_index`` on most labels and the last two on none."""
    out = family_batches(cfg, 4, 16, seed)
    for b in out:
        b["labels"][0, 3:] = -100
        b["labels"][1, :12] = -100
    return out


@functools.lru_cache(maxsize=None)
def meshed_case(arch):
    """(reference config, port config, weights, batches, the reference's
    run), computed once for both meshes."""
    jcfg, cfg = configs(arch)
    params_np = initial_params(cfg, 7)
    batches = uneven_batches(cfg, 40)
    return jcfg, cfg, params_np, batches, reference_run(jcfg, params_np,
                                                        batches)


@pytest.mark.parametrize("model", [1, 2], ids=["data2", "data2-model2"])
def test_meshed_step_matches_the_reference(model, tmp_path):
    cases = {arch: meshed_case(arch)[:4] for arch in MESHED_ARCHS}
    torch.save({a: (c[1], c[2], c[3]) for a, c in cases.items()},
               tmp_path / "in.pt")
    got = run_ranks(2 * model, f"""
        from torch.distributed.tensor import DTensor
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.models import build
        from repro_torch.models.weights import from_jax_params
        from repro_torch.train import (init_train_state, make_optimizer,
                                       make_train_step)
        mesh = make_local_mesh(model={model}, device="cpu")
        out = {{}}
        for arch, (cfg, params_np, batches) in load("in.pt").items():
            bundle = build(cfg)
            opt = make_optimizer(peak_lr=3e-3, warmup=1, total=20)
            _p, o, e = init_train_state(bundle, device="cpu", optimizer=opt,
                                        mesh=mesh)
            from repro_torch.train.step import param_sharding
            from repro_torch.distributed import place
            from repro_torch.train.optimizer import tree_map
            p = tree_map(place, from_jax_params(params_np, cfg, "cpu"),
                         param_sharding(bundle, mesh))
            step = make_train_step(bundle, optimizer=opt, mesh=mesh)
            metrics = []
            for b in batches:
                p, o, e, m = step(p, o, e, b)
                metrics.append({{k: float(v) for k, v in m.items()}})
            full = tree_map(lambda t: t.full_tensor().numpy(), p)
            out[arch] = (metrics, full)
        save(out)
    """, tmp_path)
    for arch, (jcfg, cfg, params_np, batches) in cases.items():
        jm, jp, noise = meshed_case(arch)[4]
        for r, g in enumerate(got):
            tm, tp = g[arch]
            assert_metrics_close(tm, jm)
            assert_params_close(tp, jp, noise)
        if cfg.moe is not None:
            assert all(m["aux"] > 0 for m in jm)


def test_prefill_and_serve_steps_on_two_ranks(tmp_path):
    cfg = smoke_config("smollm-360m").with_(compute_dtype="float32")
    got = run_ranks(2, """
        from repro_torch.configs import smoke_config
        from repro_torch.configs.base import ShapeCell
        from repro_torch.distributed import place
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.models import build
        from repro_torch.train.optimizer import tree_map
        from repro_torch.train.step import (
            make_prefill_step, make_serve_step, param_sharding)
        cfg = smoke_config("smollm-360m").with_(compute_dtype="float32")
        mesh = make_local_mesh(device="cpu")
        bundle = build(cfg)
        gen = torch.Generator().manual_seed(3)
        params = bundle.init(gen, "cpu")
        placed = tree_map(place, params, param_sharding(bundle, mesh))
        prompts = torch.randint(0, cfg.vocab_size, (4, 12), generator=gen,
                                dtype=torch.int32)
        logits, cache = make_prefill_step(bundle, mesh, 16)(placed, prompts)
        serve = make_serve_step(bundle, mesh, ShapeCell("d", "decode", 16, 4))
        tok = torch.argmax(logits, -1).to(torch.int32)
        steps = []
        for i in range(2):
            pos = torch.full((4,), 12 + i, dtype=torch.int32)
            tok, lg, cache = serve(placed, tok, cache, pos)
            steps.append((tok, lg))
        # the one-card path on the same parameters
        with torch.no_grad():
            l1, c1 = bundle.prefill(params, prompts, max_len=16)
            t1 = torch.argmax(l1, -1).to(torch.int32)
            want = []
            for i in range(2):
                pos = torch.full((4,), 12 + i, dtype=torch.int32)
                lg, c1 = bundle.decode_step(params, t1, c1, pos)
                t1 = torch.argmax(lg, -1).to(torch.int32)
                want.append((t1, lg))
        save({"logits": (logits, l1), "steps": steps, "want": want,
              "k": (cache["layers"]["k"].full_tensor(), c1["layers"]["k"])})
    """, tmp_path)
    for g in got:
        torch.testing.assert_close(*g["logits"], atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(*g["k"], atol=1e-5, rtol=1e-5)
        for (t, lg), (wt, wl) in zip(g["steps"], g["want"]):
            assert torch.equal(t, wt)
            torch.testing.assert_close(lg, wl, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# one rank: the mesh adds no arithmetic


def test_a_one_rank_mesh_equals_the_one_card_step_bit_for_bit():
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import init_train_state, make_optimizer, make_train_step
    from repro_torch.train.optimizer import tree_leaves

    mesh = make_local_mesh(device="cpu")
    assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {"data": 1, "model": 1}
    runs = []
    for arch in MESHED_ARCHS:
        cfg = smoke_config(arch).with_(compute_dtype="float32")
        bundle = build(cfg)
        batches = uneven_batches(cfg, 41)
        for m in (None, mesh):
            opt = make_optimizer(peak_lr=3e-3, warmup=1, total=20)
            step = make_train_step(bundle, optimizer=opt, mesh=m)
            p, o, e = init_train_state(bundle, seed=4, device=CPU,
                                       optimizer=opt, mesh=m)
            losses = []
            for b in batches:
                p, o, e, met = step(p, o, e, b)
                losses.append([float(v) for v in met.values()])
            local = [t.to_local() if m is not None else t
                     for t in tree_leaves({"p": p, "m": o.m, "v": o.v})]
            runs.append((losses, local))
        (l0, t0), (l1, t1) = runs[-2:]
        assert l0 == l1, arch
        assert all(torch.equal(a, b) for a, b in zip(t0, t1)), arch


# ---------------------------------------------------------------------------
# the loop on a mesh


def test_loop_saves_on_two_ranks_and_restores_on_one(tmp_path):
    from repro_torch.ckpt.checkpoint import _flatten_with_names
    from repro_torch.pipeline import PackedLoader, ingest_corpus, synth_corpus
    from repro_torch.train import LoopConfig, TrainLoop, make_optimizer

    cfg = smoke_config("deepseek-moe-16b").with_(compute_dtype="float32")
    data = tmp_path / "corpus.rntj"
    ingest_corpus(synth_corpus(60, seed=1, mean_len=64, vocab=cfg.vocab_size),
                  str(data), n_workers=1, device="cpu")
    ckpt = tmp_path / "ckpt"
    got = run_ranks(2, f"""
        from repro_torch.configs import smoke_config
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.models import build
        from repro_torch.pipeline import PackedLoader
        from repro_torch.train import LoopConfig, TrainLoop, make_optimizer
        from repro_torch.train.optimizer import tree_map
        cfg = smoke_config("deepseek-moe-16b").with_(compute_dtype="float32")
        mesh = make_local_mesh(device="cpu")
        loader = PackedLoader({str(data)!r}, batch=2, seq_len=16,
                              engine="host", device="cpu")
        loop = TrainLoop(build(cfg), loader, {str(ckpt)!r},
                         config=LoopConfig(steps=2, ckpt_every=2,
                                           ckpt_async=False),
                         optimizer=make_optimizer(peak_lr=3e-3, warmup=1,
                                                  total=20),
                         device="cpu", seed=3, mesh=mesh)
        loop.run()
        full = lambda t: t.full_tensor().clone()  # the step works in place
        saved = {{"p": tree_map(full, loop.params),
                  "m": tree_map(full, loop.opt_state.m),
                  "v": tree_map(full, loop.opt_state.v)}}
        loop.run(1)
        nxt = {{"loss": loop.history[-1].loss,
               "p": tree_map(lambda t: t.full_tensor(), loop.params)}}
        save({{"saved": saved, "next": nxt}})
    """, tmp_path / "ranks")
    loader = PackedLoader(str(data), batch=2, seq_len=16, engine="host",
                          device="cpu")
    one = TrainLoop(build(cfg), loader, str(ckpt),
                    config=LoopConfig(steps=1, ckpt_every=100),
                    optimizer=make_optimizer(peak_lr=3e-3, warmup=1, total=20),
                    device="cpu", seed=99)
    assert one.step == 2
    restored, _r = _flatten_with_names(
        {"p": one.params, "m": one.opt_state.m, "v": one.opt_state.v})
    for g in got:
        want, _r = _flatten_with_names(g["saved"])
        for (n, a), (_n, b) in zip(restored, want, strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b), n
    one.run()
    nxt = got[0]["next"]
    np.testing.assert_allclose(one.history[-1].loss, nxt["loss"], rtol=1e-5,
                               atol=1e-5)
    for (n, a), (_n, b) in zip(flat(one.params), flat(nxt["p"]), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4, rtol=0,
                                   err_msg=n)
    loader.close()


def test_a_meshed_init_keeps_only_shards_of_the_one_card_draw(tmp_path):
    """``init_train_state`` on (data=2, model=2) draws what the one-card
    init draws, layer by layer, and each rank holds its shards only: the
    gathered tensors equal the one-card ones bit for bit, and the local
    tensors hold a quarter of the parameters (each sharded leaf cut in
    4, a 2-D stacked leaf along its layer dim too)."""
    cfg = smoke_config("deepseek-moe-16b").with_(compute_dtype="float32")
    got = run_ranks(4, """
        from repro_torch.configs import smoke_config
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.models import build
        from repro_torch.train import init_train_state
        from repro_torch.train.optimizer import tree_leaves, tree_map
        cfg = smoke_config("deepseek-moe-16b").with_(compute_dtype="float32")
        mesh = make_local_mesh(model=2, device="cpu")
        p, _o, _e = init_train_state(build(cfg), seed=4, device="cpu",
                                     mesh=mesh)
        save({"full": tree_map(lambda t: t.full_tensor(), p),
              "local": sum(t.to_local().numel() for t in tree_leaves(p)),
              "total": sum(t.numel() for t in tree_leaves(p))})
    """, tmp_path)
    bundle = build(cfg)
    want, _o, _e = init_train_state(bundle, seed=4, device="cpu")
    for g in got:
        for (n, a), (_n, b) in zip(flat(g["full"]), flat(want), strict=True):
            assert torch.equal(a, b), n
        # the leaves too small to cut stay whole: within 1 % of a quarter
        assert g["local"] <= 1.01 * g["total"] / 4
