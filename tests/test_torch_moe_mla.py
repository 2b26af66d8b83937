"""The port's MoE and MLA layers, ``layer_norm``, the registry's dry-run
pieces and the weight carry of the new families, against the JAX
package's, on the CPU.

MoE: ``moe_apply`` of the smoke configs of deepseek-moe-16b (8 experts,
top-2, one shared expert) and mixtral-8x22b (8 experts, top-2) on inputs
whose capacity buckets overflow (the drops are counted here from the
routing, independently of both), ``y`` and the balance loss.  MLA:
``mla_apply`` and a decode step against the latent cache, layer by layer.
Weights come from the reference's init; inputs from numpy with a seed.
Tolerance: fp32 within 1e-4 absolute and relative (the two sum in
different orders).  The dry-run pieces are compared at full size on the
``meta`` device (shapes and dtypes, no memory) for all ten archs.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.configs.base import SHAPES as J_SHAPES
from repro.models import attention as JA
from repro.models import build as j_build
from repro.models import layers as JL
from repro.models import moe as JM

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.configs.base import SHAPES
from repro_torch.models import attention as TA
from repro_torch.models import build, layers as TL, moe as TM
from repro_torch.models.weights import from_jax_params

# six test workers share the cores: one thread each, not one per core
torch.set_num_threads(max(1, os.cpu_count() // 6))

FP32_TOL = 1e-4
MOE = ["deepseek-moe-16b", "mixtral-8x22b"]
CPU = torch.device("cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=FP32_TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _fp32(make, name):
    """A smoke config in fp32 compute (they default to bf16)."""
    return make(name).with_(compute_dtype="float32")


def _torch_tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


# ---------------------------------------------------------------------------
# layers


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = (3 + 2 * rng.standard_normal((2, 5, 48))).astype(np.float32)
    gamma, beta = rng.standard_normal((2, 48)).astype(np.float32)
    _close(TL.layer_norm(torch.from_numpy(x), torch.from_numpy(gamma),
                         torch.from_numpy(beta), 1e-5),
           JL.layer_norm(jnp.asarray(x), jnp.asarray(gamma),
                         jnp.asarray(beta), 1e-5))
    got = TL.layer_norm(torch.from_numpy(x).bfloat16(),
                        torch.from_numpy(gamma), torch.from_numpy(beta), 1e-5)
    assert got.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# MoE


def _drops(params, x, cfg) -> int:
    """(token, k) places past their bucket, counted in numpy from the
    routing (fp32 compute): the cumulative count of each expert over the
    group's (t, k) order, t-major."""
    m = cfg.moe
    logits = x @ np.asarray(params["router"])
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top = np.argsort(-probs, axis=-1)[..., :m.top_k]             # (B, T, K)
    cap = JM._capacity(x.shape[1], cfg)
    dropped = 0
    for row in top:
        seen = np.zeros(m.n_experts, np.int64)
        for e in row.reshape(-1):
            dropped += seen[e] >= cap
            seen[e] += 1
    return int(dropped)


@pytest.mark.parametrize("name", MOE)
def test_moe_apply_matches_reference_with_drops(name):
    cfg = _fp32(j_smoke_config, name)
    params = JM.moe_init(jax.random.PRNGKey(3), cfg)
    # a direction every token shares skews the routing: some buckets fill
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 48, cfg.d_model))
         + 2 * rng.standard_normal(cfg.d_model)).astype(np.float32)
    tcfg = _fp32(smoke_config, name)
    assert TM._capacity(48, tcfg) == JM._capacity(48, cfg) == 16
    assert _drops(params, x, cfg) > 0  # the capacity really drops tokens
    y_t, aux_t = TM.moe_apply(_torch_tree(params), torch.from_numpy(x), tcfg)
    y_j, aux_j = JM.moe_apply(params, jnp.asarray(x), cfg)
    assert y_t.shape == x.shape and aux_t.dtype == torch.float32
    _close(y_t, y_j)
    _close(aux_t, aux_j)
    # without drops every routed place counts, and the output changes
    roomy = dataclasses.replace(cfg.moe, capacity_factor=4.0)
    y_all, _ = TM.moe_apply(_torch_tree(params), torch.from_numpy(x),
                            tcfg.with_(moe=roomy))
    assert _drops(params, x, cfg.with_(moe=roomy)) == 0
    _close(y_all, JM.moe_apply(params, jnp.asarray(x),
                               cfg.with_(moe=roomy))[0])
    assert not np.allclose(_np(y_all), _np(y_t), atol=1e-3)


@pytest.mark.parametrize("t,want", [(1, 4), (16, 8), (48, 16), (1000, 316)])
def test_moe_capacity_matches_reference(t, want):
    for name in MOE:
        assert TM._capacity(t, smoke_config(name)) == JM._capacity(
            t, j_smoke_config(name))
    full = ARCHS["deepseek-moe-16b"]
    assert TM._capacity(t, smoke_config("mixtral-8x22b")) == want
    assert TM._capacity(1000, full) == 120  # 64 experts, top-6


# ---------------------------------------------------------------------------
# MLA


def test_mla_apply_and_decode_match_reference():
    cfg = _fp32(j_smoke_config, "minicpm3-4b")
    tcfg = _fp32(smoke_config, "minicpm3-4b")
    params = JA.mla_init(jax.random.PRNGKey(1), cfg)
    tparams = _torch_tree(params)
    rng = np.random.default_rng(2)
    b, s = 2, 11
    x = rng.standard_normal((b, s + 1, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(s + 1, dtype=np.int32), (b, 1))
    full_t = TA.mla_apply(tparams, torch.from_numpy(x), tcfg,
                          torch.from_numpy(pos))
    full_j = JA.mla_apply(params, jnp.asarray(x), cfg, jnp.asarray(pos))
    _close(full_t, full_j)

    # the latent cache of the prompt, then one token at position s
    q_nope, q_rope, c, k_rope = TA._mla_qckr(
        tparams, torch.from_numpy(x[:, :s]), tcfg,
        torch.from_numpy(pos[:, :s]))
    jc = JA._mla_qckr(params, jnp.asarray(x[:, :s]), cfg,
                      jnp.asarray(pos[:, :s]))
    for a, w in zip((q_nope, q_rope, c, k_rope), jc):
        _close(a, w)
    cache = TA.mla_init_cache(tcfg, 1, b, s + 4, torch.float32, CPU)
    one = {k: v[0] for k, v in cache.items()}
    one["c"][:, :s], one["k_rope"][:, :s] = c, k_rope
    jcache = {"c": jnp.pad(jc[2], ((0, 0), (0, 4), (0, 0))),
              "k_rope": jnp.pad(jc[3], ((0, 0), (0, 4), (0, 0)))}
    pos_t = torch.full((b,), s, dtype=torch.int32)
    y_t, one = TA.mla_apply_decode(tparams, torch.from_numpy(x[:, s:]), tcfg,
                                   one, pos_t)
    y_j, jcache = JA.mla_apply_decode(params, jnp.asarray(x[:, s:]), cfg,
                                      jcache, jnp.full((b,), s, jnp.int32))
    _close(y_t, y_j)
    _close(one["c"], jcache["c"])
    _close(one["k_rope"], jcache["k_rope"])
    assert cache["c"].shape == (1, b, s + 4, cfg.mla.kv_rank)
    # the latent-space decode is the full form's last row
    _close(y_t[:, 0], full_t[:, -1])


# ---------------------------------------------------------------------------
# the registry's dry-run pieces, at full size on ``meta``


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def _j_flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"".join(f"/{k.key}" for k in path): (tuple(x.shape), str(x.dtype))
            for path, x in leaves}


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_shapes_match_reference(name):
    jb = j_build(name)
    want = _j_flat(jax.eval_shape(lambda: jb.init(jax.random.PRNGKey(0))))
    got = build(name).param_shapes()
    assert all(t.device.type == "meta" for t in
               jax.tree_util.tree_leaves(got))
    assert _flat(got) == want


@pytest.mark.parametrize("cell", [c.name for c in SHAPES])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_input_specs_match_reference(name, cell):
    jb, tb = j_build(name), build(name)
    jcell = next(c for c in J_SHAPES if c.name == cell)
    tcell = next(c for c in SHAPES if c.name == cell)
    assert dataclasses.asdict(jcell) == dataclasses.asdict(tcell)
    assert _flat(tb.input_specs(tcell)) == _j_flat(jb.input_specs(jcell))
    assert tb.runnable(tcell) == jb.runnable(jcell)


# ---------------------------------------------------------------------------
# the weight carry of the new families


@pytest.mark.parametrize("name,leaf", [
    ("deepseek-moe-16b", ("layers", "moe", "experts", "w_gate")),
    ("mixtral-8x22b", ("layers", "moe", "router")),
    ("minicpm3-4b", ("layers", "attn", "w_uk")),
    ("musicgen-large", ("embedding", "lm_head")),
    ("chameleon-34b", ("layers", "attn", "q_norm")),
])
def test_weights_carry_new_families_and_check_shapes(name, leaf):
    cfg = j_smoke_config(name)
    tree = jax.tree_util.tree_map(
        np.asarray, j_build(cfg).init(jax.random.PRNGKey(7)))
    got = from_jax_params(tree, smoke_config(name), CPU)
    assert _flat(got) == {k: (s, "float32") for k, (s, _d) in
                          _j_flat(tree).items()}
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), x)
    node = tree
    for k in leaf[:-1]:
        node = node[k]
    node[leaf[-1]] = node[leaf[-1]][..., :-1]
    with pytest.raises(ValueError, match=leaf[-1]):
        from_jax_params(tree, smoke_config(name), CPU)
