"""The port's attention-block models against the JAX package's, on the CPU.

Weights come from ``repro.models.build(cfg).init(PRNGKey(k))`` and are
carried into the port with ``repro_torch.models.weights.from_jax_params``;
tokens come from numpy with a seed.  Both run the smoke configs of
smollm-360m (GQA here MQA: 4 heads over 1 kv head) and gemma-2b (MQA,
GeGLU, tied embeddings, embedding scaling), and of the five families of
``NEW``: minicpm3-4b (MLA), deepseek-moe-16b and mixtral-8x22b (MoE with
capacity drops; mixtral's sliding window), chameleon-34b (qk-norm) and
musicgen-large (4 codebooks, plain gelu MLP).  A MoE model's one-token
decode routes with other capacity buckets than ``forward`` over the
whole sequence (as in the reference), so decode is held against teacher
forcing under a capacity factor that drops nothing, and its bf16 logits
(whose top-k picks bf16 noise flips) are held as the recurrent families'
are (``tests/test_torch_recurrent_models.py``): no farther from the
reference's fp32 logits than the reference's own bf16 ones, plus
``BF16_REL`` of the largest.  Tolerances otherwise: fp32 compute
within 1e-4 absolute and relative on logits and caches (XLA's and
PyTorch's CPU products sum in different orders over 4 layers); bf16
compute within 3e-2 of the largest logit's magnitude (bf16 keeps 8
mantissa bits, and the two frameworks round the products to bf16 at
different places in each of the 4 layers); greedy tokens exactly equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import smoke_config as j_smoke_config
from repro.launch.serve import generate as j_generate
from repro.models import build as j_build
from repro.models import layers as JL

from repro_torch.configs import ARCHS, get_arch, smoke_config
from repro_torch.launch.serve import generate
from repro_torch.models import build, layers as TL
from repro_torch.models.weights import from_jax_params, to_numpy_tree

DENSE = ["smollm-360m", "gemma-2b"]
NEW = ["minicpm3-4b", "deepseek-moe-16b", "mixtral-8x22b", "chameleon-34b",
       "musicgen-large"]
FP32_TOL = 1e-4
BF16_REL = 3e-2
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _pair(name, compute_dtype="float32", window=None, key=0, no_drop=False):
    """(JAX bundle, JAX params, port bundle, port params) on one set of
    weights; ``no_drop``: a MoE capacity factor at which no bucket fills."""
    over = dict(compute_dtype=compute_dtype, window=window)
    jcfg, tcfg = j_smoke_config(name), smoke_config(name)
    if no_drop:
        jcfg, tcfg = _no_drop(jcfg), _no_drop(tcfg)
    jb = j_build(jcfg.with_(**over))
    jp = jb.init(jax.random.PRNGKey(key))
    tb = build(tcfg.with_(**over))
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tb.cfg, CPU)
    return jb, jp, tb, tp


def _no_drop(cfg):
    """A MoE config whose capacity holds a whole group (``cf = E / k``):
    every (token, k) keeps its place.  Other configs as they are."""
    if cfg.moe is None:
        return cfg
    m = cfg.moe
    return cfg.with_(moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))


def _tokens(cfg, b, s, seed):
    shape = (b, s) if cfg.n_codebooks == 1 else (b, s, cfg.n_codebooks)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _vocab_shape(cfg):
    """The logits' trailing shape: (V,), or (Q, V) with codebooks."""
    v = cfg.vocab_size
    return (v,) if cfg.n_codebooks == 1 else (cfg.n_codebooks, v)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=FP32_TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# layers


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    gamma = rng.standard_normal(32).astype(np.float32)
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(gamma), 1e-5),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(gamma), 1e-5))
    x = rng.standard_normal((2, 3, 7, 32)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)[:, None],
                         10000.0),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos)[:, None], 10000.0))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_configs_match_reference(name):
    """The port's configs are the JAX package's, plus ``scale_embeddings``:
    on exactly where the reference's name test turns gemma's scaling on."""
    port = dataclasses.asdict(get_arch(name))
    assert port.pop("scale_embeddings") == name.startswith("gemma")
    assert port == dataclasses.asdict(j_get_arch(name))


def test_embedding_scaling_follows_the_config_not_the_name():
    _, _, tb, tp = _pair("gemma-2b")
    toks = torch.from_numpy(_tokens(tb.cfg, 2, 5, 3))
    want = TL.embed_tokens(tp["embedding"], toks, tb.cfg)
    _close(TL.embed_tokens(tp["embedding"], toks,
                           tb.cfg.with_(name="renamed")), want)
    _close(TL.embed_tokens(tp["embedding"], toks,
                           tb.cfg.with_(scale_embeddings=False)),
           want / np.sqrt(tb.cfg.d_model))


@pytest.mark.parametrize("name", DENSE + ["musicgen-large"])
def test_mlp_embed_and_logits_match_reference(name):
    jb, jp, tb, tp = _pair(name)
    cfg, jcfg = tb.cfg, jb.cfg
    toks = _tokens(cfg, 2, 9, 1)
    x_t = TL.embed_tokens(tp["embedding"], torch.from_numpy(toks), cfg)
    x_j = JL.embed_tokens(jp["embedding"], jnp.asarray(toks), jcfg)
    _close(x_t, x_j)
    if name == "gemma-2b":  # the embedding scaling is on
        _close(x_t, tp["embedding"]["embed"][toks] * np.sqrt(cfg.d_model))
    mlp_t = {k: v[0] for k, v in tp["layers"]["mlp"].items()}
    mlp_j = {k: v[0] for k, v in jp["layers"]["mlp"].items()}
    h = np.random.default_rng(2).standard_normal((2, 9, cfg.d_model)).astype(
        np.float32)
    _close(TL.mlp_apply(mlp_t, torch.from_numpy(h), cfg),
           JL.mlp_apply(mlp_j, jnp.asarray(h), jcfg))
    _close(TL.lm_logits(tp["embedding"], torch.from_numpy(h), cfg),
           JL.lm_logits(jp["embedding"], jnp.asarray(h), jcfg))
    assert ("lm_head" in tp["embedding"]) == (not cfg.tie_embeddings)


# ---------------------------------------------------------------------------
# forward / prefill / decode


def _teacher_forcing(name, window=None, n=17, seed=3):
    """(forward's last logits, the decode step's at the same position)
    on prompt ``n - 1`` then one token, under a capacity that drops
    nothing (see the module docstring)."""
    _, _, tb, tp = _pair(name, window=window, no_drop=True)
    toks = torch.from_numpy(_tokens(tb.cfg, 2, n, seed))
    full, _ = tb.forward(tp, toks)
    _, cache = tb.prefill(tp, toks[:, :n - 1], max_len=n + 7)
    dec, _ = tb.decode_step(tp, toks[:, n - 1:n], cache,
                            torch.full((2,), n - 1, dtype=torch.int32))
    return full[:, -1], dec[:, 0]


@pytest.mark.parametrize("name", DENSE + NEW)
def test_forward_prefill_decode_match_reference(name):
    jb, jp, tb, tp = _pair(name)
    toks = _tokens(tb.cfg, 2, 17, 3)
    t_toks, j_toks = torch.from_numpy(toks), jnp.asarray(toks)

    full_t, aux = tb.forward(tp, t_toks)
    full_j, aux_j = jax.jit(jb.forward)(jp, j_toks)
    assert full_t.shape == (2, 17) + _vocab_shape(tb.cfg)
    assert (float(aux) == 0.0) == (tb.cfg.moe is None)
    _close(full_t, full_j)
    _close(aux, aux_j)

    last_t, cache_t = tb.prefill(tp, t_toks[:, :16], max_len=24)
    last_j, cache_j = jax.jit(lambda p, t: jb.prefill(p, t, max_len=24))(
        jp, j_toks[:, :16])
    _close(last_t, last_j)
    assert set(cache_t["layers"]) == set(cache_j["layers"])
    for k in cache_j["layers"]:
        assert cache_t["layers"][k].shape == cache_j["layers"][k].shape
        _close(cache_t["layers"][k], cache_j["layers"][k])

    pos_t = torch.full((2,), 16, dtype=torch.int32)
    dec_t, cache_t = tb.decode_step(tp, t_toks[:, 16:17], cache_t, pos_t)
    dec_j, cache_j = jax.jit(jb.decode_step)(
        jp, j_toks[:, 16:17], cache_j, jnp.full((2,), 16, jnp.int32))
    _close(dec_t, dec_j)
    for k in cache_j["layers"]:
        _close(cache_t["layers"][k], cache_j["layers"][k])
    # the port's own cache path reproduces teacher forcing
    if tb.cfg.moe is None:
        _close(dec_t[:, 0], full_t[:, -1])
    else:
        _close(*_teacher_forcing(name))


@pytest.mark.parametrize("name", DENSE + NEW)
def test_greedy_generation_matches_reference(name):
    jb, jp, tb, tp = _pair(name, key=5)
    prompts = _tokens(tb.cfg, 3, 12, 4)
    got, logits = generate(tb, tp, torch.from_numpy(prompts), 8,
                           keep_logits=True)
    want = j_generate(jb, jp, jnp.asarray(prompts), 8)
    assert got.dtype == np.int32 and got.shape == (3, 8) + prompts.shape[2:]
    np.testing.assert_array_equal(got, want)
    # the kept logits are the ones that chose each token
    np.testing.assert_array_equal(_np(logits).argmax(-1), got)


@pytest.mark.parametrize("name", DENSE + ["mixtral-8x22b"])
def test_sliding_window_ring_cache_matches_reference(name):
    """A window shorter than the prompt takes the ring-buffer branches of
    prefill and decode (cache of 8 slots, 12-token prompt, 6 steps)."""
    jb, jp, tb, tp = _pair(name, window=8)
    toks = _tokens(tb.cfg, 2, 18, 6)
    last_t, cache_t = tb.prefill(tp, torch.from_numpy(toks[:, :12]), max_len=18)
    last_j, cache_j = jb.prefill(jp, jnp.asarray(toks[:, :12]), max_len=18)
    assert cache_t["layers"]["k"].shape[3] == 8
    _close(last_t, last_j)
    _close(cache_t["layers"]["v"], cache_j["layers"]["v"])
    for t in range(12, 18):
        tok = toks[:, t:t + 1]
        lt, cache_t = tb.decode_step(tp, torch.from_numpy(tok), cache_t,
                                     torch.full((2,), t, dtype=torch.int32))
        lj, cache_j = jb.decode_step(jp, jnp.asarray(tok), cache_j,
                                     jnp.full((2,), t, jnp.int32))
        _close(lt, lj)
    if tb.cfg.moe is None:
        full_t, _ = tb.forward(tp, torch.from_numpy(toks))
        _close(lt[:, 0], full_t[:, -1])
    else:
        _close(*_teacher_forcing(name, window=8, n=18, seed=6))


@pytest.mark.parametrize("name", DENSE + NEW)
def test_bf16_compute_stays_near_reference(name):
    jb, jp, tb, tp = _pair(name, compute_dtype="bfloat16")
    toks = _tokens(tb.cfg, 2, 16, 8)
    got, _ = tb.forward(tp, torch.from_numpy(toks))
    want, _ = jax.jit(jb.forward)(jp, jnp.asarray(toks))
    assert got.dtype == torch.bfloat16
    want = _np(want)
    if tb.cfg.moe is None:
        np.testing.assert_allclose(_np(got), want,
                                   atol=BF16_REL * np.abs(want).max(), rtol=0)
        return
    # MoE: bf16 noise flips top-k picks (and so the buckets' drops), a jump
    # that puts the reference's own bf16 logits 28-38 % of the largest
    # logit away from its fp32 ones: hold the port's bf16 no farther from
    # the fp32 logits than that, plus BF16_REL
    want32 = _np(jax.jit(_pair(name)[0].forward)(jp, jnp.asarray(toks))[0])
    ref_err = np.abs(want - want32).max()
    np.testing.assert_allclose(_np(got), want32, rtol=0,
                               atol=ref_err + BF16_REL * np.abs(want32).max())


# ---------------------------------------------------------------------------
# parameters, weights, families


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_count_of_full_config_matches_reference(name):
    bundle = j_build(name)
    shapes = jax.eval_shape(lambda: bundle.init(jax.random.PRNGKey(0)))
    want = sum(int(x.size) for x in jax.tree_util.tree_leaves(shapes))
    assert get_arch(name).param_count() == want


def test_weights_carry_round_trips_and_checks_shapes():
    jb, jp, tb, tp = _pair("smollm-360m")
    tree = jax.tree_util.tree_map(np.asarray, jp)
    back = to_numpy_tree(tp)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, leaf)
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["layers"]["attn"]["wq"] = bad["layers"]["attn"]["wq"][:, :, :-1]
    with pytest.raises(ValueError, match="wq"):
        from_jax_params(bad, tb.cfg, CPU)
    del bad["layers"]["norm1"]
    with pytest.raises(ValueError, match="keys"):
        from_jax_params(bad, tb.cfg, CPU)


#: why ``check_trainable`` refuses each new family, a word of its message
NOT_TRAINABLE = {"minicpm3-4b": "narrower than q/k",
                 "deepseek-moe-16b": "distributed",
                 "mixtral-8x22b": "distributed",
                 "chameleon-34b": "distributed",
                 "musicgen-large": "not ported yet"}


@pytest.mark.parametrize("name", NEW)
def test_new_families_serve_but_do_not_train_yet(name):
    from repro_torch.models.backbone import check_trainable

    build(name)  # served
    with pytest.raises(NotImplementedError, match=NOT_TRAINABLE[name]):
        check_trainable(get_arch(name))
    _, _, tb, tp = _pair(name)
    toks = torch.from_numpy(_tokens(tb.cfg, 1, 4, 0))
    with pytest.raises(NotImplementedError, match=NOT_TRAINABLE[name]):
        tb.loss(tp, {"tokens": toks, "labels": toks})


def test_bundle_init_is_seeded():
    tb = build(smoke_config("smollm-360m"))

    def draw(seed):
        g = torch.Generator(device="cpu")
        g.manual_seed(seed)
        return tb.init(g, "cpu")

    a, b, c = draw(1), draw(1), draw(2)
    assert torch.equal(a["layers"]["attn"]["wq"], b["layers"]["attn"]["wq"])
    assert not torch.equal(a["layers"]["attn"]["wq"], c["layers"]["attn"]["wq"])
    assert a["layers"]["mlp"]["w_up"].shape == (4, 128, 256)
