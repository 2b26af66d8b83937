"""The port's recurrent-family models (rwkv6-7b's RWKV-6 stack, zamba2-2.7b's
Mamba-2 hybrid with shared attention) against the JAX package's, on the
CPU.

Weights come from ``repro.models.build(cfg).init(PRNGKey(k))`` and are
carried into the port with ``repro_torch.models.weights.from_jax_params``;
tokens come from numpy with a seed.  Both run the smoke configs (4 layers,
d_model 128; rwkv6: 8 heads of 16, zamba2: 16 Mamba-2 heads of 16 with a
16-wide state and a shared attention block after every 2 layers).  Prompt
lengths are no multiple of the smoke chunk (16).

Tolerances: fp32 compute within 1e-4 absolute and relative on logits and
every cache leaf (XLA's and PyTorch's CPU products sum in different
orders).  bf16 compute, for one block of each kind and for the whole
model: the port's bf16 result lies no farther from the reference's fp32
result than the reference's own bf16 result does, plus 3e-2 of the
largest value (the block's largest update, the largest logit).  The two
frameworks round to bf16 at different places, and where the gated norms
divide by small rows that rounding is amplified: at these random weights
the reference's bf16 logits lie 15 % (zamba2) and 6 % (rwkv6) of the
largest logit from its fp32 logits, the port's 5 %; one Mamba-2 block
input of the smoke tests (seed 6) moves both frameworks' bf16 outputs 40 %
of the block's update away from fp32.  A fixed bound between the two bf16
runs would measure that amplification, not the port.  Greedy tokens
(fp32) are exactly equal.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.launch.serve import generate as j_generate
from repro.models import backbone as JB
from repro.models import build as j_build
from repro.models import mamba2 as JM2
from repro.models import rwkv6 as JR6

from repro_torch.configs import get_arch, smoke_config
from repro_torch.launch.serve import generate
from repro_torch.models import backbone as TB
from repro_torch.models import build
from repro_torch.models import mamba2 as TM2
from repro_torch.models import rwkv6 as TR6
from repro_torch.models.weights import from_jax_params

# six test workers share the cores: one thread each, not one per core
torch.set_num_threads(max(1, os.cpu_count() // 6))

RECURRENT = ["rwkv6-7b", "zamba2-2.7b"]
FP32_TOL = 1e-4
BF16_REL = 3e-2
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _pair(name, compute_dtype="float32", key=0):
    """(JAX bundle, JAX params, port bundle, port params) on one set of
    weights."""
    jb = j_build(j_smoke_config(name).with_(compute_dtype=compute_dtype))
    jp = jb.init(jax.random.PRNGKey(key))
    tb = build(smoke_config(name).with_(compute_dtype=compute_dtype))
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tb.cfg, CPU)
    return jb, jp, tb, tp


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=FP32_TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _close_tree(got, want):
    """Every leaf of the reference's cache tree equals the port's."""
    leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert leaves
    for path, leaf in leaves:
        node = got
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, jax.tree_util.keystr(path)
        assert node.dtype == getattr(torch, str(leaf.dtype))
        _close(node, leaf)


# ---------------------------------------------------------------------------
# forward / prefill / decode


@pytest.mark.parametrize("name", RECURRENT)
def test_forward_prefill_decode_match_reference(name):
    jb, jp, tb, tp = _pair(name)
    toks = _tokens(tb.cfg, 2, 17, 3)
    t_toks, j_toks = torch.from_numpy(toks), jnp.asarray(toks)

    full_t, aux = tb.forward(tp, t_toks)
    full_j, _ = jax.jit(jb.forward)(jp, j_toks)
    assert full_t.shape == (2, 17, tb.cfg.vocab_size) and float(aux) == 0.0
    _close(full_t, full_j)

    # a 13-token prompt: no multiple of the smoke chunk (16)
    last_t, cache_t = tb.prefill(tp, t_toks[:, :13], max_len=20)
    last_j, cache_j = jax.jit(lambda p, t: jb.prefill(p, t, max_len=20))(
        jp, j_toks[:, :13])
    _close(last_t, last_j)
    _close_tree(cache_t, cache_j)

    for t in range(13, 17):
        pos_t = torch.full((2,), t, dtype=torch.int32)
        dec_t, cache_t2 = tb.decode_step(tp, t_toks[:, t:t + 1], cache_t, pos_t)
        assert cache_t2 is cache_t  # updated in place
        dec_j, cache_j = jax.jit(jb.decode_step)(
            jp, j_toks[:, t:t + 1], cache_j, jnp.full((2,), t, jnp.int32))
        _close(dec_t, dec_j)
        _close_tree(cache_t, cache_j)
        # the port's own cache path reproduces teacher forcing
        _close(dec_t[:, 0], full_t[:, t])


@pytest.mark.parametrize("name", RECURRENT)
def test_greedy_generation_matches_reference(name):
    jb, jp, tb, tp = _pair(name, key=5)
    prompts = _tokens(tb.cfg, 3, 11, 4)
    got, logits = generate(tb, tp, torch.from_numpy(prompts), 8,
                           keep_logits=True)
    want = j_generate(jb, jp, jnp.asarray(prompts), 8)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_np(logits).argmax(-1), got)


def test_zamba2_short_prompt_pads_the_conv_state():
    """A prompt shorter than the conv's k - 1 = 3 rows takes the padded
    branch of the conv state; decode continues from it."""
    jb, jp, tb, tp = _pair("zamba2-2.7b")
    toks = _tokens(tb.cfg, 2, 5, 11)
    last_t, cache_t = tb.prefill(tp, torch.from_numpy(toks[:, :2]), max_len=5)
    last_j, cache_j = jb.prefill(jp, jnp.asarray(toks[:, :2]), max_len=5)
    _close(last_t, last_j)
    _close_tree(cache_t, cache_j)
    assert not cache_t["layers"]["conv"][:, :, 0].any()
    for t in range(2, 5):
        lt, _ = tb.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]), cache_t,
                               torch.full((2,), t, dtype=torch.int32))
        lj, cache_j = jb.decode_step(jp, jnp.asarray(toks[:, t:t + 1]),
                                     cache_j, jnp.full((2,), t, jnp.int32))
        _close(lt, lj)


def test_zamba2_long_context_windows_the_shared_blocks():
    """Above 65,536 cache positions the shared blocks keep a 4,096-slot
    ring, as in the reference (its documented long-context cut)."""
    jb, jp, tb, tp = _pair("zamba2-2.7b")
    toks = _tokens(tb.cfg, 1, 9, 12)
    last_t, cache_t = tb.prefill(tp, torch.from_numpy(toks[:, :7]),
                                 max_len=70_000)
    last_j, cache_j = jb.prefill(jp, jnp.asarray(toks[:, :7]), max_len=70_000)
    assert cache_t["shared"]["k"].shape == (2, 1, 4, 4096, 32)
    _close(last_t, last_j)
    _close_tree(cache_t, cache_j)
    for t in (7, 8):
        lt, _ = tb.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]), cache_t,
                               torch.full((1,), t, dtype=torch.int32))
        lj, cache_j = jb.decode_step(jp, jnp.asarray(toks[:, t:t + 1]),
                                     cache_j, jnp.full((1,), t, jnp.int32))
        _close(lt, lj)
    assert TB._zamba_shared_window(65_536) is None


# ---------------------------------------------------------------------------
# bf16


def _blocks():
    """name -> (port block, reference block, port params, reference
    params) of one block of each kind: layer 0, or zamba2's shared block."""
    pos = np.tile(np.arange(11, dtype=np.int32), (2, 1))

    def layer0(tp, jp):
        return (TB._layer_slice(tp["layers"], 0),
                jax.tree_util.tree_map(lambda a: a[0], jp["layers"]))

    return {
        "rwkv6": ("rwkv6-7b", lambda p, x, c: TR6.rwkv6_block_apply(p, x, c)[0],
                  JR6.rwkv6_block_apply, layer0),
        "mamba2": ("zamba2-2.7b",
                   lambda p, x, c: TM2.mamba2_block_apply(p, x, c)[0],
                   JM2.mamba2_block_apply, layer0),
        "shared": ("zamba2-2.7b",
                   lambda p, x, c: TB.block_apply(
                       p, x, TB._shared_attn_cfg(c), torch.from_numpy(pos)),
                   lambda p, x, c: JB._shared_attn_apply(
                       p, x, c, jnp.asarray(pos)),
                   lambda tp, jp: (tp["shared_attn"], jp["shared_attn"])),
    }


def _no_farther(got16, ref16, want32, scale):
    """The port's bf16 result lies no farther from the fp32 result than
    the reference's bf16 result does, plus 3e-2 of ``scale``."""
    ref_err = np.abs(_np(ref16) - want32).max()
    np.testing.assert_allclose(_np(got16), want32,
                               atol=ref_err + BF16_REL * scale, rtol=0)


@pytest.mark.parametrize("which", ["rwkv6", "mamba2", "shared"])
def test_bf16_block_stays_near_reference(which):
    name, t_fn, j_fn, params = _blocks()[which]
    jb, jp, _tb, _tp = _pair(name)
    jb16, _jp, tb16, tp16 = _pair(name, compute_dtype="bfloat16")
    t_p, j_p = params(tp16, jp)
    x = np.random.default_rng(len(which)).standard_normal(
        (2, 11, jb.cfg.d_model)).astype(np.float32)
    x16 = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    want32 = _np(j_fn(j_p, jnp.asarray(x16), jb.cfg))
    ref16 = j_fn(j_p, jnp.asarray(x16, jnp.bfloat16), jb16.cfg)
    got16 = t_fn(t_p, torch.from_numpy(x16).bfloat16(), tb16.cfg)
    assert got16.dtype == torch.bfloat16
    _no_farther(got16, ref16, want32, np.abs(want32 - x16).max())


@pytest.mark.parametrize("name", RECURRENT)
def test_bf16_model_no_farther_from_fp32_than_reference(name):
    jb, jp, _tb, _tp = _pair(name)
    jb16, _jp, tb16, tp16 = _pair(name, compute_dtype="bfloat16")
    toks = _tokens(tb16.cfg, 2, 13, 8)
    want32 = _np(jax.jit(jb.forward)(jp, jnp.asarray(toks))[0])
    ref16 = _np(jax.jit(jb16.forward)(jp, jnp.asarray(toks))[0])
    got16, _ = tb16.forward(tp16, torch.from_numpy(toks))
    assert got16.dtype == torch.bfloat16
    _no_farther(got16, ref16, want32, np.abs(want32).max())


# ---------------------------------------------------------------------------
# parameters, weights


@pytest.mark.parametrize("name", RECURRENT)
def test_param_count_of_full_config_matches_reference(name):
    bundle = j_build(name)
    shapes = jax.eval_shape(lambda: bundle.init(jax.random.PRNGKey(0)))
    want = sum(int(x.size) for x in jax.tree_util.tree_leaves(shapes))
    assert get_arch(name).param_count() == want


@pytest.mark.parametrize("name", RECURRENT)
def test_full_config_parameter_tree_matches_reference(name):
    """Every name and shape of the full model, as ``from_jax_params``
    carries them (built on the meta device: no memory)."""
    bundle = j_build(name)
    shapes = jax.eval_shape(lambda: bundle.init(jax.random.PRNGKey(0)))
    meta = build(name).init(None, "meta")
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    for path, leaf in flat:
        node = meta
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, jax.tree_util.keystr(path)
    assert len(flat) == _n_leaves(meta)


def _n_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_leaves(v) for v in tree.values())
    return 1
