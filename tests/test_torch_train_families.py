"""The families whose training waited for ``distributed`` or for
backward kernels: MoE (deepseek-moe-16b, mixtral-8x22b), VLM
(chameleon-34b), audio (musicgen-large, four codebooks, logits (B, T, Q,
V)), MLA (minicpm3-4b), RWKV-6 (rwkv6-7b) and the Mamba-2 hybrid
(zamba2-2.7b) train through the port's step, held against
``repro.train.make_train_step`` on one CPU device.

Smoke configs in fp32 compute, the same random weights in both
(``repro_torch.models.weights``), the same three batches: each step's
loss, ``ce`` and ``aux`` (the MoE balance loss, 0 without MoE) within
1e-5, the final parameters within 2e-4 absolute (the bound of
``tests/test_torch_train.py``).  Adam's first steps move each weight by
about ``lr`` whatever its gradient's size, so where a weight's gradient
is within fp32 sum-order noise of 0 the two frameworks may move it either
way, as ``tests/test_torch_train.py`` finds for gemma-2b: a weight whose
reference gradient at a step (along the reference's own trajectory) is
not 0 but within ``NOISE_FLOOR`` of its tensor's largest may differ by 2
``lr`` more for each such step, and no more than ``NOISE_SHARE`` of a
tensor's weights may have such a step (``assert_params_close``).  A
gradient of exactly 0 (an expert no token picked, the embedding row of a
token the batch lacks) is no noise: such a weight keeps the 2e-4 bound.

``STEPWISE`` (minicpm3-4b, rwkv6-7b, zamba2-2.7b) is held a step at a
time instead, each of the three steps from the reference's state before
it (parameters and AdamW moments, ``reference_states``), under the same
bounds a step, and the port's moments after each step against the
reference's.  Their step-1 gradients match the reference's to 2e-6
(minicpm3-4b), 6e-6 (rwkv6-7b) and 4e-5 (zamba2-2.7b) of each tensor's
largest, with no sign that differs above ``NOISE_FLOOR``, but two
free-running trajectories part: a weight of noise that Adam moves by
``lr`` either way at step 1 moves the step-2 loss by 2.2e-5, 2.7e-5 and
6.0e-5, and the weights after it by up to 7.5e-3.  rwkv6-7b's
``ddlerp_b`` and ``mu_x`` have 9-13 % of a step's gradients under
``NOISE_FLOOR`` of their largest (the decay branch's gradients are
small by structure); ``CROWDED`` names them, and they get no allowance:
every weight of theirs keeps 2e-4.

The models' K5, K7 and K8 calls run their plain forwards and backwards
here (MLA's K5 at q/k 96, v 64).  The helpers serve
``tests/test_torch_distributed.py``'s meshed step too.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.mesh import make_local_mesh
from repro.models import build as j_build
from repro.train import make_train_step as j_make_train_step
from repro.train import optimizer as JO

from repro_torch.configs import smoke_config
from repro_torch.models import build
from repro_torch.models.weights import from_jax_params, to_numpy_tree
from repro_torch.train import init_train_state, make_optimizer, make_train_step

# six test workers share the cores: one thread each, not one per core
torch.set_num_threads(max(1, os.cpu_count() // 6))

CPU = torch.device("cpu")
TOL = 1e-5
#: final parameters: absolute, as ``tests/test_torch_train.py``
PARAM_TOL = 2e-4
LR = 3e-3
#: a gradient within this share of its tensor's largest is sum-order noise
#: (``tests/test_torch_train.py``'s floor)
NOISE_FLOOR = 1e-5
#: the largest share of a tensor's weights that may have a step of noise
#: (the most seen: 1.28 % of mixtral-8x22b's smoke ``experts/w_gate``,
#: whose experts few tokens pick; of all four families' weights with such
#: a step, 3 of chameleon-34b's ``lm_head`` lie beyond 2e-4, by up to
#: 1.2e-3)
NOISE_SHARE = 0.02
#: AdamW's moments after a step, as a share of each tensor's largest (the
#: most seen: 4.4e-5, zamba2-2.7b's ``v`` of ``final_norm``)
MOMENT_TOL = 1e-4


def flat(tree, path=""):
    """(path, leaf) in sorted key order, as ``jax.tree_util`` walks dicts."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k], f"{path}/{k}")]
    return [(path, tree)]


def configs(arch, **over):
    """(reference, port) smoke configs in fp32 compute."""
    from repro.configs import smoke_config as j_smoke_config

    over = dict(compute_dtype="float32", **over)
    return j_smoke_config(arch).with_(**over), smoke_config(arch).with_(**over)


def initial_params(cfg, seed):
    """Random weights as numpy, in the reference's tree (the port draws
    them: the reference's eager init of a smoke config takes seconds)."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    return to_numpy_tree(build(cfg).init(gen, CPU))


def family_batches(cfg, b, s, seed, n=3):
    """``n`` batches of next-token pairs: (B, S) ids, or (B, S, Q) for a
    model of Q codebooks."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        shape = (b, s + 1) + ((cfg.n_codebooks,) if cfg.n_codebooks > 1
                              else ())
        toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        out.append({"tokens": toks[:, :-1].copy(),
                    "labels": toks[:, 1:].copy()})
    return out


def optimizer():
    return make_optimizer(peak_lr=LR, warmup=1, total=20)


def reference_run(jcfg, params_np, batches):
    """-> (each step's metrics, the final parameters, {path: how many
    steps gave each weight a gradient that is not 0 but within
    ``NOISE_FLOOR`` of its tensor's largest})."""
    bundle = j_build(jcfg)
    opt = JO.make_optimizer(peak_lr=LR, warmup=1, total=20)
    grad = jax.jit(jax.grad(lambda p, b: bundle.loss(p, b)[0]))
    noise = {}
    jitted_for, _sh = j_make_train_step(bundle, make_local_mesh(),
                                        optimizer=opt)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    opt_state = opt.init(params)
    step = jitted_for(jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), batches[0]))
    metrics = []
    err = jnp.zeros(())
    for b in batches:
        jb = jax.tree_util.tree_map(jnp.asarray, b)
        for n, g in flat(jax.tree_util.tree_map(np.asarray, grad(params, jb))):
            tiny = (g != 0) & (np.abs(g) <= NOISE_FLOOR * np.abs(g).max())
            noise[n] = noise.get(n, 0) + tiny
        params, opt_state, err, m = step(params, opt_state, err, jb)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree_util.tree_map(np.asarray, params), noise


def port_run(cfg, params_np, batches, **step_kw):
    """The port's one-card step from ``params_np`` -> (metrics, numpy
    parameters)."""
    bundle = build(cfg)
    opt = optimizer()
    step = make_train_step(bundle, optimizer=opt, **step_kw)
    params = from_jax_params(params_np, cfg, CPU)
    _p, opt_state, err = init_train_state(bundle, device=CPU, optimizer=opt)
    metrics = []
    for b in batches:
        params, opt_state, err, m = step(params, opt_state, err, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, to_numpy_tree(params)


def reference_states(jcfg, params_np, batches):
    """The reference's run, step by step -> ([(parameters, AdamW step
    count, m, v) as numpy before each step and after the last], [each
    step's gradient as numpy], [each step's metrics])."""
    bundle = j_build(jcfg)
    opt = JO.make_optimizer(peak_lr=LR, warmup=1, total=20)
    grad = jax.jit(jax.grad(lambda p, b: bundle.loss(p, b)[0]))
    jitted_for, _sh = j_make_train_step(bundle, make_local_mesh(),
                                        optimizer=opt)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    opt_state = opt.init(params)
    step = jitted_for(jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), batches[0]))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)

    def state():
        return (as_np(params), int(opt_state.step), as_np(opt_state.m),
                as_np(opt_state.v))

    states, grads, metrics = [], [], []
    err = jnp.zeros(())
    for b in batches:
        states.append(state())
        jb = jax.tree_util.tree_map(jnp.asarray, b)
        grads.append(as_np(grad(params, jb)))
        params, opt_state, err, m = step(params, opt_state, err, jb)
        metrics.append({k: float(v) for k, v in m.items()})
    states.append(state())
    return states, grads, metrics


def port_step_from(cfg, state, batch):
    """One port step from a reference state -> (metrics, the parameters,
    m and v after it as numpy)."""
    from repro_torch.train.optimizer import AdamWState

    params_np, count, m_np, v_np = state
    bundle = build(cfg)
    opt = optimizer()
    params = from_jax_params(params_np, cfg, CPU)
    _p, _o, err = init_train_state(bundle, device=CPU, optimizer=opt)
    opt_state = AdamWState(torch.tensor(count, dtype=torch.int32),
                           from_jax_params(m_np, cfg, CPU),
                           from_jax_params(v_np, cfg, CPU))
    params, opt_state, _e, m = make_train_step(bundle, optimizer=opt)(
        params, opt_state, err, batch)
    return ({k: float(v) for k, v in m.items()}, to_numpy_tree(params),
            to_numpy_tree(opt_state.m), to_numpy_tree(opt_state.v))


def assert_metrics_close(got, want):
    for w, g in zip(want, got, strict=True):
        assert set(g) == set(w) == {"loss", "ce", "aux"}
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, atol=TOL,
                                       err_msg=k)


def assert_params_close(got, want, noise, crowded=()):
    """Each weight within ``PARAM_TOL`` plus 2 ``lr`` for each step of
    noise in its gradient (``noise``: ``reference_run``'s counts), and no
    more than ``NOISE_SHARE`` of a tensor's weights with such a step; a
    tensor named in ``crowded`` may have more, and then gets no allowance
    (``PARAM_TOL`` for every weight)."""
    for (n, a), (_n, w) in zip(flat(got), flat(want), strict=True):
        steps = noise[n]
        share = float(np.mean(steps > 0))
        if n in crowded:
            steps = np.zeros_like(steps)
        else:
            assert share <= NOISE_SHARE, f"{n}: {share:.4%} of the weights noisy"
        over = np.abs(a - w) - (PARAM_TOL + 2 * LR * steps)
        assert not (over > 0).any(), (
            f"{n}: {int((over > 0).sum())} weights beyond their bound, the "
            f"worst by {float(over.max()):.3e}")


def assert_moments_close(got, want):
    """AdamW's m or v after a step: each tensor within ``MOMENT_TOL`` of
    its largest."""
    for (n, a), (_n, w) in zip(flat(got), flat(want), strict=True):
        d = float(np.abs(a - w).max())
        top = float(np.abs(w).max())
        assert d <= MOMENT_TOL * top, f"{n}: off by {d:.3e}, its largest {top:.3e}"


FAMILIES = ("deepseek-moe-16b", "mixtral-8x22b", "chameleon-34b",
            "musicgen-large")
#: held a step at a time (module docstring)
STEPWISE = ("minicpm3-4b", "rwkv6-7b", "zamba2-2.7b")
#: tensors with more than ``NOISE_SHARE`` of noisy gradients at a step
#: (module docstring): 9.6-12.5 % of rwkv6-7b's smoke ``ddlerp_b``,
#: 8.9-9.9 % of its ``mu_x``
CROWDED = {"rwkv6-7b": ("/layers/ddlerp_b", "/layers/mu_x")}


@pytest.mark.parametrize("arch", FAMILIES)
def test_three_steps_match_the_reference(arch):
    jcfg, cfg = configs(arch)
    params_np = initial_params(cfg, 5)
    batches = family_batches(cfg, 4, 16, 30)
    jm, jp, noise = reference_run(jcfg, params_np, batches)
    tm, tp = port_run(cfg, params_np, batches)
    assert_metrics_close(tm, jm)
    if cfg.moe is not None:
        assert all(m["aux"] > 0 for m in tm)
    assert_params_close(tp, jp, noise)


@pytest.mark.parametrize("arch", STEPWISE)
def test_each_step_matches_the_reference_from_its_state(arch):
    jcfg, cfg = configs(arch)
    params_np = initial_params(cfg, 5)
    batches = family_batches(cfg, 4, 16, 30)
    states, grads, jm = reference_states(jcfg, params_np, batches)
    for k, b in enumerate(batches):
        tm, tp, m, v = port_step_from(cfg, states[k], b)
        assert_metrics_close([tm], [jm[k]])
        noise = {n: ((g != 0) & (np.abs(g) <= NOISE_FLOOR * np.abs(g).max())
                     ).astype(np.int64) for n, g in flat(grads[k])}
        jp, count, jmom, jvel = states[k + 1]
        assert count == k + 1
        assert_params_close(tp, jp, noise, CROWDED.get(arch, ()))
        assert_moments_close(m, jmom)
        assert_moments_close(v, jvel)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):  # AdamWState
        return type(tree)(*(_clone(v) for v in tree))
    return tree.clone()


@pytest.mark.parametrize("arch", FAMILIES + STEPWISE)
def test_the_step_updates_its_state_in_place(arch):
    """The step returns the tensors it was passed, updated in place, and
    a caller that clones the state first keeps the old one: a run from the
    clone gives the same values, bit for bit."""
    _j, cfg = configs(arch)
    bundle = build(cfg)
    batches = family_batches(cfg, 2, 8, 31, n=2)
    opt = optimizer()
    step = make_train_step(bundle, optimizer=opt)
    state = list(init_train_state(bundle, seed=2, device=CPU, optimizer=opt))
    kept = [_clone(t) for t in state]
    first = flat(state[0]) + flat(state[1].m) + flat(state[1].v)
    losses = []
    for b in batches:
        *state[:3], m = step(*state, b)
        losses.append(float(m["loss"]))
    now = flat(state[0]) + flat(state[1].m) + flat(state[1].v)
    assert all(a is b for (_n, a), (_m, b) in zip(first, now, strict=True))
    again = []
    for b in batches:
        *kept[:3], m = step(*kept, b)
        again.append(float(m["loss"]))
    assert again == losses
    for (n, a), (_n, b) in zip(now, flat(kept[0]) + flat(kept[1].m)
                               + flat(kept[1].v), strict=True):
        assert torch.equal(a, b), n
