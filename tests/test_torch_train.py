"""The port's training pieces against the JAX package's, on the CPU.

* K5's LSE and backward: ``ref.flash_attention_lse_ref`` (the rows'
  log-sum-exp K5's forward hands to its backward) against
  ``jax.scipy.special.logsumexp`` of the oracle's masked, scaled scores,
  ``-inf`` for a row that sees no key; ``ref.flash_attention_bwd_ref`` (the
  gradients written out, P from that LSE) against ``jax.vjp`` of
  ``repro.kernels.ref.flash_attention_ref`` in fp32, within 1e-5
  (absolute and relative: the same sums in another order); the autograd
  Function around K5 against autograd through the plain forward (1e-5),
  and the LSE it saves only under a recorded graph;
* a model's gradients: ``loss.backward()`` through ``forward`` reaches
  K5's Function and gives every parameter the gradient of the plain
  attention (1e-5 relative to the largest gradient of each tensor);
* AdamW, the cosine schedule and int8 compression against the
  reference's on identical numpy inputs (1e-6 relative for the update:
  ``pow`` and ``sqrt`` may round differently; the schedule within 1e-7
  of peak; compression bit for bit);
* three train steps of the smollm-360m smoke config, and of the gemma-2b
  smoke config at gemma's head dim 256 (GeGLU, tied and scaled embeddings,
  MQA), in fp32 compute from carried weights on the same batches against
  ``repro.train``'s step
  (losses within 1e-5, final parameters within 2e-4 absolute: Adam's
  first steps move each weight by about ``lr`` whatever the gradient's
  size, so sum-order noise in a tiny gradient can flip a weight's move;
  with int8 compression an element on a quantizer rounding edge may move
  by up to ``lr`` a step: within 3 ``lr``, and at most 0.1 % of the
  elements beyond 2e-4; gemma-2b: a weight whose first gradient is within
  fp32 sum-order noise of 0 within 2 ``lr`` a step, and under compression
  the 3 ``lr`` bound alone, see ``EDGE_SHARE``);
* microbatch accumulation against the plain step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import jax.scipy.special as jsp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.kernels import ref as jref
from repro.launch.mesh import make_local_mesh
from repro.models import build as j_build
from repro.train import grad_compress as JG
from repro.train import optimizer as JO
from repro.train import make_train_step as j_make_train_step

from repro_torch.configs import smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import build
from repro_torch.models import attention as TA
from repro_torch.models.weights import from_jax_params, to_numpy_tree
from repro_torch.train import (
    compress_grads, cosine_schedule, init_train_state, loss_and_grads,
    make_optimizer, make_train_step,
)
from repro_torch.train import optimizer as TO

CPU = torch.device("cpu")
TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# K5's backward

BWD_CASES = [
    # b, h, g, sq, sk, d, causal, window
    (2, 6, 2, 37, 37, 16, True, None),      # GQA 3:1, causal
    (1, 4, 1, 20, 20, 32, True, None),      # MQA
    (1, 6, 2, 50, 50, 16, True, 7),         # window
    (2, 4, 2, 13, 40, 16, True, None),      # ragged Sq < Sk
    (1, 4, 2, 13, 40, 16, True, 9),         # ragged Sq with a window
    (1, 4, 4, 24, 31, 8, False, None),      # non-causal, MHA
    (1, 8, 1, 40, 40, 256, True, None),     # gemma-2b's MQA 8:1, D=256
    (1, 8, 1, 30, 70, 256, True, 25),       # D=256, window, ragged Sq
]


def _bwd_inputs(case, seed):
    b, h, g, sq, sk, d = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((b, h, sq, d), (b, g, sk, d), (b, g, sk, d), (b, h, sq, d))]


#: cases with rows that see no key: Sq > Sk under the causal mask (rows
#: before the first key), and a window
EMPTY_ROW_CASES = [
    (1, 4, 2, 12, 8, 16, True, None),
    (2, 2, 1, 20, 9, 8, True, 3),
]


def _jax_scores(q, k, causal, window):
    """The oracle's masked, scaled scores (``-inf`` where masked), as
    ``repro.kernels.ref.flash_attention_ref`` forms them."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    kk = jnp.repeat(jnp.asarray(k), h // k.shape[1], axis=1)
    logits = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q) / np.sqrt(d), kk)
    q_pos = jnp.arange(sq)[:, None] + (sk - sq)
    k_pos = jnp.arange(sk)[None, :]
    mask = jnp.ones((sq, sk), dtype=bool)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return jnp.where(mask, logits, -jnp.inf)


@pytest.mark.parametrize("case", BWD_CASES + EMPTY_ROW_CASES)
def test_lse_ref_matches_jax_logsumexp(case):
    causal, window = case[6], case[7]
    q, k, _v, _do = _bwd_inputs(case, 3 + sum(case[:6]))
    want = np.asarray(jsp.logsumexp(_jax_scores(q, k, causal, window),
                                    axis=-1))
    got = ref.flash_attention_lse_ref(_t(q), _t(k), causal=causal,
                                      window=window).numpy()
    assert got.dtype == np.float32 and got.shape == q.shape[:3]
    empty = np.isneginf(want)
    assert empty.any() == (case in EMPTY_ROW_CASES)
    np.testing.assert_array_equal(np.isneginf(got), empty)
    np.testing.assert_allclose(got[~empty], want[~empty], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", BWD_CASES)
def test_bwd_ref_matches_jax_vjp_of_the_oracle(case):
    causal, window = case[6], case[7]
    q, k, v, do = _bwd_inputs(case, sum(case[:6]))
    out, vjp = jax.vjp(lambda a, b_, c: jref.flash_attention_ref(
        a, b_, c, causal=causal, window=window), q, k, v)
    want = vjp(jnp.asarray(do))
    lse = ref.flash_attention_lse_ref(_t(q), _t(k), causal=causal,
                                      window=window)
    got = ref.flash_attention_bwd_ref(_t(q), _t(k), _t(v), _t(np.asarray(out)),
                                      lse, _t(do), causal=causal,
                                      window=window)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL, err_msg=name)


@pytest.mark.parametrize("case", BWD_CASES)
def test_autograd_function_matches_autograd_through_the_plain_forward(case):
    causal, window = case[6], case[7]
    arrays = _bwd_inputs(case, 7 + sum(case[:6]))
    do = _t(arrays[3])

    def grads(fn):
        q, k, v = (_t(a).requires_grad_(True) for a in arrays[:3])
        y = fn(q, k, v, causal=causal, window=window)
        y.backward(do)
        return y, (q.grad, k.grad, v.grad)

    before = ops.launch_counts()["flash_attention_bwd"]
    y1, g1 = grads(flash_attention)
    assert type(y1.grad_fn).__name__ == "FlashAttentionBackward"
    assert ops.launch_counts()["flash_attention_bwd"] == before  # CPU: plain
    _y2, g2 = grads(ref.flash_attention_ref)
    for a, w in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=TOL, rtol=TOL)


def test_no_grad_call_skips_the_function():
    q, k, v = (torch.randn(1, 2, 5, 8, requires_grad=True) for _ in range(3))
    with torch.no_grad():
        y = flash_attention(q, k, v)
    assert y.grad_fn is None


def test_function_saves_the_lse_only_under_a_recorded_graph(monkeypatch):
    """K5's forward forms the rows' LSE (on the CPU: the plain
    ``flash_attention_lse_ref``) and saves it with q, k, v and the output
    when a graph is recorded; under ``no_grad``, or when no input requires
    grad, it forms none (the serve path's prefill)."""
    calls = []
    plain = ref.flash_attention_lse_ref
    monkeypatch.setattr(ref, "flash_attention_lse_ref",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    q, k, v = (torch.from_numpy(a) for a in _bwd_inputs(BWD_CASES[0], 5)[:3])
    with torch.no_grad():
        flash_attention(q.requires_grad_(), k, v)
    q.requires_grad_(False)
    assert flash_attention(q, k, v).grad_fn is None
    assert calls == []
    y = flash_attention(q, k.requires_grad_(), v, window=9)
    assert calls == [1]
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 5
    for a, w in zip(saved, (q, k, v, y)):
        assert torch.equal(a, w)
    torch.testing.assert_close(saved[4], plain(q, k, window=9), rtol=0, atol=0)


def test_bwd_refuses_a_missing_or_misshapen_lse():
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(BWD_CASES[0], 6))
    lse = ref.flash_attention_lse_ref(q, k)
    for bad in (None, lse[:, :, :-1], lse.double(), lse[..., None]):
        with pytest.raises(ValueError, match="lse"):
            FA.flash_attention_bwd(q, k, v, q, bad, do)


def test_refuse_grad_raises_only_when_a_gradient_is_asked_for():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        ops.refuse_grad("rwkv6_scan", torch.ones(3), x)
    ops.refuse_grad("rwkv6_scan", torch.ones(3))
    with torch.no_grad():
        ops.refuse_grad("rwkv6_scan", x)


# ---------------------------------------------------------------------------
# model gradients


def _cfg(name="smollm-360m", **over):
    return smoke_config(name).with_(compute_dtype="float32", **over)


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}


def _flat(tree, path=""):
    """(path, leaf) in sorted key order, as ``jax.tree_util`` walks dicts."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], f"{path}/{k}")]
    return [(path, tree)]


@pytest.mark.parametrize("remat", [False, True])
def test_model_gradients_go_through_k5s_function(monkeypatch, remat):
    """``loss.backward()`` through ``forward`` reaches K5's Function (the
    route that launches the backward kernel on a card) and gives every
    parameter the gradient that the plain attention gives."""
    bundle = build(_cfg(remat=remat))
    gen = torch.Generator().manual_seed(0)
    params = bundle.init(gen, CPU)
    batch = {k: _t(v) for k, v in _batch(bundle.cfg, 2, 24, 1).items()}
    seen = []
    real = TA.flash_attention

    def spy(*a, **kw):
        y = real(*a, **kw)
        seen.append(type(y.grad_fn).__name__)
        return y

    monkeypatch.setattr(TA, "flash_attention", spy)
    leaves = TO.tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, _m = bundle.loss(leaves, batch)
    loss.backward()
    assert seen and all(n == "FlashAttentionBackward" for n in seen)

    monkeypatch.setattr(TA, "flash_attention", ref.flash_attention_ref)
    plain = TO.tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss2, _m = bundle.loss(plain, batch)
    loss2.backward()
    assert float(abs(loss - loss2).detach()) <= TOL
    for (path, t), (_p, w) in zip(_flat(leaves), _flat(plain)):
        assert t.grad is not None, path
        scale = max(float(w.grad.abs().max()), 1e-30)
        assert float((t.grad - w.grad).abs().max()) <= TOL * scale, path


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-2.7b"])
def test_training_the_recurrent_families_is_refused(arch):
    bundle = build(smoke_config(arch))
    with pytest.raises(NotImplementedError, match="backward"):
        make_train_step(bundle)
    with pytest.raises(NotImplementedError, match="backward"):
        init_train_state(bundle, device=CPU)


def test_cross_entropy_matches_the_reference():
    from repro.models.layers import cross_entropy_loss as j_ce
    from repro_torch.models.layers import cross_entropy_loss as t_ce

    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :3] = -100
    np.testing.assert_allclose(float(t_ce(_t(logits), _t(labels))),
                               float(j_ce(jnp.asarray(logits),
                                          jnp.asarray(labels))),
                               rtol=1e-6)


def test_train_state_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(build(_cfg()))


# ---------------------------------------------------------------------------
# optimizer and compression


def _param_tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "sub": {"b": rng.standard_normal(5).astype(np.float32),
                    "m": rng.standard_normal((2, 3, 4)).astype(np.float32)}}


def _to_torch(tree):
    return TO.tree_map(lambda x: _t(x), tree)


@pytest.mark.parametrize("clip", [1.0, None, 1e3])
def test_adamw_update_matches_the_reference(clip):
    rng = np.random.default_rng(11)
    params = _param_tree(rng)
    jopt = JO.make_optimizer(peak_lr=1e-2, warmup=2, total=10, clip_norm=clip)
    topt = make_optimizer(peak_lr=1e-2, warmup=2, total=10, clip_norm=clip)
    jp, js = params, jopt.init(params)
    tp, ts = _to_torch(params), topt.init(_to_torch(params))
    for step in range(4):
        grads = TO.tree_map(lambda x: (rng.standard_normal(x.shape) * 3)
                            .astype(np.float32), params)
        jp, js = jopt.update(grads, js, jp)
        tp, ts = topt.update(_to_torch(grads), ts, tp)
        assert int(ts.step) == int(js.step) == step + 1
        for name, a, w in ((n, a, w) for (n, a), (_n, w) in zip(
                _flat(tp), _flat(jax.tree_util.tree_map(np.asarray, jp)))):
            np.testing.assert_allclose(a.numpy(), w, rtol=1e-6, atol=1e-7,
                                       err_msg=f"{name} step {step}")
        for (_n, a), (_m, w) in zip(_flat(ts.v), _flat(jax.tree_util.tree_map(
                np.asarray, js.v))):
            np.testing.assert_allclose(a.numpy(), w, rtol=1e-6, atol=1e-12)


def test_global_norm_matches_the_reference():
    rng = np.random.default_rng(2)
    tree = _param_tree(rng)
    np.testing.assert_allclose(float(TO.global_norm(_to_torch(tree))),
                               float(JO.global_norm(tree)), rtol=1e-6)


@pytest.mark.parametrize("warmup,total", [(1, 20), (5, 12), (0, 4)])
def test_cosine_schedule_matches_the_reference(warmup, total):
    jf = JO.cosine_schedule(3e-4, warmup, total)
    tf = cosine_schedule(3e-4, warmup, total)
    for s in range(total + 3):
        got = float(tf(torch.tensor(s, dtype=torch.int32)))
        want = float(jf(jnp.asarray(s, jnp.int32)))
        assert abs(got - want) <= 1e-7 * 3e-4, (s, got, want)


def test_compress_grads_is_bit_identical_to_the_reference():
    rng = np.random.default_rng(5)
    grads = _param_tree(rng)
    grads["tiny"] = np.full((4,), 1e-20, np.float32)
    grads["zero"] = np.zeros((3,), np.float32)
    grads["half"] = (np.arange(-6, 7, dtype=np.float32) / 2) * (127 / 3)
    err = TO.tree_map(lambda x: (rng.standard_normal(x.shape) * 0.01)
                      .astype(np.float32), grads)
    for _ in range(3):
        jd, je = JG.compress_grads(grads, err)
        td, te = compress_grads(_to_torch(grads), _to_torch(err))
        for (n, a), (_n, w) in zip(_flat(td), _flat(jax.tree_util.tree_map(
                np.asarray, jd))):
            np.testing.assert_array_equal(a.numpy(), w, err_msg=n)
        for (n, a), (_n, w) in zip(_flat(te), _flat(jax.tree_util.tree_map(
                np.asarray, je))):
            np.testing.assert_array_equal(a.numpy(), w, err_msg=n)
        err = jax.tree_util.tree_map(np.asarray, je)


# ---------------------------------------------------------------------------
# the train step against the reference's


def _reference_run(cfg, params_np, batches, **kw):
    bundle = j_build(cfg)
    opt = JO.make_optimizer(peak_lr=3e-3, warmup=1, total=20)
    jitted_for, _sh = j_make_train_step(bundle, make_local_mesh(),
                                        optimizer=opt, **kw)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    opt_state = opt.init(params)
    err = (JG.init_error_state(params) if kw.get("grad_compression")
           else jnp.zeros(()))
    shapes = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), batches[0])
    step = jitted_for(shapes)
    losses = []
    for b in batches:
        params, opt_state, err, m = step(params, opt_state, err,
                                         jax.tree_util.tree_map(jnp.asarray, b))
        losses.append(float(m["loss"]))
    return losses, jax.tree_util.tree_map(np.asarray, params)


def _port_run(cfg, params_np, batches, **kw):
    bundle = build(cfg)
    opt = make_optimizer(peak_lr=3e-3, warmup=1, total=20)
    step = make_train_step(bundle, optimizer=opt, **kw)
    params = from_jax_params(params_np, cfg, CPU)
    _p, opt_state, err = init_train_state(
        bundle, device=CPU, optimizer=opt,
        grad_compression=kw.get("grad_compression", False))
    losses = []
    for b in batches:
        params, opt_state, err, m = step(params, opt_state, err, b)
        losses.append(float(m["loss"]))
        assert set(m) == {"loss", "ce", "aux"}
    return losses, to_numpy_tree(params)


#: the archs whose smoke configs train against the reference, with what
#: each changes in both packages' configs: gemma-2b at its own head dim
TRAIN_ARCHS = {"smollm-360m": {}, "gemma-2b": {"head_dim": 256}}
#: archs some of whose weights get a first gradient within fp32 sum-order
#: noise of 0 (gemma-2b's single kv head and tied embedding: |g| down to
#: 1e-9 where the tensor's largest is 6e-3, and the two frameworks' sums
#: differ by 1.4e-8): Adam's first steps move such a weight by about lr
#: whichever sign the noise gives it, so it is held to the 2 lr a step
#: that two runs can differ by, and the others to the test's bounds
NOISE_FLOOR_ARCHS = ("gemma-2b",)
#: a first gradient within this share of its tensor's largest is noise
NOISE_FLOOR = 1e-5
#: the share of a tensor's weights that may sit on a rounding edge of the
#: int8 quantizer under grad compression (see below), for the archs where
#: it is a bound: smollm-360m 0.1 %.  For gemma-2b it is not one: a weight
#: crosses an edge where sum-order noise of up to 1.4e-8 in its gradient
#: spans the rest of a quantum (6.2e-3 / 127 in the embedding), which
#: over 3 steps may reach 3 x 2 x 1.4e-8 / 4.9e-5 = 0.17 % of a tensor
#: and more where the quantum is smaller (0.10-0.30 % seen); its weights
#: are held to the 3 lr bound alone
EDGE_SHARE = {"smollm-360m": 1e-3}


def _gradient_noise(jcfg, params_np, batch):
    """{path: mask of the weights whose first gradient in the reference is
    within ``NOISE_FLOOR`` of its tensor's largest}, for the tensors that
    have any."""
    bundle = j_build(jcfg)
    grads = jax.grad(lambda p: bundle.loss(p, jax.tree_util.tree_map(
        jnp.asarray, batch))[0])(jax.tree_util.tree_map(jnp.asarray, params_np))
    out = {}
    for n, g in _flat(jax.tree_util.tree_map(np.asarray, grads)):
        tiny = np.abs(g) <= NOISE_FLOOR * np.abs(g).max()
        if tiny.any():
            out[n] = tiny
    return out


#: the step's variants; smollm-360m's cases keep their ids of before
#: the arch was a parameter
VARIANTS = [{"remat": True}, {"remat": False, "grad_compression": True}]


@pytest.mark.parametrize("arch,variant", [
    pytest.param(a, v, id=("" if a == "smollm-360m" else f"{a}-")
                 + f"variant{i}")
    for a in TRAIN_ARCHS for i, v in enumerate(VARIANTS)])
def test_three_steps_match_the_reference(arch, variant):
    variant = dict(variant)
    remat = variant.pop("remat")
    over = dict(TRAIN_ARCHS[arch], compute_dtype="float32", remat=remat)
    jcfg = j_smoke_config(arch).with_(**over)
    cfg = smoke_config(arch).with_(**over)
    params_np = jax.tree_util.tree_map(
        np.asarray, j_build(jcfg).init(jax.random.PRNGKey(3)))
    batches = [_batch(cfg, 4, 32, 100 + i) for i in range(3)]
    jl, jp = _reference_run(jcfg, params_np, batches, **variant)
    tl, tp = _port_run(cfg, params_np, batches, **variant)
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    noise = (_gradient_noise(jcfg, params_np, batches[0])
             if arch in NOISE_FLOOR_ARCHS else {})
    for (n, a), (_n, w) in zip(_flat(tp), _flat(jp)):
        if n in noise:
            # gradients within fp32 sum-order noise of 0: the two runs' Adam
            # steps may move such a weight either way, up to 2 lr a step
            tiny = noise[n]
            np.testing.assert_allclose(a[tiny], w[tiny], atol=3 * 2 * 3e-3,
                                       rtol=0, err_msg=n)
            a, w = a[~tiny], w[~tiny]
        if not variant.get("grad_compression"):
            np.testing.assert_allclose(a, w, atol=2e-4, rtol=0, err_msg=n)
            continue
        # an element on a rounding edge of the int8 quantizer may round the
        # other way (one quantum), which Adam turns into a move of up to
        # lr a step: all within 3 lr, at most EDGE_SHARE beyond 2e-4
        np.testing.assert_allclose(a, w, atol=3 * 3e-3, rtol=0, err_msg=n)
        if arch in EDGE_SHARE:
            assert np.mean(np.abs(a - w) > 2e-4) <= EDGE_SHARE[arch], n


def test_microbatches_match_the_plain_step():
    """Two microbatches of 2 against one batch of 4 (fp32 compute: only
    the order of the sums differs; Adam's first steps amplify a tiny
    gradient's noise, hence the absolute tolerance on weights)."""
    cfg = _cfg()
    params_np = jax.tree_util.tree_map(np.asarray, j_build(
        j_smoke_config("smollm-360m").with_(compute_dtype="float32")).init(
            jax.random.PRNGKey(4)))
    batches = [_batch(cfg, 4, 32, 200 + i) for i in range(3)]
    l1, p1 = _port_run(cfg, params_np, batches)
    l2, p2 = _port_run(cfg, params_np, batches, microbatches=2)
    np.testing.assert_allclose(l2, l1, rtol=1e-5, atol=1e-5)
    for (n, a), (_n, w) in zip(_flat(p2), _flat(p1)):
        np.testing.assert_allclose(a, w, atol=2e-4, rtol=0, err_msg=n)


def test_loss_and_grads_gives_every_parameter_a_gradient():
    cfg = _cfg()
    bundle = build(cfg)
    params, _o, _e = init_train_state(bundle, seed=1, device=CPU)
    loss, metrics, grads = loss_and_grads(
        bundle, params, {k: _t(v) for k, v in _batch(cfg, 2, 16, 9).items()})
    assert torch.isfinite(loss) and set(metrics) == {"ce", "aux"}
    for (n, p), (_n, g) in zip(_flat(params), _flat(grads)):
        assert g.shape == p.shape and bool(torch.isfinite(g).all()), n
        assert float(g.abs().max()) > 0, n
        assert p.grad is None and not p.requires_grad
