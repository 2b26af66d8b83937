"""Step builders: the train step (one card, or a mesh), and the prefill and
serve steps — the twins of ``repro.train.step``.

Without a mesh the train step is eager PyTorch on one card: the loss and
its gradients by autograd (K5's forward and backward kernels on a card,
their plain versions on the CPU), then optional int8 error-feedback
compression and the AdamW update, with microbatch accumulation as in the
reference's ``_accumulated_grads``.  Parameters, optimizer state and the
error state are passed in and updated in place, as the reference's step
donates its buffers (``AdamW.update``).

On a mesh (a ``DeviceMesh`` of ``launch.mesh``) the state is placed as
the reference's ``jit`` places it:

  * params + optimizer state (+ the error state): FSDP auto-sharding
    (largest dim over pod x data, second over model) — ZeRO-3 style,
    DTensors with ``auto_param_sharding``'s placements;
  * the batch: rows over the ``dp`` axes (``batch_sharding``); every rank
    is handed the global batch, as the reference's host is, and keeps its
    rows.

The model then computes data-parallel on gathered parameters, the
semantics of FSDP: each layer's parameters are all-gathered when the
layer runs (inside its remat region, so the backward gathers them again
and one layer is whole at a time; the embedding's for the whole step),
and their gradients come back summed over the ranks that hold other rows
and scattered to the parameters' placements (DTensor's redistribution
and its backward).  ``init_train_state`` draws one layer at a time and
keeps its shards.  The ``model`` axis shards state, not compute: its
ranks compute the same rows.  Kernels (K5 and its backward) launch on
plain local tensors.  Three reductions keep the result the reference's
global math, where a rank sees only its rows: the model returns its sums
over the rows (``bundle.loss_sums``) and the step sums cross-entropy's
token count and the balance loss's picks and token count over the ranks
(``collectives.sum_over``) before it forms the loss
(``bundle.loss_from_sums``); AdamW clips by the norm summed over every
rank's shards.  Gradient compression compresses the reduced gradient, as
the reference does where GSPMD reduces first.

The prefill and serve steps run ``bundle.prefill`` / ``bundle.decode_step``
on gathered parameters; their results come back with
``cache_sharding``'s placements (the reference's
``[stack, dp, tp_kv, sp_kv, ...]`` rule) and the logits replicated.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ShapeCell
from repro_torch.distributed.collectives import sum_over
from repro_torch.distributed.sharding import (
    AxisRules, NamedSharding, _axes, auto_param_sharding, place,
    tree_map_with_path,
)
from repro_torch.models.registry import ModelBundle, model_device

from .grad_compress import compress_grads, init_error_state
from .optimizer import AdamW, AdamWState, make_optimizer, tree_leaves, tree_map


def params_device(params) -> torch.device:
    return tree_leaves(params)[0].device


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A loader's batch (numpy arrays from the host engine, tensors from
    the device engine) as tensors on ``device``."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if
                isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# placements


def batch_sharding(mesh, shapes: Dict, rules: AxisRules) -> Dict:
    """tokens/labels (B, S[, Q]) -> batch sharded over dp."""
    return {k: NamedSharding(mesh, rules.spec(
        ["dp"] + [None] * (len(v.shape) - 1), v.shape))
        for k, v in shapes.items()}


def cache_sharding(mesh, cache_shapes, rules: AxisRules):
    """Generic cache rule: [stack, dp, tp_kv, sp_kv, None...].

    The AxisRules divisibility+dedup logic resolves this per tensor: kv
    heads shard over model when they divide it, otherwise the cache
    sequence dim takes the model axis (S-sharded decode), otherwise
    replicate — every assigned arch is placed with this one pattern.
    """
    def one(leaf):
        rank = len(leaf.shape)
        logical = [None, "dp", "tp_kv", "sp_kv"][:rank]
        logical += [None] * (rank - len(logical))
        return NamedSharding(mesh, rules.spec(logical, leaf.shape))
    return tree_map(one, cache_shapes)


def _local_rows(batch: Dict, mesh, rules: AxisRules):
    """-> (this rank's rows of each tensor of the global ``batch``, the
    mesh axes the rows are split over)."""
    sh = batch_sharding(mesh, batch, rules)
    local = {k: place(v, sh[k]).to_local() for k, v in batch.items()}
    return local, _axes(sh["tokens"].spec[0])


def _gatherer(mesh, row_axes) -> Callable:
    """-> ``view(tree)``: each parameter DTensor of ``tree`` all-gathered
    to a plain full tensor whose gradient comes back summed over the ranks
    of ``row_axes`` (the ranks that computed on other rows) and scattered
    to the parameter's placements."""
    from torch.distributed.tensor import Partial, Replicate

    names = list(mesh.mesh_dim_names)
    full = [Replicate()] * len(names)
    grad = [Partial() if a in row_axes and mesh.size(i) > 1 else Replicate()
            for i, a in enumerate(names)]

    def one(p):
        if list(p.placements) == full == grad:
            return p.to_local()  # nothing to gather, nothing to reduce
        return p.redistribute(mesh, full).to_local(grad_placements=grad)

    return lambda tree: tree_map(one, tree)


def _layers_whole_along_dim0(params, mesh):
    """Each stacked leaf sharded along its layer dim (a 2-D one, a layer's
    norm: the reference's rules skip that dim only from 3-D on)
    redistributed whole along it, so that the model can take its layers
    apart; its gradient goes back to the leaf's placements."""
    from torch.distributed.tensor import Replicate, Shard

    def one(path, p):
        cut = [isinstance(pl, Shard) and pl.dim == 0 for pl in p.placements]
        if path[0] != "layers" or not any(cut):
            return p
        return p.redistribute(mesh, [Replicate() if c else pl for c, pl in
                                     zip(cut, p.placements)])

    return tree_map_with_path(one, params)


# ---------------------------------------------------------------------------
# train


def loss_and_grads(bundle: ModelBundle, params: Dict, batch: Dict,
                   view: Optional[Callable] = None,
                   total: Optional[Callable] = None,
                   mesh=None) -> Tuple[torch.Tensor, Dict, Dict]:
    """-> (loss, metrics, grads): ``bundle.loss`` and its gradient in
    every parameter (``torch.autograd.grad`` raises when a parameter gets
    none).  ``params`` are not modified.  ``view`` and ``total`` are
    ``bundle.loss_sums``' and ``bundle.loss_from_sums``' (the meshed
    step's gather and its sums over the ranks); on a ``mesh`` the
    parameters are DTensors."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    model_params = (leaves if mesh is None
                    else _layers_whole_along_dim0(leaves, mesh))
    loss, metrics = bundle.loss_from_sums(
        bundle.loss_sums(model_params, batch, view), total)
    flat = tree_leaves(leaves)
    grads = iter(torch.autograd.grad(loss, flat))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _p: next(grads), leaves))


def _accumulated_grads(bundle: ModelBundle, params: Dict, batch: Dict,
                       n: int, local: Optional[Callable] = None,
                       view: Optional[Callable] = None,
                       total: Optional[Callable] = None, mesh=None):
    """Gradients averaged over ``n`` microbatches (the global batch split
    along its first axis, then ``local`` of each), accumulated in fp32;
    the loss averaged, the metrics of the last microbatch."""
    micro = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])
             for k, v in batch.items()}
    acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params)
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=params_device(params))
    for i in range(n):
        mb = {k: v[i] for k, v in micro.items()}
        loss, metrics, g = loss_and_grads(bundle, params,
                                          local(mb) if local else mb, view,
                                          total, mesh)
        acc = tree_map(torch.add, acc, g)
        loss_sum = loss_sum + loss
    return tree_map(lambda g: g / n, acc), loss_sum / n, metrics


def param_sharding(bundle: ModelBundle, mesh,
                   fsdp_axes: Optional[Tuple] = None):
    """The parameters' (and the moments') NamedSharding tree on ``mesh``."""
    return auto_param_sharding(bundle.param_shapes(), mesh,
                               fsdp_axes=fsdp_axes)


def make_train_step(bundle: ModelBundle, optimizer: Optional[AdamW] = None,
                    grad_compression: bool = False, microbatches: int = 1,
                    mesh=None, rules_mapping: Optional[Dict] = None
                    ) -> Callable:
    """-> ``step(params, opt_state, error_state, batch) -> (params,
    opt_state, error_state, metrics)``; ``batch`` holds ``tokens`` and
    ``labels`` (B, S[, Q]), as numpy arrays or tensors (on a mesh: the
    global batch, the same on every rank); ``metrics`` holds fp32 scalars
    on the device (``loss``, ``ce``, ``aux``, over the global batch):
    reading one syncs.  The step updates the passed state in place and
    returns it (``AdamW.update``).  ``mesh=None`` is the one-card step;
    on a mesh the state must be ``init_train_state(..., mesh=mesh)``'s
    (its placements are the parameters'; ``rules_mapping`` places the
    batch's rows)."""
    opt = optimizer or make_optimizer()
    rules = AxisRules(mesh, rules_mapping) if mesh is not None else None

    def step(params, opt_state, error_state, batch):
        batch = to_device(batch, params_device(params))
        local = view = total = None
        if mesh is not None:
            tok = batch["tokens"].shape
            mb = (tok[0] // microbatches,) + tuple(tok[1:])
            row_axes = _axes(rules.spec(["dp"] + [None] * (len(mb) - 1),
                                        mb)[0])

            def local(b):
                return _local_rows(b, mesh, rules)[0]

            view = _gatherer(mesh, row_axes)
            total = sum_over(mesh, row_axes)
        on_card = params_device(params).type == "cuda"
        with obs.span("train.forward_backward", card=on_card):
            if microbatches > 1:
                grads, loss, metrics = _accumulated_grads(
                    bundle, params, batch, microbatches, local, view, total,
                    mesh)
            else:
                loss, metrics, grads = loss_and_grads(
                    bundle, params, local(batch) if local else batch, view,
                    total, mesh)
        if total is not None:  # each rank's share -> the global batch's
            loss = total(loss)
            metrics = {k: total(v) for k, v in metrics.items()}
        if grad_compression:
            grads, error_state = compress_grads(grads, error_state)
        with obs.span("train.optimizer", card=on_card):
            if mesh is None:
                params, opt_state = opt.update(grads, opt_state, params)
            else:
                params, opt_state = _sharded_update(opt, grads, opt_state,
                                                    params, mesh)
        return params, opt_state, error_state, {
            "loss": loss.float(),
            **{k: v.float() for k, v in metrics.items()}}

    return step


def _sharded_update(opt: AdamW, grads, opt_state: AdamWState, params,
                    mesh):
    """AdamW on each rank's shards, in place: the update is elementwise,
    so it runs on the local tensors (no DTensor dispatch a leaf and op),
    which alias the DTensors' own; only the clip's global norm needs every
    rank, a sum of the local squares in which a leaf replicated over
    ``r`` ranks counts ``1 / r``, all-reduced over the mesh."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate

    def local(t):
        return t.to_local()

    def copies(p):
        return math.prod(mesh.size(i) for i, pl in enumerate(p.placements)
                         if isinstance(pl, Replicate))

    reps = tree_map(copies, params)

    def norm(gf):
        total = sum(torch.sum(torch.square(g.float())) / r if r > 1 else
                    torch.sum(torch.square(g.float()))
                    for g, r in zip(tree_leaves(gf), tree_leaves(reps)))
        for i in range(mesh.ndim):  # summed over every rank of the mesh
            dist.all_reduce(total, group=mesh.get_group(i))
        return torch.sqrt(total)

    lm, lv = (tree_map(local, t) for t in (opt_state.m, opt_state.v))
    _p, new = opt.update(tree_map(local, grads),
                         AdamWState(opt_state.step, lm, lv),
                         tree_map(local, params), norm=norm)
    return params, AdamWState(new.step, opt_state.m, opt_state.v)


def init_train_state(bundle: ModelBundle, seed: int = 0, device="cuda",
                     optimizer: Optional[AdamW] = None,
                     grad_compression: bool = False, mesh=None,
                     fsdp_axes: Optional[Tuple] = None):
    """-> (params, optimizer state, error state): random parameters from
    a ``torch.Generator`` seeded with ``seed`` on ``device`` (``"cuda"``
    by default, ``RuntimeError`` without a card; ``"cpu"`` when asked).
    On a mesh every rank draws the same parameters, one layer at a time,
    and keeps its shards of each (``param_sharding``): a rank holds its
    shards and one drawn layer; the moments and the error state take the
    parameters' placements."""
    opt = optimizer or make_optimizer()
    dev = model_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if mesh is None:
        params = bundle.init(gen, dev)
    else:
        params = _init_shards(bundle, gen, dev, mesh, fsdp_axes)
    err = (init_error_state(params) if grad_compression
           else torch.zeros((), dtype=torch.float32, device=dev))
    return params, opt.init(params), err


def _init_shards(bundle: ModelBundle, gen, dev, mesh, fsdp_axes):
    """``bundle.init`` keeping this rank's shard of each drawn tensor (a
    layer's under its stacked leaf's spec less the layer dim), then the
    kept tree as DTensors of the full shapes.  A 2-D stacked leaf (a
    layer's norm) may be sharded along its layer dim too: its layers are
    kept whole along it and cut once stacked (a local slice)."""
    from torch.distributed.tensor import DTensor

    shapes = bundle.param_shapes()
    sh = param_sharding(bundle, mesh, fsdp_axes)

    def at(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def keep(path, t):
        spec = at(sh, path).spec
        if path[0] == "layers":
            spec = spec[1:]
        return place(t, NamedSharding(mesh, spec)).to_local().clone()

    def wrap(path, t):
        s, m = at(sh, path), at(shapes, path)
        spec = s.spec
        if path[0] == "layers":
            spec = (None,) + tuple(spec[1:])
        d = DTensor.from_local(t, mesh, NamedSharding(mesh, spec).placements,
                               run_check=False, shape=m.shape,
                               stride=m.stride())
        return d if spec == s.spec else d.redistribute(mesh, s.placements)

    return tree_map_with_path(wrap, bundle.init(gen, dev, keep=keep))


# ---------------------------------------------------------------------------
# serving


def _gathered(params, mesh):
    from torch.distributed.tensor import Replicate

    full = [Replicate()] * mesh.ndim
    return tree_map(lambda p: p.redistribute(mesh, full).to_local(), params)


def make_prefill_step(bundle: ModelBundle, mesh, max_len: int,
                      rules_mapping: Optional[Dict] = None):
    """-> ``prefill(params, tokens) -> (last-token logits, cache)`` on the
    global prompts (the same on every rank): each rank prefills its rows
    on gathered parameters; the logits come back whole on every rank and
    the cache with ``cache_sharding``'s placements."""
    rules = AxisRules(mesh, rules_mapping)

    def prefill_step(params, tokens):
        local, _axes_ = _local_rows({"tokens": tokens}, mesh, rules)
        with torch.no_grad():
            logits, cache = bundle.prefill(_gathered(params, mesh),
                                           local["tokens"], max_len=max_len)
        return (_from_rows(logits, tokens.shape[0], mesh, rules),
                _cache_from_rows(cache, tokens.shape[0], mesh, rules))

    return prefill_step


def make_serve_step(bundle: ModelBundle, mesh, cell: ShapeCell,
                    rules_mapping: Optional[Dict] = None):
    """One-token decode step with a ``cell.seq_len``-sized cache (decode
    cells): ``serve(params, tokens, cache, pos) -> (next tokens, logits,
    cache)``; ``tokens`` and ``pos`` are the global batch's, ``cache`` has
    ``cache_sharding``'s placements (``make_prefill_step``'s, or
    ``init_cache`` placed with them)."""
    rules = AxisRules(mesh, rules_mapping)
    b = cell.global_batch

    def serve_step(params, tokens, cache, pos):
        local, _a = _local_rows({"tokens": tokens, "pos": pos}, mesh, rules)
        with torch.no_grad():
            logits, new_cache = bundle.decode_step(
                _gathered(params, mesh), local["tokens"],
                _cache_to_rows(cache, mesh, rules), local["pos"])
            next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return (_from_rows(next_token, b, mesh, rules),
                _from_rows(logits, b, mesh, rules),
                _cache_from_rows(new_cache, b, mesh, rules))

    return serve_step


def _row_sharding(mesh, rules, shape):
    return NamedSharding(mesh, rules.spec(["dp"] + [None] * (len(shape) - 1),
                                          shape))


def _from_rows(t: torch.Tensor, batch: int, mesh, rules) -> torch.Tensor:
    """A tensor of this rank's rows -> the global tensor on every rank."""
    from torch.distributed.tensor import DTensor

    shape = (batch,) + tuple(t.shape[1:])
    sh = _row_sharding(mesh, rules, shape)
    return DTensor.from_local(t, mesh, sh.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride()
                              ).full_tensor()


def _cache_rows_sharding(mesh, rules, shape):
    """The cache's rows: dim 1 over dp (the rule's batch entry)."""
    return NamedSharding(mesh, tuple(
        p if i == 1 else None for i, p in enumerate(
            rules.spec([None, "dp"] + [None] * (len(shape) - 2), shape))))


def _cache_from_rows(cache, batch: int, mesh, rules):
    """Each leaf of a cache of this rank's rows -> a DTensor with
    ``cache_sharding``'s placements."""
    from torch.distributed.tensor import DTensor

    def one(t):
        shape = (t.shape[0], batch) + tuple(t.shape[2:])
        rows = _cache_rows_sharding(mesh, rules, shape)
        d = DTensor.from_local(t, mesh, rows.placements, run_check=False,
                               shape=torch.Size(shape),
                               stride=torch.empty(shape, device="meta").stride())
        return d.redistribute(mesh, cache_sharding(mesh, d, rules).placements)
    return tree_map(one, cache)


def _cache_to_rows(cache, mesh, rules):
    """A placed cache -> plain tensors of this rank's rows (whole heads
    and positions), for the decode step to write in place."""
    def one(d):
        rows = _cache_rows_sharding(mesh, rules, d.shape)
        return d.redistribute(mesh, rows.placements).to_local().clone()
    return tree_map(one, cache)
