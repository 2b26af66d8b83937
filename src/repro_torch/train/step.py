"""The one-card train step, the twin of ``repro.train.step``'s
``make_train_step`` and ``init_train_state`` without the mesh.

The reference jits a sharded step over a ``Mesh``; on one card the step
is eager PyTorch: the loss and its gradients by autograd (K5's forward
and backward kernels on a card, their plain versions on the CPU), then
optional int8 error-feedback compression and the AdamW update, with
microbatch accumulation as in the reference's ``_accumulated_grads``.
Parameters, optimizer state and the error state are passed in and
returned new, as the reference's donated buffers are.  The prefill and
serve steps stay with ``repro_torch.launch.serve``.  The dense family
only (``backbone.check_trainable``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.backbone import check_trainable
from repro_torch.models.registry import ModelBundle, model_device

from .grad_compress import compress_grads, init_error_state
from .optimizer import AdamW, make_optimizer, tree_leaves, tree_map


def params_device(params) -> torch.device:
    return tree_leaves(params)[0].device


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A loader's batch (numpy arrays from the host engine, tensors from
    the device engine) as tensors on ``device``."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if
                isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def loss_and_grads(bundle: ModelBundle, params: Dict,
                   batch: Dict) -> Tuple[torch.Tensor, Dict, Dict]:
    """-> (loss, metrics, grads): ``bundle.loss`` and its gradient in
    every parameter (``torch.autograd.grad`` raises when a parameter gets
    none).  ``params`` are not modified."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = bundle.loss(leaves, batch)
    flat = tree_leaves(leaves)
    grads = iter(torch.autograd.grad(loss, flat))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _p: next(grads), leaves))


def _accumulated_grads(bundle: ModelBundle, params: Dict, batch: Dict,
                       n: int):
    """Gradients averaged over ``n`` microbatches (the batch split along
    its first axis), accumulated in fp32; the loss averaged, the metrics
    of the last microbatch."""
    micro = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])
             for k, v in batch.items()}
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=params_device(params))
    for i in range(n):
        loss, metrics, g = loss_and_grads(
            bundle, params, {k: v[i] for k, v in micro.items()})
        acc = tree_map(torch.add, acc, g)
        loss_sum = loss_sum + loss
    return tree_map(lambda g: g / n, acc), loss_sum / n, metrics


def make_train_step(bundle: ModelBundle, optimizer: Optional[AdamW] = None,
                    grad_compression: bool = False,
                    microbatches: int = 1) -> Callable:
    """-> ``step(params, opt_state, error_state, batch) -> (params,
    opt_state, error_state, metrics)``; ``batch`` holds ``tokens`` and
    ``labels`` (B, S), as numpy arrays or tensors; ``metrics`` holds fp32
    scalars on the card (``loss``, ``ce``, ``aux``): reading one syncs."""
    check_trainable(bundle.cfg)
    opt = optimizer or make_optimizer()

    def step(params, opt_state, error_state, batch):
        batch = to_device(batch, params_device(params))
        if microbatches > 1:
            grads, loss, metrics = _accumulated_grads(bundle, params, batch,
                                                      microbatches)
        else:
            loss, metrics, grads = loss_and_grads(bundle, params, batch)
        if grad_compression:
            grads, error_state = compress_grads(grads, error_state)
        new_params, new_opt = opt.update(grads, opt_state, params)
        return new_params, new_opt, error_state, {
            "loss": loss.float(),
            **{k: v.float() for k, v in metrics.items()}}

    return step


def init_train_state(bundle: ModelBundle, seed: int = 0, device="cuda",
                     optimizer: Optional[AdamW] = None,
                     grad_compression: bool = False):
    """-> (params, optimizer state, error state): random parameters from
    a ``torch.Generator`` seeded with ``seed`` on ``device`` (``"cuda"``
    by default, ``RuntimeError`` without a card; ``"cpu"`` when asked)."""
    check_trainable(bundle.cfg)
    opt = optimizer or make_optimizer()
    dev = model_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = bundle.init(gen, dev)
    err = (init_error_state(params) if grad_compression
           else torch.zeros((), dtype=torch.float32, device=dev))
    return params, opt.init(params), err
