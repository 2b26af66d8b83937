"""AdamW and the cosine learning-rate schedule, the twins of
``repro.train.optimizer``.

Parameters, gradients and the moments are nested dicts of tensors (the
models' parameter trees).  The math is the reference's, step for step:
gradients in fp32, clipped by their global norm before the moments,
bias-corrected moments, decoupled weight decay only on tensors of two or
more dimensions, fp32 moments, the update cast back to each parameter's
dtype.  ``torch.optim.AdamW`` differs (it decays ``p`` by ``lr * wd``
before the step and clips nothing), so it is not used.  ``update`` is
functional like the reference's: it returns new parameters and a new
state and leaves its arguments as they were.  ``AdamWState`` keeps the
reference's field names (``step``, ``m``, ``v``), so a checkpoint can
flatten it to the same keys.  The step lives on the parameters' device as
an int32 scalar and the learning rate is computed there: a step makes no
host sync.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    m: Dict                  # like params, fp32
    v: Dict                  # like params, fp32


@dataclass(frozen=True)
class AdamW:
    schedule: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def init(self, params) -> AdamWState:
        zeros = lambda p: tree_map(
            lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                  device=x.device), p)
        device = tree_leaves(params)[0].device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                          zeros(params), zeros(params))

    def update(self, grads, state: AdamWState,
               params) -> Tuple[Dict, AdamWState]:
        step = state.step + 1
        gf = tree_map(lambda g: g.float(), grads)
        scale = None
        if self.clip_norm is not None:
            gnorm = global_norm(gf)
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        s = step.float()
        bc1 = 1 - torch.pow(torch.tensor(self.b1, dtype=torch.float32,
                                         device=s.device), s)
        bc2 = 1 - torch.pow(torch.tensor(self.b2, dtype=torch.float32,
                                         device=s.device), s)
        lr = self.schedule(step)

        # one leaf at a time, so that a clipped gradient and the update's
        # temporaries exist for one tensor at once: the step's peak is the
        # old and new state beside the gradients (gemma-2b: 70 of the
        # card's 80 GB), as under the reference's fused, donated update
        def leaf(p, g, mm, vv):
            if scale is not None:
                g = g * scale
            mm = self.b1 * mm + (1 - self.b1) * g
            vv = self.b2 * vv + (1 - self.b2) * g * g
            u = (mm / bc1) / (torch.sqrt(vv / bc2) + self.eps)
            if self.weight_decay and p.dim() >= 2:
                u = u + self.weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype), mm, vv

        out = tree_map(leaf, params, gf, state.m, state.v)
        new_params, m, v = (tree_map(lambda _p, t: t[i], params, out)
                            for i in range(3))
        return new_params, AdamWState(step, m, v)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> Callable:
    """step (int tensor) -> learning rate (fp32 tensor): linear warm-up to
    ``peak_lr`` over ``warmup`` steps, then a cosine down to
    ``floor_frac * peak_lr`` at ``total``."""
    def f(step):
        s = step.float()
        warm = peak_lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor_frac + (1 - floor_frac) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup, warm, cos)
    return f


def make_optimizer(peak_lr: float = 3e-4, warmup: int = 100,
                   total: int = 10_000, **kw) -> AdamW:
    return AdamW(schedule=cosine_schedule(peak_lr, warmup, total), **kw)
