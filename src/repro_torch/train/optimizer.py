"""AdamW and the cosine learning-rate schedule, the twins of
``repro.train.optimizer``.

Parameters, gradients and the moments are nested dicts of tensors (the
models' parameter trees).  The math is the reference's, step for step:
gradients in fp32, clipped by their global norm before the moments,
bias-corrected moments, decoupled weight decay only on tensors of two or
more dimensions, fp32 moments, the update cast back to each parameter's
dtype.  ``torch.optim.AdamW`` differs (it decays ``p`` by ``lr * wd``
before the step and clips nothing), so it is not used.  ``update`` works
in place: it consumes the parameters, the state and the gradients, as the
reference's step donates its buffers, and returns the same trees (the
reference's is functional).  ``AdamWState`` keeps the
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
        # ``zeros_like``: a sharded parameter (DTensor) gets moments of its
        # placements
        zeros = lambda p: tree_map(
            lambda x: torch.zeros_like(x, dtype=torch.float32), p)
        device = tree_leaves(params)[0].device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                          zeros(params), zeros(params))

    def update(self, grads, state: AdamWState, params,
               norm: Optional[Callable] = None) -> Tuple[Dict, AdamWState]:
        """-> (params, state), updated in place: the update consumes
        ``grads``, ``state`` and ``params``, as the reference's step donates
        its buffers (a caller that needs the old state clones it first).
        Each parameter and its moments are updated, and its gradient
        dropped, leaf by leaf, with two temporaries of the leaf's size: the
        peak is the state and the gradients (16 bytes a parameter) and two
        fp32 temporaries of the largest leaf.  ``norm`` maps the gradients
        to their global norm (``global_norm`` by default; a rank's shards
        need the sum over every rank's)."""
        step = state.step + 1
        scale = None
        if self.clip_norm is not None:
            gnorm = (norm or global_norm)(grads)
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        s = step.float()
        bc1 = 1 - torch.pow(torch.tensor(self.b1, dtype=torch.float32,
                                         device=s.device), s)
        bc2 = 1 - torch.pow(torch.tensor(self.b2, dtype=torch.float32,
                                         device=s.device), s)
        lr = self.schedule(step)

        def leaf(p, g, mm, vv):
            g = g.float()
            if scale is not None:
                g.mul_(scale)
            a = g * (1 - self.b1)
            mm.mul_(self.b1).add_(a)                  # b1 m + (1 - b1) g
            torch.mul(g, 1 - self.b2, out=a).mul_(g)
            vv.mul_(self.b2).add_(a)                  # b2 v + (1 - b2) g g
            del g
            b = torch.div(vv, bc2).sqrt_().add_(self.eps)
            torch.div(mm, bc1, out=a).div_(b)         # the Adam direction
            if self.weight_decay and p.dim() >= 2:
                a.add_(torch.mul(p.float(), self.weight_decay, out=b))
            del b
            a.mul_(lr)
            if p.dtype == torch.float32:
                p.sub_(a)
            else:
                p.copy_(p.float().sub_(a))

        def walk(p, g, mm, vv):
            for k in list(p):
                if isinstance(p[k], dict):
                    walk(p[k], g[k], mm[k], vv[k])
                else:
                    leaf(p[k], g.pop(k), mm[k], vv[k])

        walk(params, grads, state.m, state.v)
        return params, AdamWState(step, state.m, state.v)


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
