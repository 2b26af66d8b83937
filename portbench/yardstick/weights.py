"""Weights drawn from ``--seed`` on the card, the same for the program and
the reference.

Each leaf has a generator of its own, seeded from the run's seed and the
leaf's place in the parameter spec, so one leaf can be drawn again alone
(the change of the parameters over the checked steps is measured against
the drawn start, leaf by leaf, without a second copy of the model).  A
leaf is drawn in place by one ``normal_`` call: a matrix with standard
deviation ``1 / sqrt(fan_in)``, the embedding table 0.02, a norm's gain
ones.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch

_MIX = 0x9E3779B97F4A7C15


def leaf_seed(seed: int, index: int) -> int:
    return (seed * _MIX + index) % (2 ** 63)


def fill_leaf(t: torch.Tensor, std: float, seed: int, index: int) -> torch.Tensor:
    """Draw leaf ``index`` of the spec into ``t`` in place; ``std`` 0 means
    ones (a norm's gain)."""
    with torch.no_grad():
        if std == 0:
            return t.fill_(1.0)
        gen = torch.Generator(device=t.device)
        gen.manual_seed(leaf_seed(seed, index))
        return t.normal_(0.0, std, generator=gen)


def draw_leaf(shape, std: float, seed: int, index: int, device,
              dtype=torch.float32) -> torch.Tensor:
    return fill_leaf(torch.empty(shape, dtype=dtype, device=device), std,
                     seed, index)


def walk(spec: Dict[str, Tuple[tuple, float]]) -> Iterator[Tuple[int, str, tuple, float]]:
    """(index, path, shape, std) of each leaf of ``spec``, in its order."""
    for i, (path, (shape, std)) in enumerate(spec.items()):
        yield i, path, tuple(shape), std
