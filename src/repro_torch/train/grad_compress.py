"""Gradient compression: int8 quantization with error feedback, the twin
of ``repro.train.grad_compress``.

Each gradient tensor is quantized to int8 (symmetric, max-abs scale) and
dequantized; the quantization error is carried into the next step's
gradient, so the scheme stays unbiased over time.  On one card there is
no all-reduce for it to shrink: the step runs it, as the reference's does
on one device, so a run's numbers match the reference's.  ``torch.round``
rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .optimizer import tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(params) -> Dict:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_grads(grads, error_state) -> Tuple[Dict, Dict]:
    """-> (dequantized grads, new error state)."""

    def one(g, e):
        gf = g.float() + e
        deq = dequantize_int8(*quantize_int8(gf))
        return deq, gf - deq

    pairs = tree_map(one, grads, error_state)
    return _split(pairs, 0), _split(pairs, 1)


def _split(tree, i: int):
    if isinstance(tree, dict):
        return {k: _split(v, i) for k, v in tree.items()}
    return tree[i]
