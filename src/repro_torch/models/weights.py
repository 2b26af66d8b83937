"""Weight carry between the JAX package's parameter trees and the port's.

The port keeps the reference's parameter names, its stacked leading
layer axis and its ``(in, out)`` matrix layout (applied as ``x @ w``), so
carrying weights is a copy, with no transpose:

* ``from_jax_params(tree, cfg, device)`` takes the reference's tree as
  numpy arrays (``jax.tree_util.tree_map(np.asarray, params)`` on the
  caller's side) and returns the port's tensors on ``device``, after
  checking every name and shape against the port's own model;
* ``to_numpy_tree(params)`` is the converse, for tests.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig

from .registry import build, model_device


def _carry(tree, want, device, path: str):
    if isinstance(want, dict):
        if not isinstance(tree, dict) or set(tree) != set(want):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{path or 'params'}: keys {got} != {sorted(want)}")
        return {k: _carry(tree[k], want[k], device, f"{path}/{k}")
                for k in want}
    t = torch.from_numpy(np.array(tree, copy=True)).to(device)
    if tuple(t.shape) != tuple(want.shape):
        raise ValueError(f"{path}: shape {tuple(t.shape)} != "
                         f"{tuple(want.shape)}")
    return t


def from_jax_params(tree: Dict, cfg: ArchConfig, device="cuda") -> Dict:
    """The reference's parameter tree (numpy leaves) -> the port's."""
    want = build(cfg).init(None, "meta")
    return _carry(tree, want, model_device(device), "")


def to_numpy_tree(params) -> Dict:
    """The port's parameters -> nested dicts of numpy arrays, copies (the
    train step updates its state in place)."""
    if isinstance(params, dict):
        return {k: to_numpy_tree(v) for k, v in params.items()}
    return np.array(params.detach().cpu().numpy())
