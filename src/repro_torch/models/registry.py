"""Model registry: ArchConfig -> ModelBundle (init/forward/prefill/decode).

The twin of ``repro.models.registry`` for the families the port has (the
dense family, rwkv6 and the zamba2 hybrid, see ``backbone.check_ported``);
``build`` raises ``NotImplementedError`` for the others, and ``loss`` for
all but the dense family (``backbone.check_trainable``).  The reference's
dry-run pieces (``param_shapes``, ``input_specs``, ``runnable``) wait for
their slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.archs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ops import resolve_device

from . import backbone as B


def model_device(device) -> torch.device:
    """A model's device: ``"cuda"`` needs a card (``RuntimeError``
    without one), ``"cpu"`` runs only when asked for, ``"meta"`` builds
    shapes without memory."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)


@dataclass
class ModelBundle:
    cfg: ArchConfig

    def init(self, gen: Optional[torch.Generator], device="cuda") -> Dict:
        """Random parameters drawn from ``gen`` (a ``torch.Generator`` on
        ``device``; ``None`` on ``meta``)."""
        return B.init_params(gen, self.cfg, model_device(device))

    def loss(self, params, batch):
        """-> (loss, {"ce", "aux"}): ``backbone.loss_fn``."""
        return B.loss_fn(params, batch, self.cfg)

    def forward(self, params, tokens):
        return B.forward(params, tokens, self.cfg)

    def prefill(self, params, tokens, max_len: int, cache_dtype=None):
        return B.prefill(params, tokens, self.cfg, max_len, cache_dtype)

    def init_cache(self, batch: int, max_len: int, dtype=None, device="cuda"):
        return B.init_cache(self.cfg, batch, max_len, dtype,
                            model_device(device))

    def decode_step(self, params, tokens, cache, pos):
        return B.decode_step(params, tokens, cache, pos, self.cfg)


def build(cfg_or_name) -> ModelBundle:
    cfg = cfg_or_name if isinstance(cfg_or_name, ArchConfig) else get_arch(cfg_or_name)
    B.check_ported(cfg)
    return ModelBundle(cfg)


def make_batch(bundle: ModelBundle, rng: np.random.Generator, batch: int,
               seq: int, device="cuda") -> Dict[str, torch.Tensor]:
    """Random int32 token batch for smoke tests / examples."""
    toks = rng.integers(0, bundle.cfg.vocab_size, (batch, seq)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    dev = model_device(device)
    return {"tokens": torch.from_numpy(toks).to(dev),
            "labels": torch.from_numpy(labels).to(dev)}
