"""Model registry: ArchConfig -> ModelBundle (init/forward/prefill/decode).

The twin of ``repro.models.registry`` for every architecture of the
registry, each served and trained.  The
reference's dry-run pieces are here too: ``param_shapes`` and
``input_specs`` build ``meta`` tensors (shapes and dtypes, no memory) where
the reference builds ``jax.ShapeDtypeStruct``s, and ``runnable`` says
whether an (arch x shape cell) can run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.archs import get_arch
from repro_torch.configs.base import ArchConfig, ShapeCell
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

    def init(self, gen: Optional[torch.Generator], device="cuda",
             keep=None) -> Dict:
        """Random parameters drawn from ``gen`` (a ``torch.Generator`` on
        ``device``; ``None`` on ``meta``); ``keep``: ``backbone.init_params``'."""
        return B.init_params(gen, self.cfg, model_device(device), keep)

    def loss(self, params, batch):
        """-> (loss, {"ce", "aux"}): ``backbone.loss_fn``."""
        return B.loss_fn(params, batch, self.cfg)

    def loss_sums(self, params, batch, view=None):
        """The loss's sums over ``batch``: ``backbone.loss_sums``."""
        return B.loss_sums(params, batch, self.cfg, view)

    @staticmethod
    def loss_from_sums(sums, total=None):
        """-> (loss, {"ce", "aux"}): ``backbone.loss_from_sums``."""
        return B.loss_from_sums(sums, total)

    def forward(self, params, tokens):
        return B.forward(params, tokens, self.cfg)

    def prefill(self, params, tokens, max_len: int, cache_dtype=None):
        return B.prefill(params, tokens, self.cfg, max_len, cache_dtype)

    def init_cache(self, batch: int, max_len: int, dtype=None, device="cuda"):
        return B.init_cache(self.cfg, batch, max_len, dtype,
                            model_device(device))

    def decode_step(self, params, tokens, cache, pos):
        return B.decode_step(params, tokens, cache, pos, self.cfg)

    # -- dry-run specs -------------------------------------------------------

    def param_shapes(self) -> Dict:
        """The parameter tree on the ``meta`` device: shapes and dtypes."""
        return self.init(None, "meta")

    def _token_shape(self, batch: int, seq: int) -> Tuple[int, ...]:
        if self.cfg.n_codebooks > 1:
            return (batch, seq, self.cfg.n_codebooks)
        return (batch, seq)

    def input_specs(self, cell: ShapeCell) -> Dict[str, Any]:
        """``meta`` stand-ins for the cell's step function inputs: int32
        tokens (and labels), or for a decode cell one token each, the cache
        of ``cell.seq_len`` and the positions.  The modality frontends of
        the vlm / audio archs are stubs, as in the reference: the tokens
        are precomputed ids (VQ image codes, EnCodec codebook codes)."""
        def ids(*shape):
            return torch.empty(shape, dtype=torch.int32, device="meta")

        b = cell.global_batch
        if cell.kind == "train":
            return {"tokens": ids(*self._token_shape(b, cell.seq_len)),
                    "labels": ids(*self._token_shape(b, cell.seq_len))}
        if cell.kind == "prefill":
            return {"tokens": ids(*self._token_shape(b, cell.seq_len))}
        return {"tokens": ids(*self._token_shape(b, 1)),
                "cache": self.init_cache(b, cell.seq_len, device="meta"),
                "pos": ids(b)}

    def runnable(self, cell: ShapeCell) -> Tuple[bool, str]:
        """Is this (arch x cell) runnable? long_500k needs sub-quadratic."""
        if cell.name == "long_500k" and not self.cfg.sub_quadratic:
            return False, "SKIP(full-attn): 500k dense decode cache unbounded"
        return True, ""


def build(cfg_or_name) -> ModelBundle:
    cfg = cfg_or_name if isinstance(cfg_or_name, ArchConfig) else get_arch(cfg_or_name)
    B.check_ported(cfg)
    return ModelBundle(cfg)


def make_batch(bundle: ModelBundle, rng: np.random.Generator, batch: int,
               seq: int, device="cuda") -> Dict[str, torch.Tensor]:
    """Random int32 token batch for smoke tests / examples."""
    shape = bundle._token_shape(batch, seq)
    toks = rng.integers(0, bundle.cfg.vocab_size, shape).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    dev = model_device(device)
    return {"tokens": torch.from_numpy(toks).to(dev),
            "labels": torch.from_numpy(labels).to(dev)}
