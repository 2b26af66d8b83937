"""Parallel single-file distributed checkpointing (the paper's technique
applied to training state), for torch trees.

Exports resolve lazily (PEP 562): ``repro_torch.ckpt._mpworker`` — the
multiprocessing save worker — must be importable in a *spawn* child
without building anything else of the checkpoint layer, and an eager
``from .checkpoint import ...`` here would pull it in.
"""

import importlib

_EXPORTS = {
    "CKPT_SCHEMA": "_mpworker",
    "run_save_worker": "_mpworker",
    "load_checkpoint": "checkpoint",
    "save_checkpoint": "checkpoint",
    "save_checkpoint_mp": "checkpoint",
    "CheckpointManager": "manager",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        mod = importlib.import_module("." + _EXPORTS[name], __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
