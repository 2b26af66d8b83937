"""Training of the port on one card: AdamW, the train step and int8
error-feedback gradient compression, twins of ``repro.train``'s
``optimizer``, ``step`` and ``grad_compress`` (the loop waits for the
checkpoint's slice)."""

from .grad_compress import compress_grads, init_error_state
from .optimizer import (
    AdamW, AdamWState, cosine_schedule, global_norm, make_optimizer,
)
from .step import init_train_state, loss_and_grads, make_train_step

__all__ = [
    "AdamW", "AdamWState", "cosine_schedule", "global_norm",
    "make_optimizer", "compress_grads", "init_error_state",
    "init_train_state", "loss_and_grads", "make_train_step",
]
