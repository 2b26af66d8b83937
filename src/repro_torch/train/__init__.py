"""Training of the port on one card: AdamW, the train step, int8
error-feedback gradient compression and the training loop, twins of
``repro.train``'s ``optimizer``, ``step``, ``grad_compress`` and
``loop``."""

from .grad_compress import compress_grads, init_error_state
from .optimizer import (
    AdamW, AdamWState, cosine_schedule, global_norm, make_optimizer,
)
from .step import init_train_state, loss_and_grads, make_train_step
from .loop import LoopConfig, SaveEvent, StepEvent, TrainLoop

__all__ = [
    "AdamW", "AdamWState", "cosine_schedule", "global_norm",
    "make_optimizer", "compress_grads", "init_error_state",
    "init_train_state", "loss_and_grads", "make_train_step",
    "LoopConfig", "SaveEvent", "StepEvent", "TrainLoop",
]
