"""Optimizer, train steps and the training loop (counterpart of
``odise_tpu/engine``; checkpointing and hooks are not ported yet)."""

from .optimizer import AdamW, make_optimizer, multistep_lr
from .train_loop import (
    Trainer,
    check_finite,
    make_caption_train_step,
    make_category_train_step,
    partition_params,
)

__all__ = ["AdamW", "Trainer", "check_finite", "make_caption_train_step",
           "make_category_train_step", "make_optimizer", "multistep_lr",
           "partition_params"]
