"""Optimizer, train steps, the training loop, checkpoints, hooks and the
default setup (counterpart of ``odise_tpu/engine``)."""

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
