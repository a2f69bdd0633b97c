"""Config scaling (counterpart of ``odise_tpu/config/utils.py``): when a
config was written for ``reference_world_size`` workers and the run has
another number, scale the global batch, the learning rate, the iteration
count and the periods linearly.

The JAX function's semantics are kept as they are, quirks included: it
scales ``lr_multiplier.warmup_iter`` and ``lr_multiplier.milestones`` but not
``optimizer.milestones`` or ``optimizer.warmup_steps`` (where the shipped
configs keep them), and it counts ``train.accum_steps`` micro-steps as that
many workers.
"""

from __future__ import annotations

import copy
import logging

logger = logging.getLogger(__name__)


def auto_scale_workers(cfg, num_workers: int):
    """Scale total batch size / lr / max_iter / periods by world size.

    ``cfg.train.reference_world_size`` declares the world size the config's
    hyperparameters were tuned for. Returns a scaled deep copy; a value of 0
    disables scaling.
    """
    old_world_size = cfg.train.get("reference_world_size", 0)
    # gradient accumulation multiplies the effective world size: k micro
    # steps per worker stand for k workers' share of the batch, so
    # train.accum_steps=8 on 1 worker with reference_world_size=8 trains the
    # config's batch, lr and schedule unscaled
    accum = int(cfg.train.get("accum_steps", 1))
    num_workers = num_workers * max(accum, 1)
    if old_world_size == 0 or old_world_size == num_workers:
        return cfg
    cfg = copy.deepcopy(cfg)
    assert cfg.dataloader.train.total_batch_size % old_world_size == 0, (
        "Invalid reference_world_size in config!"
    )
    scale = num_workers / old_world_size
    bs = cfg.dataloader.train.total_batch_size = int(
        round(cfg.dataloader.train.total_batch_size * scale)
    )
    lr = cfg.optimizer.lr = cfg.optimizer.lr * scale
    max_iter = cfg.train.max_iter = int(round(cfg.train.max_iter / scale))
    if "warmup_iter" in cfg.get("lr_multiplier", {}):
        cfg.lr_multiplier.warmup_iter = int(round(cfg.lr_multiplier.warmup_iter / scale))
    if "milestones" in cfg.get("lr_multiplier", {}):
        cfg.lr_multiplier.milestones = [
            int(round(m / scale)) for m in cfg.lr_multiplier.milestones
        ]
    cfg.train.eval_period = int(round(cfg.train.eval_period / scale))
    cfg.train.checkpointer.period = int(round(cfg.train.checkpointer.period / scale))
    cfg.train.reference_world_size = num_workers
    logger.info(
        "Auto-scaling config to batch_size=%d, lr=%g, max_iter=%d for %d workers.",
        bs, lr, max_iter, num_workers,
    )
    return cfg
