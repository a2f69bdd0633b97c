"""Train steps and the training loop (counterpart of
``odise_tpu/engine/train_loop.py``).

PyTorch runs eagerly, so a step is a plain function: the model and the
optimizer hold the state and are updated in place, and the step returns its
metrics as device scalars. The metric keys are the JAX step's: every loss,
``total_loss``, ``grad_norm``, ``clipped_grad_norm`` and ``loss_scale``
(identically 1: bf16 compute needs no loss scaling). ``Trainer`` reads the
metrics once per ``log_period`` window, its only host sync.

Over W ranks (``torch.distributed``, one process per card) each rank runs
the step on its slice of the batch; the trainable gradients are averaged
over the ranks in one all-reduce of one flat buffer before the clip, which
so acts on the global norm, and the metrics are averaged too. Together with
the criterion's global counts and draws (``losses/set_criterion.py``) and
the grounding loss's gathered negatives, the step is the JAX package's one
global step on the union batch, and every rank's parameters stay equal.
With a model axis (``parallel/mesh.py``) the ranks of one model group take
the same batch; the gradients' all-reduce runs over every rank, which also
makes their copies bitwise equal.
``DistributedDataParallel`` is not used: the training forward runs the
towers on 4 crops under ``torch.utils.checkpoint`` and may loop over
micro-batches, where DDP's reducer expects one forward per backward.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..losses import CriterionConfig, mask_grounding_criterion, set_criterion
from ..losses.grounding import GroundingConfig
from ..parallel.mesh import FROZEN_TOWER_KEYWORDS, is_frozen_path
from ..parallel.multihost import (all_reduce_mean_, all_reduce_sum, gather_pickled,
                                  get_world_size)
from ..utils.tracing import span
from .optimizer import clip_by_global_norm_, global_norm

__all__ = ["FROZEN_TOWER_KEYWORDS", "Trainer", "check_finite", "is_frozen_path",
           "make_caption_train_step", "make_category_train_step",
           "partition_params"]

def partition_params(model: torch.nn.Module
                     ) -> Tuple[Dict[str, torch.nn.Parameter], Dict[str, torch.nn.Parameter]]:
    """Split the model's parameters into (trainable, frozen) name ->
    parameter dicts by the JAX package's frozen-tower rule, and mark the
    frozen ones ``requires_grad=False``. Trainable parameters are held in
    float32, as the JAX package holds every parameter; ``Dense`` and
    ``Conv`` still compute in the dtype they were built with. Frozen
    parameters keep their dtype."""
    trainable, frozen = {}, {}
    for name, p in model.named_parameters():
        if is_frozen_path(tuple(name.split("."))):
            p.requires_grad_(False)
            frozen[name] = p
        else:
            if p.dtype != torch.float32:
                p.data = p.data.float()
            p.requires_grad_(True)
            trainable[name] = p
    return trainable, frozen


def _split(batch: Dict[str, torch.Tensor], k: int) -> List[Dict[str, torch.Tensor]]:
    n = next(iter(batch.values())).shape[0]
    if n % k:
        raise ValueError(f"batch of {n} does not split into {k} micro-batches")
    m = n // k
    return [{key: v[i * m:(i + 1) * m] for key, v in batch.items()} for i in range(k)]


def _make_grads_and_losses(loss_fn, params: List[torch.nn.Parameter], accum_steps: int):
    """Wrap ``loss_fn(batch, generator, num_masks_override)`` -> (total,
    losses) into a function that leaves the gradient in each parameter's
    ``.grad`` and returns (total, losses).

    ``accum_steps=k`` reproduces k-way data parallelism as the JAX code
    does: k equal micro-batches in turn, each with the DDP-equivalent
    number of masks (the mean over the micro-batches of each one's clamped
    target count), gradients and losses summed and scaled by 1/k.

    Over W ranks micro-step i is collective: it takes the i-th micro-batch
    of every rank, and its target count (clamped) is theirs summed. So W
    ranks of k micro-batches of m rows are one process with ``accum_steps=k``
    on the union batch ordered micro-step by micro-step, rank by rank: rows
    [rank 0's i-th m, rank 1's i-th m, ...] for i = 0 .. k-1.
    """

    def grads_and_losses(batch, generator):
        for p in params:
            p.grad = None
        if accum_steps == 1:
            total, losses = loss_fn(batch, generator, None)
            total.backward()
            return total.detach(), {k: v.detach() for k, v in losses.items()}
        micro = _split(batch, accum_steps)
        counts = all_reduce_sum(torch.stack([mb["gt_valid"].float().sum() for mb in micro]))
        nm = torch.clamp(counts, min=1.0).mean()
        total_sum, loss_sum = None, None
        for mb in micro:
            total, losses = loss_fn(mb, generator, nm)
            total.backward()
            total = total.detach()
            losses = {k: v.detach() for k, v in losses.items()}
            if total_sum is None:
                total_sum, loss_sum = total, losses
            else:
                total_sum = total_sum + total
                loss_sum = {k: loss_sum[k] + v for k, v in losses.items()}
        inv_k = 1.0 / accum_steps
        with torch.no_grad():
            for p in params:
                if p.grad is not None:
                    p.grad.mul_(inv_k)
        return total_sum * inv_k, {k: v * inv_k for k, v in loss_sum.items()}

    return grads_and_losses


def _make_step(model, optimizer, loss_fn, grad_clip: float, accum_steps: int):
    params = [p for p in model.parameters() if p.requires_grad]
    grads_and_losses = _make_grads_and_losses(loss_fn, params, accum_steps)

    checked = []

    def step(batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        total, losses = grads_and_losses(batch, generator)
        grads = [p.grad for p in params if p.grad is not None]
        metrics = dict(losses)
        metrics["total_loss"] = total
        if get_world_size() > 1:
            if not checked:  # every rank must reduce the same tensors
                layouts = gather_pickled([tuple(g.shape) for g in grads])
                if any(lay != layouts[0] for lay in layouts):
                    raise RuntimeError("the ranks' trainable gradients differ in layout")
                checked.append(True)
            keys = sorted(metrics)
            mean = torch.stack([metrics[k].float().reshape(()) for k in keys])
            all_reduce_mean_(grads + [mean])
            metrics = dict(zip(keys, mean.unbind()))
        with span("odise.optimizer"):
            gnorm = global_norm(grads)
            if grad_clip:
                clip_by_global_norm_(grads, grad_clip, gnorm)
            optimizer.step()
        metrics["grad_norm"] = gnorm
        metrics["clipped_grad_norm"] = torch.clamp(gnorm, max=grad_clip)
        metrics["loss_scale"] = torch.ones((), device=gnorm.device)
        return metrics

    return step


def make_category_train_step(model, optimizer, criterion_cfg: CriterionConfig,
                             text_embed_raw: torch.Tensor, labels: tuple,
                             grad_clip: float = 0.01,
                             accum_steps: int = 1) -> Callable:
    """The CategoryODISE train step: ``step(batch, generator)`` -> metrics.

    batch: image [B, S, S, 3] in [0, 1], gt_labels [B, T], gt_masks
    [B, T, S, S] bool, gt_valid [B, T] bool, on the model's device.
    ``generator`` feeds the criterion's random points. Gradients reach the
    parameters with ``requires_grad`` (``partition_params``); the clip is
    optax's global-norm clip, then ``optimizer`` (``make_optimizer``) takes
    one step."""

    def loss_fn(batch, generator, num_masks_override):
        outputs = model.forward_train(batch["image"], text_embed_raw, labels)
        targets = {"labels": batch["gt_labels"], "masks": batch["gt_masks"],
                   "valid": batch["gt_valid"]}
        losses = set_criterion(outputs, targets, criterion_cfg, generator,
                               num_masks_override)
        return sum(losses.values()), losses

    return _make_step(model, optimizer, loss_fn, grad_clip, accum_steps)


def make_caption_train_step(model, optimizer, criterion_cfg: CriterionConfig,
                            grounding_cfg: GroundingConfig = GroundingConfig(),
                            grad_clip: float = 0.01,
                            accum_steps: int = 1) -> Callable:
    """The CaptionODISE train step: binary mask losses (every valid target
    is class 0) plus the grounding loss; batch adds word_tokens [B, K, 77]
    and word_valid [B, K]. Otherwise as ``make_category_train_step``; under
    accumulation each micro-batch's images are the grounding loss's
    negatives."""

    def loss_fn(batch, generator, num_masks_override):
        outputs = model.forward_train(batch["image"], batch["word_tokens"])
        targets = {"labels": torch.zeros_like(batch["gt_labels"]),
                   "masks": batch["gt_masks"], "valid": batch["gt_valid"]}
        losses = set_criterion(outputs, targets, criterion_cfg, generator,
                               num_masks_override)
        losses.update(mask_grounding_criterion(outputs, batch["word_valid"],
                                               grounding_cfg))
        return sum(losses.values()), losses

    return _make_step(model, optimizer, loss_fn, grad_clip, accum_steps)


def check_finite(metrics: Dict[str, float], step: int) -> None:
    """Raise FloatingPointError if a metric is NaN or infinite."""
    bad = {k: float(v) for k, v in metrics.items() if not math.isfinite(float(v))}
    if bad:
        raise FloatingPointError(
            f"Loss became infinite or NaN at iteration={step}! metrics={bad}")


class Trainer:
    """Host-side training loop with hooks. ``log_period > 1`` defers reading
    the metrics (the loop's only host sync) to every log_period-th step, so
    the host keeps queueing work; ``check_finite`` still sees every step's
    metrics. Hooks get (iteration, metrics) at flush time, and a hook whose
    ``due(iteration)`` is true (a checkpoint or an eval reads the model as
    that iteration left it) has the pending metrics flushed right after that
    iteration. Each step's metrics gain ``data_time`` and ``time``, the host
    time of its flush window divided by its steps, as ``tools/train_net.py``
    logs it."""

    def __init__(self, step_fn: Callable, data_iter, generator: Optional[torch.Generator] = None,
                 hooks: Optional[list] = None, log_period: int = 1):
        self.step_fn = step_fn
        self.data_iter = data_iter
        self.generator = generator
        self.hooks = hooks or []
        self.log_period = max(int(log_period), 1)
        self.metrics_history: list = []

    def train(self, start_iter: int, max_iter: int) -> None:
        pending: list = []  # (iteration, data time, device-side metrics)
        window_t0 = time.perf_counter()
        for it in range(start_iter, max_iter):
            with span("odise.step", it):
                with span("odise.data_wait"):
                    t0 = time.perf_counter()
                    batch = next(self.data_iter)
                    data_time = time.perf_counter() - t0
                metrics = self.step_fn(batch, self.generator)
                pending.append((it, data_time, metrics))
                if (len(pending) >= self.log_period or it == max_iter - 1
                        or any(h.due(it) for h in self.hooks if hasattr(h, "due"))):
                    self._flush(pending, window_t0)
                    window_t0 = time.perf_counter()

    def _flush(self, pending: list, window_t0: float) -> None:
        # one transfer of every pending scalar: a single host sync
        keys = [sorted(dm) for _, _, dm in pending]
        flat = torch.stack([dm[k].float().reshape(()) for (_, _, dm), ks in zip(pending, keys)
                            for k in ks]).tolist()
        per_step = (time.perf_counter() - window_t0) / len(pending)
        i = 0
        for (pit, data_time, _), ks in zip(pending, keys):
            m = dict(zip(ks, flat[i:i + len(ks)]))
            i += len(ks)
            check_finite(m, pit)
            m["data_time"] = data_time
            m["time"] = per_step
            self.metrics_history.append(m)
            for h in self.hooks:
                h(pit, m)
        pending.clear()
