"""Dataset inference loop with timing and ETA logging (counterpart of
``odise_tpu/evaluation/evaluator.py``): timing split into data, compute and
evaluation with the first iterations excluded, ETA logs, evaluator
composition and the csv-style result log.
"""

from __future__ import annotations

import datetime
import logging
import time
from typing import Callable, Iterable, List, Optional

import torch

logger = logging.getLogger(__name__)


class DatasetEvaluators:
    """Compose several evaluators (process/evaluate fan-out)."""

    def __init__(self, evaluators: List):
        self.evaluators = evaluators

    def reset(self):
        for e in self.evaluators:
            e.reset()

    def process(self, *args, **kwargs):
        for e in self.evaluators:
            e.process(*args, **kwargs)

    def evaluate(self):
        results = {}
        for e in self.evaluators:
            r = e.evaluate()
            if r:
                results.update(r)
        return results


def _cuda_device(outputs):
    """The device of the first CUDA tensor in ``outputs``, else None."""
    if isinstance(outputs, torch.Tensor):
        return outputs.device if outputs.is_cuda else None
    items = outputs.values() if isinstance(outputs, dict) else (
        outputs if isinstance(outputs, (list, tuple)) else ())
    for o in items:
        dev = _cuda_device(o)
        if dev is not None:
            return dev
    return None


def _synchronize(outputs):
    dev = _cuda_device(outputs)
    if dev is not None:
        torch.cuda.synchronize(dev)


def inference_on_dataset(
    predict_fn: Callable,
    data_iter: Iterable,
    process_fn: Callable,
    evaluator,
    total: Optional[int] = None,
    num_warmup: int = 5,
    log_interval: int = 50,
):
    """Run ``predict_fn(batch)`` over the dataset and feed ``process_fn``.

    predict_fn: batch -> model outputs (tensors, or tuples, lists or dicts
    of them); the compute time waits for those on a CUDA device.
    process_fn: (evaluator, batch, outputs) -> None (host-side bookkeeping).
    """
    if hasattr(evaluator, "reset"):
        evaluator.reset()
    total_data_time = total_compute_time = total_eval_time = 0.0
    start = time.perf_counter()
    idx = -1
    t0 = time.perf_counter()
    for idx, batch in enumerate(data_iter):
        total_data_time += time.perf_counter() - t0
        if idx == num_warmup:
            start = time.perf_counter()
            total_data_time = total_compute_time = total_eval_time = 0.0

        t1 = time.perf_counter()
        outputs = predict_fn(batch)
        _synchronize(outputs)
        total_compute_time += time.perf_counter() - t1

        t2 = time.perf_counter()
        process_fn(evaluator, batch, outputs)
        total_eval_time += time.perf_counter() - t2

        iters_after_start = idx + 1 - num_warmup * int(idx >= num_warmup)
        if (idx + 1) % log_interval == 0 and iters_after_start > 0:
            spi = (time.perf_counter() - start) / iters_after_start
            eta = (datetime.timedelta(seconds=int(spi * (total - idx - 1)))
                   if total else "?")
            logger.info(
                "Inference done %d%s. %.4f s/iter. "
                "Data: %.4f s/iter. Compute: %.4f s/iter. Eval: %.4f s/iter. ETA=%s",
                idx + 1, f"/{total}" if total else "",
                spi, total_data_time / iters_after_start,
                total_compute_time / iters_after_start,
                total_eval_time / iters_after_start, eta)
        t0 = time.perf_counter()

    n = idx + 1
    total_time = time.perf_counter() - start
    logger.info("Total inference time: %s (%.6f s / iter)",
                datetime.timedelta(seconds=total_time),
                total_time / max(n - num_warmup, 1))
    results = evaluator.evaluate()
    return results if results is not None else {}


def print_csv_format(results: dict, logger_=None):
    """Log results in the reference's csv-ish format (d2 print_csv_format)."""
    log = (logger_ or logger).info
    for task, metrics in results.items():
        if isinstance(metrics, dict):
            log("copypaste: Task: %s", task)
            names = [k for k in metrics if "-" not in k]
            log("copypaste: %s", ",".join(names))
            log("copypaste: %s", ",".join(f"{metrics[k]:.4f}" for k in names))
        else:
            log("copypaste: %s: %s", task, metrics)
