"""Event storage and writers (counterpart of ``odise_tpu/utils/events.py``):
median-smoothed scalars, a console line with every metric, the ETA and the
learning rate, a JSON writer that appends to ``metrics.json``, a
``WandbWriter`` that imports wandb only when it is built and does nothing
where wandb is missing, and ``WriterStack``, which closes the writers even
when training raises.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)


class EventStorage:
    """Scalar history with windowed median smoothing (d2 EventStorage)."""

    def __init__(self, start_iter: int = 0, window: int = 20):
        self.iter = start_iter
        self.window = window
        self._history: Dict[str, deque] = defaultdict(lambda: deque(maxlen=200))
        self._latest: Dict[str, tuple] = {}

    def put_scalars(self, **kwargs):
        for k, v in kwargs.items():
            v = float(v)
            self._history[k].append((self.iter, v))
            self._latest[k] = (self.iter, v)

    def latest(self) -> Dict[str, tuple]:
        return dict(self._latest)

    def median(self, name: str) -> float:
        vals = sorted(v for _, v in list(self._history[name])[-self.window:])
        return vals[len(vals) // 2] if vals else float("nan")

    def latest_with_smoothing_hint(self) -> Dict[str, tuple]:
        out = {}
        for k, (it, v) in self._latest.items():
            out[k] = (it, self.median(k))
        return out

    def step(self):
        self.iter += 1


class CommonMetricPrinter:
    """Console line with all smoothed metrics + ETA + lr."""

    def __init__(self, max_iter: Optional[int] = None, window: int = 20):
        self.max_iter = max_iter
        self._last_write = None

    def write(self, storage: EventStorage):
        it = storage.iter
        eta = ""
        if self.max_iter and "time" in storage._history:
            t = storage.median("time")
            eta_sec = int(t * (self.max_iter - it))
            eta = f"eta: {datetime.timedelta(seconds=eta_sec)}  "
        parts = []
        for k in sorted(storage._latest):
            if k in ("time", "data_time", "lr"):
                continue
            parts.append(f"{k}: {storage.median(k):.4g}")
        lr = f"lr: {storage._latest['lr'][1]:.4g}  " if "lr" in storage._latest else ""
        tstr = (f"time: {storage.median('time'):.4f}  "
                if "time" in storage._history else "")
        dstr = (f"data_time: {storage.median('data_time'):.4f}  "
                if "data_time" in storage._history else "")
        logger.info("%siter: %d  %s  %s%s%s", eta, it, "  ".join(parts), tstr,
                    dstr, lr)

    def close(self):
        pass


class JSONWriter:
    """Append smoothed scalars to metrics.json (d2 JSONWriter)."""

    def __init__(self, json_file: str, window: int = 20):
        os.makedirs(os.path.dirname(json_file) or ".", exist_ok=True)
        self._file = open(json_file, "a")

    def write(self, storage: EventStorage):
        rec = {"iteration": storage.iter}
        for k, (_, v) in storage.latest_with_smoothing_hint().items():
            rec[k] = v
        self._file.write(json.dumps(rec, sort_keys=True) + "\n")
        self._file.flush()

    def close(self):
        self._file.close()


class WandbWriter:
    """Weights & Biases writer; no-op if wandb is unavailable or disabled."""

    def __init__(self, project: str = "odise_torch", run_name: str = "run",
                 max_iter: Optional[int] = None, **kwargs):
        self.max_iter = max_iter
        try:
            import wandb

            self._run = wandb.init(project=project, name=run_name, **kwargs)
            self._wandb = wandb
        except Exception:
            self._run = None
            self._wandb = None

    def write(self, storage: EventStorage):
        if self._run is None:
            return
        log = {k: v for k, (_, v) in storage.latest_with_smoothing_hint().items()}
        if self.max_iter:
            log["progress"] = storage.iter / self.max_iter
        self._run.log(log, step=storage.iter)

    def close(self):
        if self._run is not None:
            self._run.finish()


class WriterStack:
    """Context manager closing writers even on exceptions."""

    def __init__(self, writers: List):
        self.writers = writers

    def __enter__(self):
        return self.writers

    def __exit__(self, exc_type, exc, tb):
        for w in self.writers:
            try:
                w.close()
            except Exception:
                logger.exception("Failed to close writer %r", w)
        return False
