"""Checkpoints without the frozen towers (counterpart of
``odise_tpu/engine/checkpoint.py``, written with ``torch.save``).

A parameter is frozen when its name matches ``train_loop.is_frozen_path``
(the SD and CLIP towers); ``save`` leaves those out, so a checkpoint holds
the 28.6M trainable parameters of FULL and the optimizer's state with its
update count, and ``load`` copies what it holds over the parameters it is
given, reporting trainable names the file lacks by their common prefix.
The frozen towers come from where the model was built.

Layout, in ``save_dir``: ``<name>.pth``, one file per checkpoint, a dict of
``params`` (name -> CPU tensor), ``optimizer`` (``state_dict()``, or None),
``step`` (the iteration to resume at) and ``extra``; ``last_checkpoint``
names the newest. Names are ``model_{iteration:07d}``, ``model_final`` and
``model_best``; all but the last two count against ``max_to_keep``, the
oldest going first. A file is written to ``<name>.pth.tmp`` and renamed,
so an interrupted save leaves the previous checkpoints whole.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional, Tuple

import torch

from .train_loop import is_frozen_path

logger = logging.getLogger(__name__)

Params = Dict[str, torch.Tensor]


def split_frozen(params: Params) -> Tuple[Params, Params]:
    """(trainable, frozen) CPU copies of a name -> tensor dict."""
    trainable, frozen = {}, {}
    for name, p in params.items():
        target = frozen if is_frozen_path(tuple(name.split("."))) else trainable
        target[name] = p.detach().to("cpu", copy=True)
    return trainable, frozen


def merge_params(base: Params, override: Params) -> Params:
    """``base`` with the entries of ``override`` put over it."""
    return {**base, **override}


class Checkpointer:
    """Save and load the trainable parameters and the optimizer's state."""

    keep_always = ("model_final.pth", "model_best.pth")

    def __init__(self, save_dir: str, max_to_keep: int = 2, backend: str = "torch"):
        if backend != "torch":
            raise ValueError(f"checkpoint backend {backend!r}: the port writes 'torch'")
        self.save_dir = save_dir
        self.max_to_keep = max_to_keep
        os.makedirs(save_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.save_dir, f"{name}.pth")

    def save(self, name: str, params: Params, optimizer=None, step: int = 0,
             extra: Optional[Dict[str, Any]] = None) -> str:
        trainable, _ = split_frozen(params)
        payload = {"params": trainable,
                   "optimizer": optimizer.state_dict() if optimizer is not None else None,
                   "step": int(step), "extra": dict(extra or {})}
        path = self._path(name)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        with open(os.path.join(self.save_dir, "last_checkpoint"), "w") as f:
            f.write(name)
        self._gc()
        logger.info("Saved checkpoint to %s", path)
        return path

    def _gc(self) -> None:
        ckpts = sorted((f for f in os.listdir(self.save_dir) if f.endswith(".pth")),
                       key=lambda f: os.path.getmtime(os.path.join(self.save_dir, f)))
        removable = [c for c in ckpts if c not in self.keep_always]
        while len(removable) > self.max_to_keep:
            os.remove(os.path.join(self.save_dir, removable.pop(0)))

    def has_checkpoint(self) -> bool:
        return os.path.isfile(os.path.join(self.save_dir, "last_checkpoint"))

    def get_checkpoint_file(self) -> Optional[str]:
        try:
            with open(os.path.join(self.save_dir, "last_checkpoint")) as f:
                return self._path(f.read().strip())
        except FileNotFoundError:
            return None

    def load(self, path: str, params: Params, optimizer=None) -> Tuple[int, dict]:
        """Copy the checkpoint's parameters over ``params`` (name -> tensor,
        in place) and its optimizer state into ``optimizer`` where both are
        there. Returns (step, extra)."""
        payload = torch.load(path, map_location="cpu", weights_only=True)
        self._report_missing(params, payload["params"])
        with torch.no_grad():
            for name, t in payload["params"].items():
                if name in params:
                    params[name].copy_(t)
        if optimizer is not None:
            if payload["optimizer"] is not None:
                optimizer.load_state_dict(payload["optimizer"])
            else:
                logger.warning("Checkpoint %s has no optimizer state", path)
        logger.info("Loaded checkpoint %s (step %d)", path, payload["step"])
        return payload["step"], payload["extra"]

    def resume_or_load(self, path: Optional[str], params: Params, resume: bool,
                       optimizer=None) -> Tuple[int, dict]:
        """resume=True: the last checkpoint in save_dir if there is one; else
        ``path`` if given; else nothing (step 0)."""
        if resume and self.has_checkpoint():
            return self.load(self.get_checkpoint_file(), params, optimizer)
        if path:
            return self.load(path, params, optimizer)
        return 0, {}

    @staticmethod
    def _longest_common_prefix(names) -> str:
        """The dotted prefix all names share."""
        parts = [n.split(".") for n in names]
        if not parts:
            return ""
        m1, m2 = min(parts), max(parts)
        common = []
        for a, b in zip(m1, m2):
            if a != b:
                break
            common.append(a)
        return ".".join(common) + ("." if common else "")

    def _report_missing(self, params: Params, loaded: Params) -> None:
        init_keys = {k for k in params if not is_frozen_path(tuple(k.split(".")))}
        missing = sorted(init_keys - set(loaded))
        if missing:
            logger.warning("Missing %d trainable keys (common prefix %r)", len(missing),
                           self._longest_common_prefix(missing))
        unexpected = sorted(set(loaded) - init_keys)
        if unexpected:
            logger.warning("Unexpected keys in checkpoint: %s", unexpected[:10])


class BestCheckpointer:
    """Track a metric and keep ``model_best``."""

    def __init__(self, checkpointer: Checkpointer, metric: str, mode: str = "max"):
        self.checkpointer = checkpointer
        self.metric = metric
        self.mode = mode
        self.best: Optional[float] = None

    def maybe_save(self, results: dict, params: Params, optimizer=None, step: int = 0) -> bool:
        value = results.get(self.metric)
        if value is None:
            return False
        better = (self.best is None
                  or (value > self.best if self.mode == "max" else value < self.best))
        if better:
            self.best = value
            self.checkpointer.save("model_best", params, optimizer, step,
                                   {"best_metric": value})
        return better
