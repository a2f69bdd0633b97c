"""Parameter counts per module (counterpart of
``odise_tpu/utils/parameter_count.py``): the tables that check the 28.1M
trainable parameters of the reference (28,591,297 exactly)."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch

from ..engine.train_loop import is_frozen_path


def parameter_count(model: torch.nn.Module, trainable_only: bool = False) -> Dict[str, int]:
    """Parameters per dotted prefix of the module's parameter names, ``""``
    the total. ``trainable_only`` counts what ``engine.partition_params``
    leaves trainable."""
    counts: Dict[str, int] = defaultdict(int)
    for name, p in model.named_parameters():
        keys = tuple(name.split("."))
        if trainable_only and is_frozen_path(keys):
            continue
        for i in range(len(keys) + 1):
            counts[".".join(keys[:i])] += p.numel()
    return dict(counts)


def _fmt(n: int) -> str:
    if n >= 1e9:
        return f"{n / 1e9:.2f}G"
    if n >= 1e6:
        return f"{n / 1e6:.2f}M"
    if n >= 1e3:
        return f"{n / 1e3:.2f}K"
    return str(n)


def parameter_count_table(model, max_depth: int = 3, trainable_only: bool = False) -> str:
    """The counts as a table, one row per prefix above ``max_depth``,
    indented by depth, in the JAX package's layout."""
    counts = parameter_count(model, trainable_only=trainable_only)
    rows = [("model", _fmt(counts.get("", 0)))]
    for name in sorted(counts):
        if not name or name.count(".") >= max_depth:
            continue
        rows.append((" " * (name.count(".") + 1) + name.rsplit(".", 1)[-1],
                     _fmt(counts[name])))
    width = max(len(r[0]) for r in rows) + 2
    lines = [f"{'name':<{width}} #params", "-" * (width + 8)]
    lines += [f"{n:<{width}} {c}" for n, c in rows]
    return "\n".join(lines)
