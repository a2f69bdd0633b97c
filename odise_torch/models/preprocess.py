"""Batch placement (counterpart of ``odise_tpu/models/preprocess.py``)."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def batched_input_to_device(batched_inputs: Any, device=None):
    """Move every numpy array and tensor of a nested dict / list / tuple
    batch to ``device`` (numpy arrays become tensors there); other leaves
    stay as they are. With ``device`` None the batch is returned as it is,
    as the JAX function returns it without a placement."""
    if device is None:
        return batched_inputs
    device = torch.device(device)

    def move(x):
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(move(v) for v in x)
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return x

    return move(batched_inputs)
