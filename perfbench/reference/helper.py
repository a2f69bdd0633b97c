"""Shared model helpers (counterpart of ``odise_tpu/models/helper.py``)."""

from __future__ import annotations

import math
from typing import Sequence

import torch

from . import decisions


def ensemble_logits_with_labels(logits: torch.Tensor,
                                labels: Sequence[Sequence[str]],
                                ensemble_method: str = "max") -> torch.Tensor:
    """Reduce per-synonym logits [..., K_flat] to per-category [..., K]
    (max or mean over each synonym group)."""
    if ensemble_method not in ("max", "mean"):
        raise ValueError(f"unknown ensemble_method {ensemble_method!r}")
    sizes = [len(l) for l in labels]
    if sum(sizes) != logits.shape[-1]:
        raise ValueError(f"labels hold {sum(sizes)} synonyms, logits "
                         f"{logits.shape[-1]}")
    if all(s == 1 for s in sizes):
        return logits
    groups = torch.split(logits, sizes, dim=-1)
    if ensemble_method == "max":
        return torch.stack([g.amax(-1) for g in groups], dim=-1)
    return torch.stack([g.mean(-1) for g in groups], dim=-1)


def mask_pooling(x: torch.Tensor, mask: torch.Tensor, hard: bool = True,
                 threshold: float = 0.5) -> torch.Tensor:
    """Average-pool features inside each predicted mask.

    x: [B, C, H, W]; mask: [B, Q, H, W] logits. Returns [B, Q, C].
    """
    logits = mask.detach()
    mask = torch.sigmoid(logits)
    if hard:
        at = logits - math.log(threshold / (1 - threshold))
        mask = decisions.threshold(mask > threshold, at).to(x.dtype)
    denorm = mask.sum(dim=(-1, -2), keepdim=True) + 1e-8
    mask = mask / denorm
    return torch.einsum("bchw,bqhw->bqc", x, mask.to(x.dtype))


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``x * rsqrt(sum(x^2) + eps)``: finite at an all-zero input, unlike
    ``F.normalize``'s clamp of the norm."""
    return x * torch.rsqrt(x.square().sum(dim=dim, keepdim=True) + eps)
