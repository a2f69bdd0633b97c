"""Least times of multi-scale deformable attention on the card (copied from
the port's ``chip_smoke.py``: ``deform_bound_ms`` and ``backward_bound_ms``).

Bytes: each input read once and each output written once at the HBM rate.
Operations: float32 multiply-adds over the bilinear corners that these
sampling locations put inside their level (the work depends on the data,
so it is counted from the inputs, not at its most). The bound is the
larger of the two times. Counts are device tensors, so that a traced run
sums them without a host sync per call.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .peaks import F32_FLOPS, HBM_BYTES_PER_S


def inside_corners(loc: torch.Tensor, shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """The bilinear corners inside their level, summed over every sample:
    loc [B, Lq, H, L, P, 2] in [0, 1], pixel centres at +0.5."""
    total = torch.zeros((), dtype=torch.int64, device=loc.device)
    for lvl, (h, w) in enumerate(shapes):
        x0 = torch.floor(loc[:, :, :, lvl, :, 0].float() * w - 0.5)
        y0 = torch.floor(loc[:, :, :, lvl, :, 1].float() * h - 0.5)
        for dx in (0, 1):
            for dy in (0, 1):
                total += ((x0 + dx >= 0) & (x0 + dx <= w - 1)
                          & (y0 + dy >= 0) & (y0 + dy <= h - 1)).sum()
    return total


def forward_work(value, loc, attn, shapes) -> Tuple[int, torch.Tensor]:
    """(bytes, flops) of the forward: value [B, S, H, D], loc [B, Lq, H,
    L, P, 2], attn [B, Lq, H, L, P]; output [B, Lq, H * D] in value's
    dtype; a multiply and an add per inside corner and channel."""
    elem = value.element_size()
    n_bytes = (value.numel() * elem + loc.numel() * loc.element_size()
               + attn.numel() * attn.element_size()
               + loc.shape[0] * loc.shape[1] * value.shape[2] * value.shape[3] * elem)
    return n_bytes, inside_corners(loc, shapes) * value.shape[3] * 2


def backward_work(value, loc, attn, shapes) -> Tuple[int, torch.Tensor]:
    """(bytes, flops) of the backward: value, locations, weights and
    grad_out read once, the three gradients written once; 8 operations a
    sample and channel for the four corner dot products that give the
    weight and location gradients, and a multiply and an add per inside
    corner and channel for the value gradient."""
    elem = value.element_size()
    samples = loc.numel() // 2
    n_bytes = (2 * value.numel() * elem + 2 * loc.numel() * loc.element_size()
               + 2 * attn.numel() * attn.element_size()
               + loc.shape[0] * loc.shape[1] * value.shape[2] * value.shape[3] * elem)
    flops = (samples * 8 + inside_corners(loc, shapes) * 2) * value.shape[3]
    return n_bytes, flops


def least_seconds(n_bytes: float, flops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS)
