"""Multi-scale deformable attention in plain PyTorch: per level
``F.grid_sample`` (bilinear, zero padding, pixel centres at +0.5) and a
weighted sum over levels and points, in float32. Autograd gives its
backward."""

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def ms_deform_attn(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """value [B, S, H, D], sampling_locations [B, Lq, H, L, P, 2] in [0, 1],
    attention_weights [B, Lq, H, L, P] -> [B, Lq, H * D]."""
    B, _, n_heads, hd = value.shape
    _, Lq, _, n_levels, n_points, _ = sampling_locations.shape
    value_list = value.float().split([h * w for h, w in spatial_shapes], dim=1)
    grids = 2 * sampling_locations.float() - 1
    weights = attention_weights.float()
    out = value.new_zeros((B, Lq, n_heads, hd), dtype=torch.float32)
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = value_list[lvl].reshape(B, h, w, n_heads, hd)
        v = v.permute(0, 3, 4, 1, 2).reshape(B * n_heads, hd, h, w)
        g = grids[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(B * n_heads, Lq, n_points, 2)
        sampled = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                align_corners=False).reshape(B, n_heads, hd, Lq, n_points)
        w_l = weights[:, :, :, lvl].permute(0, 2, 1, 3)
        out = out + torch.einsum("bhcqp,bhqp->bqhc", sampled, w_l)
    return out.reshape(B, Lq, n_heads * hd).to(value.dtype)
