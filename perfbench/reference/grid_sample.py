"""Bilinear point sampling (counterpart of ``odise_tpu/ops/grid_sample.py``).

The public functions keep the JAX package's layout: feature maps NHWC,
``grid`` xy in [-1, 1], ``points`` xy in [0, 1], zero padding outside the
map, ``align_corners=False``. Float maps go through ``F.grid_sample``,
whose forward and backward are the same bilinear arithmetic as the JAX
code's four weighted corner gathers. Binary masks are sampled by gathering
their four corner bits directly: the values equal a dense sample of the 0/1
mask, which the JAX package gets from bit-plane packing
(``point_sample_packed_binary``), without a float copy of the masks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["grid_sample", "point_sample", "point_sample_binary",
           "sample_nchw"]


def sample_nchw(im: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Sample [B, C, H, W] maps at [B, N, 2] xy points in [0, 1] ->
    [B, C, N], float32."""
    grid = (2.0 * points.float() - 1.0)[:, :, None, :]
    out = F.grid_sample(im.float(), grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out[..., 0]


def grid_sample(im: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample NHWC ``im`` [B, H, W, C] at ``grid`` [B, N, 2] (xy in [-1, 1])
    -> [B, N, C]."""
    out = F.grid_sample(im.permute(0, 3, 1, 2).float(), grid.float()[:, :, None, :],
                        mode="bilinear", padding_mode="zeros", align_corners=False)
    return out[..., 0].transpose(1, 2)


def point_sample(feat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Sample NHWC ``feat`` [B, H, W, C] at ``points`` [B, N, 2] (xy in
    [0, 1]) -> [B, N, C]."""
    return grid_sample(feat, 2.0 * points - 1.0)


def point_sample_binary(masks: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of binary masks [N, H, W] (bool, or 0/1 values, read
    as ``> 0.5``) at per-mask points [N, P, 2] (xy in [0, 1]) -> [N, P]
    float32: the four corner bits are gathered and weighted as JAX's
    ``point_sample_packed_binary`` weights them."""
    N, H, W = masks.shape
    bits = masks if masks.dtype == torch.bool else masks > 0.5
    bits = bits.reshape(N, H * W)
    points = points.float()
    # the JAX code's sequence: 2p - 1, then the grid_sample mapping
    gx = 2.0 * points[..., 0] - 1.0
    gy = 2.0 * points[..., 1] - 1.0
    x = ((gx + 1.0) * W - 1.0) * 0.5
    y = ((gy + 1.0) * H - 1.0) * 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    out = None
    for xi, yi, w in ((x0, y0, wx0 * wy0), (x0 + 1, y0, wx1 * wy0),
                      (x0, y0 + 1, wx0 * wy1), (x0 + 1, y0 + 1, wx1 * wy1)):
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        flat = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
        bit = torch.gather(bits, 1, flat) & valid
        term = w * bit.float()
        out = term if out is None else out + term
    return out
