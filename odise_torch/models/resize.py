"""``jax.image.resize`` semantics for the port.

jax resizes with half-pixel centres and, when downsampling, an antialiased
(scaled) kernel; its cubic is Keys' with a = -0.5. ``F.interpolate`` with
``antialias=True, align_corners=False`` matches it for "bilinear" and
"bicubic" (to about 1e-6), and jax's "nearest" is torch's "nearest-exact".
Without ``antialias`` a downsample differs by whole units.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize(x: torch.Tensor, size: Tuple[int, int], method: str) -> torch.Tensor:
    """Resize the last two dims of ``x`` to ``size`` = (h, w).

    ``method`` is "bilinear", "bicubic" or "nearest". Leading dims are kept.
    Interpolation runs in float32; the result has ``x``'s dtype.
    """
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[-2:]) == size:
        return x
    lead = x.shape[:-2]
    y = x.reshape((-1, 1) + tuple(x.shape[-2:])).float()
    if method in ("bilinear", "bicubic"):
        y = F.interpolate(y, size=size, mode=method, align_corners=False,
                          antialias=True)
    elif method == "nearest":
        y = F.interpolate(y, size=size, mode="nearest-exact")
    else:
        raise ValueError(f"unknown resize method {method!r}")
    return y.reshape(tuple(lead) + size).to(x.dtype)
