"""CLIP preprocessing and the MaskCLIP reader mask (counterpart of
``odise_tpu/models/clip/adapter.py``); images are NCHW."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..resize import resize
from .model import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD


def clip_preprocess(image: torch.Tensor, size: int) -> torch.Tensor:
    """Resize the shorter side to ``size`` (bicubic), centre-crop, and
    CLIP-normalise. ``image``: [B, 3, H, W] in [0, 1]."""
    H, W = image.shape[-2:]
    scale = size / min(H, W)
    nh = max(int(round(H * scale)), size)
    nw = max(int(round(W * scale)), size)
    image = resize(image, (nh, nw), "bicubic")
    top, left = (nh - size) // 2, (nw - size) // 2
    image = image[:, :, top:top + size, left:left + size]
    mean = torch.tensor(CLIP_PIXEL_MEAN, dtype=image.dtype, device=image.device)
    std = torch.tensor(CLIP_PIXEL_STD, dtype=image.dtype, device=image.device)
    return (image - mean[:, None, None]) / std[:, None, None]


def _token_masked(mask_logits: torch.Tensor, patch_size: int,
                  num_image_tokens: int) -> torch.Tensor:
    """[B, Q, N] bool: True where a patch's max mask probability is < 0.5."""
    B, Q = mask_logits.shape[:2]
    prob = torch.sigmoid(mask_logits)
    patch_max = F.max_pool2d(prob, kernel_size=patch_size, stride=patch_size)
    token_masked = (patch_max < 0.5).reshape(B, Q, -1)
    if token_masked.shape[-1] != num_image_tokens:
        raise ValueError(f"{token_masked.shape[-1]} patches for "
                         f"{num_image_tokens} image tokens")
    return token_masked


def build_mask_reader_mask(mask_logits: torch.Tensor, patch_size: int,
                           num_image_tokens: int) -> torch.Tensor:
    """Split-stream MaskCLIP mask, bool [B, Q, 1+N]; True = masked out.

    Column 0 is the class token and is never masked; columns 1..N mask the
    patches outside each predicted mask (``mask_logits`` [B, Q, S, S]).
    """
    token_masked = _token_masked(mask_logits, patch_size, num_image_tokens)
    cls_col = torch.zeros(token_masked.shape[:2] + (1,), dtype=torch.bool,
                          device=token_masked.device)
    return torch.cat([cls_col, token_masked], dim=-1)
