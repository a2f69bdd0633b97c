"""Augmentations, resizes and panoptic id codecs (counterpart of
``odise_tpu/data/transforms.py``), in PyTorch instead of cv2: the LSJ
training recipe (``RandomFlip``, ``ResizeScale``, ``FixedSizeCrop``) and
the eval resize (``ResizeShortestEdge``), on tensors of any device, with
their random draws from the same ``np.random.RandomState`` calls as the JAX
package's, so that one seed gives one flip, scale and crop window.

The JAX package resizes with cv2: ``INTER_LINEAR`` for images and
``INTER_NEAREST`` for label maps. Here:

* images and probability maps: bilinear ``F.interpolate`` with
  ``align_corners=False, antialias=False``, which is cv2's ``INTER_LINEAR``
  (cv2 does not antialias). An image is rounded back to uint8; cv2 weights
  uint8 pixels in fixed point, so the two differ by at most one level.
* label maps and masks: a gather at ``floor(dst * (1 / (out / in)))``,
  the source index cv2's ``INTER_NEAREST`` computes in double precision.
  ``F.interpolate(mode="nearest")`` takes the same floor but of a float32
  scale, and lands one pixel off for some shape pairs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[..., H, W] float -> [..., h, w] float32 (cv2 ``INTER_LINEAR``)."""
    lead = x.shape[:-2]
    y = x.reshape((-1, 1) + tuple(x.shape[-2:])).float()
    y = F.interpolate(y, size=(h, w), mode="bilinear", align_corners=False,
                      antialias=False)
    return y.reshape(tuple(lead) + (h, w))


def resize_image(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[H, W, C] uint8 -> [h, w, C] uint8, bilinear."""
    y = resize_bilinear(img.permute(2, 0, 1), h, w)
    return y.round_().clamp_(0, 255).to(torch.uint8).permute(1, 2, 0).contiguous()


def _nearest_index(n_out: int, n_in: int, device) -> torch.Tensor:
    scale = 1.0 / (n_out / n_in)
    idx = torch.floor(torch.arange(n_out, dtype=torch.float64, device=device) * scale)
    return idx.long().clamp_(max=n_in - 1)


def resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[..., H, W] of any dtype -> [..., h, w] (cv2 ``INTER_NEAREST``)."""
    iy = _nearest_index(h, x.shape[-2], x.device)
    ix = _nearest_index(w, x.shape[-1], x.device)
    return x[..., iy[:, None], ix[None, :]]


@dataclasses.dataclass
class AugInput:
    image: torch.Tensor                     # [H, W, 3] uint8
    sem_seg: Optional[torch.Tensor] = None  # [H, W] int
    pan_seg: Optional[torch.Tensor] = None  # [H, W] int (rgb2id'd)

    def apply(self, img_fn, seg_fn):
        self.image = img_fn(self.image)
        if self.sem_seg is not None:
            self.sem_seg = seg_fn(self.sem_seg)
        if self.pan_seg is not None:
            self.pan_seg = seg_fn(self.pan_seg)
        return self


class RandomFlip:
    def __init__(self, prob: float = 0.5, horizontal: bool = True):
        self.prob = prob
        self.horizontal = horizontal

    def __call__(self, ai: AugInput, rng: np.random.RandomState) -> AugInput:
        if rng.rand() < self.prob:
            ax = 1 if self.horizontal else 0
            return ai.apply(lambda x: torch.flip(x, (ax,)), lambda x: torch.flip(x, (ax,)))
        return ai


class ResizeScale:
    """Scale by U(min_scale, max_scale) relative to a target size (LSJ)."""

    def __init__(self, min_scale: float, max_scale: float,
                 target_height: int, target_width: int):
        self.min_scale, self.max_scale = min_scale, max_scale
        self.th, self.tw = target_height, target_width

    def __call__(self, ai: AugInput, rng: np.random.RandomState) -> AugInput:
        scale = rng.uniform(self.min_scale, self.max_scale)
        h, w = ai.image.shape[:2]
        out_scale = min(self.th * scale / h, self.tw * scale / w)
        nh, nw = max(1, int(h * out_scale + 0.5)), max(1, int(w * out_scale + 0.5))
        return ai.apply(lambda x: resize_image(x, nh, nw),
                        lambda x: resize_nearest(x, nh, nw))


class FixedSizeCrop:
    """Random crop (where larger) then pad (where smaller) to a fixed size."""

    def __init__(self, crop_size, pad_value: float = 128.0, seg_pad_value: int = 0):
        self.ch, self.cw = crop_size
        self.pad_value = pad_value
        self.seg_pad_value = seg_pad_value

    def __call__(self, ai: AugInput, rng: np.random.RandomState) -> AugInput:
        h, w = ai.image.shape[:2]
        y0 = rng.randint(0, max(h - self.ch, 0) + 1)
        x0 = rng.randint(0, max(w - self.cw, 0) + 1)

        def crop_pad(x, pad_val):
            x = x[y0:y0 + self.ch, x0:x0 + self.cw]
            out = x.new_full((self.ch, self.cw) + tuple(x.shape[2:]), pad_val)
            out[:x.shape[0], :x.shape[1]] = x
            return out

        ai.image = crop_pad(ai.image, self.pad_value)
        if ai.sem_seg is not None:
            ai.sem_seg = crop_pad(ai.sem_seg, self.seg_pad_value)
        if ai.pan_seg is not None:
            ai.pan_seg = crop_pad(ai.pan_seg, 0)
        return ai


class ResizeShortestEdge:
    """Resize the shorter side to ``short``, capping the longer at ``max_size``."""

    def __init__(self, short: int, max_size: int = 2560):
        self.short, self.max_size = short, max_size

    def output_size(self, h: int, w: int):
        scale = self.short / min(h, w)
        if max(h, w) * scale > self.max_size:
            scale = self.max_size / max(h, w)
        return int(h * scale + 0.5), int(w * scale + 0.5)

    def __call__(self, ai: AugInput, rng=None) -> AugInput:
        nh, nw = self.output_size(*ai.image.shape[:2])
        return ai.apply(lambda x: resize_image(x, nh, nw),
                        lambda x: resize_nearest(x, nh, nw))


def rgb2id(color: np.ndarray) -> np.ndarray:
    """Panoptic png RGB -> segment id (panopticapi convention)."""
    color = color.astype(np.uint32)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


def id2rgb(ids: np.ndarray) -> np.ndarray:
    """Segment id map -> RGB png (inverse of rgb2id)."""
    ids = ids.astype(np.uint32)
    return np.stack([ids % 256, (ids // 256) % 256, (ids // 65536) % 256],
                    axis=-1).astype(np.uint8)
