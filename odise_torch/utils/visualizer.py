"""Panoptic and instance overlays for the demo (counterpart of
``odise_tpu/utils/visualizer.py``).

Colours per category (deterministic), alpha-blended segments and darkened
boundaries in numpy; category names at segment centres are drawn with PIL,
imported only there.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _color_for(cat_id: int) -> np.ndarray:
    rng = np.random.RandomState(cat_id * 7919 + 13)
    return rng.randint(60, 255, 3).astype(np.uint8)


def _boundaries(seg: np.ndarray) -> np.ndarray:
    b = np.zeros(seg.shape, bool)
    b[1:] |= seg[1:] != seg[:-1]
    b[:, 1:] |= seg[:, 1:] != seg[:, :-1]
    return b


class Visualizer:
    def __init__(self, image: np.ndarray,
                 class_names: Optional[Sequence[str]] = None,
                 alpha: float = 0.55):
        self.image = np.asarray(image).astype(np.float32)
        self.class_names = class_names
        self.alpha = alpha

    def draw_panoptic_seg(self, panoptic_seg: np.ndarray,
                          segment_category: Sequence[int],
                          num_segments: int) -> np.ndarray:
        """panoptic_seg [H, W] int ids (0 = void); segment_category[i] is the
        category of segment id i+1. Returns a uint8 overlay image."""
        seg = np.asarray(panoptic_seg)
        out = self.image.copy()
        centers = []
        for sid in range(1, int(num_segments) + 1):
            mask = seg == sid
            if not mask.any():
                continue
            cat = int(segment_category[sid - 1])
            color = _color_for(cat).astype(np.float32)
            out[mask] = (1 - self.alpha) * out[mask] + self.alpha * color
            ys, xs = np.nonzero(mask)
            centers.append((int(xs.mean()), int(ys.mean()), cat))
        out[_boundaries(seg)] *= 0.3
        out = np.clip(out, 0, 255).astype(np.uint8)
        if self.class_names is not None and centers:
            out = self._draw_labels(out, centers)
        return out

    def _draw_labels(self, out: np.ndarray, centers) -> np.ndarray:
        try:
            from PIL import Image, ImageDraw
        except ImportError:  # labels are optional; the overlay stands
            return out
        img = Image.fromarray(out)
        draw = ImageDraw.Draw(img)
        for (x, y, cat) in centers:
            name = self.class_names[cat] if cat < len(self.class_names) else str(cat)
            for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):  # halo
                draw.text((x + dx, y + dy), name, fill=(0, 0, 0))
            draw.text((x, y), name, fill=(255, 255, 255))
        return np.asarray(img)

    def draw_instances(self, masks: np.ndarray, classes: Sequence[int],
                       scores: Sequence[float],
                       score_threshold: float = 0.5) -> np.ndarray:
        """masks [N, H, W] bool; draws the instances above the threshold."""
        seg = np.zeros(self.image.shape[:2], np.int32)
        kept = []
        for i in range(len(masks)):
            if float(scores[i]) < score_threshold:
                continue
            seg[masks[i] & (seg == 0)] = len(kept) + 1
            kept.append(int(classes[i]))
        return self.draw_panoptic_seg(seg, kept, len(kept))
