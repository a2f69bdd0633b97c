"""The training mapper: record -> fixed-shape tensors (counterpart of
``odise_tpu/data/dataset_mapper.py``).

A record holds its image and panoptic ids in memory (``image`` [H, W, 3]
uint8 and ``pan_seg`` [H, W] segment ids, as
``data/synthetic.make_shapes_records`` makes them) or names their files
(``file_name``, read by ``image_io.read_image`` onto the mapper's device,
and ``pan_seg_file_name``, an RGB PNG read by ``read_rgb_png`` and
``rgb2id``), as the registered datasets do. The LSJ augmentations run on
the mapper's device, and the targets are built there: per segment a binary
mask, padded to ``max_instances`` with a validity flag, as the JAX mapper
pads them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..model_zoo.factory import resolve_device
from ..models.clip.tokenizer import tokenize
from .image_io import read_image, read_rgb_png
from .transforms import AugInput, FixedSizeCrop, RandomFlip, ResizeScale, rgb2id

__all__ = ["COCOPanopticDatasetMapper", "collate", "default_lsj_augmentations"]


def default_lsj_augmentations(image_size: int = 1024):
    """The LSJ recipe: flip, scale in [0.1, 2.0] of the size, crop or pad."""
    return [RandomFlip(0.5), ResizeScale(0.1, 2.0, image_size, image_size),
            FixedSizeCrop((image_size, image_size))]


@dataclasses.dataclass
class COCOPanopticDatasetMapper:
    """Map a record to tensors on ``device`` (default CUDA):

      image [S, S, 3] float32 in [0, 1]; gt_labels [T] int64, gt_masks
      [T, S, S] bool, gt_valid [T] bool; with captions also word_tokens
      [num_words, 77] int64 and word_valid [num_words] bool.

    ``is_train=False`` maps the record without the augmentations.
    """

    image_size: int = 1024
    max_instances: int = 100
    with_captions: bool = False
    num_words: int = 8
    word_dropout: float = 0.0
    augmentations: Optional[list] = None
    is_train: bool = True
    seed: int = 0
    device: Optional[object] = None

    def __post_init__(self):
        if self.augmentations is None:
            self.augmentations = default_lsj_augmentations(self.image_size)
        self.device = resolve_device(self.device)

    def __call__(self, record: Dict, rng: Optional[np.random.RandomState] = None) -> Dict:
        """``rng`` draws the augmentations and caption words (default: a
        fresh one from ``seed``, as in the JAX mapper)."""
        rng = rng or np.random.RandomState(self.seed)
        dev = self.device
        if "image" in record:
            image = torch.as_tensor(np.asarray(record["image"]), device=dev)
        else:
            image = read_image(record["file_name"], dev)
        pan_seg = None
        if "pan_seg" in record:
            pan_seg = np.asarray(record["pan_seg"])
        elif "pan_seg_file_name" in record:
            pan_seg = rgb2id(read_rgb_png(record["pan_seg_file_name"]))
        if pan_seg is not None:
            pan_seg = torch.as_tensor(pan_seg.astype(np.int64), device=dev)
        ai = AugInput(image=image, pan_seg=pan_seg)
        if self.is_train:
            for aug in self.augmentations:
                ai = aug(ai, rng)
        out: Dict = {"image": ai.image.float() / 255.0}
        pan_seg = ai.pan_seg
        T = self.max_instances
        S_h, S_w = ai.image.shape[:2]
        gt_labels = torch.zeros((T,), dtype=torch.long, device=dev)
        gt_masks = torch.zeros((T, S_h, S_w), dtype=torch.bool, device=dev)
        gt_valid = torch.zeros((T,), dtype=torch.bool, device=dev)
        segments = [s for s in record.get("segments_info", ()) if not s.get("iscrowd", 0)]
        if pan_seg is not None and segments:
            ids = torch.tensor([s["id"] for s in segments], device=dev)
            masks = pan_seg == ids[:, None, None]
            # the segments the crop kept, in one reduction and one read
            kept = [i for i, p in enumerate(masks.flatten(1).any(1).tolist()) if p][:T]
            n = len(kept)
            gt_labels[:n] = torch.tensor([segments[i]["category_id"] for i in kept], device=dev)
            gt_masks[:n] = masks[kept]
            gt_valid[:n] = True
        out.update(gt_labels=gt_labels, gt_masks=gt_masks, gt_valid=gt_valid)

        if self.with_captions:
            words: List[str] = []
            # words extracted offline (noun phrases), else the raw captions
            for key in ("words", "captions"):
                if key in record and record[key]:
                    words = list(record[key])
                    break
            chosen = []
            for _ in range(self.num_words):
                if words and (self.word_dropout <= 0 or rng.rand() >= self.word_dropout):
                    chosen.append(words[rng.randint(len(words))])
                else:
                    chosen.append("")
            out["word_tokens"] = torch.as_tensor(tokenize(chosen).astype(np.int64),
                                                 device=dev)
            out["word_valid"] = torch.tensor([bool(w) for w in chosen], device=dev)
        return out


def collate(samples: Sequence[Dict]) -> Dict[str, torch.Tensor]:
    """Stack mapped samples into batch tensors."""
    return {k: torch.stack([s[k] for s in samples]) for k in samples[0]}
