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

A record is mapped in two stages, ``augment(record, read(record), rng)``:
``read`` does the deterministic host work (file bytes, PNG decoding,
``rgb2id``) and touches no device, so a worker process can run it ahead of
the step (``loader.build_grain_train_loader``); ``augment`` draws from
``rng`` and runs on the device, in order on the consuming thread. On a
CUDA device a JPEG is decoded there, on a side stream (one a device in the
process) that the current stream then waits for.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..model_zoo.factory import resolve_device
from ..models.clip.tokenizer import tokenize
from .image_io import EncodedJpeg, image_to_device, load_image, read_rgb_png
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
        return self.augment(record, self.read(record), rng)

    def read(self, record: Dict) -> Dict:
        """The record's host reads, which draw nothing and touch no device:
        ``image`` (pixels, or a JPEG's ``EncodedJpeg`` bytes) and
        ``pan_seg`` (segment ids, or None)."""
        if "image" in record:
            image = np.asarray(record["image"])
        else:
            image = load_image(record["file_name"])
        pan_seg = None
        if "pan_seg" in record:
            pan_seg = np.asarray(record["pan_seg"])
        elif "pan_seg_file_name" in record:
            pan_seg = rgb2id(read_rgb_png(record["pan_seg_file_name"]))
        return {"image": image, "pan_seg": pan_seg}

    def augment(self, record: Dict, read: Dict,
                rng: Optional[np.random.RandomState] = None) -> Dict:
        """Map ``record`` from its ``read`` result: the augmentations, the
        targets and the caption words, drawn from ``rng`` (default: a fresh
        one from ``seed``)."""
        rng = rng or np.random.RandomState(self.seed)
        dev = self.device
        image = self._image_to_device(read["image"])
        pan_seg = read["pan_seg"]
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

    def _image_to_device(self, image) -> torch.Tensor:
        dev = self.device
        if not (isinstance(image, EncodedJpeg) and dev.type == "cuda"):
            return image_to_device(image, dev)
        # nvJPEG on a side stream: the decode does not queue behind the
        # steps still on the current stream
        side = _side_streams.get(dev)
        if side is None:
            side = _side_streams.setdefault(dev, torch.cuda.Stream(dev))
        current = torch.cuda.current_stream(dev)
        with torch.cuda.stream(side):
            out = image_to_device(image, dev)
        current.wait_stream(side)
        out.record_stream(current)
        return out


# device -> the stream the mappers of this process decode JPEGs on (not held
# by the mapper, which is pickled to the loader's worker processes)
_side_streams: Dict[torch.device, "torch.cuda.Stream"] = {}


def collate(samples: Sequence[Dict]) -> Dict[str, torch.Tensor]:
    """Stack mapped samples into batch tensors."""
    return {k: torch.stack([s[k] for s in samples]) for k in samples[0]}
