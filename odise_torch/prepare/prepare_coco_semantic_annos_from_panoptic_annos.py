"""COCO's semantic maps from its panoptic annotations (counterpart of
``datasets/prepare_coco_semantic_annos_from_panoptic_annos.py``).

    python -m odise_torch.prepare.prepare_coco_semantic_annos_from_panoptic_annos [root]

For the val and train splits: each panoptic PNG of
``coco/panoptic_{split}2017`` becomes a gray PNG of contiguous category
ids (255 void) in ``coco/panoptic_semseg_{split}2017``, which
``coco_2017_{split}_panoptic_with_sem_seg`` reads for training.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from ..data.datasets.register_coco import coco_meta
from ..data.image_io import read_label, write_png
from ..data.transforms import rgb2id


def process_split(root: str, split: str) -> None:
    meta = coco_meta()
    id_map = {c["id"]: meta["stuff_dataset_id_to_contiguous_id"][c["id"]]
              for c in meta["categories"]}
    ann_file = os.path.join(root, "coco", "annotations", f"panoptic_{split}2017.json")
    pan_dir = os.path.join(root, "coco", f"panoptic_{split}2017")
    out_dir = os.path.join(root, "coco", f"panoptic_semseg_{split}2017")
    os.makedirs(out_dir, exist_ok=True)
    with open(ann_file) as f:
        info = json.load(f)
    for i, ann in enumerate(info["annotations"]):
        pan_ids = rgb2id(read_label(os.path.join(pan_dir, ann["file_name"])))
        sem = np.full(pan_ids.shape, 255, np.uint8)
        for seg in ann["segments_info"]:
            sem[pan_ids == seg["id"]] = id_map[seg["category_id"]]
        write_png(os.path.join(out_dir, ann["file_name"]), sem)
        if (i + 1) % 5000 == 0:
            print(f"{split}: {i + 1}/{len(info['annotations'])}")
    print("wrote", out_dir)


def main(root: str) -> None:
    for split in ("val", "train"):
        process_split(root, split)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.environ.get("DETECTRON2_DATASETS", "datasets"))
