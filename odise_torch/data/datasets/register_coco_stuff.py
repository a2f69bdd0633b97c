"""COCO-Stuff-10k semantic registration, 171 classes (counterpart of
``odise_tpu/data/datasets/register_coco_stuff.py``); the category table is
``metadata/coco_stuff_categories.json``, and preparation maps the ignore
id 0 to 255.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from ..catalog import DatasetCatalog, MetadataCatalog
from .register_ade20k import load_sem_seg
from .register_coco import get_dataset_root

_METADATA_DIR = os.path.join(os.path.dirname(__file__), "metadata")


def coco_stuff_categories() -> List[dict]:
    with open(os.path.join(_METADATA_DIR, "coco_stuff_categories.json")) as f:
        return json.load(f)


def coco_stuff_meta() -> Dict:
    cats = coco_stuff_categories()
    return {"stuff_classes": [c["name"] for c in cats],
            "stuff_dataset_id_to_contiguous_id": {c["id"]: i for i, c in enumerate(cats)}}


def register_coco_stuff_10k(root: Optional[str] = None) -> None:
    root = os.path.join(root or get_dataset_root(), "coco", "coco_stuff_10k")
    meta = coco_stuff_meta()
    for split in ("train", "test"):
        image_dir = os.path.join(root, "images_detectron2", split)
        gt_dir = os.path.join(root, "annotations_detectron2", split)
        name = f"coco_2017_{split}_stuff_10k_sem_seg"
        if name not in DatasetCatalog:
            DatasetCatalog.register(name, lambda im=image_dir, gt=gt_dir: load_sem_seg(im, gt))
        MetadataCatalog.get(name).set(
            image_root=image_dir, sem_seg_root=gt_dir, ignore_label=255,
            evaluator_type="sem_seg", **meta)


register_coco_stuff_10k()
