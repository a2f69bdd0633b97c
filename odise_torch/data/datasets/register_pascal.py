"""Pascal VOC-21 and Context-59 and -459 semantic registration (counterpart
of ``odise_tpu/data/datasets/register_pascal.py``). Context-459's labels
are 16-bit TIFFs with ignore 65535. Class names are the first synonym of
each openseg label. The prepared layout (``pascal_ctx_d2``,
``pascal_voc_d2``) is taken where it exists, else the ``VOCdevkit`` one.
"""

from __future__ import annotations

import os
from typing import Optional

from ..build import get_openseg_labels
from ..catalog import DatasetCatalog, MetadataCatalog
from .register_ade20k import load_sem_seg
from .register_coco import get_dataset_root


def _first_existing(*candidates: str) -> str:
    for c in candidates:
        if os.path.isdir(c):
            return c
    return candidates[0]


def register_pascal(root: Optional[str] = None) -> None:
    root = root or get_dataset_root()
    voc = os.path.join(root, "VOCdevkit")
    ctx_d2 = os.path.join(root, "pascal_ctx_d2")
    voc_d2 = os.path.join(root, "pascal_voc_d2")
    ctx_images = _first_existing(os.path.join(ctx_d2, "images", "validation"),
                                 os.path.join(voc, "VOC2010", "JPEGImages"))
    sets = [
        ("ctx59_sem_seg_val", ctx_images,
         _first_existing(os.path.join(ctx_d2, "annotations_ctx59", "validation"),
                         os.path.join(voc, "VOC2010", "annotations_detectron2", "pc59_val")),
         "png", 255, "pascal_context_59"),
        ("ctx459_sem_seg_val", ctx_images,
         _first_existing(os.path.join(ctx_d2, "annotations_ctx459", "validation"),
                         os.path.join(voc, "VOC2010", "annotations_detectron2", "pc459_val")),
         "tif", 65535, "pascal_context_459"),
        ("pascal21_sem_seg_val",
         _first_existing(os.path.join(voc_d2, "images", "val"),
                         os.path.join(voc, "VOC2012", "JPEGImages")),
         _first_existing(os.path.join(voc_d2, "annotations_pascal21", "val"),
                         os.path.join(voc, "VOC2012", "annotations_detectron2", "val")),
         "png", 255, "pascal_voc_21"),
    ]
    for name, img_dir, gt_dir, gt_ext, ignore, labels in sets:
        if name not in DatasetCatalog:
            DatasetCatalog.register(name, lambda x=img_dir, y=gt_dir, e=gt_ext:
                                    load_sem_seg(x, y, gt_ext=e))
        MetadataCatalog.get(name).set(
            stuff_classes=[l[0] for l in get_openseg_labels(labels)],
            image_root=img_dir, sem_seg_root=gt_dir, ignore_label=ignore,
            evaluator_type="sem_seg")


register_pascal()
