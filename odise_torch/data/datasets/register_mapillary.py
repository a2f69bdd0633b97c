"""Mapillary Vistas semantic and panoptic registration (counterpart of
``odise_tpu/data/datasets/register_mapillary.py``). The category tables
are ``metadata/mapillary_vistas_categories.json`` (66 rows, the
non-evaluated "unlabeled" among them) and
``metadata/mapillary_vistas_panoptic_categories.json`` (65 rows). Mapillary
ignores label 65.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from ..catalog import DatasetCatalog, MetadataCatalog
from .register_ade20k import load_ade_panoptic_json, load_sem_seg
from .register_coco import get_dataset_root

_METADATA_DIR = os.path.join(os.path.dirname(__file__), "metadata")


def _categories(name: str) -> List[dict]:
    with open(os.path.join(_METADATA_DIR, name)) as f:
        return json.load(f)


def mapillary_semseg_categories() -> List[dict]:
    return _categories("mapillary_vistas_categories.json")


def mapillary_panoptic_categories() -> List[dict]:
    return _categories("mapillary_vistas_panoptic_categories.json")


def mapillary_semseg_meta() -> Dict:
    cats = [c for c in mapillary_semseg_categories() if c["evaluate"]]
    return {"stuff_classes": [c["readable"] for c in cats],
            "stuff_colors": [c["color"] for c in cats]}


def mapillary_panoptic_meta() -> Dict:
    cats = mapillary_panoptic_categories()
    meta = {
        "thing_classes": [c["name"] for c in cats],
        "thing_colors": [c["color"] for c in cats],
        "stuff_classes": [c["name"] for c in cats],
        "stuff_colors": [c["color"] for c in cats],
        "thing_dataset_id_to_contiguous_id": {},
        "stuff_dataset_id_to_contiguous_id": {},
        "categories": [{"id": c["id"], "isthing": bool(c["isthing"]), "name": c["name"]}
                       for c in cats],
    }
    for i, c in enumerate(cats):
        if c["isthing"]:
            meta["thing_dataset_id_to_contiguous_id"][c["id"]] = i
        # every class is in the stuff map, so that semantic evaluation can
        # read panoptic predictions
        meta["stuff_dataset_id_to_contiguous_id"][c["id"]] = i
    return meta


def register_mapillary_vistas(root: Optional[str] = None) -> None:
    root = os.path.join(root or get_dataset_root(), "mapillary_vistas")
    sem_meta = mapillary_semseg_meta()
    pan_meta = mapillary_panoptic_meta()
    for split, dirname in (("train", "training"), ("val", "validation")):
        image_dir = os.path.join(root, dirname, "images")
        gt_dir = os.path.join(root, dirname, "labels")
        name = f"mapillary_vistas_sem_seg_{split}"
        if name not in DatasetCatalog:
            DatasetCatalog.register(name, lambda im=image_dir, gt=gt_dir: load_sem_seg(im, gt))
        MetadataCatalog.get(name).set(
            image_root=image_dir, sem_seg_root=gt_dir, ignore_label=65,
            evaluator_type="sem_seg", **sem_meta)

        name = f"mapillary_vistas_panoptic_{split}"
        pan_dir = os.path.join(root, dirname, "panoptic")
        pan_json = os.path.join(pan_dir, "panoptic_2018.json")
        if name not in DatasetCatalog:
            DatasetCatalog.register(name, (lambda jf=pan_json, im=image_dir, gt=pan_dir,
                                           ss=gt_dir: load_ade_panoptic_json(
                                               jf, im, gt, ss, pan_meta)))
        MetadataCatalog.get(name).set(
            panoptic_root=pan_dir, image_root=image_dir, panoptic_json=pan_json,
            sem_seg_root=gt_dir, ignore_label=65, label_divisor=1000,
            evaluator_type="mapillary_vistas_panoptic_seg", **pan_meta)


register_mapillary_vistas()
