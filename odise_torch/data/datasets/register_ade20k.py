"""ADE20K registration (counterpart of
``odise_tpu/data/datasets/register_ade20k.py``): the A-150 panoptic and
semantic validation sets, the 100-thing instance splits and the A-847 full
semantic validation set (16-bit TIFF labels, ignore 65535); and
``load_sem_seg``, the image and label pairs of a semantic dataset.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from ..catalog import DatasetCatalog, MetadataCatalog
from .register_coco import get_dataset_root, load_coco_instances_json

_METADATA_DIR = os.path.join(os.path.dirname(__file__), "metadata")


def ade150_categories() -> List[dict]:
    with open(os.path.join(_METADATA_DIR, "ade20k_150_categories.json")) as f:
        return json.load(f)


def ade150_meta() -> Dict:
    cats = ade150_categories()
    meta = {
        "thing_classes": [c["name"] for c in cats if c["isthing"]],
        "stuff_classes": [c["name"] for c in cats],
        "thing_dataset_id_to_contiguous_id": {},
        "stuff_dataset_id_to_contiguous_id": {},
        "categories": [{"id": c["id"], "isthing": c["isthing"], "name": c["name"]}
                       for c in cats],
    }
    for i, c in enumerate(cats):
        if c["isthing"]:
            meta["thing_dataset_id_to_contiguous_id"][c["id"]] = i
        meta["stuff_dataset_id_to_contiguous_id"][c["id"]] = i
    return meta


def ade_instance_meta() -> Dict:
    """The 100 instance classes: the ``isthing`` rows of the A-150 table."""
    things = [c for c in ade150_categories() if c["isthing"]]
    return {"thing_classes": [c["name"] for c in things],
            "thing_dataset_id_to_contiguous_id": {c["id"]: i for i, c in enumerate(things)}}


def load_ade_panoptic_json(json_file: str, image_dir: str, gt_dir: str, semseg_dir: str,
                           meta: Dict) -> List[dict]:
    with open(json_file) as f:
        info = json.load(f)
    id_map = meta["stuff_dataset_id_to_contiguous_id"]
    ret = []
    for ann in info["annotations"]:
        stem = os.path.splitext(ann["file_name"])[0]
        ret.append({
            "file_name": os.path.join(image_dir, stem + ".jpg"),
            "image_id": ann["image_id"],
            "pan_seg_file_name": os.path.join(gt_dir, ann["file_name"]),
            "sem_seg_file_name": os.path.join(semseg_dir, stem + ".png"),
            "segments_info": [dict(seg, category_id=id_map[seg["category_id"]])
                              for seg in ann["segments_info"]],
        })
    return ret


def load_sem_seg(image_dir: str, gt_dir: str, image_ext: str = "jpg",
                 gt_ext: str = "png") -> List[dict]:
    """(image, label) record pairs by shared base name, as detectron2's
    ``load_sem_seg``; none where ``gt_dir`` is absent."""
    if not os.path.isdir(gt_dir):
        return []
    return [{"file_name": os.path.join(image_dir, os.path.splitext(g)[0] + "." + image_ext),
             "sem_seg_file_name": os.path.join(gt_dir, g)}
            for g in sorted(f for f in os.listdir(gt_dir) if f.endswith(gt_ext))]


def register_ade20k(root: Optional[str] = None) -> None:
    root = root or get_dataset_root()
    ade = os.path.join(root, "ADEChallengeData2016")
    meta = ade150_meta()

    name = "ade20k_panoptic_val"
    image_dir = os.path.join(ade, "images", "validation")
    gt_dir = os.path.join(ade, "ade20k_panoptic_val")
    json_file = os.path.join(ade, "ade20k_panoptic_val.json")
    semseg_dir = os.path.join(ade, "annotations_detectron2", "validation")
    if name not in DatasetCatalog:
        DatasetCatalog.register(name, lambda: load_ade_panoptic_json(
            json_file, image_dir, gt_dir, semseg_dir, meta))
    # the instance json is the instance task's ground truth on this split
    MetadataCatalog.get(name).set(
        panoptic_root=gt_dir, image_root=image_dir, panoptic_json=json_file,
        sem_seg_root=semseg_dir, ignore_label=255, label_divisor=1000,
        json_file=os.path.join(ade, "ade20k_instance_val.json"),
        evaluator_type="ade20k_panoptic_seg", **meta)

    name = "ade20k_sem_seg_val"
    if name not in DatasetCatalog:
        DatasetCatalog.register(name, lambda: load_sem_seg(image_dir, semseg_dir))
    MetadataCatalog.get(name).set(
        stuff_classes=[c["name"] for c in ade150_categories()],
        image_root=image_dir, sem_seg_root=semseg_dir, ignore_label=255,
        evaluator_type="sem_seg")

    inst_meta = ade_instance_meta()
    for split, img_sub in (("train", "training"), ("val", "validation")):
        name = f"ade20k_instance_{split}"
        inst_json = os.path.join(ade, f"ade20k_instance_{split}.json")
        inst_img_dir = os.path.join(ade, "images", img_sub)
        if name not in DatasetCatalog:
            DatasetCatalog.register(name, (lambda jf=inst_json, im=inst_img_dir:
                                           load_coco_instances_json(
                                               jf, im,
                                               inst_meta["thing_dataset_id_to_contiguous_id"])))
        MetadataCatalog.get(name).set(
            image_root=inst_img_dir, json_file=inst_json, ignore_label=255,
            evaluator_type="coco_instance_seg", **inst_meta)

    name = "ade20k_full_sem_seg_val"
    img847 = os.path.join(root, "ADE20K_2021_17_01", "images_detectron2", "val")
    gt847 = os.path.join(root, "ADE20K_2021_17_01", "annotations_detectron2", "val")
    if name not in DatasetCatalog:
        DatasetCatalog.register(name, lambda: load_sem_seg(img847, gt847, gt_ext="tif"))
    MetadataCatalog.get(name).set(
        image_root=img847, sem_seg_root=gt847, ignore_label=65535, evaluator_type="sem_seg")


register_ade20k()
