"""COCO panoptic (with captions) registration (counterpart of
``odise_tpu/data/datasets/register_coco.py``): registers
``coco_2017_{train,val}_panoptic_with_sem_seg`` and the caption split
``coco_2017_train_panoptic_caption_with_sem_seg``, with thing and stuff
metadata and the maps from dataset to contiguous ids.

The dataset root is ``$DETECTRON2_DATASETS``, else ``$ODISE_TPU_DATASETS``,
else ``datasets`` (relative to the working directory). Records load when a
dataset is first read.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from ..build import coco_panoptic_categories
from ..catalog import DatasetCatalog, MetadataCatalog


def get_dataset_root() -> str:
    return os.environ.get(
        "DETECTRON2_DATASETS", os.environ.get("ODISE_TPU_DATASETS", "datasets"))


def coco_meta() -> Dict:
    cats = coco_panoptic_categories()
    meta = {
        "thing_classes": [c["name"] for c in cats if c["isthing"]],
        "stuff_classes": [c["name"] for c in cats],  # stuff includes things
        "thing_dataset_id_to_contiguous_id": {},
        "stuff_dataset_id_to_contiguous_id": {},
        "categories": cats,
    }
    for i, cat in enumerate(cats):
        if cat["isthing"]:
            meta["thing_dataset_id_to_contiguous_id"][cat["id"]] = i
        meta["stuff_dataset_id_to_contiguous_id"][cat["id"]] = i
    return meta


def load_coco_panoptic_json(json_file: str, image_dir: str, gt_dir: str, semseg_dir: str,
                            meta: Dict, caption_json: Optional[str] = None) -> List[dict]:
    """Panoptic json -> records with contiguous category ids (and the
    image's captions where ``caption_json`` exists)."""
    with open(json_file) as f:
        info = json.load(f)
    id_map = {cat["id"]: meta["stuff_dataset_id_to_contiguous_id"][cat["id"]]
              for cat in meta["categories"]}
    captions_by_image: Dict[int, List[str]] = {}
    if caption_json and os.path.isfile(caption_json):
        with open(caption_json) as f:
            for ann in json.load(f)["annotations"]:
                captions_by_image.setdefault(ann["image_id"], []).append(ann["caption"])
    ret = []
    for ann in info["annotations"]:
        image_id = int(ann["image_id"])
        stem = os.path.splitext(ann["file_name"])[0]
        rec = {
            "file_name": os.path.join(image_dir, stem + ".jpg"),
            "image_id": image_id,
            "pan_seg_file_name": os.path.join(gt_dir, ann["file_name"]),
            "sem_seg_file_name": os.path.join(semseg_dir, stem + ".png"),
            "segments_info": [dict(seg, category_id=id_map[seg["category_id"]])
                              for seg in ann["segments_info"]],
        }
        if image_id in captions_by_image:
            rec["captions"] = captions_by_image[image_id]
        ret.append(rec)
    return ret


def load_coco_instances_json(json_file: str, image_dir: str,
                             id_map: Dict[int, int]) -> List[dict]:
    """COCO instance json -> records with ``annotations`` (category ids
    through ``id_map``, ``segmentation`` left in its COCO encoding for
    ``data.coco_mask``), as detectron2's ``load_coco_json``."""
    with open(json_file) as f:
        info = json.load(f)
    anns_by_image: Dict[int, List[dict]] = {}
    for ann in info.get("annotations", []):
        if ann.get("category_id") not in id_map:
            continue
        anns_by_image.setdefault(int(ann["image_id"]), []).append({
            "category_id": id_map[ann["category_id"]],
            "segmentation": ann.get("segmentation"),
            "bbox": ann.get("bbox"),
            "iscrowd": int(ann.get("iscrowd", 0)),
            "area": ann.get("area"),
        })
    images = {im["id"]: im for im in info["images"]}
    return [{"file_name": os.path.join(image_dir, im["file_name"]),
             "image_id": int(image_id),
             "height": int(im["height"]),
             "width": int(im["width"]),
             "annotations": anns_by_image.get(int(image_id), [])}
            for image_id, im in sorted(images.items())]


def load_instance_gt_index(json_file: str, id_map: Dict[int, int]) -> Dict[int, List[dict]]:
    """image_id -> its annotations (category id through ``id_map``,
    ``segmentation``, ``iscrowd``), the evaluation's instance ground truth."""
    with open(json_file) as f:
        info = json.load(f)
    out: Dict[int, List[dict]] = {}
    for ann in info.get("annotations", []):
        if ann.get("category_id") not in id_map:
            continue
        out.setdefault(int(ann["image_id"]), []).append({
            "category_id": id_map[ann["category_id"]],
            "segmentation": ann.get("segmentation"),
            "iscrowd": int(ann.get("iscrowd", 0)),
        })
    return out


def register_coco_panoptic(root: Optional[str] = None) -> None:
    """Register the three COCO names under ``root`` (default
    ``get_dataset_root()``); a name already registered keeps its loader."""
    root = root or get_dataset_root()
    meta = coco_meta()
    coco = os.path.join(root, "coco")
    for split in ("train", "val"):
        name = f"coco_2017_{split}_panoptic_with_sem_seg"
        json_file = os.path.join(coco, "annotations", f"panoptic_{split}2017.json")
        image_dir = os.path.join(coco, f"{split}2017")
        gt_dir = os.path.join(coco, f"panoptic_{split}2017")
        semseg_dir = os.path.join(coco, f"panoptic_semseg_{split}2017")
        if name not in DatasetCatalog:
            DatasetCatalog.register(
                name, (lambda jf=json_file, im=image_dir, gt=gt_dir, ss=semseg_dir:
                       load_coco_panoptic_json(jf, im, gt, ss, meta)))
        # the instances json is the instance task's ground truth
        MetadataCatalog.get(name).set(
            panoptic_root=gt_dir, image_root=image_dir, panoptic_json=json_file,
            sem_seg_root=semseg_dir, ignore_label=255, label_divisor=1000,
            json_file=os.path.join(coco, "annotations", f"instances_{split}2017.json"),
            evaluator_type="coco_panoptic_seg", **meta)

    name = "coco_2017_train_panoptic_caption_with_sem_seg"
    json_file = os.path.join(coco, "annotations", "panoptic_train2017.json")
    caption_json = os.path.join(coco, "annotations", "captions_train2017.json")
    image_dir = os.path.join(coco, "train2017")
    gt_dir = os.path.join(coco, "panoptic_train2017")
    semseg_dir = os.path.join(coco, "panoptic_semseg_train2017")
    if name not in DatasetCatalog:
        DatasetCatalog.register(
            name, (lambda jf=json_file, im=image_dir, gt=gt_dir, ss=semseg_dir, cj=caption_json:
                   load_coco_panoptic_json(jf, im, gt, ss, meta, caption_json=cj)))
    MetadataCatalog.get(name).set(
        panoptic_root=gt_dir, image_root=image_dir, panoptic_json=json_file,
        sem_seg_root=semseg_dir, ignore_label=255, label_divisor=1000,
        evaluator_type="coco_panoptic_seg", **meta)


register_coco_panoptic()
