"""Label vocabularies and prompt templates (counterpart of
``odise_tpu/data/build.py``).

The port carries its own copy of the JAX package's label files
(``datasets/openseg_labels``: COCO panoptic, ADE20K-150 and -847, Pascal
Context 59 and 459, Pascal VOC 21 and LVIS 1203, plain and with prompt
engineering) and of its category metadata (``datasets/metadata``).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(__file__), "datasets")
_LABEL_DIR = os.path.join(_DATA_DIR, "openseg_labels")

PROMPT_TEMPLATES = {
    None: "{}",
    "a": "a {}",
    "photo": "a photo of a {}.",
    "scene": "a photo of a {} in the scene.",
}


def get_openseg_labels(dataset: str, prompt_engineered: bool = False) -> List[List[str]]:
    """Parse an openseg label file (``id:name1,name2,...``) into a list of
    synonym lists, skipping the ``invalid_class_id`` placeholder rows."""
    available = [
        "ade20k_150",
        "ade20k_847",
        "coco_panoptic",
        "pascal_context_59",
        "pascal_context_459",
        "pascal_voc_21",
        "lvis_1203",
    ]
    assert dataset in available, f"{dataset} not in {available}"
    filename = os.path.join(
        _LABEL_DIR, f"{dataset}_with_prompt_eng.txt" if prompt_engineered else f"{dataset}.txt")
    if not os.path.isfile(filename):
        raise FileNotFoundError(f"the port carries no label file for {dataset}: {filename}")
    with open(filename) as f:
        lines = [l.strip() for l in f if l.strip()]
    categories = []
    for line in lines:
        _, names = line.split(":", 1)
        if names == "invalid_class_id":
            continue
        categories.append([n.strip() for n in names.split(",")])
    return categories


def prompt_labels(labels: List[List[str]], prompt: Optional[str]) -> List[List[str]]:
    """Apply a prompt template to every synonym."""
    if prompt is None:
        return labels
    template = PROMPT_TEMPLATES[prompt]
    return [[template.format(l) for l in syns] for syns in labels]


def coco_panoptic_categories() -> List[dict]:
    """COCO panoptic's 133 categories (``id``, ``isthing``, ``name``), in the
    order of ``get_openseg_labels("coco_panoptic")``."""
    with open(os.path.join(_DATA_DIR, "metadata", "coco_panoptic_categories.json")) as f:
        return json.load(f)


def coco_panoptic_thing_mask() -> np.ndarray:
    """[133] bool: True where the COCO panoptic category is a thing."""
    return np.asarray([bool(c["isthing"]) for c in coco_panoptic_categories()])
