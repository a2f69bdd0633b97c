"""COCO panoptic's 133 prompt-engineered label groups and which are things,
read from the copies under ``perfbench/data`` (the harness hands the same
labels to the program)."""

import json
import os
from typing import Tuple

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
PROMPT = "a photo of a {}."  # the port's "photo" template


def coco_panoptic_labels() -> Tuple[Tuple[str, ...], ...]:
    """Synonym groups, one per category, in the categories' order."""
    out = []
    with open(os.path.join(DATA, "coco_panoptic_with_prompt_eng.txt")) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            names = line.split(":", 1)[1]
            if names != "invalid_class_id":
                out.append(tuple(n.strip() for n in names.split(",")))
    return tuple(out)


def coco_panoptic_thing_mask() -> np.ndarray:
    with open(os.path.join(DATA, "coco_panoptic_categories.json")) as f:
        return np.asarray([bool(c["isthing"]) for c in json.load(f)])


def prompted(labels):
    return tuple(tuple(PROMPT.format(n) for n in group) for group in labels)
