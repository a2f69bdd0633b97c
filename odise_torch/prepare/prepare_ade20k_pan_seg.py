"""ADE20K panoptic annotations (counterpart of
``datasets/prepare_ade20k_pan_seg.py``).

    python -m odise_torch.prepare.prepare_ade20k_pan_seg [root]

Combines ``ADEChallengeData2016``'s validation semantic PNGs (class id + 1,
0 unlabeled) and instance PNGs (R the thing class among the 100, G the
instance) into panoptic PNGs under ``ade20k_panoptic_val/`` and
``ade20k_panoptic_val.json`` (panopticapi's format, contiguous A-150
category ids), which ``ade20k_panoptic_val`` reads. Stuff segments come
from the semantic map, thing segments from the instance map.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from ..data.datasets.register_ade20k import ade150_categories
from ..data.image_io import read_label, write_png
from ..data.transforms import id2rgb


def main(root: str) -> None:
    base = os.path.join(root, "ADEChallengeData2016")
    cats = ade150_categories()
    thing_cats = [j for j, c in enumerate(cats) if c["isthing"]]
    sem_dir = os.path.join(base, "annotations", "validation")
    inst_dir = os.path.join(base, "annotations_instance", "validation")
    out_dir = os.path.join(base, "ade20k_panoptic_val")
    os.makedirs(out_dir, exist_ok=True)
    if not os.path.isdir(inst_dir):
        print(f"missing {inst_dir}; download ADE instance annotations first")
        return

    images, annotations = [], []
    for i, fname in enumerate(sorted(os.listdir(sem_dir))):
        sem = read_label(os.path.join(sem_dir, fname))
        inst = read_label(os.path.join(inst_dir, fname))
        pan = np.zeros(sem.shape, np.uint32)
        segments_info = []
        next_id = 1
        for cid in np.unique(sem):
            if cid == 0 or cats[cid - 1]["isthing"]:
                continue
            mask = sem == cid
            pan[mask] = next_id
            segments_info.append({"id": next_id, "category_id": int(cid - 1),
                                  "iscrowd": 0, "area": int(mask.sum())})
            next_id += 1
        r, g = inst[..., 0], inst[..., 1]
        # the same set, in the same order, as the JAX script iterates
        for (tc, ti) in {(int(a), int(b)) for a, b in zip(r[g > 0].ravel(), g[g > 0].ravel())}:
            if tc - 1 >= len(thing_cats):
                continue
            mask = (r == tc) & (g == ti)
            pan[mask] = next_id
            segments_info.append({"id": next_id, "category_id": thing_cats[tc - 1],
                                  "iscrowd": 0, "area": int(mask.sum())})
            next_id += 1
        write_png(os.path.join(out_dir, fname), id2rgb(pan))
        stem = os.path.splitext(fname)[0]
        images.append({"id": stem, "file_name": fname.replace(".png", ".jpg"),
                       "height": int(sem.shape[0]), "width": int(sem.shape[1])})
        annotations.append({"image_id": stem, "file_name": fname,
                            "segments_info": segments_info})
        if (i + 1) % 500 == 0:
            print(f"{i + 1} images")
    with open(os.path.join(base, "ade20k_panoptic_val.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": j, "name": c["name"], "isthing": c["isthing"]}
                                  for j, c in enumerate(cats)]}, f)
    print("done")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.environ.get("DETECTRON2_DATASETS", "datasets"))
