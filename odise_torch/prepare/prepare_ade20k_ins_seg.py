"""ADE20K instance annotations to a COCO-style json (counterpart of
``datasets/prepare_ade20k_ins_seg.py``).

    python -m odise_torch.prepare.prepare_ade20k_ins_seg [root]

Reads ``ADEChallengeData2016/annotations_instance/validation/*.png`` (R
the thing class among the 100, G the instance) and writes
``ade20k_instance_val.json``: per instance its A-150 category (the
instance class n is the n-th thing of the A-150 table, as the reference's
mapping file has it), area, box and the PNG and (R, G) key that hold its
mask.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from ..data.datasets.register_ade20k import ade150_categories
from ..data.image_io import read_label


def main(root: str) -> None:
    base = os.path.join(root, "ADEChallengeData2016")
    inst_dir = os.path.join(base, "annotations_instance", "validation")
    if not os.path.isdir(inst_dir):
        print(f"missing {inst_dir}")
        return
    cats = ade150_categories()
    thing_idx = [i for i, c in enumerate(cats) if c["isthing"]]

    images, annotations = [], []
    ann_id = 1
    for img_id, fname in enumerate(sorted(os.listdir(inst_dir))):
        inst = read_label(os.path.join(inst_dir, fname))
        h, w = inst.shape[:2]
        images.append({"id": img_id, "file_name": fname.replace(".png", ".jpg"),
                       "height": int(h), "width": int(w)})
        r, g = inst[..., 0], inst[..., 1]
        # the same set, in the same order, as the JAX script iterates
        for (tc, ti) in {(int(a), int(b)) for a, b in zip(r[g > 0].ravel(), g[g > 0].ravel())}:
            if tc - 1 >= len(thing_idx):
                continue
            mask = (r == tc) & (g == ti)
            ys, xs = np.nonzero(mask)
            if len(ys) == 0:
                continue
            annotations.append({
                "id": ann_id, "image_id": img_id, "category_id": thing_idx[tc - 1],
                "area": int(mask.sum()), "iscrowd": 0,
                "bbox": [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1),
                         int(ys.max() - ys.min() + 1)],
                "source_png": fname, "instance_key": [tc, ti],
            })
            ann_id += 1
    out = os.path.join(base, "ade20k_instance_val.json")
    with open(out, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": i, "name": cats[i]["name"]} for i in thing_idx]}, f)
    print("wrote", out, f"({len(annotations)} instances)")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.environ.get("DETECTRON2_DATASETS", "datasets"))
