"""The LVIS-1203 label files from LVIS's annotation json (counterpart of
``datasets/prepare_lvis_openseg_labels.py``).

    python -m odise_torch.prepare.prepare_lvis_openseg_labels [root]

Reads ``lvis/lvis_v1_val.json`` and writes ``lvis_1203.txt`` (``id:name``)
and ``lvis_1203_with_prompt_eng.txt`` (``id:synonym,...``), underscores as
spaces, into the port's ``data/datasets/openseg_labels/`` (or ``out_dir``).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Optional

LABEL_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data", "datasets",
                         "openseg_labels")


def main(root: str, out_dir: Optional[str] = None) -> None:
    ann = os.path.join(root, "lvis", "lvis_v1_val.json")
    if not os.path.isfile(ann):
        print(f"missing {ann}")
        return
    with open(ann) as f:
        cats = sorted(json.load(f)["categories"], key=lambda c: c["id"])
    out = out_dir or LABEL_DIR
    with open(os.path.join(out, "lvis_1203.txt"), "w") as f:
        for c in cats:
            f.write(f"{c['id']}:{c['name'].replace('_', ' ')}\n")
    with open(os.path.join(out, "lvis_1203_with_prompt_eng.txt"), "w") as f:
        for c in cats:
            syns = [s.replace("_", " ") for s in c.get("synonyms", [c["name"]])]
            f.write(f"{c['id']}:{','.join(dict.fromkeys(syns))}\n")
    print("wrote lvis label files")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.environ.get("DETECTRON2_DATASETS", "datasets"))
