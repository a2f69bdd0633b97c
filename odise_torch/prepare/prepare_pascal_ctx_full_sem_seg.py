"""Pascal Context's 459-class labels (counterpart of
``datasets/prepare_pascal_ctx_full_sem_seg.py``).

    python -m odise_torch.prepare.prepare_pascal_ctx_full_sem_seg [root]

For each image of ``pascal_ctx_d2/images/{training,validation}/*.jpg``,
reads ``VOCdevkit/VOC2010/trainval/<stem>.mat`` (``LabelMap``, uint16, 0
unlabeled, 1 to 459) with scipy and writes ids 0 to 458, 65535 void, as a
16-bit TIFF to ``pascal_ctx_d2/annotations_ctx459/<split>/<stem>.tif``,
which the ctx459 task reads.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np

from ..data.image_io import write_tiff


def convert_label_map(label_map: np.ndarray) -> np.ndarray:
    """uint16 LabelMap (0 unlabeled, 1..459) -> 0..458 with 65535 void."""
    if label_map.dtype != np.uint16:
        raise ValueError(f"LabelMap is {label_map.dtype}, not uint16")
    out = label_map.astype(np.int64) - 1
    out[out < 0] = 65535
    return out.astype(np.uint16)


def generate_labels(mat_file: Path, out_dir: Path) -> None:
    import scipy.io as sio

    label_map = convert_label_map(sio.loadmat(str(mat_file))["LabelMap"])
    write_tiff(out_dir / mat_file.with_suffix(".tif").name, label_map)


def main(root: str) -> None:
    dataset_dir = Path(root) / "pascal_ctx_d2"
    mat_dir = Path(root) / "VOCdevkit" / "VOC2010" / "trainval"
    for split in ("training", "validation"):
        img_dir = dataset_dir / "images" / split
        out_dir = dataset_dir / "annotations_ctx459" / split
        out_dir.mkdir(parents=True, exist_ok=True)
        n = 0
        for img_file in sorted(img_dir.glob("*.jpg")):
            mat_file = mat_dir / f"{img_file.stem}.mat"
            if not mat_file.is_file():
                print(f"missing annotation {mat_file}, skipping")
                continue
            generate_labels(mat_file, out_dir)
            n += 1
        print(f"{split}: wrote {n} tiffs to {out_dir}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.environ.get("DETECTRON2_DATASETS", "datasets"))
