"""PQ of semantic segmentation outputs (counterpart of
``tools/evaluate_pq_for_semantic_segmentation.py``).

    python -m odise_torch.evaluate_pq_for_semantic_segmentation \\
        --pred-dir PRED --gt-dir GT --num-classes N [--ignore-label 255]

Each file of ``--pred-dir`` (class ids, PNG or TIFF) is scored against the
file of the same name in ``--gt-dir``: every class present in a map is one
segment (``seg_from_semantic``), and PQ, SQ and RQ are computed over the
pairs by ``evaluation.panoptic_eval``. Files are read by
``data.image_io.read_label``, without PIL.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np

from .data.image_io import read_label
from .evaluation.panoptic_eval import PanopticEvaluator


def seg_from_semantic(sem: np.ndarray, ignore_label: int):
    """Semantic map -> (id map, segments): one segment per present class,
    ids from 1 in class order, 0 where the map is ``ignore_label``."""
    ids = np.zeros(sem.shape, np.uint32)
    segments = []
    for cls in np.unique(sem):
        if cls == ignore_label:
            continue
        ids[sem == cls] = len(segments) + 1
        segments.append({"id": len(segments) + 1, "category_id": int(cls)})
    return ids, segments


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--pred-dir", required=True)
    ap.add_argument("--gt-dir", required=True)
    ap.add_argument("--num-classes", type=int, required=True)
    ap.add_argument("--ignore-label", type=int, default=255)
    args = ap.parse_args(argv)

    ev = PanopticEvaluator(categories=list(range(args.num_classes)))
    for f in sorted(os.listdir(args.pred_dir)):
        pred = read_label(os.path.join(args.pred_dir, f))
        gt = read_label(os.path.join(args.gt_dir, f))
        pred_ids, pred_segs = seg_from_semantic(pred, args.ignore_label)
        gt_ids, gt_segs = seg_from_semantic(gt, args.ignore_label)
        ev.process(gt_ids, gt_segs, pred_ids, pred_segs)
    result = ev.evaluate()
    print(result)
    return result


if __name__ == "__main__":
    main()
