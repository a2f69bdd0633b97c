"""Semantic segmentation (mIoU) evaluator (counterpart of
``odise_tpu/evaluation/sem_seg_eval.py``, numpy, copied as it is):
confusion-matrix accumulation with an ignore label, mIoU and a
per-category IoU table.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


class SemSegEvaluator:
    def __init__(self, num_classes: int, ignore_label: int = 255,
                 class_names: Optional[Sequence[str]] = None):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.class_names = class_names
        self.reset()

    def reset(self):
        self.conf = np.zeros((self.num_classes, self.num_classes), np.int64)

    def process(self, pred: np.ndarray, gt: np.ndarray):
        """pred/gt: [H, W] int class maps."""
        # int64 up-front: uint16 gt (ctx459 tiffs) would overflow in the
        # flat confusion index (458*459 > 65535)
        pred = np.asarray(pred).reshape(-1).astype(np.int64)
        gt = np.asarray(gt).reshape(-1).astype(np.int64)
        valid = gt != self.ignore_label
        pred = np.clip(pred[valid], 0, self.num_classes - 1)
        gt = gt[valid]
        idx = gt * self.num_classes + pred
        self.conf += np.bincount(
            idx, minlength=self.num_classes ** 2
        ).reshape(self.num_classes, self.num_classes)

    def add_confusion(self, conf: np.ndarray):
        """Device-eval path: merge an externally accumulated [K, K]
        confusion matrix (rows = gt, cols = pred)."""
        assert conf.shape == self.conf.shape, (conf.shape, self.conf.shape)
        self.conf += conf.astype(np.int64)

    def evaluate(self) -> Dict[str, float]:
        conf = self.conf.astype(np.float64)
        tp = np.diag(conf)
        fp = conf.sum(0) - tp
        fn = conf.sum(1) - tp
        union = tp + fp + fn
        present = union > 0
        iou = np.zeros(self.num_classes)
        iou[present] = tp[present] / union[present]
        acc = np.zeros(self.num_classes)
        gt_total = conf.sum(1)
        acc[gt_total > 0] = tp[gt_total > 0] / gt_total[gt_total > 0]
        res = {
            "mIoU": 100 * iou[present].mean() if present.any() else 0.0,
            "fwIoU": 100 * (iou * gt_total / max(gt_total.sum(), 1)).sum(),
            "mACC": 100 * acc[gt_total > 0].mean() if (gt_total > 0).any() else 0.0,
            "pACC": 100 * tp.sum() / max(conf.sum(), 1),
        }
        if self.class_names is not None:
            for i, name in enumerate(self.class_names):
                if present[i]:
                    res[f"IoU-{name}"] = 100 * iou[i]
        return res
