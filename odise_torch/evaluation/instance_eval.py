"""Instance segmentation mask-AP evaluator (counterpart of
``odise_tpu/evaluation/instance_eval.py``, numpy): COCO-style mask AP
averaged over IoU thresholds
0.50:0.95:0.05, with greedy score-ordered per-image matching, crowd-gt
ignore handling, area-range splits (AP / APs / APm / APl), maxDets capping
and the standard 101-point interpolated precision.

This re-implements the metric definition (not pycocotools internals), as
the JAX package does.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils import host_ops

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def mask_iou(pred: np.ndarray, gt: np.ndarray) -> float:
    """Pairwise IoU of two bool masks (the host C++ op, as JAX's native)."""
    return host_ops.mask_iou(pred, gt)


class InstanceSegEvaluator:
    def __init__(self, num_classes: int, max_dets: int = 100,
                 class_names: Optional[Sequence[str]] = None):
        self.num_classes = num_classes
        self.max_dets = max_dets
        self.class_names = class_names
        self.reset()

    def reset(self):
        # per (img, cat): dict with dt scores/areas, gt areas/crowd, iou matrix
        self._by_img_cat: Dict[tuple, dict] = {}
        self._img_counter = 0

    def process(self, pred_masks: np.ndarray, pred_classes: np.ndarray,
                pred_scores: np.ndarray, gt_masks: np.ndarray,
                gt_classes: np.ndarray, gt_iscrowd: Optional[np.ndarray] = None):
        """One image. pred_masks [N,H,W] bool, gt_masks [M,H,W] bool."""

        def areas(m):
            return (m.reshape(m.shape[0], -1).sum(1).astype(np.float64)
                    if m.shape[0] else np.zeros((0,), np.float64))

        dt_area = areas(np.asarray(pred_masks))
        gt_area = areas(np.asarray(gt_masks))
        D, M = len(dt_area), len(gt_area)
        if D and M:
            dt = pred_masks.reshape(D, -1).astype(np.float32)
            gt = gt_masks.reshape(M, -1).astype(np.float32)
            inter = (dt @ gt.T).astype(np.float64)
        else:
            inter = np.zeros((D, M), np.float64)
        self.process_from_counts(pred_scores, pred_classes, dt_area, inter,
                                 gt_classes, gt_area, gt_iscrowd)

    def process_from_counts(self, pred_scores, pred_classes,
                            dt_areas: np.ndarray, inter: np.ndarray,
                            gt_classes, gt_areas: np.ndarray,
                            gt_iscrowd: Optional[np.ndarray] = None):
        """One image from sufficient statistics: intersection-pixel counts
        [D, M] plus per-mask areas (device-eval path — masks never leave
        the device)."""
        img_id = self._img_counter
        self._img_counter += 1
        pred_scores = np.asarray(pred_scores, np.float64)
        # instance_inference pads its top-k with stuff rows at score 0;
        # callers must drop them (evaluation/run.py filters score > 0):
        # scoring a padded row as a real detection would depress AP
        if pred_scores.size and pred_scores.min() <= 0.0:
            raise ValueError(
                "process_from_counts received score<=0 rows — filter the "
                "device-eval top-k padding (score > 0) before scoring")
        pred_classes = np.asarray(pred_classes)
        gt_classes = np.asarray(gt_classes)
        dt_areas = np.asarray(dt_areas, np.float64)
        gt_areas = np.asarray(gt_areas, np.float64)
        inter = np.asarray(inter, np.float64)
        if gt_iscrowd is None:
            gt_iscrowd = np.zeros(len(gt_classes), bool)
        gt_iscrowd = np.asarray(gt_iscrowd, bool)

        # crowd gt: IoU = intersection / det area (pycocotools semantics)
        union = dt_areas[:, None] + gt_areas[None, :] - inter
        denom = np.where(gt_iscrowd[None, :], dt_areas[:, None], union)
        ious_all = np.zeros_like(inter)
        np.divide(inter, denom, out=ious_all, where=denom > 0)

        cats = set(pred_classes.tolist()) | set(gt_classes.tolist())
        for c in cats:
            dsel = np.where(pred_classes == c)[0]
            # score-sorted (stable), capped at maxDets per image-category
            dsel = dsel[np.argsort(-pred_scores[dsel], kind="mergesort")]
            dsel = dsel[: self.max_dets]
            gsel = np.where(gt_classes == c)[0]
            self._by_img_cat[(img_id, int(c))] = {
                "dt_scores": pred_scores[dsel],
                "dt_areas": dt_areas[dsel],
                "gt_areas": gt_areas[gsel],
                "gt_crowd": gt_iscrowd[gsel],
                "ious": ious_all[np.ix_(dsel, gsel)],
            }

    def merge_state(self, by_img_cat: dict, img_counter: int):
        """Multi-host eval: fold another host's per-(image, cat) entries in,
        re-keying image ids past this evaluator's local counter so shards
        never collide (the counterpart of COCOeval's rank-merged img_ids)."""
        base = self._img_counter
        for (img, c), e in by_img_cat.items():
            self._by_img_cat[(base + int(img), int(c))] = e
        self._img_counter = base + int(img_counter)

    def _match_img_cat(self, e: dict, area_rng) -> dict:
        """Greedy COCOeval-style matching for one (image, cat, areaRng)."""
        T = len(IOU_THRS)
        gt_ig = e["gt_crowd"] | (e["gt_areas"] < area_rng[0]) | \
            (e["gt_areas"] > area_rng[1])
        # non-ignored gts first (stable)
        gorder = np.argsort(gt_ig.astype(np.int64), kind="mergesort")
        ious = e["ious"][:, gorder]
        gt_ig = gt_ig[gorder]
        gt_crowd = e["gt_crowd"][gorder]
        D, G = ious.shape
        dtm = -np.ones((T, D), np.int64)
        gtm = -np.ones((T, G), np.int64)
        dt_ig = np.zeros((T, D), bool)
        for ti, t in enumerate(IOU_THRS):
            for d in range(D):
                best = min(t, 1 - 1e-10)
                m = -1
                for g in range(G):
                    if gtm[ti, g] >= 0 and not gt_crowd[g]:
                        continue
                    if m > -1 and not gt_ig[m] and gt_ig[g]:
                        break  # ignores are sorted last; stop at the boundary
                    if ious[d, g] < best:
                        continue
                    best = ious[d, g]
                    m = g
                if m == -1:
                    continue
                dtm[ti, d] = m
                gtm[ti, m] = d
                dt_ig[ti, d] = gt_ig[m]
        # unmatched dets outside the area range are ignored too
        out_rng = (e["dt_areas"] < area_rng[0]) | (e["dt_areas"] > area_rng[1])
        dt_ig |= (dtm == -1) & out_rng[None, :]
        return {"scores": e["dt_scores"], "matched": dtm >= 0, "dt_ig": dt_ig,
                "n_gt": int((~gt_ig).sum())}

    def _ap_for_cat(self, cat: int, area_rng) -> Optional[np.ndarray]:
        entries = [self._match_img_cat(e, area_rng)
                   for (img, c), e in self._by_img_cat.items() if c == cat]
        if not entries:
            return None
        n_gt = sum(x["n_gt"] for x in entries)
        if n_gt == 0:
            return None
        scores = np.concatenate([x["scores"] for x in entries])
        order = np.argsort(-scores, kind="mergesort")
        matched = np.concatenate([x["matched"] for x in entries], axis=1)[:, order]
        dt_ig = np.concatenate([x["dt_ig"] for x in entries], axis=1)[:, order]
        T = len(IOU_THRS)
        aps = np.zeros(T)
        for ti in range(T):
            tp = np.cumsum(matched[ti] & ~dt_ig[ti]).astype(np.float64)
            fp = np.cumsum(~matched[ti] & ~dt_ig[ti]).astype(np.float64)
            recall = tp / n_gt
            precision = tp / np.maximum(tp + fp, np.spacing(1))
            q = np.zeros(len(REC_THRS))
            if len(precision):
                for k in range(len(precision) - 2, -1, -1):
                    precision[k] = max(precision[k], precision[k + 1])
                inds = np.searchsorted(recall, REC_THRS, side="left")
                valid = inds < len(precision)
                q[valid] = precision[inds[valid]]
            aps[ti] = q.mean()
        return aps

    def evaluate(self) -> Dict[str, float]:
        cats_seen = sorted({c for (_, c) in self._by_img_cat})
        res: Dict[str, float] = {}
        per_cat_all: Dict[int, np.ndarray] = {}
        for rng_name, rng in AREA_RNG.items():
            per_cat = {}
            for c in cats_seen:
                ap = self._ap_for_cat(c, rng)
                if ap is not None:
                    per_cat[c] = ap
            if rng_name == "all":
                per_cat_all = per_cat
            key = {"all": "AP", "small": "APs", "medium": "APm",
                   "large": "APl"}[rng_name]
            if not per_cat:
                res[key] = 0.0
                if rng_name == "all":
                    res["AP50"] = res["AP75"] = 0.0
                continue
            all_aps = np.stack(list(per_cat.values()))
            res[key] = 100 * all_aps.mean()
            if rng_name == "all":
                res["AP50"] = 100 * all_aps[:, 0].mean()
                res["AP75"] = 100 * all_aps[:, 5].mean()
        if self.class_names is not None:
            for c, ap in per_cat_all.items():
                res[f"AP-{self.class_names[c]}"] = 100 * ap.mean()
        return res
