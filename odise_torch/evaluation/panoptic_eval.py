"""Panoptic Quality (PQ) evaluation (counterpart of
``odise_tpu/evaluation/panoptic_eval.py``, numpy).

The JAX package counts gt x pred pixel pairs with a host C++ helper
(``odise_tpu/native``) when it is built and numpy otherwise; the port keeps
the numpy form only. The PQ definition (Kirillov et al.):
segments match iff IoU > 0.5 (computed excluding void pixels);
PQ = sum(IoU of TPs) / (|TP| + |FP|/2 + |FN|/2), per category, averaged.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

VOID = 0


@dataclasses.dataclass
class PQStatCat:
    iou: float = 0.0
    tp: int = 0
    fp: int = 0
    fn: int = 0


class PQStat:
    def __init__(self):
        self.per_cat: Dict[int, PQStatCat] = defaultdict(PQStatCat)

    def __iadd__(self, other: "PQStat"):
        for c, s in other.per_cat.items():
            mine = self.per_cat[c]
            mine.iou += s.iou
            mine.tp += s.tp
            mine.fp += s.fp
            mine.fn += s.fn
        return self

    def pq_average(self, categories: Sequence[int],
                   isthing_map: Optional[Dict[int, bool]] = None,
                   thing: Optional[bool] = None) -> Dict[str, float]:
        pq, sq, rq, n = 0.0, 0.0, 0.0, 0
        for c in categories:
            if thing is not None and isthing_map is not None:
                if bool(isthing_map.get(c, False)) != thing:
                    continue
            s = self.per_cat[c]
            if s.tp + s.fp + s.fn == 0:
                continue
            n += 1
            pq_c = s.iou / (s.tp + 0.5 * s.fp + 0.5 * s.fn)
            sq_c = s.iou / s.tp if s.tp else 0.0
            rq_c = s.tp / (s.tp + 0.5 * s.fp + 0.5 * s.fn)
            pq += pq_c
            sq += sq_c
            rq += rq_c
        if n == 0:
            return {"pq": 0.0, "sq": 0.0, "rq": 0.0, "n": 0}
        return {"pq": 100 * pq / n, "sq": 100 * sq / n, "rq": 100 * rq / n, "n": n}


def pq_compute_single(
    gt_seg: np.ndarray,
    gt_segments: List[dict],      # {id, category_id, iscrowd}
    pred_seg: np.ndarray,
    pred_segments: List[dict],    # {id, category_id}
) -> PQStat:
    """PQ stats for one image. Void id = 0 in both maps."""
    gt_by_id = {s["id"]: s for s in gt_segments}
    pred_by_id = {s["id"]: s for s in pred_segments}

    # areas
    gt_ids, gt_areas = np.unique(gt_seg, return_counts=True)
    pred_ids, pred_areas = np.unique(pred_seg, return_counts=True)
    gt_area = dict(zip(gt_ids.tolist(), gt_areas.tolist()))
    pred_area = dict(zip(pred_ids.tolist(), pred_areas.tolist()))

    g_ids, p_ids, cnts = pq_intersections(gt_seg, pred_seg)
    inter: Dict[Tuple[int, int], int] = {
        (int(g), int(p)): int(c) for g, p, c in zip(g_ids, p_ids, cnts)
    }
    return _pq_stats_core(inter, gt_area, pred_area, gt_by_id, pred_by_id,
                          gt_segments, pred_segments)


def pq_compute_from_counts(
    counts: np.ndarray,           # [S+1, P+1] gt-row x pred-col intersections
    gt_segments: List[dict],      # row i+1 described by gt_segments[i]
    pred_segments: List[dict],    # col j+1 described by pred_segments[j]
) -> PQStat:
    """PQ stats from a precomputed intersection-count matrix (row/col 0 =
    void), as produced on device by evaluation.device_eval — the fetch is
    the [S+1, P+1] matrix instead of two dense id maps."""
    s1, p1 = counts.shape
    gt_segments = [dict(s, id=i + 1) for i, s in enumerate(gt_segments)]
    pred_segments = [dict(s, id=j + 1) for j, s in enumerate(pred_segments)]
    gt_by_id = {s["id"]: s for s in gt_segments}
    pred_by_id = {s["id"]: s for s in pred_segments}
    gt_area = {g: int(a) for g, a in enumerate(counts.sum(1)) if a > 0}
    pred_area = {p: int(a) for p, a in enumerate(counts.sum(0)) if a > 0}
    gg, pp = np.nonzero(counts)
    inter = {(int(g), int(p)): int(counts[g, p]) for g, p in zip(gg, pp)}
    return _pq_stats_core(inter, gt_area, pred_area, gt_by_id, pred_by_id,
                          gt_segments, pred_segments)


def _pq_stats_core(
    inter: Dict[Tuple[int, int], int],
    gt_area: Dict[int, int],
    pred_area: Dict[int, int],
    gt_by_id: Dict[int, dict],
    pred_by_id: Dict[int, dict],
    gt_segments: List[dict],
    pred_segments: List[dict],
) -> PQStat:
    stat = PQStat()
    matched_gt, matched_pred = set(), set()
    for (gid, pid), c in inter.items():
        if gid == VOID or pid == VOID:
            continue
        if gid not in gt_by_id or pid not in pred_by_id:
            continue
        g, p = gt_by_id[gid], pred_by_id[pid]
        if g.get("iscrowd", 0):
            continue
        if g["category_id"] != p["category_id"]:
            continue
        # union excludes void overlaps of the pred segment
        void_inter = inter.get((VOID, pid), 0)
        union = (gt_area.get(gid, 0) + pred_area.get(pid, 0) - c - void_inter)
        if union <= 0:
            continue
        iou = c / union
        if iou > 0.5:
            cat = g["category_id"]
            stat.per_cat[cat].tp += 1
            stat.per_cat[cat].iou += iou
            matched_gt.add(gid)
            matched_pred.add(pid)

    crowd_by_cat: Dict[int, int] = {}
    for s in gt_segments:
        if s.get("iscrowd", 0):
            crowd_by_cat[s["category_id"]] = s["id"]
            continue
        if s["id"] not in matched_gt:
            stat.per_cat[s["category_id"]].fn += 1

    for s in pred_segments:
        pid = s["id"]
        if pid in matched_pred:
            continue
        area = pred_area.get(pid, 0)
        if area == 0:
            continue
        # ignore predictions mostly covered by void / matching crowd of same cat
        ignore = inter.get((VOID, pid), 0)
        crowd_id = crowd_by_cat.get(s["category_id"])
        if crowd_id is not None:
            ignore += inter.get((crowd_id, pid), 0)
        if ignore / area > 0.5:
            continue
        stat.per_cat[s["category_id"]].fp += 1
    return stat


def pq_intersections(gt: np.ndarray, pred: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Distinct (gt_id, pred_id) pairs and their intersection areas."""
    combined = (np.asarray(gt, np.uint32).astype(np.uint64) * (2 ** 32)
                + np.asarray(pred, np.uint32).astype(np.uint64))
    pairs, counts = np.unique(combined, return_counts=True)
    return ((pairs >> np.uint64(32)).astype(np.uint32),
            (pairs & np.uint64(0xFFFFFFFF)).astype(np.uint32), counts)


class PanopticEvaluator:
    """Accumulate per-image PQ stats; report PQ/SQ/RQ (+Th/St splits)."""

    def __init__(self, categories: Sequence[int],
                 isthing_map: Optional[Dict[int, bool]] = None):
        self.categories = list(categories)
        self.isthing_map = isthing_map or {}
        self.reset()

    def reset(self):
        self.stat = PQStat()

    def process(self, gt_seg, gt_segments, pred_seg, pred_segments):
        self.stat += pq_compute_single(gt_seg, gt_segments, pred_seg, pred_segments)

    def process_counts(self, counts, gt_segments, pred_segments):
        """Device-eval path: intersection-count matrix instead of id maps."""
        self.stat += pq_compute_from_counts(counts, gt_segments, pred_segments)

    def merge_stat(self, stat: PQStat):
        """Multi-host eval: fold another host's accumulated PQStat in
        (the counterpart of panopticapi's rank merge in d2 evaluators)."""
        self.stat += stat

    def evaluate(self) -> Dict[str, float]:
        res = self.stat.pq_average(self.categories)
        out = {"PQ": res["pq"], "SQ": res["sq"], "RQ": res["rq"]}
        if self.isthing_map:
            th = self.stat.pq_average(self.categories, self.isthing_map, thing=True)
            st = self.stat.pq_average(self.categories, self.isthing_map, thing=False)
            out.update({"PQ_th": th["pq"], "SQ_th": th["sq"], "RQ_th": th["rq"],
                        "PQ_st": st["pq"], "SQ_st": st["sq"], "RQ_st": st["rq"]})
        return out
