"""Open-vocabulary evaluation of one task (counterpart of one task of
``do_test`` in ``tools/train_net.py``, without the config system).

With ``across_ranks`` and several ranks (``torch.distributed``) each rank
evaluates ``records[rank::world]`` and the evaluators' statistics (the
semantic confusion matrix, ``PQStat``, the instance entries, the image and
host-fallback counts) are gathered and merged in rank order before the
metrics are computed, so that every rank returns the same metrics, those of
one process over all the records. With one process per card this is the
port's counterpart of JAX's ``ShardedOpenPanopticInference``, which spreads
one process's images over its devices.

Per record: resize the shorter side, pad to a multiple of 64 and then into
its shape bucket, run the model, and score it. With ``device_stats`` the
scores come from sufficient statistics computed where the model's outputs
lie (``DeviceEvalRunner``); an image that does not fit that path (larger
than every grid, too many gt segments or instances) and every image without
``device_stats`` takes the host path, which fuses at bucket resolution and
resizes the result to the original size. Host-path images are counted in
``host_fallback_images`` and logged.

Records hold ``image`` [H, W, 3] uint8 and optionally ``sem_seg`` [H, W]
int, ``pan_seg`` [H, W] segment ids and ``segments_info``
(``make_shapes_records`` makes such records), or name their files instead
(``file_name``, ``sem_seg_file_name``, ``pan_seg_file_name``), as the
registered datasets do; a label file that is absent leaves its task without
ground truth for the image, as in ``tools/train_net.py``. Instance gt comes
from a record's COCO ``annotations``, else from ``inst_gt_index`` (the
task's instances json by image id), else from the thing segments of the
panoptic gt.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..data.coco_mask import annotations_to_masks
from ..data.image_io import read_image, read_label, read_rgb_png
from ..data.transforms import (AugInput, ResizeShortestEdge, resize_bilinear,
                               resize_nearest, rgb2id)
from ..models.inference import (instance_inference, panoptic_inference,
                                semantic_inference)
from ..parallel.multihost import gather_pickled, get_rank, get_world_size
from .buckets import compute_eval_buckets, pick_bucket
from .device_eval import DeviceEvalRunner
from .evaluator import print_csv_format
from .instance_eval import InstanceSegEvaluator
from .panoptic_eval import PanopticEvaluator
from .sem_seg_eval import SemSegEvaluator

logger = logging.getLogger(__name__)

IGNORE_LABEL = 255  # the semantic gt's "no label", as in COCO and ADE20K


def prep_record(rec: dict, resize: ResizeShortestEdge, buckets, thing_mask: np.ndarray,
                semantic_on: bool = True, panoptic_on: bool = True,
                instance_on: bool = True, device=None,
                inst_gt_index: Optional[Dict[int, List[dict]]] = None) -> dict:
    """Resize and pad the image into its bucket; gather the gt of the tasks
    that are on at the original resolution. An image file is decoded on
    ``device`` (default CUDA; a JPEG by nvJPEG there) and prepared on the
    host."""
    if "image" in rec:
        img = np.asarray(rec["image"])
    else:
        img = read_image(rec["file_name"], device).cpu().numpy()
    oh, ow = img.shape[:2]
    image = resize(AugInput(image=torch.from_numpy(img))).image
    h, w = image.shape[:2]
    h64, w64 = -(-h // 64) * 64, -(-w // 64) * 64
    bh, bw = pick_bucket(h64, w64, buckets) or (h64, w64)
    padded = torch.zeros((1, bh, bw, 3), dtype=torch.float32)
    padded[0, :h, :w] = image.float() / 255.0

    sem_gt = None
    if semantic_on and "sem_seg" in rec:
        sem_gt = np.asarray(rec["sem_seg"])
    elif semantic_on and os.path.isfile(rec.get("sem_seg_file_name", "")):
        sem_gt = read_label(rec["sem_seg_file_name"])
    gt_ids = gt_segments = None
    if (panoptic_on or instance_on) and "segments_info" in rec:
        if "pan_seg" in rec:
            gt_ids = np.asarray(rec["pan_seg"], np.uint32)
        elif os.path.isfile(rec.get("pan_seg_file_name", "")):
            gt_ids = rgb2id(read_rgb_png(rec["pan_seg_file_name"]))
        if gt_ids is not None:
            gt_segments = [dict(s) for s in rec["segments_info"]]
    inst_gt_masks = inst_gt_classes = inst_gt_crowd = None
    if instance_on:
        anns = rec.get("annotations")
        if anns is None and inst_gt_index is not None and "image_id" in rec:
            # an image the index does not name has no instances: its
            # detections still count as false positives
            anns = inst_gt_index.get(int(rec["image_id"]), [])
        if anns is not None:
            inst_gt_masks = annotations_to_masks(anns, oh, ow)
            inst_gt_classes = np.asarray([a["category_id"] for a in anns], np.int64)
            inst_gt_crowd = np.asarray([bool(a.get("iscrowd", 0)) for a in anns], bool)
        elif gt_ids is not None:
            things = [s for s in gt_segments if thing_mask[s["category_id"]]]
            inst_gt_masks = (np.stack([gt_ids == s["id"] for s in things]) if things
                             else np.zeros((0, oh, ow), bool))
            inst_gt_classes = np.asarray([s["category_id"] for s in things], np.int64)
            inst_gt_crowd = np.asarray([bool(s.get("iscrowd", 0)) for s in things], bool)
    return dict(padded=padded, h=h, w=w, oh=oh, ow=ow, sem_gt=sem_gt,
                gt_ids=gt_ids, gt_segments=gt_segments,
                inst_gt_masks=inst_gt_masks, inst_gt_classes=inst_gt_classes,
                inst_gt_crowd=inst_gt_crowd)


@torch.inference_mode()
def evaluate_open_vocab(infer, records: Iterable[dict], *,
                        labels: Sequence[Sequence[str]], thing_mask,
                        device_stats: bool = True, short_side: int = 1024,
                        max_size: int = 2560, semantic_on: bool = True,
                        panoptic_on: bool = True, instance_on: bool = True,
                        ignore_label: int = IGNORE_LABEL,
                        inst_gt_index: Optional[Dict[int, List[dict]]] = None,
                        task: str = "main", across_ranks: bool = False) -> Dict[str, float]:
    """Evaluate ``infer`` (images [1, H, W, 3] -> (mask_cls, mask_pred), with
    the fusion settings on ``infer.model``) over ``records`` against a
    vocabulary of ``labels`` with a [K] bool ``thing_mask``. Returns the
    semantic (mIoU, ...), panoptic (PQ, ...) and instance (AP, ...) metrics
    of the tasks that are on, with ``images``, ``s_per_img`` and, with
    ``device_stats``, ``host_fallback_images``; logs them under ``task``.
    ``inst_gt_index`` (image id -> COCO annotations) is the instance gt of
    records without ``annotations``. Image files are decoded on
    ``infer.device``. ``across_ranks`` shares the records out over the ranks
    and merges their statistics (see the module's docstring)."""
    model = infer.model
    device = getattr(infer, "device", None)
    obj_thr = float(model.object_mask_threshold)
    ovl_thr = float(model.overlap_threshold)
    topk = int(model.test_topk_per_image)
    K = len(labels)
    thing_np = np.asarray(thing_mask, bool)
    thing_t = torch.from_numpy(thing_np)
    buckets = compute_eval_buckets(short_side, max_size)
    resize = ResizeShortestEdge(short_side, max_size)
    if across_ranks:
        records = list(records)[get_rank()::get_world_size()]

    def evaluators():
        return (SemSegEvaluator(num_classes=K, ignore_label=ignore_label),
                PanopticEvaluator(categories=list(range(K)),
                                  isthing_map={i: bool(thing_np[i]) for i in range(K)}),
                InstanceSegEvaluator(num_classes=K))

    sem_ev, pan_ev, inst_ev = evaluators()
    runner = (DeviceEvalRunner(num_classes=K, thing_mask=thing_np,
                               object_mask_threshold=obj_thr,
                               overlap_threshold=ovl_thr, topk=topk,
                               ignore_label=ignore_label, semantic_on=semantic_on,
                               panoptic_on=panoptic_on, instance_on=instance_on)
              if device_stats else None)

    t_start = time.perf_counter()
    n = n_fallback = 0
    for rec in records:
        p = prep_record(rec, resize, buckets, thing_np, semantic_on, panoptic_on,
                        instance_on, device, inst_gt_index)
        mask_cls, mask_pred = infer(p["padded"])
        mask_cls, mask_pred = mask_cls[0], mask_pred[0]
        h, w, oh, ow = p["h"], p["w"], p["oh"], p["ow"]
        sem_gt, gt_ids, gt_segments = p["sem_gt"], p["gt_ids"], p["gt_segments"]
        inst_gt_masks = p["inst_gt_masks"]
        inst_gt_classes, inst_gt_crowd = p["inst_gt_classes"], p["inst_gt_crowd"]

        # ---- statistics on the outputs' device ----
        stats = None
        if runner is not None:
            dev_sem = sem_gt if sem_gt is not None and sem_gt.shape == (oh, ow) else None
            dev_pan = gt_ids if gt_ids is not None and gt_ids.shape == (oh, ow) else None
            dev_inst = (inst_gt_masks if inst_gt_masks is not None
                        and len(inst_gt_masks) <= 128 else None)
            if dev_sem is not None or dev_pan is not None or dev_inst is not None:
                stats = runner.process(
                    mask_cls, mask_pred, (h, w), (oh, ow), sem_gt=dev_sem,
                    pan_gt_ids=dev_pan,
                    pan_seg_ids=(np.asarray([s["id"] for s in gt_segments], np.uint32)
                                 if dev_pan is not None else None),
                    inst_gt_masks=dev_inst)
        sem_done = pan_done = inst_done = False
        if stats is not None:
            if "pan_counts" in stats:
                segs_by_id = {int(s["id"]): s for s in gt_segments}
                gt_sorted = [segs_by_id[int(i)] for i in stats["pan_gt_ids_sorted"]]
                nseg = stats["pan_num_segments"]
                cats = stats["pan_segment_category"]
                things = stats["pan_segment_isthing"]
                pred_segments = [{"category_id": int(cats[i]), "isthing": bool(things[i])}
                                 for i in range(nseg)]
                pan_ev.process_counts(stats["pan_counts"][:, : nseg + 1], gt_sorted,
                                      pred_segments)
            if "inst_inter" in stats:
                keeps = stats["inst_scores"] > 0  # drop stuff-flagged rows
                inst_ev.process_from_counts(
                    stats["inst_scores"][keeps], stats["inst_classes"][keeps],
                    stats["inst_dt_area"][keeps], stats["inst_inter"][keeps],
                    inst_gt_classes, stats["inst_gt_area"], inst_gt_crowd)
            sem_done = dev_sem is not None
            pan_done = dev_pan is not None
            inst_done = dev_inst is not None

        # ---- host path: fuse at bucket resolution, resize to the original ----
        valid_hw = (h, w)
        if sem_gt is not None and not sem_done:
            sem = semantic_inference(mask_cls, mask_pred)[:, :h, :w]
            # resize probabilities before the argmax
            sem_r = resize_bilinear(sem, sem_gt.shape[0], sem_gt.shape[1])
            sem_ev.process(sem_r.argmax(dim=0).int().cpu().numpy(), sem_gt)
        if panoptic_on and gt_ids is not None and not pan_done:
            pan = panoptic_inference(mask_cls, mask_pred, thing_t,
                                     object_mask_threshold=obj_thr,
                                     overlap_threshold=ovl_thr, valid_hw=valid_hw)
            pan_seg = resize_nearest(pan.panoptic_seg[:h, :w], oh, ow)
            nseg = int(pan.num_segments)
            cats = pan.segment_category.cpu().numpy()
            things = pan.segment_isthing.cpu().numpy()
            pred_segments = [{"id": i + 1, "category_id": int(cats[i]),
                              "isthing": bool(things[i])} for i in range(nseg)]
            pan_ev.process(gt_ids, gt_segments, pan_seg.cpu().numpy().astype(np.uint32),
                           pred_segments)
        if inst_gt_masks is not None and not inst_done:
            inst = instance_inference(mask_cls, mask_pred, thing_t,
                                      topk=topk, valid_hw=valid_hw)
            masks = resize_nearest(inst.masks[:, :h, :w], oh, ow).cpu().numpy()
            scores = inst.scores.cpu().numpy()
            keeps = scores > 0  # drop stuff-flagged rows
            # always processed: detections on an image without thing gt
            # count as false positives
            inst_ev.process(masks[keeps], inst.classes.cpu().numpy()[keeps],
                            scores[keeps], inst_gt_masks, inst_gt_classes,
                            inst_gt_crowd)
        if ((sem_gt is not None and not sem_done)
                or (panoptic_on and gt_ids is not None and not pan_done)
                or (inst_gt_masks is not None and not inst_done)):
            n_fallback += 1
            if runner is not None:
                logger.info("Image %d used the host eval path (oh=%d ow=%d, "
                            "gt_segments=%d, gt_instances=%d)", n, oh, ow,
                            len(gt_segments or ()), len(inst_gt_masks)
                            if inst_gt_masks is not None else 0)
        n += 1
    dt = time.perf_counter() - t_start
    if runner is not None:
        sem_ev.add_confusion(runner.flush_confusion())
    if across_ranks and get_world_size() > 1:
        # every rank merges every rank's statistics in rank order, so that
        # the float sums, and the metrics, are the same on all of them
        states = gather_pickled((sem_ev.conf, pan_ev.stat, inst_ev._by_img_cat,
                                 inst_ev._img_counter, n, n_fallback))
        sem_ev, pan_ev, inst_ev = evaluators()
        n = n_fallback = 0
        for conf, stat, by_img_cat, img_counter, n_rank, fallback_rank in states:
            sem_ev.add_confusion(conf)
            pan_ev.merge_stat(stat)
            inst_ev.merge_state(by_img_cat, img_counter)
            n += n_rank
            n_fallback += fallback_rank
    r = {}
    if semantic_on:
        r.update(sem_ev.evaluate())
    if panoptic_on:
        r.update(pan_ev.evaluate())
    if instance_on:
        r.update(inst_ev.evaluate())
    r["images"] = n
    r["s_per_img"] = dt / max(n, 1)
    if runner is not None:
        r["host_fallback_images"] = n_fallback
        if n_fallback:
            logger.warning("%d/%d images took the host eval path (beyond the "
                           "largest grid or the gt-count limits)", n_fallback, n)
    print_csv_format({task: r})
    return r
