"""Evaluation statistics computed on the model's device (counterpart of
``odise_tpu/evaluation/device_eval.py``).

Per image, only the evaluators' sufficient statistics leave the device:

* semantic mIoU    -> a [K, K] confusion matrix, accumulated on the device
* panoptic PQ      -> an [S+1, Q+1] gt-segment x predicted-segment
                      intersection-count matrix
* instance mask AP -> [topk, M] intersection counts and the mask areas

As in the reference post-processing, mask logits are resized bilinearly
(``align_corners=False``) from the valid region of the padded bucket to the
original image size, inside one of a few fixed output grids, by two
products with tent-weight matrices; fusion then runs on the resized logits
with ``valid_hw`` = the original size.

The JAX runner packs the ground truth into one uint8 upload and its results
into one int32 fetch per image, because its remote device paid a round trip
per transfer; the port uploads and fetches each array on its own, and keeps
the confusion matrix in int64 (no overflow flush). ``process`` returns the
JAX runner's dict, key for key, with the same dtypes.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.inference import instance_inference, panoptic_inference

__all__ = ["DeviceEvalRunner", "pick_grid", "resize_chw", "DEFAULT_GRIDS"]

# output grids (original-resolution ladder); per image the smallest grid
# that fits (oh, ow) is used
DEFAULT_GRIDS: Tuple[Tuple[int, int], ...] = (
    (768, 768), (1280, 1280), (2048, 2048))

# images with more instance-GT masks than this take the host path
_MAX_GT_INSTANCES = 128


def pick_grid(oh: int, ow: int,
              grids: Sequence[Tuple[int, int]] = DEFAULT_GRIDS):
    for g in grids:
        if oh <= g[0] and ow <= g[1]:
            return g
    return None  # larger than every grid: caller falls back to host path


def _tent_matrix(out_pad: int, in_pad: int, out_len: int, in_len: int,
                 device=None) -> torch.Tensor:
    """[out_pad, in_pad] bilinear (align_corners=False) weight matrix, float32.
    Rows >= out_len and columns >= in_len carry zero weight."""
    i = torch.arange(out_pad, dtype=torch.float32, device=device)
    in_f = torch.tensor(float(in_len), dtype=torch.float32, device=device)
    out_f = torch.tensor(float(out_len), dtype=torch.float32, device=device)
    y = torch.clamp((i + 0.5) * (in_f / out_f) - 0.5, min=0.0)
    y = torch.minimum(y, in_f - 1.0)
    j = torch.arange(in_pad, dtype=torch.float32, device=device)
    a = torch.clamp(1.0 - (y[:, None] - j[None, :]).abs(), min=0.0)
    return a * ((i[:, None] < out_len) & (j[None, :] < in_len))


def resize_chw(x: torch.Tensor, src_hw, dst_hw, out_shape: Tuple[int, int]) -> torch.Tensor:
    """[C, H, W] -> [C, OH, OW] float32: bilinear resize of the ``src_hw``
    content region to the ``dst_hw`` content region of an ``out_shape`` grid
    (zero outside it)."""
    h, w = src_hw
    oh, ow = dst_hw
    a = _tent_matrix(out_shape[0], x.shape[1], oh, h, x.device)
    b = _tent_matrix(out_shape[1], x.shape[2], ow, w, x.device)
    return torch.matmul(torch.matmul(a, x.float()), b.T)


def _grid_valid(out_shape, dst_hw, device=None) -> torch.Tensor:
    oh, ow = dst_hw
    return ((torch.arange(out_shape[0], device=device)[:, None] < oh)
            & (torch.arange(out_shape[1], device=device)[None, :] < ow))


def _sem_labels(mask_cls: torch.Tensor, masks_resized: torch.Tensor,
                k_chunk: int = 128) -> torch.Tensor:
    """[OH, OW] argmax over classes of the semantic probabilities (softmax
    class x sigmoid mask blend), in chunks of ``k_chunk`` classes so
    [K, OH, OW] never exists; the first maximum wins, across chunks too."""
    q, k1 = mask_cls.shape
    k = k1 - 1
    cls_prob = torch.softmax(mask_cls.float(), dim=-1)[:, :-1]  # [Q, K]
    oh, ow = masks_resized.shape[1:]
    flat = torch.sigmoid(masks_resized).reshape(q, oh * ow)
    best = torch.full((oh * ow,), -float("inf"), device=flat.device)
    arg = torch.zeros((oh * ow,), dtype=torch.int32, device=flat.device)
    for base in range(0, k, k_chunk):
        probs = cls_prob[:, base:base + k_chunk].T @ flat  # [k_chunk, N]
        m, a = probs.max(dim=0)
        take = m > best
        best = torch.where(take, m, best)
        arg = torch.where(take, a.to(torch.int32) + base, arg)
    return arg.clamp(max=k - 1).reshape(oh, ow)


class DeviceEvalRunner:
    """Per-task evaluator statistics on the device of the model's outputs.

    One ``process`` call per image computes every enabled statistic from the
    model's (mask_cls, mask_pred) at bucket resolution and returns small
    numpy arrays; the semantic confusion matrix stays on the device until
    ``flush_confusion``.
    """

    def __init__(self, *, num_classes: int, thing_mask: np.ndarray,
                 object_mask_threshold: float, overlap_threshold: float,
                 topk: int, ignore_label: int = 255,
                 semantic_on=True, panoptic_on=True, instance_on=True,
                 s_max: int = 256,
                 grids: Sequence[Tuple[int, int]] = DEFAULT_GRIDS):
        self.K = num_classes
        self.thing_mask = torch.as_tensor(np.asarray(thing_mask, bool))
        self.object_mask_threshold = float(object_mask_threshold)
        self.overlap_threshold = float(overlap_threshold)
        self.topk = int(topk)
        self.ignore_label = int(ignore_label)
        self.semantic_on = semantic_on
        self.panoptic_on = panoptic_on
        self.instance_on = instance_on
        self.s_max = int(s_max)
        self.grids = tuple(tuple(g) for g in grids)
        self.reset()

    def process(self, mask_cls: torch.Tensor, mask_pred: torch.Tensor,
                src_hw: Tuple[int, int], orig_hw: Tuple[int, int],
                sem_gt: Optional[np.ndarray] = None,
                pan_gt_ids: Optional[np.ndarray] = None,
                pan_seg_ids: Optional[np.ndarray] = None,
                inst_gt_masks: Optional[np.ndarray] = None) -> Optional[dict]:
        """One image. Returns a dict of host-side statistics, or None when
        the image does not fit the device path (original size beyond every
        grid, more than ``s_max`` panoptic gt segments, or more than 128
        instance masks): the caller then takes the host path.

        mask_cls [Q, K+1], mask_pred [Q, H, W]: the model's outputs for one
        image, bucket padded, on any device.
        sem_gt [oh, ow] int: semantic gt at the original resolution.
        pan_gt_ids [oh, ow] uint32: panoptic gt id map (rgb2id output).
        pan_seg_ids [S]: gt segment ids present (any order).
        inst_gt_masks [M, oh, ow] bool: instance gt masks.
        """
        oh, ow = orig_hw
        grid = pick_grid(oh, ow, self.grids)
        if grid is None:
            return None
        if pan_gt_ids is not None and pan_seg_ids is not None \
                and len(pan_seg_ids) > self.s_max:
            return None  # crowded image: host fallback
        if inst_gt_masks is not None and len(inst_gt_masks) > _MAX_GT_INSTANCES:
            return None  # too many gt instances: host fallback
        K = self.K
        dev = mask_cls.device
        has_sem = self.semantic_on and sem_gt is not None
        has_pan = self.panoptic_on and pan_gt_ids is not None
        has_inst = self.instance_on and inst_gt_masks is not None
        if not (has_sem or has_pan or has_inst):
            return {}

        gh, gw = grid
        n = gh * gw
        masks_r = resize_chw(mask_pred, src_hw, orig_hw, grid)
        valid = _grid_valid(grid, orig_hw, dev)
        thing_mask = self.thing_mask.to(dev)
        res: dict = {}

        if has_sem:
            # uint16 as in the JAX runner's upload (labels <= 65535)
            sg = np.full((gh, gw), self.ignore_label, np.uint16)
            sg[:oh, :ow] = np.asarray(sem_gt).astype(np.uint16)
            sem = torch.from_numpy(sg.astype(np.int64)).to(dev)
            labels = _sem_labels(mask_cls, masks_r).long()
            keep = valid & (sem != self.ignore_label) & (sem < K)
            idx = torch.where(keep, sem * K + labels.clamp(0, K - 1), K * K)
            inc = torch.bincount(idx.reshape(-1), minlength=K * K + 1)[:K * K]
            inc = inc.reshape(K, K)
            self._conf = inc if self._conf is None else self._conf + inc

        if has_pan:
            pg = np.zeros((gh, gw), np.uint32)
            pg[:oh, :ow] = np.asarray(pan_gt_ids, np.uint32)
            lut = np.sort(np.asarray(pan_seg_ids, np.uint32))
            s = len(lut)
            pan = panoptic_inference(
                mask_cls, masks_r, thing_mask,
                object_mask_threshold=self.object_mask_threshold,
                overlap_threshold=self.overlap_threshold, valid_hw=orig_hw)
            # gt ids -> row index through the sorted segment ids
            # (row 0 = void or an id not listed)
            gt = torch.from_numpy(pg.astype(np.int64)).to(dev)
            lut_t = torch.from_numpy(lut.astype(np.int64)).to(dev)
            if s:
                pos = torch.searchsorted(lut_t, gt).clamp(max=s - 1)
                gt_row = torch.where(lut_t[pos] == gt, pos + 1, 0)
            else:
                gt_row = torch.zeros_like(gt)
            gt_row = torch.where(valid, gt_row, 0)
            q1 = pan.segment_category.shape[0] + 1
            pred_col = torch.where(valid, pan.panoptic_seg.long(), 0)
            # padding pixels fall in (void, void); take them out again
            counts = torch.bincount((gt_row * q1 + pred_col).reshape(-1),
                                    minlength=(s + 1) * q1)
            counts[0] -= n - oh * ow
            res["pan_counts"] = counts.reshape(s + 1, q1).to(torch.int32).cpu().numpy()
            res["pan_segment_category"] = pan.segment_category.cpu().numpy()
            res["pan_segment_isthing"] = pan.segment_isthing.cpu().numpy()
            res["pan_num_segments"] = int(pan.num_segments)
            res["pan_gt_ids_sorted"] = lut

        if has_inst:
            m = len(inst_gt_masks)
            gm = np.zeros((m, gh, gw), bool)
            gm[:, :oh, :ow] = inst_gt_masks
            inst = instance_inference(mask_cls, masks_r, thing_mask,
                                      topk=self.topk, valid_hw=orig_hw)
            det = inst.masks.reshape(inst.masks.shape[0], n).float()
            gt = torch.from_numpy(gm.reshape(m, n)).to(dev).float()
            res["inst_scores"] = inst.scores.float().cpu().numpy()
            res["inst_classes"] = inst.classes.cpu().numpy()
            # 0/1 products and sums in float32 are exact below 2**24 pixels
            res["inst_inter"] = (det @ gt.T).cpu().numpy().astype(np.float64)
            res["inst_dt_area"] = det.sum(dim=1).cpu().numpy().astype(np.float64)
            res["inst_gt_area"] = gt.sum(dim=1).cpu().numpy().astype(np.float64)
        return res

    def reset(self):
        """Clear the accumulated statistics."""
        self._conf = None  # on the device, since the last flush
        self._conf_host = np.zeros((self.K, self.K), np.int64)

    def flush_confusion(self) -> np.ndarray:
        """Move the device confusion matrix into the host total and return
        the running host matrix [K, K] int64."""
        if self._conf is not None:
            self._conf_host += self._conf.cpu().numpy()
            self._conf = None
        return self._conf_host
