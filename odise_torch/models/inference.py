"""Semantic, panoptic and instance fusion for one image (counterpart of
``odise_tpu/models/inference.py``).

Panoptic fusion keeps the JAX package's form: one fused pass over the
[Q, H, W] masks computes every per-query statistic and the disjoint paint;
only the sequential id assignment (stuff classes merge into one segment)
runs as a loop, over Q small host values.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.tracing import span
from .resize import resize


def semantic_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor) -> torch.Tensor:
    """[Q, K+1] logits, [Q, H, W] mask logits -> [K, H, W] semantic probs."""
    with span("odise.fusion"):
        cls_prob = torch.softmax(mask_cls, dim=-1)[..., :-1]
        return torch.einsum("qc,qhw->chw", cls_prob, torch.sigmoid(mask_pred))


class PanopticOutput(NamedTuple):
    panoptic_seg: torch.Tensor      # [H, W] int32 segment ids (0 = void)
    segment_category: torch.Tensor  # [Q] int32 category of segment id-1 (-1 unused)
    segment_isthing: torch.Tensor   # [Q] bool
    num_segments: torch.Tensor      # [] int32


def _pixel_valid(H: int, W: int, valid_hw, device) -> torch.Tensor:
    """[H, W] bool: True inside the top-left (h, w) region."""
    hh, ww = valid_hw
    return ((torch.arange(H, device=device)[:, None] < hh)
            & (torch.arange(W, device=device)[None, :] < ww))


def panoptic_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor,
                       thing_mask: torch.Tensor,
                       object_mask_threshold: float = 0.8,
                       overlap_threshold: float = 0.8,
                       valid_hw: Optional[Tuple[int, int]] = None) -> PanopticOutput:
    """Panoptic fusion: mask_cls [Q, K+1] logits (last = null), mask_pred
    [Q, H, W] logits, thing_mask [K] bool. Segment ids are 1..n in query
    order; a query whose class is null, or whose score is at or below the
    threshold, paints nothing. With ``valid_hw`` = (h, w), pixels outside
    the top-left h x w region (shape-bucket padding) belong to no query and
    count toward no area."""
    with span("odise.fusion"):
        Q, K1 = mask_cls.shape
        K = K1 - 1
        dev = mask_pred.device
        probs = torch.softmax(mask_cls, dim=-1)
        scores = probs.amax(dim=-1)
        labels = probs.argmax(dim=-1)
        keep = (labels != K) & (scores > object_mask_threshold)

        mask_prob = torch.sigmoid(mask_pred)
        cur_prob_masks = torch.where(keep[:, None, None],
                                     scores[:, None, None] * mask_prob,
                                     torch.full_like(mask_prob, -1.0))
        mask_ids = cur_prob_masks.argmax(dim=0)  # [H, W]
        in_bounds = None
        if valid_hw is not None:
            in_bounds = _pixel_valid(*mask_pred.shape[1:], valid_hw, dev)
            mask_ids = torch.where(in_bounds, mask_ids, -1)  # padding: no winner
        isthing_q = thing_mask.to(dev)[labels.clamp(0, K - 1)]

        won_q = mask_ids[None] == torch.arange(Q, device=dev)[:, None, None]
        won = won_q & (mask_prob >= 0.5)
        mask_area = won_q.sum(dim=(1, 2))
        won_area = won.sum(dim=(1, 2))
        orig = mask_pred >= 0.0
        if in_bounds is not None:
            orig = orig & in_bounds
        original_area = orig.sum(dim=(1, 2))
        valid = (keep & (mask_area > 0) & (original_area > 0) & (won_area > 0)
                 & (mask_area.float() >= overlap_threshold * original_area.float())
                 & keep.any())

        # sequential id assignment over Q host values (one device sync)
        valid_h = valid.tolist()
        labels_h = labels.tolist()
        thing_h = isthing_q.tolist()
        class_to_id = [0] * K
        next_id = 1
        qid = [0] * Q
        seg_cat = [-1] * Q
        seg_thing = [False] * Q
        for q in range(Q):
            if not valid_h[q]:
                continue
            label, thing = labels_h[q], thing_h[q]
            existing = class_to_id[label]
            if not thing and existing > 0:  # stuff class already has a segment
                qid[q] = existing
                continue
            qid[q] = next_id
            seg_cat[next_id - 1] = label
            seg_thing[next_id - 1] = thing
            if not thing:
                class_to_id[label] = next_id
            next_id += 1

        qid_t = torch.tensor(qid, dtype=torch.int32, device=dev)
        pan_seg = (won * qid_t[:, None, None]).sum(dim=0, dtype=torch.int32)
        return PanopticOutput(
            pan_seg,
            torch.tensor(seg_cat, dtype=torch.int32, device=dev),
            torch.tensor(seg_thing, dtype=torch.bool, device=dev),
            torch.tensor(next_id - 1, dtype=torch.int32, device=dev))


class InstanceOutput(NamedTuple):
    scores: torch.Tensor       # [topk]
    classes: torch.Tensor      # [topk] int32
    masks: torch.Tensor        # [topk, H, W] bool
    mask_scores: torch.Tensor  # [topk] mask-probability rescoring factor


def instance_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor,
                       thing_mask: torch.Tensor, topk: int = 100,
                       panoptic_on: bool = True,
                       valid_hw: Optional[Tuple[int, int]] = None) -> InstanceOutput:
    """Top-k (query, class) pairs over the [Q, K] class probabilities,
    rescored by each mask's mean probability inside its binary mask.

    ``topk`` is capped at Q*K. Equal scores keep the lower flat index first,
    as ``jax.lax.top_k`` does (a stable descending sort; ``torch.topk``
    promises no order among ties). With ``panoptic_on``, stuff entries keep
    their slot and get score 0; callers drop rows with score 0. With
    ``valid_hw``, bucket padding adds no mask pixels.
    """
    Q, K1 = mask_cls.shape
    K = K1 - 1
    topk = min(topk, Q * K)
    scores = torch.softmax(mask_cls, dim=-1)[:, :-1]
    top_scores, top_idx = torch.sort(scores.reshape(-1), descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:topk], top_idx[:topk]
    top_classes = (top_idx % K).to(torch.int32)
    if panoptic_on:
        is_thing = thing_mask.to(mask_cls.device)[top_classes.long()]
        top_scores = torch.where(is_thing, top_scores, torch.zeros_like(top_scores))
    masks_logits = mask_pred[top_idx // K]  # [topk, H, W]
    mask_bin = masks_logits > 0
    if valid_hw is not None:
        mask_bin = mask_bin & _pixel_valid(*masks_logits.shape[1:], valid_hw,
                                           masks_logits.device)
    mask_scores = ((torch.sigmoid(masks_logits) * mask_bin).sum(dim=(1, 2))
                   / (mask_bin.sum(dim=(1, 2)) + 1e-6))
    return InstanceOutput(top_scores * mask_scores, top_classes, mask_bin, mask_scores)


def sem_seg_postprocess(result: torch.Tensor, img_hw: Tuple[int, int],
                        out_hw: Tuple[int, int]) -> torch.Tensor:
    """Crop [C, H_pad, W_pad] to its valid ``img_hw`` region, then resize to
    ``out_hw`` (bilinear, as ``jax.image.resize``)."""
    return resize(result[:, :img_hw[0], :img_hw[1]], out_hw, "bilinear")
