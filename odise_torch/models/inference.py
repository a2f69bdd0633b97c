"""Semantic and panoptic fusion for one image (counterpart of
``odise_tpu/models/inference.py``).

Panoptic fusion keeps the JAX package's form: one fused pass over the
[Q, H, W] masks computes every per-query statistic and the disjoint paint;
only the sequential id assignment (stuff classes merge into one segment)
runs as a loop, over Q small host values.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def semantic_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor) -> torch.Tensor:
    """[Q, K+1] logits, [Q, H, W] mask logits -> [K, H, W] semantic probs."""
    cls_prob = torch.softmax(mask_cls, dim=-1)[..., :-1]
    return torch.einsum("qc,qhw->chw", cls_prob, torch.sigmoid(mask_pred))


class PanopticOutput(NamedTuple):
    panoptic_seg: torch.Tensor      # [H, W] int32 segment ids (0 = void)
    segment_category: torch.Tensor  # [Q] int32 category of segment id-1 (-1 unused)
    segment_isthing: torch.Tensor   # [Q] bool
    num_segments: torch.Tensor      # [] int32


def panoptic_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor,
                       thing_mask: torch.Tensor,
                       object_mask_threshold: float = 0.8,
                       overlap_threshold: float = 0.8) -> PanopticOutput:
    """Panoptic fusion: mask_cls [Q, K+1] logits (last = null), mask_pred
    [Q, H, W] logits, thing_mask [K] bool. Segment ids are 1..n in query
    order; a query whose class is null, or whose score is at or below the
    threshold, paints nothing."""
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
    isthing_q = thing_mask.to(dev)[labels.clamp(0, K - 1)]

    won_q = mask_ids[None] == torch.arange(Q, device=dev)[:, None, None]
    won = won_q & (mask_prob >= 0.5)
    mask_area = won_q.sum(dim=(1, 2))
    won_area = won.sum(dim=(1, 2))
    original_area = (mask_pred >= 0.0).sum(dim=(1, 2))
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
