"""Set criterion (counterpart of ``odise_tpu/losses/set_criterion.py``):
Hungarian-matched cross-entropy with the no-object class down-weighted by
``eos_coef``, and point-sampled sigmoid BCE and dice mask losses over
``num_points`` importance-sampled points, on the final and every auxiliary
decoder layer. Targets are padded to a fixed count with a validity mask.

The random points come from ``matcher.draw_uniform`` in the JAX package's
order: the matching points of every layer, then per layer the oversampled
candidates and the random top-up.

Over W ranks (``torch.distributed``) each rank holds its slice of the
batch, and the mean over the ranks of their losses and gradients is the
JAX package's one global step on the union batch: the draws are the union
batch's, sliced (``matcher.draw_rows``); the target count and each layer's
class-weight sum are summed over the ranks in one all-reduce, and each rank
divides by the union's over W. (Mask2Former's DDP criterion clamps the
mean count instead, ``clamp(N / W, min=1)``, and averages the class loss
over each rank's own weights; ROADMAP C27.)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import matcher
from ..ops.grid_sample import point_sample_binary, sample_nchw
from ..parallel.multihost import all_reduce_sum, get_world_size

__all__ = ["CriterionConfig", "get_uncertain_point_coords_with_randomness",
           "set_criterion"]


@dataclasses.dataclass(frozen=True)
class CriterionConfig:
    """The JAX config's fields but its TPU-only options (``approx_topk``,
    ``pred_quad_sample``), which select how, not what, it computes."""

    num_classes: int = 133
    class_weight: float = 2.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    eos_coef: float = 0.1
    num_points: int = 12544
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    deep_supervision: bool = True


def get_uncertain_point_coords_with_randomness(
        mask_logits: torch.Tensor, num_points: int, oversample_ratio: float,
        importance_sample_ratio: float, generator: Optional[torch.Generator] = None,
        layer: int = 0) -> torch.Tensor:
    """PointRend importance sampling. mask_logits [N, h, w] -> [N, P, 2] xy
    in [0, 1]: the most uncertain (smallest |logit|) of the oversampled
    candidates, in descending uncertainty with the lower index first on
    ties (``lax.top_k``'s order, from a stable sort), then random points."""
    N = mask_logits.shape[0]
    dev = mask_logits.device
    n_sampled = int(num_points * oversample_ratio)
    cand = matcher.draw_rows(generator, (N, n_sampled, 2), dev, "oversample", layer)
    logits = sample_nchw(mask_logits[:, None], cand)[:, 0]            # [N, S]
    uncertainty = -logits.abs()
    n_unc = int(importance_sample_ratio * num_points)
    n_rand = num_points - n_unc
    idx = torch.sort(uncertainty, dim=-1, descending=True, stable=True).indices[:, :n_unc]
    unc_pts = torch.gather(cand, 1, idx[..., None].expand(N, n_unc, 2))
    if n_rand > 0:
        rand_pts = matcher.draw_rows(generator, (N, n_rand, 2), dev, "random", layer)
        return torch.cat([unc_pts, rand_pts], dim=1)
    return unc_pts


def _class_targets(Q, targets, matched, cfg):
    """The matched targets' labels in a [B, Q] class map (the no-object
    class elsewhere) and each entry's weight in the class loss."""
    B = matched.shape[0]
    valid = targets["valid"].bool()
    target_classes = torch.full((B, Q + 1), cfg.num_classes, dtype=torch.long,
                                device=matched.device)
    target_classes.scatter_(1, torch.where(valid, matched, Q), targets["labels"].long())
    target_classes = target_classes[:, :Q]
    return target_classes, torch.where(target_classes == cfg.num_classes, cfg.eos_coef, 1.0)


def _one_layer_losses(pred_logits, pred_masks, targets, matched, cfg, num_masks,
                      class_weight_sum, generator, layer):
    B, Q, K1 = pred_logits.shape
    T = targets["labels"].shape[1]
    valid = targets["valid"].bool()

    target_classes, w = _class_targets(Q, targets, matched, cfg)
    logp = F.log_softmax(pred_logits.float(), dim=-1)
    ce = -torch.gather(logp, 2, target_classes[..., None])[..., 0]
    loss_ce = torch.sum(ce * w) / (torch.sum(w) if class_weight_sum is None
                                   else class_weight_sum)

    # masks: the matched prediction of every (valid or padded) target
    h, w_ = pred_masks.shape[-2:]
    pred_m = torch.gather(pred_masks, 1, matched[:, :, None, None].expand(B, T, h, w_))
    flat_pred = pred_m.reshape(B * T, h, w_)
    flat_gt = targets["masks"].reshape((B * T,) + tuple(targets["masks"].shape[2:]))
    flat_valid = valid.reshape(B * T).float()

    pts = get_uncertain_point_coords_with_randomness(
        flat_pred.detach(), cfg.num_points, cfg.oversample_ratio,
        cfg.importance_sample_ratio, generator, layer)
    pred_pts = sample_nchw(flat_pred[:, None], pts)[:, 0]             # [BT, P]
    gt_pts = point_sample_binary(flat_gt, pts)

    bce = (F.softplus(-pred_pts) * gt_pts
           + F.softplus(pred_pts) * (1.0 - gt_pts)).mean(-1)
    loss_mask = torch.sum(bce * flat_valid) / num_masks

    p = torch.sigmoid(pred_pts)
    numerator = 2.0 * torch.sum(p * gt_pts, dim=-1)
    denominator = torch.sum(p, -1) + torch.sum(gt_pts, -1)
    dice = 1.0 - (numerator + 1.0) / (denominator + 1.0)
    loss_dice = torch.sum(dice * flat_valid) / num_masks
    return {"loss_ce": loss_ce * cfg.class_weight,
            "loss_mask": loss_mask * cfg.mask_weight,
            "loss_dice": loss_dice * cfg.dice_weight}


def set_criterion(outputs: Dict, targets: Dict[str, torch.Tensor],
                  cfg: CriterionConfig = CriterionConfig(),
                  generator: Optional[torch.Generator] = None,
                  num_masks_override: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """Main and auxiliary losses.

    outputs: pred_logits [B, Q, K+1], pred_masks [B, Q, h, w] and
    aux_outputs (a list of the same). targets: labels [B, T] int, masks
    [B, T, H, W] binary, valid [B, T] bool. ``num_masks_override`` replaces
    the target count of the whole batch (gradient accumulation's
    DDP-equivalent count); over several ranks it is the count of every
    rank's rows, which each rank divides by the world size.
    """
    layers = [outputs] + (list(outputs.get("aux_outputs", []))
                          if cfg.deep_supervision else [])
    # every layer's costs first, then ONE auction over every (layer, image)
    costs = [matcher.match_cost_matrix(
        l["pred_logits"].detach().float(), l["pred_masks"].detach().float(),
        targets["labels"], targets["masks"], targets["valid"],
        num_points=cfg.num_points, cost_class=cfg.class_weight,
        cost_mask=cfg.mask_weight, cost_dice=cfg.dice_weight,
        generator=generator, layer=i) for i, l in enumerate(layers)]
    B = costs[0].shape[0]
    matched_all = matcher.assign_from_cost(torch.cat(costs, dim=0))
    matched = [matched_all[i * B:(i + 1) * B] for i in range(len(layers))]
    count = targets["valid"].float().sum()
    world = get_world_size()
    class_weight_sums = [None] * len(layers)
    if world > 1:
        # the union batch's target count and class-weight sums, one collective
        Q = layers[0]["pred_logits"].shape[1]
        sums = all_reduce_sum(torch.stack(
            [count] + [_class_targets(Q, targets, m, cfg)[1].sum() for m in matched]))
        count, class_weight_sums = sums[0], list(sums[1:] / world)
    if num_masks_override is not None:
        num_masks = num_masks_override / world
    else:
        num_masks = torch.clamp(count, min=1.0) / world
    losses: Dict[str, torch.Tensor] = {}
    for i, layer_out in enumerate(layers):
        ld = _one_layer_losses(
            layer_out["pred_logits"].float(), layer_out["pred_masks"].float(),
            targets, matched[i], cfg, num_masks, class_weight_sums[i], generator, i)
        if i == 0:
            losses.update(ld)
        else:
            losses.update({f"{k}_{i - 1}": v for k, v in ld.items()})
    return losses
