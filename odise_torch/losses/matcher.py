"""Hungarian matcher with point-sampled costs (counterpart of
``odise_tpu/losses/matcher.py``): class cost (-prob[target]) plus
point-sampled sigmoid BCE and dice over ``num_points`` random points shared
by an image's masks, solved on the device by the batched auction.

Every uniform draw of the criterion goes through ``draw_uniform``. The JAX
package draws with ``jax.random``, which torch cannot reproduce, so the
tests replace this one function with JAX's own draws. Over several ranks
each rank draws the whole batch's rows and keeps its own (``draw_rows``),
as the JAX package's one global step draws from one key over the global
batch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.grid_sample import point_sample_binary, sample_nchw
from ..ops.lap import assign_from_cost
from ..parallel.multihost import get_rank, get_world_size

__all__ = ["assign_from_cost", "batch_dice_cost", "batch_sigmoid_ce_cost",
           "draw_rows", "draw_uniform", "match_cost_matrix"]


def draw_uniform(generator: Optional[torch.Generator], shape: Tuple[int, ...],
                 device, kind: str, layer: int) -> torch.Tensor:
    """U[0, 1) float32 of ``shape`` on ``device``. ``kind`` ("match",
    "oversample" or "random") and ``layer`` (the decoder layer, 0 = final)
    name the draw; this version ignores them and draws from ``generator``."""
    return torch.rand(shape, generator=generator, device=device)


def draw_rows(generator: Optional[torch.Generator], shape: Tuple[int, ...],
              device, kind: str, layer: int) -> torch.Tensor:
    """This rank's ``shape[0]`` rows of one ``draw_uniform`` over every
    rank's rows (the ranks hold equal batches and seed ``generator`` alike):
    the draw the one-process step on the union batch makes, sliced."""
    world = get_world_size()
    if world == 1:
        return draw_uniform(generator, shape, device, kind, layer)
    n = shape[0]
    rows = draw_uniform(generator, (world * n,) + tuple(shape[1:]), device, kind, layer)
    return rows[get_rank() * n:(get_rank() + 1) * n]


def batch_sigmoid_ce_cost(pred_pts: torch.Tensor, tgt_pts: torch.Tensor) -> torch.Tensor:
    """[B, Q, P] logits x [B, T, P] targets -> [B, Q, T] mean BCE cost."""
    P = pred_pts.shape[-1]
    pos = F.softplus(-pred_pts)
    neg = F.softplus(pred_pts)
    return (torch.einsum("bqp,btp->bqt", pos, tgt_pts)
            + torch.einsum("bqp,btp->bqt", neg, 1.0 - tgt_pts)) / P


def batch_dice_cost(pred_pts: torch.Tensor, tgt_pts: torch.Tensor) -> torch.Tensor:
    """[B, Q, P] x [B, T, P] -> [B, Q, T] dice cost."""
    p = torch.sigmoid(pred_pts)
    numerator = 2.0 * torch.einsum("bqp,btp->bqt", p, tgt_pts)
    denominator = p.sum(-1)[:, :, None] + tgt_pts.sum(-1)[:, None, :]
    return 1.0 - (numerator + 1.0) / (denominator + 1.0)


@torch.no_grad()
def match_cost_matrix(pred_logits: torch.Tensor, pred_masks: torch.Tensor,
                      gt_labels: torch.Tensor, gt_masks: torch.Tensor,
                      gt_valid: torch.Tensor, *, num_points: int = 12544,
                      cost_class: float = 2.0, cost_mask: float = 5.0,
                      cost_dice: float = 5.0,
                      generator: Optional[torch.Generator] = None,
                      layer: int = 0) -> torch.Tensor:
    """Per-image matching costs [B, Q, T], invalid targets penalized.

    pred_logits [B, Q, K+1], pred_masks [B, Q, h, w] (no gradient flows),
    gt_labels [B, T], gt_masks [B, T, H, W] binary, gt_valid [B, T] bool.
    """
    B, Q, K1 = pred_logits.shape
    T = gt_labels.shape[1]
    if T > Q:
        raise ValueError("pad targets to at most num_queries")
    prob = torch.softmax(pred_logits.float(), dim=-1)
    cc = -torch.gather(prob, 2, gt_labels.long().clamp(0, K1 - 2)[:, None, :]
                       .expand(B, Q, T))
    pts = draw_rows(generator, (B, num_points, 2), pred_logits.device, "match", layer)
    pred_pts = sample_nchw(pred_masks.float(), pts)                       # [B, Q, P]
    H, W = gt_masks.shape[-2:]
    tgt_pts = point_sample_binary(
        gt_masks.reshape(B * T, H, W),
        pts[:, None].expand(B, T, num_points, 2).reshape(B * T, num_points, 2),
    ).reshape(B, T, num_points)
    cost = (cost_class * cc + cost_mask * batch_sigmoid_ce_cost(pred_pts, tgt_pts)
            + cost_dice * batch_dice_cost(pred_pts, tgt_pts))
    # invalid targets cost a little more than any real entry; the penalty
    # stays on the data's scale, so the auction's increment does too
    valid = gt_valid.bool()[:, None, :]
    real_max = torch.where(valid, cost, float("-inf")).amax(dim=(1, 2))
    real_max = torch.where(torch.isfinite(real_max), real_max, 0.0)
    return torch.where(valid, cost, real_max[:, None, None] + 1.0)
