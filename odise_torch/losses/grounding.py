"""Mask-word grounding criterion (counterpart of
``odise_tpu/losses/grounding.py`` on one process): symmetric image-caption
InfoNCE between mask and word embeddings, each image-text similarity a
softmax-attention pool over the queries.

``collect_mode`` ("diff", "concat" or None) says how the JAX criterion
gathers the negatives across devices. On one process every mode means the
local batch, which is what each computes at world size 1; the port has no
gather yet and refuses a world size above 1.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..models.helper import l2_normalize

__all__ = ["GroundingConfig", "mask_grounding_criterion"]


@dataclasses.dataclass(frozen=True)
class GroundingConfig:
    loss_weight: float = 1.0
    collect_mode: Optional[str] = "diff"
    deep_supervision: bool = True

    def __post_init__(self):
        if self.collect_mode not in ("diff", "concat", None):
            raise ValueError(f"collect_mode {self.collect_mode!r} not in "
                             "('diff', 'concat', None)")


def _one_layer_loss(outputs, word_valid_mask, cfg):
    logit_scale = outputs["logit_scale"]
    m = l2_normalize(outputs["mask_embed"].float())                   # [B, Q, C]
    w = l2_normalize(outputs["word_embed"].float())                   # [B, K, C]
    B, Q, C = m.shape
    K = w.shape[1]
    m = m.reshape(B * Q, C)
    w = w.reshape(B * K, C)
    valid = word_valid_mask.bool().any(dim=-1)                        # [B]

    # [B, Q, B, K] similarity of every mask with every word; the pool over
    # queries gives [B (images), B (texts)]
    sim_mw = (m @ w.T * logit_scale).reshape(B, Q, B, K)
    sim_img_txt = (torch.softmax(sim_mw, dim=1) * sim_mw).sum(dim=1).mean(-1)
    labels = torch.arange(B, device=m.device)

    # loss 1: each text against every image
    logp1 = F.log_softmax(sim_img_txt.T, dim=-1)
    l1 = -logp1.gather(1, labels[:, None])[:, 0]
    l1 = (l1 * valid.to(l1.dtype)).mean()

    # loss 2: each image against every text, weighted by the text's validity
    logp2 = F.log_softmax(sim_img_txt, dim=-1)
    l2_all = -logp2.gather(1, labels[:, None])[:, 0]
    wsum = valid.to(l2_all.dtype)[labels]
    l2 = torch.sum(l2_all * wsum) / torch.clamp(torch.sum(wsum), min=1e-6)
    l2 = torch.where(torch.isfinite(l2), l2, l2_all.mean())
    return {"loss_mask_word": 0.5 * (l1 + l2) * cfg.loss_weight}


def mask_grounding_criterion(outputs: Dict, word_valid_mask: torch.Tensor,
                             cfg: GroundingConfig = GroundingConfig()
                             ) -> Dict[str, torch.Tensor]:
    """outputs: mask_embed, word_embed, logit_scale and aux_outputs;
    word_valid_mask [B, K] bool."""
    if (cfg.collect_mode is not None and torch.distributed.is_available()
            and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        raise NotImplementedError(
            f"collect_mode={cfg.collect_mode!r} across {torch.distributed.get_world_size()} "
            "processes: the port's grounding loss gathers no negatives yet")
    losses = dict(_one_layer_loss(outputs, word_valid_mask, cfg))
    if cfg.deep_supervision and "aux_outputs" in outputs:
        for i, aux in enumerate(outputs["aux_outputs"]):
            aux = dict(aux)
            aux.setdefault("word_embed", outputs["word_embed"])
            ld = _one_layer_loss(aux, word_valid_mask, cfg)
            losses.update({f"{k}_{i}": v for k, v in ld.items()})
    return losses
