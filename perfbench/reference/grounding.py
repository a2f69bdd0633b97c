"""Mask-word grounding criterion (counterpart of
``odise_tpu/losses/grounding.py``): symmetric image-caption InfoNCE between
mask and word embeddings, each image-text similarity a softmax-attention
pool over the queries.

``collect_mode`` says how the negatives are gathered across ranks
(``torch.distributed``): ``"diff"`` gathers every rank's mask and word
embeddings with their gradients (the reference's diffdist, JAX's
``lax.all_gather``), ``"concat"`` gathers them as constants, so that the
gradients flow only through each product's local factor; ``None`` takes
the local batch alone. At world size 1 the three are the same. Each rank
weighs the image-to-text term by its own images' caption validity, as the
JAX package's collective path does (ROADMAP C28).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .helper import l2_normalize
from .single_process import all_gather_rows, get_data_rank, get_data_world_size

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

    def pool(masks, words):
        # [Bm, Q, Bw, K] similarity of every mask with every word; the pool
        # over queries gives [Bm (images), Bw (texts)]
        sim = (masks @ words.T * logit_scale).reshape(-1, Q, words.shape[0] // K, K)
        return (torch.softmax(sim, dim=1) * sim).sum(dim=1).mean(-1)

    if cfg.collect_mode is None or get_data_world_size() == 1:
        labels = torch.arange(B, device=m.device)
        sim_g_img_txt = sim_img_g_txt = pool(m, w)
    else:
        diff = cfg.collect_mode == "diff"
        gm, gw = all_gather_rows(m, diff), all_gather_rows(w, diff)  # [W*B*Q, C], [W*B*K, C]
        labels = torch.arange(B, device=m.device) + B * get_data_rank()
        sim_g_img_txt = pool(gm, w)   # [W*B, B]: every image against the local texts
        sim_img_g_txt = pool(m, gw)   # [B, W*B]: the local images against every text

    # loss 1: each local text against every image
    logp1 = F.log_softmax(sim_g_img_txt.T, dim=-1)
    l1 = -logp1.gather(1, labels[:, None])[:, 0]
    l1 = (l1 * valid.to(l1.dtype)).mean()

    # loss 2: each local image against every text, weighted by its own
    # text's validity
    logp2 = F.log_softmax(sim_img_g_txt, dim=-1)
    l2_all = -logp2.gather(1, labels[:, None])[:, 0]
    wsum = valid.to(l2_all.dtype)
    l2 = torch.sum(l2_all * wsum) / torch.clamp(torch.sum(wsum), min=1e-6)
    l2 = torch.where(torch.isfinite(l2), l2, l2_all.mean())
    return {"loss_mask_word": 0.5 * (l1 + l2) * cfg.loss_weight}


def mask_grounding_criterion(outputs: Dict, word_valid_mask: torch.Tensor,
                             cfg: GroundingConfig = GroundingConfig()
                             ) -> Dict[str, torch.Tensor]:
    """outputs: mask_embed, word_embed, logit_scale and aux_outputs;
    word_valid_mask [B, K] bool."""
    losses = dict(_one_layer_loss(outputs, word_valid_mask, cfg))
    if cfg.deep_supervision and "aux_outputs" in outputs:
        for i, aux in enumerate(outputs["aux_outputs"]):
            aux = dict(aux)
            aux.setdefault("word_embed", outputs["word_embed"])
            ld = _one_layer_loss(aux, word_valid_mask, cfg)
            losses.update({f"{k}_{i}": v for k, v in ld.items()})
    return losses
