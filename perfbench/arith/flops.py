"""Model FLOPs of one call or one train step, counted with
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference on
the ``meta`` device at the cell's shapes. The count follows the model's
mathematics, so it stays fixed when the port changes how it computes.

Counted: matrix products, convolutions and attention (the counter's
formulas). Not counted: elementwise work, norms, resizes, the deformable
attention's bilinear sampling, the criterion's matching and point
sampling. Training counts one forward and one backward of what the step
differentiates, without the checkpoints' recomputation.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import build as rbuild
from ..reference.train import is_trainable


@functools.lru_cache(maxsize=None)
def infer_flops(kind: str, scale: str, with_clip_head: bool, hw: Tuple[int, int],
                batch: int, n_text: int, n_clip_text: int) -> int:
    """One eval call: the trunk at ``batch`` images of ``hw`` and the
    vocabulary head against ``n_text`` (and ``n_clip_text``) embeddings."""
    m = rbuild.build(kind, scale, device="meta", with_clip_head=with_clip_head,
                     use_checkpoint=False)
    m.requires_grad_(False)
    dim = m.text_encoder.text_projection.shape[1]
    img = torch.zeros(batch, *hw, 3, device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        trunk = m.forward_eval_trunk(img)
        head = {k: v for k, v in trunk.items() if k != "mask_pred"}
        labels = tuple((str(i),) for i in range(n_text))
        clip_labels = tuple((str(i),) for i in range(n_clip_text)) if with_clip_head else None
        m.forward_eval_head(head, torch.zeros(n_text, dim, device="meta"), labels,
                            torch.zeros(n_clip_text, dim, device="meta") if with_clip_head else None,
                            clip_labels,
                            torch.zeros(n_text, dtype=torch.long, device="meta"))
    return int(fc.get_total_flops())


@functools.lru_cache(maxsize=None)
def train_flops(kind: str, scale: str, batch: int, size: int, n_text: int,
                num_words: int, text_dim: int) -> int:
    """One train step: the training forward at ``batch`` images of
    ``size`` px and the backward of what the step differentiates (the
    trainable parameters, through the frozen towers to the captioner's
    projections), from a loss that reads every output the criterion reads.
    The caption model's text tower runs on ``num_words`` words an image,
    without gradient, as the step runs it."""
    m = rbuild.build(kind, scale, device="meta", with_clip_head=False, use_checkpoint=False)
    for name, p in m.named_parameters():
        p.requires_grad_(is_trainable(name))
    img = torch.zeros(batch, size, size, 3, device="meta")
    with FlopCounterMode(display=False) as fc:
        if kind == "category":
            labels = tuple((str(i),) for i in range(n_text))
            out = m.forward_train(img, torch.zeros(n_text, text_dim, device="meta"), labels)
        else:
            tokens = torch.zeros(batch, num_words, 77, dtype=torch.long, device="meta")
            out = m.forward_train(img, tokens)
        layers = [out] + list(out["aux_outputs"])
        loss = sum(o["pred_masks"].float().sum() + o["pred_logits"].float().sum()
                   for o in layers)
        if kind == "caption":
            loss = loss + sum(o["mask_embed"].float().sum() for o in layers)
            loss = loss + out["word_embed"].float().sum()
        loss.backward()
    return int(fc.get_total_flops())
