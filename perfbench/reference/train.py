"""The reference's train steps: the copied model's training forward, set
criterion (the matcher solved exactly) and, for CaptionODISE, the grounding
loss; the gradients of the trainable parameters (the frozen-tower rule),
optax's global-norm clip and AdamW, in float32 with TF32 off."""

from __future__ import annotations

from typing import Dict, List

import torch

from . import build as rbuild
from . import decisions
from .evaluate import exact_float32
from .grounding import GroundingConfig, mask_grounding_criterion
from .optimizer import clip_by_global_norm_, global_norm, make_optimizer
from .set_criterion import CriterionConfig, set_criterion
from .tokenizer import tokenize

FROZEN = ("vae", "unet", "sd_text", "clip_visual", "_text_enc", "text_encoder", "clip_head")


def is_trainable(name: str) -> bool:
    """The JAX package's frozen-tower rule (the SD towers, the CLIP image
    and text towers, the CLIP head), by the components of a parameter's
    name."""
    return not any(any(k in c for k in FROZEN) for c in name.split("."))


def build(kind: str, scale: str, labels, opts: dict, device):
    model = rbuild.build(kind, scale, train_labels=labels, with_clip_head=False,
                         use_checkpoint=opts["use_checkpoint"],
                         slide_training=opts["slide_training"],
                         slide_serial=opts["slide_serial"], device=device)
    return model


def trainable(model) -> Dict[str, torch.nn.Parameter]:
    out = {}
    for name, p in model.named_parameters():
        p.requires_grad_(is_trainable(name))
        if p.requires_grad:
            out[name] = p
    return out


def follow(model, kind: str, labels, batches: List[dict], generator: torch.Generator,
           opts: dict) -> dict:
    """Run the steps on ``batches`` from the model's present weights; the
    criterion draws from ``generator``. Returns each step's losses, the
    first step's gradient per parameter as the clip receives it and the
    parameters after the last step, on the host."""
    params = trainable(model)
    opt = make_optimizer(params, lr=opts["lr"], weight_decay=opts["weight_decay"])
    dev = next(model.parameters()).device
    n_classes = len(labels) if kind == "category" else 1
    cfg = CriterionConfig(num_classes=n_classes, num_points=opts["num_points"])
    out = {"losses": [], "first_grad": None}
    with exact_float32():
        text = None
        if kind == "category":
            with torch.no_grad():
                flat = [t for g in labels for t in g]
                text = model.encode_vocab(torch.from_numpy(tokenize(flat)).long().to(dev))
        for i, batch in enumerate(batches):
            batch = {k: v.to(dev) for k, v in batch.items()}
            for p in params.values():
                p.grad = None
            if kind == "category":
                outputs = model.forward_train(batch["image"], text, labels)
                targets = {"labels": batch["gt_labels"], "masks": batch["gt_masks"],
                           "valid": batch["gt_valid"]}
                losses = set_criterion(outputs, targets, cfg, generator)
            else:
                outputs = model.forward_train(batch["image"], batch["word_tokens"])
                targets = {"labels": torch.zeros_like(batch["gt_labels"]),
                           "masks": batch["gt_masks"], "valid": batch["gt_valid"]}
                losses = set_criterion(outputs, targets, cfg, generator)
                losses.update(mask_grounding_criterion(outputs, batch["word_valid"],
                                                       GroundingConfig()))
            total = sum(losses.values())
            total.backward()
            del outputs
            grads = [p.grad for p in params.values() if p.grad is not None]
            if i == 0:
                out["first_grad"] = {n: p.grad.detach().cpu().clone() for n, p in params.items()
                                     if p.grad is not None}
            gnorm = global_norm(grads)
            clip_by_global_norm_(grads, opts["grad_clip"], gnorm)
            opt.step()
            out["losses"].append(float(total.detach()))
            decisions.mark()
    out["params"] = {n: p.detach().cpu().clone() for n, p in params.items()}
    return out
