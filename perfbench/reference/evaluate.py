"""The reference's eval forward: encode the vocabulary with its own text
tower, run the trunk and the head, in float32 with TF32 off."""

from __future__ import annotations

import contextlib

import torch

from . import build as rbuild
from . import labels as rlabels
from .odise import category_overlapping_mask
from .tokenizer import tokenize


@contextlib.contextmanager
def exact_float32():
    """Float32 matrix products and convolutions without TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def build_reference(kind: str, scale: str, labels, with_clip_head: bool, device):
    return rbuild.build(kind, scale, train_labels=labels, with_clip_head=with_clip_head,
                        device=device)


@torch.no_grad()
def outputs(model, labels, images: torch.Tensor):
    """images [B, H, W, 3] in [0, 1] -> (mask_cls [B, Q, K+1], mask_pred
    [B, Q, H, W]) against ``labels`` (synonym groups), with the CLIP head's
    prompted labels where the model has the head."""
    dev = images.device

    def encode(groups):
        flat = [t for g in groups for t in g]
        return model.encode_vocab(torch.from_numpy(tokenize(flat)).long().to(dev))

    with exact_float32():
        text = encode(labels)
        clip_labels = clip_text = overlap = None
        if model.clip_head is not None:
            clip_labels = rlabels.prompted(labels)
            clip_text = encode(clip_labels)
            overlap = torch.from_numpy(category_overlapping_mask(model.train_labels,
                                                                 labels)).to(dev)
        trunk = model.forward_eval_trunk(images.float())
        head = {k: v for k, v in trunk.items() if k != "mask_pred"}
        mask_cls = model.forward_eval_head(head, text, labels, clip_text, clip_labels, overlap)
    return mask_cls, trunk["mask_pred"]
