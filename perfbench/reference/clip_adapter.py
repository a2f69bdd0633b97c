"""CLIP preprocessing, image and text embedding, and MaskCLIP (counterpart
of ``odise_tpu/models/clip/adapter.py``); images are NCHW.

Text embeddings for a vocabulary are computed once and passed in as
tensors (``build_text_embed``); the MaskCLIP attention mask is built from
predicted masks (``build_mask_attn_mask``, and the split-stream
``build_mask_reader_mask`` the CLIP head runs).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import decisions
from .helper import ensemble_logits_with_labels, l2_normalize
from .resize import resize
from .clip_model import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD
from .tokenizer import tokenize


class EmbeddedText(NamedTuple):
    text_embed: torch.Tensor      # [N, D] (normalized if asked)
    text_encodings: torch.Tensor  # [N, L, width]
    text_mask: torch.Tensor       # [N, L] 1 where token != 0


class EmbeddedImage(NamedTuple):
    image_embed: torch.Tensor      # [B, D]
    image_encodings: torch.Tensor  # [B, S/16, S/16, D]


def clip_preprocess(image: torch.Tensor, size: int) -> torch.Tensor:
    """Resize the shorter side to ``size`` (bicubic), centre-crop, and
    CLIP-normalise. ``image``: [B, 3, H, W] in [0, 1]."""
    H, W = image.shape[-2:]
    scale = size / min(H, W)
    nh = max(int(round(H * scale)), size)
    nw = max(int(round(W * scale)), size)
    image = resize(image, (nh, nw), "bicubic")
    top, left = (nh - size) // 2, (nw - size) // 2
    image = image[:, :, top:top + size, left:left + size]
    mean = torch.tensor(CLIP_PIXEL_MEAN, dtype=image.dtype, device=image.device)
    std = torch.tensor(CLIP_PIXEL_STD, dtype=image.dtype, device=image.device)
    return (image - mean[:, None, None]) / std[:, None, None]


def _token_masked(mask_logits: torch.Tensor, patch_size: int,
                  num_image_tokens: int) -> torch.Tensor:
    """[B, Q, N] bool: True where a patch's max mask probability is < 0.5."""
    B, Q = mask_logits.shape[:2]
    prob = torch.sigmoid(mask_logits)
    patch_max = F.max_pool2d(prob, kernel_size=patch_size, stride=patch_size)
    token_masked = decisions.threshold(
        (patch_max < 0.5).reshape(B, Q, -1),
        F.max_pool2d(mask_logits, kernel_size=patch_size, stride=patch_size).reshape(B, Q, -1))
    if token_masked.shape[-1] != num_image_tokens:
        raise ValueError(f"{token_masked.shape[-1]} patches for "
                         f"{num_image_tokens} image tokens")
    return token_masked


def build_mask_reader_mask(mask_logits: torch.Tensor, patch_size: int,
                           num_image_tokens: int) -> torch.Tensor:
    """Split-stream MaskCLIP mask, bool [B, Q, 1+N]; True = masked out.

    Column 0 is the class token and is never masked; columns 1..N mask the
    patches outside each predicted mask (``mask_logits`` [B, Q, S, S]).
    """
    token_masked = _token_masked(mask_logits, patch_size, num_image_tokens)
    cls_col = torch.zeros(token_masked.shape[:2] + (1,), dtype=torch.bool,
                          device=token_masked.device)
    return torch.cat([cls_col, token_masked], dim=-1)


def embed_image(visual, image: torch.Tensor, image_size: int,
                normalize: bool = True) -> EmbeddedImage:
    """Encode images [B, 3, H, W] in [0, 1], with the spatial encodings
    resized to stride 16 of the preprocessed input. ``visual(x)`` returns
    (image_embed [B, D], encodings [B, gh, gw, D]), as ``VisionTransformer``
    does."""
    img_embed, enc = visual(clip_preprocess(image, image_size))
    th = tw = image_size // 16
    enc = resize(enc.permute(0, 3, 1, 2), (th, tw), "bilinear").permute(0, 2, 3, 1)
    if normalize:
        img_embed = l2_normalize(img_embed)
    return EmbeddedImage(img_embed.float(), enc)


def embed_text(text_apply, tokens: torch.Tensor, normalize: bool = True) -> EmbeddedText:
    """Encode tokens [N, L]; ``text_apply(tokens)`` returns (text_embed
    [N, D], encodings [N, L, width]), as ``TextTransformer`` does."""
    text_mask = (tokens != 0).int()
    text_embed, text_encodings = text_apply(tokens)
    text_embed = text_embed.float()
    if normalize:
        text_embed = l2_normalize(text_embed)
    return EmbeddedText(text_embed, text_encodings.float(), text_mask)


def build_text_embed(text_apply, labels, batch_size: int = 256,
                     normalize: bool = False) -> torch.Tensor:
    """Embed a label list (or a list of synonym lists) in chunks of
    ``batch_size``; returns the flattened [sum(len(syns)), D] float32 table.
    Tokens go to the device of ``text_apply``'s parameters when it is a
    module, else to the CPU."""
    if isinstance(labels, str):
        labels = [labels]
    if labels and isinstance(labels[0], str):
        labels = [[t] for t in labels]
    device = (next(text_apply.parameters()).device
              if isinstance(text_apply, nn.Module) else "cpu")
    flat = [t for sub in labels for t in sub]
    outs = []
    for i in range(0, len(flat), batch_size):
        toks = torch.from_numpy(tokenize(flat[i:i + batch_size])).long().to(device)
        outs.append(text_apply(toks)[0].float())
    out = torch.cat(outs, dim=0)
    return l2_normalize(out) if normalize else out


def build_mask_attn_mask(mask_logits: torch.Tensor, patch_size: int,
                         num_image_tokens: int) -> torch.Tensor:
    """The MaskCLIP attention mask, bool [B, L, L] with L = Q + 1 + N; True
    = masked out. Nobody attends to the Q mask tokens; mask token i attends
    to the class token and to the patches where its (sigmoid, max-pooled)
    mask reaches 0.5."""
    B, Q = mask_logits.shape[:2]
    token_masked = _token_masked(mask_logits, patch_size, num_image_tokens)
    N = token_masked.shape[-1]
    L = Q + 1 + N
    attn_mask = torch.zeros((B, L, L), dtype=torch.bool, device=mask_logits.device)
    attn_mask[:, :, :Q] = True
    attn_mask[:, :Q, -N:] = token_masked
    return attn_mask


class MaskCLIP:
    """A CLIP ViT paired with the masked forward: ``get_mask_embed(image,
    mask)`` gives one CLIP embedding per mask, ``pred_logits`` classifies
    them against text embeddings with synonym ensembling."""

    def __init__(self, visual: nn.Module, image_size: int = 336, patch_size: int = 14):
        self.visual = visual
        self.image_size = image_size
        self.patch_size = patch_size

    def get_mask_embed(self, image: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """image [B, 3, H, W] in [0, 1], mask [B, Q, h, w] logits ->
        [B, Q, D]."""
        S = self.image_size
        img = clip_preprocess(resize(image, (S, S), "bilinear"), S)
        m = resize(mask, (S, S), "bilinear")
        reader_mask = build_mask_reader_mask(m, self.patch_size,
                                             (S // self.patch_size) ** 2)
        return self.visual(img, mask_tokens=mask.shape[1], reader_mask=reader_mask)

    @staticmethod
    def pred_logits(mask_embed, text_embed, labels, logit_scale=100.0):
        logits = logit_scale * torch.einsum(
            "bqc,kc->bqk", l2_normalize(mask_embed), l2_normalize(text_embed))
        return ensemble_logits_with_labels(logits, labels, "max")
