"""Open-vocabulary inference wrapper (counterpart of
``odise_tpu/models/wrapper.py``): bind a test-time vocabulary to a model.

A vocabulary is encoded once into an immutable bundle of tensors
(``OpenVocabulary``); ``OpenPanopticInference`` runs the model's
vocabulary-independent trunk and then its head for that vocabulary. The JAX
package also caches one compiled trunk per model (``_TRUNK_JITS``) so that
several vocabularies share one compile; PyTorch runs eagerly, so the port
has nothing to cache.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.build import prompt_labels
from ..utils.tracing import span
from .clip.tokenizer import tokenize
from .odise import category_overlapping_mask

Labels = Tuple[Tuple[str, ...], ...]


@dataclasses.dataclass(frozen=True)
class OpenVocabulary:
    """Everything the eval forward needs for one vocabulary, on the model's
    device."""

    labels: Labels                                  # synonym groups
    text_embed_raw: torch.Tensor                    # [K_flat, D]
    clip_labels: Optional[Labels] = None
    clip_text_embed: Optional[torch.Tensor] = None
    category_overlap: Optional[torch.Tensor] = None
    thing_mask: Optional[torch.Tensor] = None       # [K] bool (for fusion)


def _device(model) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def build_open_vocabulary(model, labels: Sequence[Sequence[str]], *,
                          train_labels: Optional[Sequence[Sequence[str]]] = None,
                          thing_mask: Optional[np.ndarray] = None,
                          prompt: str = "photo",
                          with_clip_head: bool = True) -> OpenVocabulary:
    """Encode a vocabulary once: its flat synonyms, and for the CLIP head the
    prompted synonyms and which categories overlap ``train_labels``
    (default: the model's). ``thing_mask`` defaults to all things."""
    device = _device(model)
    labels = tuple(tuple(l) for l in labels)

    def encode(texts):
        return model.encode_vocab(torch.from_numpy(tokenize(texts)).long().to(device))

    text_embed_raw = encode([t for group in labels for t in group])
    clip_labels = clip_text_embed = overlap = None
    if with_clip_head:
        clip_labels = tuple(tuple(l) for l in prompt_labels(
            [list(g) for g in labels], prompt))
        clip_text_embed = encode([t for group in clip_labels for t in group])
        if train_labels is None:
            train_labels = model.train_labels
        overlap = torch.from_numpy(
            category_overlapping_mask(train_labels, labels)).to(device)
    if thing_mask is None:
        thing = torch.ones((len(labels),), dtype=torch.bool, device=device)
    else:
        thing = torch.as_tensor(np.asarray(thing_mask, bool), device=device)
    return OpenVocabulary(labels=labels, text_embed_raw=text_embed_raw,
                          clip_labels=clip_labels, clip_text_embed=clip_text_embed,
                          category_overlap=overlap, thing_mask=thing)


class OpenPanopticInference:
    """Bind (model, vocabulary) into an eval callable:
    ``__call__(images [B, H, W, 3] in [0, 1])`` -> (mask_cls [B, Q, K+1],
    mask_pred [B, Q, H, W]), on the model's device."""

    def __init__(self, model, vocabulary: OpenVocabulary):
        self.model = model
        self.vocabulary = vocabulary
        self.device = _device(model)

    @torch.no_grad()
    def __call__(self, images):
        with span("odise.infer"):
            images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
            trunk = self.model.forward_eval_trunk(images)
            v = self.vocabulary
            # the upsampled mask_pred is not a head input
            head_in = {k: t for k, t in trunk.items() if k != "mask_pred"}
            mask_cls = self.model.forward_eval_head(
                head_in, v.text_embed_raw, v.labels, v.clip_text_embed,
                v.clip_labels, v.category_overlap)
            return mask_cls, trunk["mask_pred"]
