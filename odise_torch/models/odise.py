"""CategoryODISE and CaptionODISE (counterpart of
``odise_tpu/models/odise.py``).

Public layouts follow the JAX package: images [B, H, W, 3] in [0, 1];
``forward_eval_trunk`` returns mask_pred [B, Q, H, W], mask_embed,
logit_scale and clip_mask_embed (CaptionODISE also the binary
pred_logits); ``forward_eval_head`` returns mask_cls [B, Q, K+1];
``forward_train`` returns the decoder's outputs with aux_outputs, ready for
the set criterion (and, for CaptionODISE, the grounding criterion).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..utils.tracing import span
from .clip.adapter import build_mask_reader_mask, clip_preprocess
from .clip.model import TextTransformer, VisionTransformer
from .helper import ensemble_logits_with_labels, l2_normalize
from .modules import Dense, param
from .resize import resize

Labels = Tuple[Tuple[str, ...], ...]


def cal_pred_logits(mask_embed, text_embed, null_embed, logit_scale, labels):
    """Cosine classification with synonym ensembling and a null column
    (float32 logits, as the JAX code's float32 scale promotes them)."""
    mask_embed = l2_normalize(mask_embed)
    pred = logit_scale * torch.einsum(
        "bqc,kc->bqk", mask_embed, l2_normalize(text_embed)).float()
    pred = ensemble_logits_with_labels(pred, labels, "max")
    null_pred = logit_scale * torch.einsum(
        "bqc,kc->bqk", mask_embed, l2_normalize(null_embed)).float()
    return torch.cat([pred, null_pred], dim=-1)


class CategoryEmbed(nn.Module):
    """Text projection + learnable null embed."""

    def __init__(self, projection_dim: int, clip_dim: int = 768,
                 dtype=torch.float32):
        super().__init__()
        self.null_embed = param((1, clip_dim))
        self.text_proj = Dense(clip_dim, projection_dim, dtype=dtype)

    def forward(self, text_embed_raw):
        return {"text_embed": self.text_proj(text_embed_raw),
                "null_embed": self.text_proj(self.null_embed)}


class WordEmbed(nn.Module):
    """Caption-word (and, at eval, vocabulary) projection of raw CLIP text
    embeds."""

    def __init__(self, projection_dim: int, clip_dim: int = 768,
                 dtype=torch.float32):
        super().__init__()
        self.word_proj = Dense(clip_dim, projection_dim, dtype=dtype)

    def forward(self, word_embed_raw):
        return {"word_embed": self.word_proj(word_embed_raw)}


class PoolingCLIPHead(nn.Module):
    """Test-time MaskCLIP classifier, geometrically ensembled with the mask
    generator's logits; exponents alpha (seen) / beta (novel)."""

    def __init__(self, alpha: float = 0.35, beta: float = 0.65,
                 clip_image_size: int = 336, patch_size: int = 14,
                 vit_width: int = 1024, vit_layers: int = 24,
                 vit_heads: int = 16, embed_dim: int = 768,
                 dtype=torch.float32):
        super().__init__()
        self.alpha, self.beta = alpha, beta
        self.clip_image_size, self.patch_size = clip_image_size, patch_size
        self.embed_dim = embed_dim
        self.dtype = dtype
        self.clip_visual = VisionTransformer(
            image_size=clip_image_size, patch_size=patch_size, width=vit_width,
            layers=vit_layers, heads=vit_heads, embed_dim=embed_dim, dtype=dtype)
        self.logit_scale = param((), fill=math.log(1 / 0.07))

    def get_mask_embed(self, images: torch.Tensor, masks: torch.Tensor):
        """images [B, 3, H, W] in [0, 1]; masks [B, Q, h, w] logits ->
        [B, Q, embed_dim] float32."""
        S = self.clip_image_size
        with span("odise.clip_head"):
            img = clip_preprocess(resize(images, (S, S), "bilinear"), S).to(self.dtype)
            m = resize(masks, (S, S), "bilinear")
            reader_mask = build_mask_reader_mask(m, self.patch_size,
                                                 (S // self.patch_size) ** 2)
            return self.clip_visual(img, mask_tokens=masks.shape[1],
                                    reader_mask=reader_mask)

    def ensemble(self, mask_embed, pred_open_logits, text_embed,
                 labels: Labels, category_overlapping_mask) -> torch.Tensor:
        """Cosine MaskCLIP logits, then the alpha/beta seen/novel geometric
        ensemble with ``pred_open_logits``. Returns [B, Q, K] float32."""
        with span("odise.clip_head"):
            me = l2_normalize(mask_embed)
            te = l2_normalize(text_embed).to(me.dtype)
            scale = torch.clamp(torch.exp(self.logit_scale), max=100.0)
            clip_logits = ensemble_logits_with_labels(
                scale * torch.einsum("bqc,kc->bqk", me, te), labels, "max")
            ovl = category_overlapping_mask.float()
            p = torch.softmax(pred_open_logits.float(), dim=-1)
            q = torch.softmax(clip_logits.float(), dim=-1)
            base = torch.log(torch.clamp(p ** (1 - self.alpha) * q ** self.alpha,
                                         min=1e-9)) * ovl
            novel = torch.log(torch.clamp(p ** (1 - self.beta) * q ** self.beta,
                                          min=1e-9)) * (1.0 - ovl)
            return base + novel


class CLIPOpenClassEmbed(nn.Module):
    """Classification head that projects the text or the image modality
    into a shared space (counterpart of ``odise_tpu/models/odise.py``'s;
    no shipped config uses it). ``forward(x [B, Q, hidden_dim],
    text_embed_raw [K_flat, clip_dim])`` -> [B, Q, K(+1)] logits with
    synonym ensembling over ``labels``, the null column last when
    ``with_null_embed``."""

    def __init__(self, labels: Labels, hidden_dim: int,
                 projection_modality: str = "text", with_null_embed: bool = True,
                 temperature: float = 0.07, ensemble_method: str = "max",
                 clip_dim: int = 768, dtype=torch.float32):
        super().__init__()
        if projection_modality not in ("text", "image"):
            raise ValueError(f"unknown projection_modality {projection_modality!r}")
        self.labels = tuple(labels)
        self.projection_modality = projection_modality
        self.ensemble_method = ensemble_method
        self.dtype = dtype
        self.logit_scale = param((), fill=math.log(1 / temperature))
        self.null_embed = param((1, clip_dim), std=0.02) if with_null_embed else None
        if projection_modality == "text":
            self.embed_projection = Dense(clip_dim, hidden_dim, bias=False, dtype=dtype)
        else:
            self.embed_projection = Dense(hidden_dim, clip_dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor, text_embed_raw: torch.Tensor) -> torch.Tensor:
        logit_scale = torch.clamp(torch.exp(self.logit_scale), max=100.0)
        null = self.null_embed
        if self.projection_modality == "text":
            text_embed = self.embed_projection(text_embed_raw)
            if null is not None:
                null = self.embed_projection(null)
        else:
            x = self.embed_projection(x)
            text_embed = text_embed_raw
        x = l2_normalize(x)
        pred = logit_scale * torch.einsum(
            "bqc,kc->bqk", x, l2_normalize(text_embed).to(x.dtype))
        pred = ensemble_logits_with_labels(pred, self.labels, self.ensemble_method)
        if null is None:
            return pred
        null_pred = logit_scale * torch.einsum(
            "bqc,kc->bqk", x, l2_normalize(null).to(x.dtype))
        return torch.cat([pred, null_pred], dim=-1)


def category_overlapping_mask(train_labels, test_labels) -> np.ndarray:
    """[K] int: 1 where a test category shares a synonym with the training
    labels."""
    train_set = {l for label in train_labels for l in label}
    return np.asarray([int(not train_set.isdisjoint(set(t))) for t in test_labels],
                      np.int64)


class _EvalODISE(nn.Module):
    """What both eval models share: the frozen text tower, the trunk and
    ``forward_eval``. Submodules register in the JAX models' field order
    (backbone, sem_seg_head, the vocabulary head, clip_head, text_encoder)."""

    def __init__(self, backbone: nn.Module, sem_seg_head: nn.Module,
                 head_name: str, head: nn.Module, text_encoder: TextTransformer,
                 clip_head: Optional[PoolingCLIPHead], train_labels: Labels,
                 num_queries: int, object_mask_threshold: float = 0.0,
                 overlap_threshold: float = 0.8, test_topk_per_image: int = 100):
        super().__init__()
        self.backbone = backbone
        self.sem_seg_head = sem_seg_head
        self.add_module(head_name, head)
        self.clip_head = clip_head
        self.text_encoder = text_encoder
        self.train_labels = tuple(train_labels)
        self.num_queries = num_queries
        # fusion settings the eval loop reads
        self.object_mask_threshold = object_mask_threshold
        self.overlap_threshold = overlap_threshold
        self.test_topk_per_image = test_topk_per_image

    def encode_vocab(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [N, 77] -> pooled projected CLIP text embeds [N, D]."""
        return self.text_encoder(tokens)[0]

    def forward_features(self, images: torch.Tensor, training: bool):
        """The mask decoder's outputs for images [B, H, W, 3]."""
        x = images.permute(0, 3, 1, 2)
        return self.sem_seg_head(self.backbone(x, training=training),
                                 training=training)

    def _trunk(self, images: torch.Tensor):
        """(trunk dict, the mask decoder's outputs) for images [B, H, W, 3]."""
        x = images.permute(0, 3, 1, 2)
        outputs = self.forward_features(images, training=False)
        trunk = {"mask_embed": outputs["mask_embed"],
                 "logit_scale": outputs["logit_scale"]}
        mask_pred = outputs["pred_masks"]
        if self.clip_head is not None:
            trunk["clip_mask_embed"] = self.clip_head.get_mask_embed(x, mask_pred)
        with span("odise.mask_upsample"):
            trunk["mask_pred"] = resize(mask_pred.float(), images.shape[1:3],
                                        "bilinear")
        return trunk, outputs

    def forward_eval(self, images, text_embed_raw, labels: Labels,
                     clip_text_embed=None, clip_labels=None,
                     category_overlap=None):
        """-> (mask_cls [B, Q, K+1], mask_pred [B, Q, H, W])."""
        trunk = self.forward_eval_trunk(images)
        mask_cls = self.forward_eval_head(trunk, text_embed_raw, labels,
                                          clip_text_embed, clip_labels,
                                          category_overlap)
        return mask_cls, trunk["mask_pred"]


class CategoryODISE(_EvalODISE):
    """Label-supervised ODISE: ``encode_vocab``, ``forward_train``,
    ``forward_eval_trunk``, ``forward_eval_head`` and ``forward_eval``."""

    def __init__(self, backbone: nn.Module, sem_seg_head: nn.Module,
                 category_head: CategoryEmbed, text_encoder: TextTransformer,
                 clip_head: Optional[PoolingCLIPHead] = None,
                 train_labels: Labels = (), num_queries: int = 100, **fusion):
        """``fusion``: the eval settings ``_EvalODISE`` takes by keyword."""
        super().__init__(backbone, sem_seg_head, "category_head", category_head,
                         text_encoder, clip_head, train_labels, num_queries, **fusion)

    def forward_train(self, images: torch.Tensor, text_embed_raw: torch.Tensor,
                      labels: Optional[Labels] = None) -> Dict:
        """Training outputs for images [B, H, W, 3]: the decoder's outputs
        with cosine ``pred_logits`` (synonym-ensembled, null column last)
        on the final and every aux layer. ``text_embed_raw`` [K_flat, D]
        holds the training vocabulary's raw CLIP text embeds."""
        labels = labels if labels is not None else self.train_labels
        outputs = self.forward_features(images, training=True)
        cat = self.category_head(text_embed_raw)
        outputs.update(cat)

        def with_logits(o):
            o = dict(o)
            o["pred_logits"] = cal_pred_logits(o["mask_embed"], cat["text_embed"],
                                               cat["null_embed"], o["logit_scale"],
                                               labels)
            return o

        outputs["pred_logits"] = with_logits(outputs)["pred_logits"]
        outputs["aux_outputs"] = [with_logits(a) for a in outputs["aux_outputs"]]
        return outputs

    def forward_eval_trunk(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Vocabulary-independent part: SD backbone, mask decoder, CLIP mask
        embeds and the mask upsample. images [B, H, W, 3] in [0, 1]."""
        return self._trunk(images)[0]

    def forward_eval_head(self, trunk: Dict[str, torch.Tensor],
                          text_embed_raw: torch.Tensor, labels: Labels,
                          clip_text_embed: Optional[torch.Tensor] = None,
                          clip_labels: Optional[Labels] = None,
                          category_overlap: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """Vocabulary-dependent tail -> mask_cls [B, Q, K+1]."""
        with span("odise.vocab_head"):
            cat = self.category_head(text_embed_raw)
            mask_cls = cal_pred_logits(trunk["mask_embed"], cat["text_embed"],
                                       cat["null_embed"], trunk["logit_scale"],
                                       labels)
            if self.clip_head is not None and clip_text_embed is not None:
                open_logits = self.clip_head.ensemble(
                    trunk["clip_mask_embed"], mask_cls[..., :-1], clip_text_embed,
                    clip_labels, category_overlap)
                bg_prob = torch.softmax(mask_cls.float(), dim=-1)[..., -1:]
                class_probs = torch.softmax(open_logits, dim=-1)
                mask_cls = torch.log(torch.cat([class_probs * (1.0 - bg_prob),
                                                bg_prob], dim=-1) + 1e-8)
            return mask_cls


class CaptionODISE(_EvalODISE):
    """Caption-supervised ODISE. Its mask classifier is binary (fg, bg); in
    training the caption words go through ``word_head`` for the grounding
    loss; at eval the vocabulary goes through ``word_head`` into cosine
    logits against the mask embeds and the CLIP head's ensemble, and the fg
    probability scales the class probabilities."""

    def __init__(self, backbone: nn.Module, sem_seg_head: nn.Module,
                 word_head: WordEmbed, text_encoder: TextTransformer,
                 clip_head: Optional[PoolingCLIPHead] = None,
                 train_labels: Labels = (), num_queries: int = 100, **fusion):
        super().__init__(backbone, sem_seg_head, "word_head", word_head,
                         text_encoder, clip_head, train_labels, num_queries, **fusion)

    def encode_words(self, word_tokens: torch.Tensor) -> torch.Tensor:
        """[B, K, 77] -> [B, K, D] raw CLIP embeds of caption words."""
        B, K, L = word_tokens.shape
        with span("odise.text_tower"):
            return self.encode_vocab(word_tokens.reshape(B * K, L)).reshape(B, K, -1)

    def forward_train(self, images: torch.Tensor, word_tokens: torch.Tensor) -> Dict:
        """Training outputs: the decoder's outputs (binary pred_logits) and
        the projected caption words ``word_embed`` [B, K, D], also on every
        aux layer. word_tokens [B, K, 77]; the text tower runs without
        gradient, as the JAX code stops it."""
        outputs = self.forward_features(images, training=True)
        with torch.no_grad():
            word_embed_raw = self.encode_words(word_tokens)
        outputs.update(self.word_head(word_embed_raw))
        for aux in outputs["aux_outputs"]:
            aux["word_embed"] = outputs["word_embed"]
        return outputs

    def forward_eval_trunk(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """As CategoryODISE's, plus the binary ``pred_logits`` [B, Q, 2]."""
        trunk, outputs = self._trunk(images)
        trunk["pred_logits"] = outputs["pred_logits"]
        return trunk

    def forward_eval_head(self, trunk: Dict[str, torch.Tensor],
                          text_embed_raw: torch.Tensor, labels: Labels,
                          clip_text_embed: Optional[torch.Tensor] = None,
                          clip_labels: Optional[Labels] = None,
                          category_overlap: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """Vocabulary-dependent tail -> mask_cls [B, Q, K+1], softmaxes in
        float32."""
        with span("odise.vocab_head"):
            word_embed = self.word_head(text_embed_raw[None])["word_embed"][0]
            open_logits = trunk["logit_scale"] * torch.einsum(
                "bqc,kc->bqk", l2_normalize(trunk["mask_embed"]),
                l2_normalize(word_embed)).float()
            open_logits = ensemble_logits_with_labels(open_logits, labels, "max")
            if self.clip_head is not None and clip_text_embed is not None:
                open_logits = self.clip_head.ensemble(
                    trunk["clip_mask_embed"], open_logits, clip_text_embed,
                    clip_labels, category_overlap)
            bg_prob = torch.softmax(trunk["pred_logits"].float(), dim=-1)[..., -1:]
            class_probs = torch.softmax(open_logits.float(), dim=-1)
            return torch.log(torch.cat([class_probs * (1.0 - bg_prob), bg_prob],
                                       dim=-1) + 1e-8)
