"""Assemble the reference CategoryODISE and CaptionODISE (a frozen copy of
the port's ``model_zoo/factory.py``): every module is built in float32 on
the current default device; weights come from ``perfbench.common.weights``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import labels
from .feature_extractor import FeatureExtractorBackbone, LdmImplicitCaptionerExtractor
from .clip_model import TextTransformer
from .pixel_decoder import MSDeformAttnPixelDecoder
from .transformer_decoder import (MaskFormerHead, ODISEMultiScaleMaskedTransformerDecoder,
                                  PooledMaskEmbed, PseudoClassEmbed)
from .odise import CaptionODISE, CategoryEmbed, CategoryODISE, PoolingCLIPHead, WordEmbed

TINY = dict(
    hidden=32, queries=10, dec_layers=3, enc_layers=2, nheads=4, ffn=64,
    model_channels=8, vae_ch=8, context_dim=16, sd_text_layers=1,
    clip_vit_cfg=(32, 8, 16, 1, 2, 16), clip_dim=16,
    backbone_in_size=(64, 64), projection_dim=32,
    pooling_clip=dict(clip_image_size=32, patch_size=8, vit_width=16,
                      vit_layers=1, vit_heads=2, embed_dim=16),
    text_encoder=dict(width=16, layers=1, heads=2, embed_dim=16),
)

FULL = dict(
    hidden=256, queries=100, dec_layers=9, enc_layers=6, nheads=8, ffn=2048,
    model_channels=320, vae_ch=128, context_dim=768, sd_text_layers=12,
    clip_vit_cfg=(224, 14, 1024, 24, 16, 768), clip_dim=768,
    backbone_in_size=(512, 512), projection_dim=512,
    pooling_clip=dict(clip_image_size=336, patch_size=14, vit_width=1024,
                      vit_layers=24, vit_heads=16, embed_dim=768),
    text_encoder=dict(width=768, layers=12, heads=12, embed_dim=768),
)

TINY_TRAIN_LABELS = (("thing a",), ("thing b",), ("stuff c",))

Labels = Tuple[Tuple[str, ...], ...]


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; CUDA without a card is an error, not the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device


def _parts(scale: str, train_labels: Optional[Labels], with_clip_head: bool,
           backbone_in_size: Optional[tuple], num_classes: Optional[int],
           dtype: torch.dtype, train_opts: dict):
    """The modules both models share, built on the current default device.
    ``num_classes`` None means one class per training label; ``train_opts``
    are the backbone's training options."""
    if scale not in ("tiny", "full"):
        raise ValueError(f"unknown scale {scale!r}")
    cfg = dict(TINY if scale == "tiny" else FULL)
    if backbone_in_size is not None:
        cfg["backbone_in_size"] = tuple(backbone_in_size)
    if train_labels is None:
        train_labels = (TINY_TRAIN_LABELS if scale == "tiny"
                        else labels.coco_panoptic_labels())
    if num_classes is None:
        num_classes = len(train_labels)
    hidden = cfg["hidden"]
    captioner = LdmImplicitCaptionerExtractor(
        learnable_time_embed=True, model_channels=cfg["model_channels"],
        vae_ch=cfg["vae_ch"], context_dim=cfg["context_dim"],
        sd_text_layers=cfg["sd_text_layers"],
        clip_vit_cfg=tuple(cfg["clip_vit_cfg"]), dtype=dtype)
    backbone = FeatureExtractorBackbone(
        captioner, out_features=("s2", "s3", "s4", "s5"),
        backbone_in_size=tuple(cfg["backbone_in_size"]),
        projection_dim=cfg["projection_dim"], dtype=dtype, **train_opts)
    pixel_decoder = MSDeformAttnPixelDecoder(
        backbone.output_shape(), conv_dim=hidden, mask_dim=hidden,
        transformer_nheads=cfg["nheads"],
        transformer_dim_feedforward=max(cfg["ffn"] // 2, 64),
        transformer_enc_layers=cfg["enc_layers"], dtype=dtype)
    predictor = ODISEMultiScaleMaskedTransformerDecoder(
        hidden_dim=hidden, num_queries=cfg["queries"], nheads=cfg["nheads"],
        dim_feedforward=cfg["ffn"], dec_layers=cfg["dec_layers"],
        mask_dim=hidden, num_classes=num_classes, in_channels=hidden,
        class_embed=PseudoClassEmbed(num_classes),
        post_mask_embed=PooledMaskEmbed(hidden, hidden, hidden, dtype=dtype),
        dtype=dtype)
    te = cfg["text_encoder"]
    return dict(
        backbone=backbone,
        sem_seg_head=MaskFormerHead(pixel_decoder, predictor),
        text_encoder=TextTransformer(width=te["width"], layers=te["layers"],
                                     heads=te["heads"],
                                     embed_dim=te["embed_dim"], dtype=dtype),
        clip_head=(PoolingCLIPHead(dtype=dtype, **cfg["pooling_clip"])
                   if with_clip_head else None),
        train_labels=train_labels, num_queries=cfg["queries"]), cfg



def build(kind: str, scale: str = "full", *, train_labels: Optional[Labels] = None,
          with_clip_head: bool = True, use_checkpoint: bool = True,
          slide_training: bool = True, slide_serial: bool = True,
          backbone_in_size: Optional[tuple] = None, device="cuda"):
    """``kind`` "category" or "caption": the model in float32 on ``device``,
    as the port's ``build_category_odise`` / ``build_caption_odise`` build
    it, in eval mode."""
    train_opts = dict(use_checkpoint=use_checkpoint, slide_training=slide_training,
                      slide_serial=slide_serial)
    with torch.device(device):
        if kind == "category":
            parts, cfg = _parts(scale, train_labels, with_clip_head, backbone_in_size,
                                None, torch.float32, train_opts)
            model = CategoryODISE(category_head=CategoryEmbed(cfg["hidden"], cfg["clip_dim"]),
                                  **parts)
        elif kind == "caption":
            parts, cfg = _parts(scale, train_labels, with_clip_head, backbone_in_size,
                                1, torch.float32, train_opts)
            model = CaptionODISE(word_head=WordEmbed(cfg["hidden"], cfg["clip_dim"]), **parts)
        else:
            raise ValueError(f"unknown model kind {kind!r}")
    return model.to(device).eval()
