"""Two-phase model instantiation (counterpart of
``odise_tpu/config/build.py``): the backbone is built first, so that its
``output_shape()`` can fill the pixel decoder's ``input_shape`` before the
rest of the model graph is instantiated. The graph's fields that only the
JAX modules hold are dropped first (``drop_jax_only_fields``).
"""

from __future__ import annotations

import torch

from .lazy import _TARGET_KEY, instantiate, locate, resolve

_ANY = object()


def _jax_only_fields():
    """The fields that the JAX modules of an ODISE graph hold and the port's
    modules do not take, each with the one value the port's modules are
    built for. The JAX code reads none of them (``mask_classification``
    only to build a missing ``class_embed``, which the port requires);
    ``_ANY`` marks what the rest of the config reads by interpolation
    (``num_classes``) or what this module fills (``input_shape``)."""
    from ..models.backbone.feature_extractor import LdmImplicitCaptionerExtractor
    from ..models.decoder.pixel_decoder import MSDeformAttnPixelDecoder
    from ..models.decoder.transformer_decoder import (
        MaskFormerHead, ODISEMultiScaleMaskedTransformerDecoder)
    from ..models.odise import CaptionODISE, CategoryODISE, WordEmbed

    model = dict(size_divisibility=64, semantic_on=True, instance_on=True, panoptic_on=True)
    return {
        CategoryODISE: model,
        CaptionODISE: model,
        MaskFormerHead: dict(num_classes=_ANY, input_shape=_ANY, ignore_value=255,
                             loss_weight=1.0,
                             transformer_in_feature="multi_scale_pixel_decoder"),
        MSDeformAttnPixelDecoder: dict(transformer_dropout=0.0, common_stride=4),
        ODISEMultiScaleMaskedTransformerDecoder: dict(mask_classification=True,
                                                      pre_norm=False),
        WordEmbed: dict(num_words=8, word_dropout=0.0),
        LdmImplicitCaptionerExtractor: dict(clip_model_name="ViT-L-14"),
    }


def drop_jax_only_fields(cfg, fields=None):
    """Remove ``_jax_only_fields()`` from every node of a resolved model
    graph, in place. A field set to another value than the port's raises
    ``ValueError``: the port would ignore it."""
    fields = _jax_only_fields() if fields is None else fields
    if isinstance(cfg, dict):
        target = cfg.get(_TARGET_KEY)
        if isinstance(target, str):
            target = locate(target)
        for name, want in fields.get(target, {}).items():
            if name in cfg:
                got = cfg.pop(name)
                if want is not _ANY and got != want:
                    raise ValueError(
                        f"{target.__name__}.{name}={got!r}: the port's module is built for "
                        f"{want!r} and takes no other value")
        for v in cfg.values():
            drop_jax_only_fields(v, fields)
    elif isinstance(cfg, (list, tuple)):
        for v in cfg:
            drop_jax_only_fields(v, fields)
    return cfg


def instantiate_odise(cfg, device=None):
    """Instantiate an ODISE model config on ``device`` (default CUDA, which
    must be there; see ``model_zoo.factory.resolve_device``).

    A graph config (one with a ``backbone``) is built with ``device`` as the
    default device and moved there; a factory config (one callable builds
    the whole model, as ``model_zoo.factory.build_category_odise``) gets it
    as its ``device`` argument."""
    from ..model_zoo.factory import resolve_device

    device = resolve_device(device)
    cfg = drop_jax_only_fields(resolve(cfg))
    if "backbone" not in cfg:
        cfg.device = device
        return instantiate(cfg, _resolved=True)
    with torch.device(device):
        backbone = instantiate(cfg.backbone, _resolved=True)
        cfg.sem_seg_head.pixel_decoder.input_shape = dict(backbone.output_shape())
        cfg.backbone = backbone
        model = instantiate(cfg, _resolved=True)
    # buffers loaded from package data (the shared noise) start on the CPU
    return model.to(device).eval()
