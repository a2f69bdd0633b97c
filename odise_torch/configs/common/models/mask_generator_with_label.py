# CategoryODISE mask-generator graph
# (reference configs/common/models/mask_generator_with_label.py:28-104).
from odise_torch.config import L
from odise_torch.data.build import get_openseg_labels
from odise_torch.models.clip.model import TextTransformer
from odise_torch.models.decoder.pixel_decoder import MSDeformAttnPixelDecoder
from odise_torch.models.decoder.transformer_decoder import (
    MaskFormerHead,
    ODISEMultiScaleMaskedTransformerDecoder,
    PooledMaskEmbed,
    PseudoClassEmbed,
)
from odise_torch.models.odise import CategoryEmbed, CategoryODISE, PoolingCLIPHead
from odise_torch.losses import CriterionConfig


def _tuple_labels(dataset="coco_panoptic", prompt_engineered=True):
    return tuple(tuple(l) for l in get_openseg_labels(dataset, prompt_engineered))


model = L(CategoryODISE)(
    backbone=None,  # attached by odise_with_label.py
    sem_seg_head=L(MaskFormerHead)(
        ignore_value=255,
        num_classes=133,
        pixel_decoder=L(MSDeformAttnPixelDecoder)(
            input_shape=None,  # filled by instantiate_odise
            conv_dim=256,
            mask_dim=256,
            transformer_dropout=0.0,
            transformer_nheads=8,
            transformer_dim_feedforward=1024,
            transformer_enc_layers=6,
            transformer_in_features=["s3", "s4", "s5"],
            common_stride=4,
        ),
        loss_weight=1.0,
        transformer_in_feature="multi_scale_pixel_decoder",
        transformer_predictor=L(ODISEMultiScaleMaskedTransformerDecoder)(
            class_embed=L(PseudoClassEmbed)(num_classes="${..num_classes}"),
            hidden_dim=256,
            post_mask_embed=L(PooledMaskEmbed)(
                hidden_dim="${..hidden_dim}",
                mask_dim="${..mask_dim}",
                projection_dim="${..mask_dim}",
            ),
            in_channels="${..pixel_decoder.conv_dim}",
            mask_classification=True,
            num_classes="${..num_classes}",
            num_queries="${...num_queries}",
            nheads=8,
            dim_feedforward=2048,
            # 9 decoder layers, +1 loss on the learnable queries
            dec_layers=9,
            pre_norm=False,
            enforce_input_project=False,
            mask_dim=256,
        ),
    ),
    category_head=L(CategoryEmbed)(
        projection_dim="${..sem_seg_head.transformer_predictor.post_mask_embed.projection_dim}",
        clip_dim=768,
    ),
    clip_head=L(PoolingCLIPHead)(),
    text_encoder=L(TextTransformer)(),
    train_labels=L(_tuple_labels)(dataset="coco_panoptic", prompt_engineered=True),
    num_queries=100,
    object_mask_threshold=0.0,
    overlap_threshold=0.8,
    size_divisibility=64,
    semantic_on=True,
    instance_on=True,
    panoptic_on=True,
    test_topk_per_image=100,
)

criterion = L(CriterionConfig)(
    num_classes="${model.sem_seg_head.num_classes}",
    class_weight=2.0,
    mask_weight=5.0,
    dice_weight=5.0,
    eos_coef=0.1,
    num_points=12544,
    oversample_ratio=3.0,
    importance_sample_ratio=0.75,
)
