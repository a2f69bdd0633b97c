# CaptionODISE mask-generator graph
# (reference configs/common/models/mask_generator_with_caption.py:27-105).
from odise_torch.config import L, get_config
from odise_torch.models.decoder.transformer_decoder import PseudoClassEmbed
from odise_torch.models.odise import CaptionODISE, WordEmbed
from odise_torch.losses import CriterionConfig, GroundingConfig

_base = get_config("common/models/mask_generator_with_label.py")
model = _base.model

# rewire: binary classification (num_classes=1) + word head instead of category head
model._target_ = CaptionODISE
model.sem_seg_head.num_classes = 1
model.sem_seg_head.transformer_predictor.class_embed = L(PseudoClassEmbed)(
    num_classes="${..num_classes}"
)
del model["category_head"]
model.word_head = L(WordEmbed)(
    projection_dim="${..sem_seg_head.transformer_predictor.post_mask_embed.projection_dim}",
    clip_dim=768,
    num_words=8,
)

criterion = L(CriterionConfig)(
    num_classes=1,
    class_weight=2.0,
    mask_weight=5.0,
    dice_weight=5.0,
    eos_coef=0.1,
    num_points=12544,
    oversample_ratio=3.0,
    importance_sample_ratio=0.75,
)

grounding_criterion = L(GroundingConfig)(
    loss_weight=1.0,
    collect_mode="diff",
)
