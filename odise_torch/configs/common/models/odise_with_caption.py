# Attach the SD backbone to the caption mask generator
# (reference configs/common/models/odise_with_caption.py:16-32).
from odise_torch.config import L, get_config
from odise_torch.models.backbone.feature_extractor import (
    FeatureExtractorBackbone,
    LdmImplicitCaptionerExtractor,
)

_base = get_config("common/models/mask_generator_with_caption.py")
model = _base.model
criterion = _base.criterion
grounding_criterion = _base.grounding_criterion

model.backbone = L(FeatureExtractorBackbone)(
    feature_extractor=L(LdmImplicitCaptionerExtractor)(
        encoder_block_indices=(5, 7),
        unet_block_indices=(2, 5, 8, 11),
        decoder_block_indices=(2, 5),
        steps=(0,),
        learnable_time_embed=True,
        num_timesteps=1,
        clip_model_name="ViT-L-14",
    ),
    out_features=["s2", "s3", "s4", "s5"],
    use_checkpoint=True,
    slide_training=True,
    backbone_in_size=(512, 512),
    projection_dim=512,
)
model.clip_head.alpha = 0.35
model.clip_head.beta = 0.65
