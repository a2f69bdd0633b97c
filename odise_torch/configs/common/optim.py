# AdamW with zero weight-decay on norm/bias (reference configs/common/optim.py:23-32).
from odise_torch.config import L
from odise_torch.engine.optimizer import make_optimizer

AdamW = L(make_optimizer)(
    params=None,  # filled by the training script after init
    lr=1e-4,
    weight_decay=0.05,
    betas=(0.9, 0.999),
    grad_clip=0.01,
    milestones=(),
    warmup_steps=0,
    warmup_factor=1e-3,
)
