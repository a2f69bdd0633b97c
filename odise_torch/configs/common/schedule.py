# LR multiplier schedules (reference configs/common/schedule.py:22-27).
from odise_torch.config import L
from odise_torch.engine.optimizer import multistep_lr

multistep = L(multistep_lr)(
    base_lr=1e-4,
    milestones=[163889, 177546],
    gamma=0.1,
    warmup_steps=0,
)
