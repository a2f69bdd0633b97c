from .schedules import get_named_beta_schedule, space_timesteps
from .gaussian import GaussianDiffusion, SpacedDiffusion, create_gaussian_diffusion
from .resample import (
    ScheduleSampler,
    UniformSampler,
    LossSecondMomentResampler,
    create_named_schedule_sampler,
)

__all__ = [
    "get_named_beta_schedule",
    "space_timesteps",
    "GaussianDiffusion",
    "SpacedDiffusion",
    "create_gaussian_diffusion",
    "ScheduleSampler",
    "UniformSampler",
    "LossSecondMomentResampler",
    "create_named_schedule_sampler",
]
