"""Beta schedules and timestep respacing (counterpart of
``odise_tpu/diffusion/schedules.py``), in float64 numpy: the schedules are
constants, gathered as float32 where a step uses them.

Schedules:
  * ``linear``      DDPM's linear betas, scaled for the step count.
  * ``cosine``      improved DDPM's squared-cosine alpha-bar schedule.
  * ``ldm_linear``  Stable Diffusion's, linear in sqrt(beta)
                    (linspace(sqrt(0.00085), sqrt(0.012)) ** 2), not scaled.
"""

from __future__ import annotations

import math
from typing import Sequence, Set, Union

import numpy as np

__all__ = ["get_named_beta_schedule", "space_timesteps"]


def _betas_for_alpha_bar(num_steps: int, alpha_bar, max_beta: float = 0.999) -> np.ndarray:
    betas = [min(1 - alpha_bar((i + 1) / num_steps) / alpha_bar(i / num_steps), max_beta)
             for i in range(num_steps)]
    return np.asarray(betas, dtype=np.float64)


def get_named_beta_schedule(schedule_name: str, num_diffusion_timesteps: int) -> np.ndarray:
    """Betas (float64, [T]) of a named schedule; ``NotImplementedError`` for
    any other name."""
    if schedule_name == "linear":
        scale = 1000 / num_diffusion_timesteps
        return np.linspace(scale * 0.0001, scale * 0.02, num_diffusion_timesteps,
                           dtype=np.float64)
    if schedule_name == "ldm_linear":
        return np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, num_diffusion_timesteps,
                           dtype=np.float64) ** 2
    if schedule_name == "cosine":
        return _betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2)
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def _fixed_stride(num_timesteps: int, desired_count: int) -> range:
    for i in range(1, num_timesteps):
        if len(range(0, num_timesteps, i)) == desired_count:
            return range(0, num_timesteps, i)
    raise ValueError(f"cannot create exactly {desired_count} steps with an integer stride")


def space_timesteps(num_timesteps: int,
                    section_counts: Union[str, Sequence[int]]) -> Set[int]:
    """The original timesteps a respaced process keeps.

    ``"ddimN"``: N steps at DDIM's fixed integer stride. ``"ldm_ddimN"``:
    the same steps plus one each, the table of CompVis/SD's DDIM sampler.
    ``"a,b,..."`` or a list: the process cut into that many equal sections,
    each spaced evenly with its count of steps (improved DDPM).
    """
    if isinstance(section_counts, str):
        if section_counts.startswith("ldm_ddim"):
            steps = _fixed_stride(num_timesteps, int(section_counts[len("ldm_ddim"):]))
            return {x + 1 for x in steps}
        if section_counts.startswith("ddim"):
            return set(_fixed_stride(num_timesteps, int(section_counts[len("ddim"):])))
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur_idx = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur_idx))
            cur_idx += stride
        start_idx += size
    return set(all_steps)
