"""The part of the diffusion process the eval path needs: Stable Diffusion's
``ldm_linear`` beta schedule and ``q_sample`` (counterpart of
``odise_tpu/diffusion/schedules.py`` and ``odise_tpu/diffusion/gaussian.py``).
"""

from __future__ import annotations

import numpy as np
import torch


def get_named_beta_schedule(schedule_name: str,
                            num_diffusion_timesteps: int) -> np.ndarray:
    """Betas (float64, [T]). Only ``ldm_linear`` (linear in sqrt(beta),
    SD's schedule) is ported."""
    if schedule_name != "ldm_linear":
        raise NotImplementedError(f"beta schedule {schedule_name!r} is not ported")
    return np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, num_diffusion_timesteps,
                       dtype=np.float64) ** 2


class GaussianDiffusion:
    """Forward process q(x_t | x_0) of a beta schedule."""

    def __init__(self, betas: np.ndarray):
        acp = np.cumprod(1.0 - np.asarray(betas, dtype=np.float64))
        self.sqrt_alphas_cumprod = np.sqrt(acp)
        self.sqrt_one_minus_alphas_cumprod = np.sqrt(1.0 - acp)

    @staticmethod
    def _extract(arr: np.ndarray, t: torch.Tensor, ndim: int) -> torch.Tensor:
        out = torch.as_tensor(arr, dtype=torch.float32, device=t.device)[t]
        return out.reshape(t.shape + (1,) * (ndim - t.dim()))

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """Diffuse x_start to timestep t (float32 coefficients)."""
        return (self._extract(self.sqrt_alphas_cumprod, t, x_start.dim()) * x_start
                + self._extract(self.sqrt_one_minus_alphas_cumprod, t,
                                x_start.dim()) * noise)
