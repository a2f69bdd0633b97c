"""The one piece of the diffusion process the backbone uses: ``q_sample``
on Stable Diffusion's "ldm_linear" schedule (linear in sqrt(beta), 1000
steps), with float32 coefficients."""

import numpy as np
import torch


def get_named_beta_schedule(name: str, steps: int) -> np.ndarray:
    if name != "ldm_linear":
        raise NotImplementedError(name)
    return np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, steps, dtype=np.float64) ** 2


class GaussianDiffusion:
    def __init__(self, betas):
        acp = np.cumprod(1.0 - np.asarray(betas, np.float64))
        self.sqrt_alphas_cumprod = np.sqrt(acp)
        self.sqrt_one_minus_alphas_cumprod = np.sqrt(1.0 - acp)

    @staticmethod
    def _extract(arr, t, ndim):
        out = torch.as_tensor(arr, dtype=torch.float32, device=t.device)[t]
        return out.reshape(t.shape + (1,) * (ndim - t.dim()))

    def q_sample(self, x_start, t, noise):
        n = x_start.dim()
        return (self._extract(self.sqrt_alphas_cumprod, t, n) * x_start
                + self._extract(self.sqrt_one_minus_alphas_cumprod, t, n) * noise)
