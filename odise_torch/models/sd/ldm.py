"""Stable Diffusion's text-to-image sampler (counterpart of
``odise_tpu/models/sd/ldm.py``), NCHW.

``LatentDiffusion`` holds SD v1's three towers under the JAX module's scope
names (``vae``, ``unet``, ``text_encoder``) and DDIM over the ``ldm_linear``
schedule: ``forward_test`` embeds the prompt and the empty prompt, runs
``ddim_steps`` DDIM steps with classifier-free guidance (one UNet call on
both halves a step), decodes the latent and returns the image in [0, 1],
[B, 3, H, W]. As in the JAX package, each step clips its predicted x_0 to
[-1, 1] in latent space (``clip_denoised=True``), where SD's scaled
latents spread about as wide as a unit normal.

Weights: the JAX module's flax tree goes in through
``model_zoo.from_jax.load_flax_params``; SD v1's checkpoint in the
reference's layout through ``model_zoo.convert.install_ldm_weights``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from ...diffusion import SpacedDiffusion, get_named_beta_schedule, space_timesteps
from ..clip.model import TextTransformer
from ..clip.tokenizer import tokenize
from .unet import UNetModel
from .vae import AutoencoderKL

__all__ = ["LDM_CONFIGS", "LatentDiffusion", "build_latent_diffusion"]

# sd://version -> (image size, latent size)
LDM_CONFIGS = {
    "sd://v1-3": ((512, 512), (64, 64)),
    "sd://v1-4": ((512, 512), (64, 64)),
    "sd://v1-5": ((512, 512), (64, 64)),
    "sd://v2-0": ((512, 512), (64, 64)),
    "sd://v2-1": ((768, 768), (96, 96)),
}

# the JAX module's defaults (FULL: SD v1) and the widths the tests run
SCALES = {
    "full": dict(model_channels=320, vae_ch=128, context_dim=768, sd_text_layers=12),
    "tiny": dict(model_channels=32, vae_ch=32, context_dim=64, sd_text_layers=2),
}


class LatentDiffusion(nn.Module):
    """SD v1 with text-conditional DDIM sampling. ``latent_image_size`` is
    the version's (the tests set a smaller one on the instance)."""

    latent_dim = 4

    def __init__(self, diffusion_version: str = "sd://v1-3", num_timesteps: int = 1000,
                 ddim_steps: int = 50, guidance_scale: float = 7.5,
                 model_channels: int = 320, vae_ch: int = 128, context_dim: int = 768,
                 sd_text_layers: int = 12, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.diffusion_version = diffusion_version
        self.guidance_scale = guidance_scale
        self.dtype = dtype
        self.image_size = LDM_CONFIGS[diffusion_version][0]
        self.latent_image_size: Tuple[int, int] = LDM_CONFIGS[diffusion_version][1]
        self.vae = AutoencoderKL(ch=vae_ch, dtype=dtype)
        self.unet = UNetModel(model_channels=model_channels, context_dim=context_dim,
                              tap_indices=(), dtype=dtype)
        self.text_encoder = TextTransformer(width=context_dim, layers=sd_text_layers,
                                            heads=max(1, context_dim // 64),
                                            embed_dim=context_dim, dtype=dtype)
        self.diffusion = SpacedDiffusion(
            use_timesteps=space_timesteps(num_timesteps, f"ldm_ddim{ddim_steps}"),
            betas=get_named_beta_schedule("ldm_linear", num_timesteps))

    def embed_text(self, tokens: torch.Tensor) -> torch.Tensor:
        """[B, 77] -> [B, 77, context_dim] conditioning (the ln_final
        hidden states)."""
        return self.text_encoder(tokens)[1].to(self.dtype)

    def uncond_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """The empty prompt's tokens, one row for each of ``tokens``."""
        empty = torch.from_numpy(tokenize([""])).long().to(tokens.device)
        return empty.expand(tokens.shape)

    def encode_to_latent(self, image: torch.Tensor) -> torch.Tensor:
        """[B, 3, H, W] in [-1, 1] -> the scaled latent (posterior mean)."""
        return self.vae.encode(image)[0]

    def decode_from_latent(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latent -> [B, 3, H, W] in about [-1, 1] (÷ 0.18215 first)."""
        return self.vae.decode(z)[0]

    def apply_model_with_guidance(self, x, t, cond, uncond) -> torch.Tensor:
        """Classifier-free guidance: one UNet call on [x; x], [t; t],
        [cond; uncond], then eps_u + guidance_scale * (eps_c - eps_u)."""
        B = x.shape[0]
        eps, _ = self.unet(torch.cat([x, x]), torch.cat([t, t]), torch.cat([cond, uncond]))
        eps_c, eps_u = eps[:B], eps[B:]
        return eps_u + self.guidance_scale * (eps_c - eps_u)

    def initial_noise(self, batch: int, generator: Optional[torch.Generator] = None,
                      device=None) -> torch.Tensor:
        h, w = self.latent_image_size
        return torch.randn((batch, self.latent_dim, h, w), generator=generator,
                           dtype=torch.float32, device=device)

    @torch.no_grad()
    def sample(self, tokens: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The decoded image before ``forward_test``'s clip: [B, 3, H, W].
        The starting latent is ``noise`` ([B, 4, h, w] float32), else drawn
        from ``generator`` on the model's device."""
        device = self.unet.input_conv.weight.device
        tokens = tokens.to(device)
        cond = self.embed_text(tokens)
        uncond = self.embed_text(self.uncond_tokens(tokens))
        latent = (self.initial_noise(tokens.shape[0], generator, device) if noise is None
                  else noise.to(device, torch.float32))

        def model_fn(x, t):
            return self.apply_model_with_guidance(x, t, cond, uncond)

        for t_scalar in range(self.diffusion.num_timesteps - 1, -1, -1):
            t = torch.full((tokens.shape[0],), t_scalar, dtype=torch.long, device=device)
            latent = self.diffusion.ddim_sample(model_fn, latent, t,
                                                clip_denoised=True)["sample"]
        return self.decode_from_latent(latent.to(self.dtype))

    @torch.no_grad()
    def forward_test(self, tokens: torch.Tensor, generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Text -> image: [B, 77] tokens -> [B, 3, H, W] in [0, 1]."""
        return ((self.sample(tokens, generator, noise) + 1.0) / 2.0).clamp(0.0, 1.0)

    def forward(self, tokens, generator=None, noise=None):
        return self.forward_test(tokens, generator, noise)


def build_latent_diffusion(scale: str = "full", *, device=None,
                           dtype: torch.dtype = torch.float32, **kwargs) -> LatentDiffusion:
    """``LatentDiffusion`` at a named width on ``device`` (default CUDA;
    without a card pass ``device="cpu"``), in eval mode; ``kwargs`` go to
    the module (``ddim_steps``, ``guidance_scale``, ...)."""
    from ...model_zoo.factory import resolve_device

    if scale not in SCALES:
        raise ValueError(f"unknown scale {scale!r}")
    device = resolve_device(device)
    with torch.device(device):
        model = LatentDiffusion(**SCALES[scale], dtype=dtype, **kwargs)
    return model.eval()
