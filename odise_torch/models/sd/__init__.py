from .vae import AutoencoderKL, Encoder, Decoder, SD_SCALE_FACTOR
from .unet import UNetModel, timestep_embedding
from .ldm import LDM_CONFIGS, LatentDiffusion, build_latent_diffusion
