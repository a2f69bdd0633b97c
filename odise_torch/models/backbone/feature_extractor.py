"""Stable-Diffusion feature-extractor backbone (counterpart of
``odise_tpu/models/backbone/feature_extractor.py``), NCHW.

``LdmExtractor`` runs SD once at t=0 with the fixed shared noise and taps
the VAE encoder, UNet output blocks and VAE decoder;
``LdmImplicitCaptionerExtractor`` conditions it on a projected CLIP image
embedding; ``FeatureExtractorBackbone`` projects the taps to the s2..s5
pyramid. The eval slide is the fused form: all crops in one batch. The
training slide (``slide_training``, ``slide_serial``) runs the crops one at
a time, each under activation checkpointing, so that one crop's activations
are held at a time, as the JAX code's ``nn.scan(nn.remat(...))`` does.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...diffusion.gaussian import GaussianDiffusion, get_named_beta_schedule
from ..clip.adapter import clip_preprocess
from ..clip.model import TextTransformer, VisionTransformer
from ..clip.tokenizer import tokenize
from ..helper import l2_normalize
from ..modules import Conv, Dense, GroupNorm, add_modules, param
from ..resize import resize
from ..sd.unet import UNetModel
from ..sd.vae import AutoencoderKL

SD_PIXEL_MEAN = 0.5  # SD normalizes [0,1] -> [-1,1]
SD_PIXEL_STD = 0.5
# jax.random.normal(PRNGKey(42), (1, 64, 64, 4), float32), NHWC: torch's
# generators cannot reproduce it, so it is carried as data
SHARED_NOISE_FILE = Path(__file__).with_name("shared_noise_seed42.npy")


class PositionalLinear(nn.Module):
    """Linear + learned ``seq_len``-token positional expansion."""

    def __init__(self, in_features: int, out_features: int, seq_len: int = 77,
                 dtype=torch.float32):
        super().__init__()
        self.linear = Dense(in_features, out_features, dtype=dtype)
        self.positional_embedding = param((1, seq_len, out_features))

    def forward(self, x):
        x = self.linear(x)
        return x[:, None, :] + self.positional_embedding.to(x.dtype)


def ldm_feature_dims_strides(model_channels: int = 320, vae_ch: int = 128,
                             encoder_block_indices=(5, 7),
                             unet_block_indices=(2, 5, 8, 11),
                             decoder_block_indices=(2, 5), steps=(0,)):
    """Static (dims, strides) of the tapped features, ordered encoder /
    unet / decoder (the reference's bookkeeping)."""
    enc_in, prev = [], vae_ch
    for mult in (1, 2, 4, 4):
        out = vae_ch * mult
        enc_in.extend([prev, out])
        prev = out
    encoder_dims = [enc_in[i] for i in encoder_block_indices]
    encoder_strides = [2 ** ((i + 2) // 2 - 1) for i in encoder_block_indices]
    mc = model_channels
    unet_in = [mc * 8, mc * 8, mc * 8, mc * 8, mc * 8, mc * 6,
               mc * 4, mc * 4, mc * 3, mc * 2, mc * 2, mc * 2]
    unet_dims = [unet_in[i] for i in unet_block_indices]
    unet_strides = [64 // (2 ** ((i + 3) // 3 - 1)) for i in unet_block_indices]
    dec_in, prev = [], vae_ch * 4
    for mult in (4, 4, 2, 1):
        out = vae_ch * mult
        dec_in.extend([prev, out, out])
        prev = out
    decoder_dims = [dec_in[i] for i in decoder_block_indices]
    decoder_strides = [8 // (2 ** ((i + 3) // 3 - 1)) for i in decoder_block_indices]
    dims = encoder_dims + unet_dims * len(steps) + decoder_dims
    strides = encoder_strides + unet_strides * len(steps) + decoder_strides
    return dims, strides


class LdmExtractor(nn.Module):
    """Frozen SD as a one-step multi-scale feature extractor.

    ``forward(img [B, 3, S, S] in [0, 1], cond_inputs, cond_emb)`` returns
    the tapped features (NCHW), ordered encoder / unet / decoder.
    """

    def __init__(self, encoder_block_indices=(5, 7),
                 unet_block_indices=(2, 5, 8, 11), decoder_block_indices=(2, 5),
                 steps=(0,), model_channels: int = 320, vae_ch: int = 128,
                 context_dim: int = 768, sd_text_layers: int = 12,
                 dtype=torch.float32):
        super().__init__()
        self.steps = tuple(steps)
        self.context_dim = context_dim
        self.dtype = dtype
        self.vae = AutoencoderKL(ch=vae_ch,
                                 encoder_tap_indices=encoder_block_indices,
                                 decoder_tap_indices=decoder_block_indices,
                                 dtype=dtype)
        self.unet = UNetModel(model_channels=model_channels,
                              context_dim=context_dim,
                              tap_indices=unet_block_indices, dtype=dtype)
        self.sd_text = TextTransformer(width=context_dim, layers=sd_text_layers,
                                       heads=max(1, context_dim // 64),
                                       embed_dim=context_dim, dtype=dtype)
        self.diffusion = GaussianDiffusion(get_named_beta_schedule("ldm_linear", 1000))
        noise = torch.from_numpy(np.load(SHARED_NOISE_FILE)).permute(0, 3, 1, 2)
        self.register_buffer("shared_noise", noise.contiguous(), persistent=False)

    def embed_text(self, tokens: torch.Tensor) -> torch.Tensor:
        """SD conditioning: ln_final hidden states [B, 77, context_dim]."""
        return self.sd_text(tokens)[1].to(self.dtype)

    def uncond_tokens(self, device) -> torch.Tensor:
        return torch.from_numpy(tokenize([""])).long().to(device)

    def _shared_noise(self, latent: torch.Tensor) -> torch.Tensor:
        base = resize(self.shared_noise, latent.shape[-2:], "bicubic")
        return base.expand(latent.shape).to(self.dtype)

    def forward(self, img, cond_inputs=None, cond_emb=None) -> List[torch.Tensor]:
        B = img.shape[0]
        x = (img - SD_PIXEL_MEAN) / SD_PIXEL_STD
        latent, encoder_features = self.vae.encode(x.to(self.dtype))
        if cond_inputs is None:
            cond_inputs = self.embed_text(self.uncond_tokens(img.device)).expand(
                B, 77, self.context_dim)
        unet_features = []
        for i, t in enumerate(self.steps):
            step_cond_emb = None if cond_emb is None else cond_emb[:, i]
            t_vec = torch.full((B,), max(t, 0), dtype=torch.long,
                               device=img.device)
            noisy = latent if t < 0 else self.diffusion.q_sample(
                latent, t_vec, self._shared_noise(latent))
            _, taps = self.unet(noisy, t_vec, cond_inputs, step_cond_emb,
                                taps_only=True)
            unet_features.extend(taps)
        _, decoder_features = self.vae.decode(latent, taps_only=True)
        return [*encoder_features, *unet_features, *decoder_features]


class LdmImplicitCaptionerExtractor(nn.Module):
    """LdmExtractor conditioned on ``uncond + tanh(alpha_cond) *
    PositionalLinear(clip_image_embed)``, plus a learnable time-embedding
    delta ``tanh(alpha_cond_time_embed) * proj``."""

    def __init__(self, encoder_block_indices=(5, 7),
                 unet_block_indices=(2, 5, 8, 11), decoder_block_indices=(2, 5),
                 steps=(0,), learnable_time_embed: bool = True,
                 num_timesteps: int = 1, model_channels: int = 320,
                 vae_ch: int = 128, context_dim: int = 768,
                 sd_text_layers: int = 12,
                 clip_vit_cfg: Tuple[int, ...] = (224, 14, 1024, 24, 16, 768),
                 dtype=torch.float32):
        super().__init__()
        self.encoder_block_indices = tuple(encoder_block_indices)
        self.unet_block_indices = tuple(unet_block_indices)
        self.decoder_block_indices = tuple(decoder_block_indices)
        self.steps = tuple(steps)
        self.model_channels, self.vae_ch = model_channels, vae_ch
        self.dtype = dtype
        self.ldm_extractor = LdmExtractor(
            encoder_block_indices, unet_block_indices, decoder_block_indices,
            steps, model_channels, vae_ch, context_dim, sd_text_layers, dtype)
        s, p, w, l, h, ed = clip_vit_cfg
        self.clip_image_size = s
        self.clip_visual = VisionTransformer(image_size=s, patch_size=p,
                                             width=w, layers=l, heads=h,
                                             embed_dim=ed, dtype=dtype)
        self.clip_project = PositionalLinear(ed, context_dim, 77, dtype)
        self.alpha_cond = param((1, 77, context_dim), fill=0.0)
        self.learnable_time_embed = learnable_time_embed
        if learnable_time_embed:
            time_embed_dim = model_channels * 4
            self.time_embed_project = PositionalLinear(
                ed, time_embed_dim, num_timesteps, dtype)
            self.alpha_cond_time_embed = param((1, time_embed_dim), fill=0.0)

    def dims_strides(self):
        return ldm_feature_dims_strides(
            self.model_channels, self.vae_ch, self.encoder_block_indices,
            self.unet_block_indices, self.decoder_block_indices, self.steps)

    @property
    def grouped_indices(self) -> List[List[int]]:
        n_enc, n_unet = len(self.encoder_block_indices), len(self.unet_block_indices)
        ret = [[i] for i in range(n_enc)]
        ret += [[i + t * n_unet + n_enc for t in range(len(self.steps))]
                for i in range(n_unet)]
        off = n_enc + len(self.steps) * n_unet
        ret += [[i + off] for i in range(len(self.decoder_block_indices))]
        return ret

    def forward(self, img: torch.Tensor) -> List[torch.Tensor]:
        B = img.shape[0]
        prep = clip_preprocess(img, self.clip_image_size).to(self.dtype)
        with torch.no_grad():  # the JAX code stops the gradient here
            image_embed, _ = self.clip_visual(prep)
        image_embed = l2_normalize(image_embed).to(self.dtype)
        prefix_embed = self.clip_project(image_embed)  # [B, 77, ctx]
        ldm = self.ldm_extractor
        uncond = ldm.embed_text(ldm.uncond_tokens(img.device)).expand(
            B, 77, ldm.context_dim)
        cond_inputs = uncond + torch.tanh(self.alpha_cond) * prefix_embed
        cond_emb = None
        if self.learnable_time_embed:
            cond_emb = (torch.tanh(self.alpha_cond_time_embed)[None]
                        * self.time_embed_project(image_embed))  # [B, T, td]
        return ldm(img, cond_inputs=cond_inputs, cond_emb=cond_emb)


class BottleneckProjection(nn.Module):
    """d2-style bottleneck block with GroupNorm (eps 1e-5)."""

    def __init__(self, in_channels: int, out_channels: int,
                 bottleneck_channels: int, dtype=torch.float32):
        super().__init__()
        if in_channels != out_channels:
            self.shortcut = Conv(in_channels, out_channels, 1, bias=False,
                                 dtype=dtype)
            self.shortcut_norm = GroupNorm(out_channels, eps=1e-5)
        else:  # d2's BottleneckBlock has no shortcut conv when widths match
            self.shortcut = None
        self.conv1 = Conv(in_channels, bottleneck_channels, 1, bias=False,
                          dtype=dtype)
        self.norm1 = GroupNorm(bottleneck_channels, eps=1e-5)
        self.conv2 = Conv(bottleneck_channels, bottleneck_channels, 3,
                          padding=1, bias=False, dtype=dtype)
        self.norm2 = GroupNorm(bottleneck_channels, eps=1e-5)
        self.conv3 = Conv(bottleneck_channels, out_channels, 1, bias=False,
                          dtype=dtype)
        self.norm3 = GroupNorm(out_channels, eps=1e-5)

    def forward(self, x):
        def gn(norm, h):
            return norm(h).to(h.dtype)

        shortcut = x
        if self.shortcut is not None:
            shortcut = gn(self.shortcut_norm, self.shortcut(x))
        h = F.relu(gn(self.norm1, self.conv1(x)))
        h = F.relu(gn(self.norm2, self.conv2(h)))
        h = gn(self.norm3, self.conv3(h))
        return F.relu(h + shortcut)


class FeatureExtractorBackbone(nn.Module):
    """Named s2..s5 pyramid over a feature extractor.

    ``forward(img [B, 3, H, W] in [0, 1], training)`` -> dict name ->
    [B, C, H/s, W/s]. ``backbone_in_size`` is the (h, w) each crop is
    resized to. In training, ``slide_training`` cuts crops of the backbone's
    input size (else the shorter side), ``slide_serial`` runs them one at a
    time under checkpointing, and ``use_checkpoint`` checkpoints the
    projections.
    """

    def __init__(self, feature_extractor: LdmImplicitCaptionerExtractor,
                 out_features: Sequence[str] = ("s2", "s3", "s4", "s5"),
                 backbone_in_size: Tuple[int, int] = (512, 512),
                 min_stride: int = 4, max_stride: int = 32,
                 projection_dim: int = 512, use_checkpoint: bool = False,
                 slide_training: bool = False, slide_serial: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.feature_extractor = feature_extractor
        self.use_checkpoint = use_checkpoint
        self.slide_training, self.slide_serial = slide_training, slide_serial
        self.out_features = tuple(out_features)
        self.backbone_in_size = tuple(backbone_in_size)
        self.min_stride, self.max_stride = min_stride, max_stride
        self.projection_dim = projection_dim
        dims, _ = feature_extractor.dims_strides()
        add_modules(self, "proj_", [
            BottleneckProjection(d, projection_dim, projection_dim // 4, dtype)
            for d in dims])

    def _grouping(self):
        """Static stride grouping: (names, name -> stride, index groups)."""
        _, feature_strides = self.feature_extractor.dims_strides()
        idx_to_stride: Dict[int, int] = {}
        stride_to_indices: Dict[int, List[int]] = {}
        for indices in self.feature_extractor.grouped_indices:
            for idx in indices:
                stride = min(max(feature_strides[idx], self.min_stride),
                             self.max_stride)
                idx_to_stride[idx] = stride
                stride_to_indices.setdefault(stride, []).append(idx)
        names, strides, groups = [], {}, []
        for s in sorted(stride_to_indices):
            indices = stride_to_indices[s]
            name = f"s{int(math.log2(s))}"
            if name not in self.out_features:
                continue
            names.append(name)
            strides[name] = s
            groups.append(indices)
        return names, strides, groups

    def output_shape(self) -> Dict[str, dict]:
        names, strides, _ = self._grouping()
        return {n: {"channels": self.projection_dim, "stride": strides[n]}
                for n in names}

    def single_forward(self, img: torch.Tensor, training: bool = False
                       ) -> Dict[str, torch.Tensor]:
        input_size = tuple(img.shape[-2:])
        if input_size != self.backbone_in_size:
            img = resize(img, self.backbone_in_size, "bicubic")
        features = self.feature_extractor(img)
        if training and self.use_checkpoint and torch.is_grad_enabled():
            return checkpoint(self._project, input_size, *features,
                              use_reentrant=False)
        return self._project(input_size, *features)

    def _project(self, input_size, *features) -> Dict[str, torch.Tensor]:
        names, strides, groups = self._grouping()
        out = {}
        for name, indices in zip(names, groups):
            s = strides[name]
            target_hw = (input_size[0] // s, input_size[1] // s)
            acc = None
            for idx in indices:
                f = resize(features[idx], target_hw, "nearest")
                p = getattr(self, f"proj_{idx}")(f)
                acc = p if acc is None else acc + p
            out[name] = acc
        return out

    def forward(self, img: torch.Tensor, training: bool = False
                ) -> Dict[str, torch.Tensor]:
        """Slide: square crops, averaged where they overlap. Eval crops the
        shorter side and folds the crops into the batch for one forward;
        training with ``slide_training`` crops the backbone's input size
        and, with ``slide_serial``, runs one checkpointed crop at a time;
        training without ``slide_training`` takes the image whole."""
        if training and not self.slide_training:
            return self.single_forward(img, training)
        B, _, h_img, w_img = img.shape
        if training:
            crop = stride = min(min(self.backbone_in_size), h_img, w_img)
        else:
            crop = stride = min(h_img, w_img)
        h_grids = max(h_img - crop + stride - 1, 0) // stride + 1
        w_grids = max(w_img - crop + stride - 1, 0) // stride + 1
        boxes = []
        for hi in range(h_grids):
            for wi in range(w_grids):
                y2, x2 = min(hi * stride + crop, h_img), min(wi * stride + crop, w_img)
                boxes.append((max(y2 - crop, 0), max(x2 - crop, 0)))
        if training and self.slide_serial and len(boxes) > 1:
            per_crop = []
            for (y1, x1) in boxes:
                crop_img = img[:, :, y1:y1 + crop, x1:x1 + crop]
                if torch.is_grad_enabled():
                    per_crop.append(checkpoint(self.single_forward, crop_img, True,
                                               use_reentrant=False))
                else:
                    per_crop.append(self.single_forward(crop_img, True))
            crop_feats = {k: torch.cat([f[k] for f in per_crop], dim=0)
                          for k in per_crop[0]}
        else:
            crops = torch.cat([img[:, :, y1:y1 + crop, x1:x1 + crop]
                               for (y1, x1) in boxes], dim=0)
            crop_feats = self.single_forward(crops, training)

        out = {}
        for name, f_all in crop_feats.items():
            s = self.output_shape()[name]["stride"]
            acc = f_all.new_zeros((B, f_all.shape[1], h_img // s, w_img // s))
            cnt = torch.zeros((1, 1, h_img // s, w_img // s),
                              dtype=torch.float32, device=img.device)
            for gi, (y1, x1) in enumerate(boxes):
                f = f_all[gi * B:(gi + 1) * B]
                ky, kx = y1 // s, x1 // s
                fh, fw = f.shape[-2:]
                acc[:, :, ky:ky + fh, kx:kx + fw] += f
                cnt[:, :, ky:ky + fh, kx:kx + fw] += 1
            out[name] = acc / cnt.to(acc.dtype)
        return out
