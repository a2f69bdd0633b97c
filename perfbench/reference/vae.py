"""Stable Diffusion VAE (AutoencoderKL) with feature taps, NCHW.

Counterpart of ``odise_tpu/models/sd/vae.py``: a tap is the *input* of the
indexed res block; encode returns the scaled posterior mean.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .modules import Conv, GroupNorm32, attention

SD_SCALE_FACTOR = 0.18215


def swish(x):
    return x * torch.sigmoid(x)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, dtype=torch.float32):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels)
        self.conv1 = Conv(in_channels, out_channels, 3, padding=1, dtype=dtype)
        self.norm2 = GroupNorm32(out_channels)
        self.conv2 = Conv(out_channels, out_channels, 3, padding=1, dtype=dtype)
        self.nin_shortcut = (Conv(in_channels, out_channels, 1, dtype=dtype)
                             if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(swish(self.norm1(x)))
        h = self.conv2(swish(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention of the VAE mid block."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.norm = GroupNorm32(channels)
        self.q = Conv(channels, channels, 1, dtype=dtype)
        self.k = Conv(channels, channels, 1, dtype=dtype)
        self.v = Conv(channels, channels, 1, dtype=dtype)
        self.proj_out = Conv(channels, channels, 1, dtype=dtype)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x)

        def tokens(conv):  # [B, HW, 1, C]
            return conv(h).reshape(B, C, H * W).transpose(1, 2)[:, :, None]

        out = attention(tokens(self.q), tokens(self.k), tokens(self.v))
        out = out[:, :, 0].transpose(1, 2).reshape(B, C, H, W)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    """Stride-2 conv with the VAE's asymmetric (0, 1, 0, 1) padding."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(channels, channels, 3, stride=2, dtype=dtype)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(channels, channels, 3, padding=1, dtype=dtype)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Encoder(nn.Module):
    """VAE encoder. ``forward(x)`` -> (moments [B, 2z, h, w], taps)."""

    def __init__(self, ch: int = 128, ch_mult: Tuple[int, ...] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4,
                 tap_indices: Sequence[int] = (), dtype=torch.float32):
        super().__init__()
        self.tap_indices = tuple(tap_indices)
        self.conv_in = Conv(3, ch, 3, padding=1, dtype=dtype)
        prev = ch
        for i_level, mult in enumerate(ch_mult):
            out_ch = ch * mult
            for i_block in range(num_res_blocks):
                blk = ResnetBlock(prev, out_ch, dtype)
                self.add_module(f"down_{i_level}_block_{i_block}", blk)
                prev = out_ch
            if i_level != len(ch_mult) - 1:
                self.add_module(f"down_{i_level}_downsample",
                                Downsample(prev, dtype))
        self.ch_mult = tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.mid_block_1 = ResnetBlock(prev, prev, dtype)
        self.mid_attn_1 = AttnBlock(prev, dtype)
        self.mid_block_2 = ResnetBlock(prev, prev, dtype)
        self.norm_out = GroupNorm32(prev)
        self.conv_out = Conv(prev, 2 * z_channels, 3, padding=1, dtype=dtype)

    def forward(self, x):
        taps = []
        block_idx = 0
        h = self.conv_in(x)
        for i_level in range(len(self.ch_mult)):
            for i_block in range(self.num_res_blocks):
                if block_idx in self.tap_indices:
                    taps.append(h)
                h = getattr(self, f"down_{i_level}_block_{i_block}")(h)
                block_idx += 1
            if i_level != len(self.ch_mult) - 1:
                h = getattr(self, f"down_{i_level}_downsample")(h)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        h = self.conv_out(swish(self.norm_out(h)))
        return h, taps


class Decoder(nn.Module):
    """VAE decoder; blocks are counted from the lowest resolution up."""

    def __init__(self, ch: int = 128, ch_mult: Tuple[int, ...] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4,
                 out_channels: int = 3, tap_indices: Sequence[int] = (),
                 dtype=torch.float32):
        super().__init__()
        self.tap_indices = tuple(tap_indices)
        self.ch_mult = tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        block_in = ch * ch_mult[-1]
        self.conv_in = Conv(z_channels, block_in, 3, padding=1, dtype=dtype)
        self.mid_block_1 = ResnetBlock(block_in, block_in, dtype)
        self.mid_attn_1 = AttnBlock(block_in, dtype)
        self.mid_block_2 = ResnetBlock(block_in, block_in, dtype)
        prev = block_in
        for i_level in reversed(range(len(ch_mult))):
            out_ch = ch * ch_mult[i_level]
            for i_block in range(num_res_blocks + 1):
                self.add_module(f"up_{i_level}_block_{i_block}",
                                ResnetBlock(prev, out_ch, dtype))
                prev = out_ch
            if i_level != 0:
                self.add_module(f"up_{i_level}_upsample", Upsample(prev, dtype))
        self.norm_out = GroupNorm32(prev)
        self.conv_out = Conv(prev, out_channels, 3, padding=1, dtype=dtype)

    def forward(self, z, taps_only: bool = False):
        """Returns (rgb, taps). With ``taps_only`` it stops after the last
        tap and returns (None, taps): the blocks after it feed nothing the
        backbone reads (the JAX graph drops them the same way under jit)."""
        taps = []
        block_idx = 0
        last_tap = max(self.tap_indices, default=-1)
        h = self.conv_in(z)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        for i_level in reversed(range(len(self.ch_mult))):
            for i_block in range(self.num_res_blocks + 1):
                if block_idx in self.tap_indices:
                    taps.append(h)
                    if taps_only and block_idx == last_tap:
                        return None, taps
                h = getattr(self, f"up_{i_level}_block_{i_block}")(h)
                block_idx += 1
            if i_level != 0:
                h = getattr(self, f"up_{i_level}_upsample")(h)
        h = self.conv_out(swish(self.norm_out(h)))
        return h, taps


class AutoencoderKL(nn.Module):
    """Full VAE with quant convs; encode is deterministic (posterior mean)."""

    def __init__(self, ch: int = 128, ch_mult: Tuple[int, ...] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4,
                 encoder_tap_indices: Sequence[int] = (),
                 decoder_tap_indices: Sequence[int] = (),
                 scale_factor: float = SD_SCALE_FACTOR, dtype=torch.float32):
        super().__init__()
        self.z_channels = z_channels
        self.scale_factor = scale_factor
        self.encoder = Encoder(ch, ch_mult, num_res_blocks, z_channels,
                               encoder_tap_indices, dtype)
        self.decoder = Decoder(ch, ch_mult, num_res_blocks, z_channels,
                               tap_indices=decoder_tap_indices, dtype=dtype)
        self.quant_conv = Conv(2 * z_channels, 2 * z_channels, 1, dtype=dtype)
        self.post_quant_conv = Conv(z_channels, z_channels, 1, dtype=dtype)

    def encode(self, x):
        """x [B, 3, H, W] in [-1, 1] -> (scaled latent mean, taps)."""
        moments, taps = self.encoder(x)
        mean = self.quant_conv(moments)[:, : self.z_channels]
        return self.scale_factor * mean, taps

    def decode(self, z, taps_only: bool = False):
        """Scaled latent -> (rgb, taps)."""
        return self.decoder(self.post_quant_conv(z / self.scale_factor),
                            taps_only=taps_only)

    def forward(self, x):
        z, enc_taps = self.encode(x)
        rgb, dec_taps = self.decode(z)
        return rgb, z, enc_taps, dec_taps
