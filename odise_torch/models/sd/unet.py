"""Stable Diffusion v1 UNet with feature taps, NCHW.

Counterpart of ``odise_tpu/models/sd/unet.py``: a tap is an output block's
input after the skip concatenation. Flax defaults kept: GEGLU's gelu is the
tanh approximation, the transformer LayerNorms use eps 1e-6, the ResBlock
GroupNorms 1e-5 and the SpatialTransformer GroupNorm 1e-6.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..modules import Conv, Dense, GroupNorm32, LayerNorm, attention, zero_init


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embedding, LDM convention (cos first), float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResBlock(nn.Module):
    """UNet residual block with additive time-embedding injection."""

    def __init__(self, in_channels: int, out_channels: int, emb_dim: int,
                 dtype=torch.float32):
        super().__init__()
        self.in_norm = GroupNorm32(in_channels, eps=1e-5)
        self.in_conv = Conv(in_channels, out_channels, 3, padding=1, dtype=dtype)
        self.emb_proj = Dense(emb_dim, out_channels, dtype=dtype)
        self.out_norm = GroupNorm32(out_channels, eps=1e-5)
        self.out_conv = zero_init(Conv(out_channels, out_channels, 3, padding=1, dtype=dtype))
        self.skip = (Conv(in_channels, out_channels, 1, dtype=dtype)
                     if in_channels != out_channels else None)

    def forward(self, x, emb):
        h = self.in_conv(F.silu(self.in_norm(x)))
        h = h + self.emb_proj(F.silu(emb))[:, :, None, None]
        h = self.out_conv(F.silu(self.out_norm(h)))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when context is None."""

    def __init__(self, query_dim: int, context_dim: int, heads: int,
                 dim_head: int, dtype=torch.float32):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Dense(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = Dense(context_dim, inner, bias=False, dtype=dtype)
        self.to_v = Dense(context_dim, inner, bias=False, dtype=dtype)
        self.to_out = Dense(inner, query_dim, dtype=dtype)

    def forward(self, x, context=None):
        context = x if context is None else context
        B, N, _ = x.shape
        M = context.shape[1]
        q = self.to_q(x).reshape(B, N, self.heads, self.dim_head)
        k = self.to_k(context).reshape(B, M, self.heads, self.dim_head)
        v = self.to_v(context).reshape(B, M, self.heads, self.dim_head)
        out = attention(q, k, v).reshape(B, N, self.heads * self.dim_head)
        return self.to_out(out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int, dtype=torch.float32):
        super().__init__()
        self.proj = Dense(dim, dim_out * 2, dtype=dtype)

    def forward(self, x):
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate, approximate="tanh")


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int,
                 dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn1 = CrossAttention(dim, dim, heads, dim_head, dtype)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head, dtype)
        self.norm3 = LayerNorm(dim, eps=1e-6)
        self.ff_geglu = GEGLU(dim, dim * 4, dtype)
        self.ff_out = Dense(dim * 4, dim, dtype=dtype)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x).to(x.dtype))
        x = x + self.attn2(self.norm2(x).to(x.dtype), context)
        h = self.ff_geglu(self.norm3(x).to(x.dtype))
        return x + self.ff_out(h)


class SpatialTransformer(nn.Module):
    def __init__(self, channels: int, context_dim: int, heads: int,
                 dim_head: int, depth: int = 1, dtype=torch.float32):
        super().__init__()
        self.depth = depth
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = Conv(channels, channels, 1, dtype=dtype)
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock(
                channels, context_dim, heads, dim_head, dtype))
        self.proj_out = zero_init(Conv(channels, channels, 1, dtype=dtype))

    def forward(self, x, context):
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x))
        h = h.reshape(B, C, H * W).transpose(1, 2)
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, context)
        h = h.transpose(1, 2).reshape(B, C, H, W)
        return self.proj_out(h) + x


class DownsampleConv(nn.Module):
    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.op = Conv(channels, channels, 3, stride=2, padding=1, dtype=dtype)

    def forward(self, x):
        return self.op(x)


class UpsampleConv(nn.Module):
    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(channels, channels, 3, padding=1, dtype=dtype)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class UNetModel(nn.Module):
    """SD v1 UNet. ``forward(x, t, context, cond_emb)`` -> (eps, taps)."""

    def __init__(self, in_channels: int = 4, model_channels: int = 320,
                 out_channels: int = 4, num_res_blocks: int = 2,
                 attention_ds: Tuple[int, ...] = (1, 2, 4),
                 channel_mult: Tuple[int, ...] = (1, 2, 4, 4),
                 num_heads: int = 8, context_dim: int = 768,
                 transformer_depth: int = 1,
                 tap_indices: Sequence[int] = (2, 5, 8, 11),
                 dtype=torch.float32):
        super().__init__()
        self.model_channels = model_channels
        self.num_res_blocks = num_res_blocks
        self.attention_ds = tuple(attention_ds)
        self.channel_mult = tuple(channel_mult)
        self.tap_indices = tuple(tap_indices)
        emb_dim = model_channels * 4
        self.time_embed_0 = Dense(model_channels, emb_dim, dtype=dtype)
        self.time_embed_2 = Dense(emb_dim, emb_dim, dtype=dtype)

        def attn(ch):
            return SpatialTransformer(ch, context_dim, num_heads,
                                      ch // num_heads, transformer_depth, dtype)

        self.input_conv = Conv(in_channels, model_channels, 3, padding=1,
                               dtype=dtype)
        skips = [model_channels]
        prev, ds, block_id = model_channels, 1, 0
        for i_level, mult in enumerate(self.channel_mult):
            ch = model_channels * mult
            for _ in range(num_res_blocks):
                block_id += 1
                self.add_module(f"in_{block_id}_res",
                                ResBlock(prev, ch, emb_dim, dtype))
                if ds in self.attention_ds:
                    self.add_module(f"in_{block_id}_attn", attn(ch))
                prev = ch
                skips.append(ch)
            if i_level != len(self.channel_mult) - 1:
                block_id += 1
                self.add_module(f"in_{block_id}_down", DownsampleConv(ch, dtype))
                skips.append(ch)
                ds *= 2
        self.mid_res_0 = ResBlock(prev, prev, emb_dim, dtype)
        self.mid_attn = attn(prev)
        self.mid_res_1 = ResBlock(prev, prev, emb_dim, dtype)
        out_idx = 0
        for i_level, mult in reversed(list(enumerate(self.channel_mult))):
            ch = model_channels * mult
            for i_block in range(num_res_blocks + 1):
                self.add_module(f"out_{out_idx}_res",
                                ResBlock(prev + skips.pop(), ch, emb_dim, dtype))
                if ds in self.attention_ds:
                    self.add_module(f"out_{out_idx}_attn", attn(ch))
                if i_level != 0 and i_block == num_res_blocks:
                    self.add_module(f"out_{out_idx}_up", UpsampleConv(ch, dtype))
                    ds //= 2
                prev = ch
                out_idx += 1
        self.out_norm = GroupNorm32(prev, eps=1e-5)
        self.out_conv = zero_init(Conv(prev, out_channels, 3, padding=1, dtype=dtype))

    def forward(self, x, timesteps, context,
                cond_emb: Optional[torch.Tensor] = None,
                taps_only: bool = False):
        """x [B, 4, h, w]; timesteps [B]; context [B, 77, context_dim];
        cond_emb optional [B, 4*model_channels]. Returns (eps, taps); with
        ``taps_only`` it stops after the last tap and returns (None, taps)."""
        dtype = self.input_conv.weight.dtype
        emb = self.time_embed_0(
            timestep_embedding(timesteps, self.model_channels).to(dtype))
        emb = self.time_embed_2(F.silu(emb))
        if cond_emb is not None:
            emb = emb + cond_emb

        taps, hs = [], []
        h = self.input_conv(x)
        hs.append(h)
        ds, block_id = 1, 0
        for i_level in range(len(self.channel_mult)):
            for _ in range(self.num_res_blocks):
                block_id += 1
                h = getattr(self, f"in_{block_id}_res")(h, emb)
                if ds in self.attention_ds:
                    h = getattr(self, f"in_{block_id}_attn")(h, context)
                hs.append(h)
            if i_level != len(self.channel_mult) - 1:
                block_id += 1
                h = getattr(self, f"in_{block_id}_down")(h)
                hs.append(h)
                ds *= 2

        h = self.mid_res_0(h, emb)
        h = self.mid_attn(h, context)
        h = self.mid_res_1(h, emb)

        last_tap = max(self.tap_indices, default=-1)
        out_idx = 0
        for i_level in reversed(range(len(self.channel_mult))):
            for i_block in range(self.num_res_blocks + 1):
                h = torch.cat([h, hs.pop()], dim=1)
                if out_idx in self.tap_indices:
                    taps.append(h)
                    if taps_only and out_idx == last_tap:
                        return None, taps
                h = getattr(self, f"out_{out_idx}_res")(h, emb)
                if ds in self.attention_ds:
                    h = getattr(self, f"out_{out_idx}_attn")(h, context)
                if i_level != 0 and i_block == self.num_res_blocks:
                    h = getattr(self, f"out_{out_idx}_up")(h)
                    ds //= 2
                out_idx += 1

        eps = self.out_conv(F.silu(self.out_norm(h)))
        return eps, taps
