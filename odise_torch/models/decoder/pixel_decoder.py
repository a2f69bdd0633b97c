"""Multi-scale deformable-attention pixel decoder (counterpart of
``odise_tpu/models/decoder/pixel_decoder.py``), NCHW feature maps.

The deformable-attention core is ``odise_torch.ops.ms_deform_attn``: the
CUDA kernel on the card, the plain version on the CPU.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.ms_deform_attn import ms_deform_attn
from ...utils.tracing import span
from ..modules import Conv, Dense, GroupNorm, LayerNorm, param
from ..resize import resize
from .layers import position_embedding_sine


def _gn(norm: GroupNorm, x: torch.Tensor) -> torch.Tensor:
    return norm(x).to(x.dtype)


class MSDeformAttn(nn.Module):
    """Deformable attention module; the offset bias keeps the reference's
    directional grid init, the offset and weight kernels start at zero."""

    def __init__(self, dim: int, n_levels: int = 3, n_heads: int = 8,
                 n_points: int = 4, dtype=torch.float32):
        super().__init__()
        self.dim, self.n_levels = dim, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        self.sampling_offsets = Dense(dim, n_heads * n_levels * n_points * 2,
                                      dtype=dtype)
        self.attention_weights = Dense(dim, n_heads * n_levels * n_points,
                                       dtype=dtype)
        self.value_proj = Dense(dim, dim, dtype=dtype)
        self.output_proj = Dense(dim, dim, dtype=dtype)
        with torch.no_grad():
            thetas = np.arange(n_heads) * (2.0 * np.pi / n_heads)
            grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
            grid = grid / np.abs(grid).max(-1, keepdims=True)
            grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
            grid = grid * np.arange(1, n_points + 1)[None, None, :, None]
            self.sampling_offsets.weight.zero_()
            self.sampling_offsets.bias.copy_(torch.from_numpy(grid.reshape(-1)))
            self.attention_weights.weight.zero_()
            self.attention_weights.bias.zero_()

    def forward(self, query, reference_points, value, spatial_shapes):
        """query [B, Lq, C]; reference_points [B, Lq, n_levels, 2] float32
        in [0, 1]; value [B, Lv, C]; spatial_shapes [(H, W)] per level."""
        v, loc, attn = self.sampling_inputs(query, reference_points, value,
                                            spatial_shapes)
        return self.output_proj(ms_deform_attn(v, list(spatial_shapes), loc, attn))

    def sampling_inputs(self, query, reference_points, value, spatial_shapes):
        """The deformable-attention op's inputs: value [B, Lv, heads, hd],
        sampling locations [B, Lq, heads, levels, points, 2] float32 and
        attention weights [B, Lq, heads, levels, points]."""
        B, Lq, _ = query.shape
        Lv = value.shape[1]
        H, L, P = self.n_heads, self.n_levels, self.n_points
        offsets = self.sampling_offsets(query).reshape(B, Lq, H, L, P, 2)
        attn = self.attention_weights(query).reshape(B, Lq, H, L * P)
        attn = torch.softmax(attn.float(), dim=-1).to(query.dtype)
        attn = attn.reshape(B, Lq, H, L, P)
        v = self.value_proj(value).reshape(B, Lv, H, self.dim // H)
        # sampling locations stay float32: bf16 would put them a quarter
        # pixel off on the 128-px level
        wh = torch.tensor([[w, h] for (h, w) in spatial_shapes],
                          dtype=torch.float32, device=query.device)
        loc = (reference_points[:, :, None, :, None, :]
               + offsets.float() / wh[None, None, None, :, None, :])
        return v, loc, attn


class DeformableEncoderLayer(nn.Module):
    def __init__(self, dim: int, ffn_dim: int = 1024, n_heads: int = 8,
                 n_points: int = 4, n_levels: int = 3, dtype=torch.float32):
        super().__init__()
        self.self_attn = MSDeformAttn(dim, n_levels, n_heads, n_points, dtype)
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.linear1 = Dense(dim, ffn_dim, dtype=dtype)
        self.linear2 = Dense(ffn_dim, dim, dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=1e-5)

    def forward(self, src, pos, reference_points, spatial_shapes):
        h = self.self_attn(src + pos, reference_points, src, spatial_shapes)
        src = self.norm1(src + h).to(h.dtype)
        h = self.linear2(F.relu(self.linear1(src)))
        return self.norm2(src + h).to(h.dtype)


class MSDeformAttnPixelDecoder(nn.Module):
    """Deformable encoder over s3..s5 plus one FPN step to stride 4.

    ``forward(features)`` -> (mask_features [B, mask_dim, H/4, W/4],
    the encoder's maps [B, conv_dim, h, w], coarsest first).
    """

    def __init__(self, input_shape: Dict[str, dict], conv_dim: int = 256,
                 mask_dim: int = 256, transformer_nheads: int = 8,
                 transformer_dim_feedforward: int = 1024,
                 transformer_enc_layers: int = 6,
                 transformer_in_features: Sequence[str] = ("s3", "s4", "s5"),
                 num_feature_levels: int = 3, dtype=torch.float32):
        super().__init__()
        self.input_shape = dict(input_shape)
        self.conv_dim = conv_dim
        self.num_feature_levels = num_feature_levels
        self.transformer_in_features = tuple(transformer_in_features)
        # coarsest first
        self.tif = sorted(self.transformer_in_features,
                          key=lambda k: -self.input_shape[k]["stride"])
        self.fpn_names = sorted(
            [k for k in self.input_shape if k not in self.transformer_in_features],
            key=lambda k: -self.input_shape[k]["stride"])
        self.enc_layers = transformer_enc_layers
        self.level_embed = param((len(self.tif), conv_dim), std=1.0)
        for i, name in enumerate(self.tif):
            ch = self.input_shape[name]["channels"]
            self.add_module(f"input_proj_{i}", Conv(ch, conv_dim, 1, dtype=dtype))
            self.add_module(f"input_proj_norm_{i}", GroupNorm(conv_dim, eps=1e-5))
        for li in range(transformer_enc_layers):
            self.add_module(f"encoder_layer_{li}", DeformableEncoderLayer(
                conv_dim, transformer_dim_feedforward, transformer_nheads,
                n_levels=len(self.tif), dtype=dtype))
        for j, name in enumerate(self.fpn_names):
            ch = self.input_shape[name]["channels"]
            self.add_module(f"lateral_{j}", Conv(ch, conv_dim, 1, bias=False,
                                                 dtype=dtype))
            self.add_module(f"lateral_norm_{j}", GroupNorm(conv_dim, eps=1e-5))
            self.add_module(f"output_conv_{j}", Conv(
                conv_dim, conv_dim, 3, padding=1, bias=False, dtype=dtype))
            self.add_module(f"output_norm_{j}", GroupNorm(conv_dim, eps=1e-5))
        self.mask_features = Conv(conv_dim, mask_dim, 3, padding=1, dtype=dtype)

    def forward(self, features: Dict[str, torch.Tensor]):
        with span("odise.pixel_decoder"):
            srcs, poss, shapes = [], [], []
            for i, name in enumerate(self.tif):
                x = getattr(self, f"input_proj_{i}")(features[name])
                x = _gn(getattr(self, f"input_proj_norm_{i}"), x)
                B, C, H, W = x.shape
                pos = position_embedding_sine(H, W, self.conv_dim // 2,
                                              dtype=x.dtype, device=x.device)
                srcs.append(x.flatten(2).transpose(1, 2)
                            + self.level_embed[i].to(x.dtype))
                poss.append(pos.reshape(1, H * W, C).expand(B, H * W, C))
                shapes.append((H, W))
            src = torch.cat(srcs, dim=1)
            pos = torch.cat(poss, dim=1)

            ref_list = []
            for (H, W) in shapes:
                ys = (torch.arange(H, dtype=torch.float32, device=src.device) + 0.5) / H
                xs = (torch.arange(W, dtype=torch.float32, device=src.device) + 0.5) / W
                yy, xx = torch.meshgrid(ys, xs, indexing="ij")
                ref_list.append(torch.stack([xx, yy], -1).reshape(H * W, 2))
            ref = torch.cat(ref_list, dim=0)
            B = src.shape[0]
            reference_points = ref[None, :, None, :].expand(B, ref.shape[0],
                                                            len(shapes), 2)

            for li in range(self.enc_layers):
                src = getattr(self, f"encoder_layer_{li}")(
                    src, pos, reference_points, shapes)

            outs, offset = [], 0
            for (H, W) in shapes:
                outs.append(src[:, offset:offset + H * W].transpose(1, 2)
                            .reshape(B, self.conv_dim, H, W))
                offset += H * W

            y = outs[-1]  # finest encoder output (stride 8)
            for j, name in enumerate(self.fpn_names):
                x = features[name]
                lateral = _gn(getattr(self, f"lateral_norm_{j}"),
                              getattr(self, f"lateral_{j}")(x))
                y = lateral + resize(y, x.shape[-2:], "bilinear")
                y = getattr(self, f"output_conv_{j}")(y)
                y = F.relu(_gn(getattr(self, f"output_norm_{j}"), y))
            return self.mask_features(y), outs[: self.num_feature_levels]
