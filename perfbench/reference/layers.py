"""Shared decoder layers: sine position embedding, MHA, MLP (counterpart of
``odise_tpu/models/decoder/layers.py``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .modules import Dense, attention


def position_embedding_sine(h: int, w: int, num_pos_feats: int = 128,
                            temperature: int = 10000, normalize: bool = True,
                            dtype=torch.float32, device=None) -> torch.Tensor:
    """2D sine positional encoding -> [h, w, 2*num_pos_feats]."""
    y_embed = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None].expand(h, w)
    x_embed = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :].expand(h, w)
    if normalize:
        eps, scale = 1e-6, 2 * math.pi
        y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / num_pos_feats)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = torch.stack([pos_x[:, :, 0::2].sin(), pos_x[:, :, 1::2].cos()],
                        dim=3).reshape(h, w, num_pos_feats)
    pos_y = torch.stack([pos_y[:, :, 0::2].sin(), pos_y[:, :, 1::2].cos()],
                        dim=3).reshape(h, w, num_pos_feats)
    return torch.cat([pos_y, pos_x], dim=-1).to(dtype)


class MultiheadAttention(nn.Module):
    """Q/KV attention. ``attn_mask``: bool broadcastable to
    [B, heads, Lq, Lk]; True = masked out (no row entirely masked)."""

    def __init__(self, dim: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.q_proj = Dense(dim, dim, dtype=dtype)
        self.k_proj = Dense(dim, dim, dtype=dtype)
        self.v_proj = Dense(dim, dim, dtype=dtype)
        self.out_proj = Dense(dim, dim, dtype=dtype)

    def forward(self, query, key, value, attn_mask: Optional[torch.Tensor] = None):
        B, Lq, _ = query.shape
        Lk = key.shape[1]
        hd = self.dim // self.heads
        q = self.q_proj(query).reshape(B, Lq, self.heads, hd)
        k = self.k_proj(key).reshape(B, Lk, self.heads, hd)
        v = self.v_proj(value).reshape(B, Lk, self.heads, hd)
        if attn_mask is not None and attn_mask.dim() == 3:  # [B, Lq, Lk]
            attn_mask = attn_mask[:, None]
        out = attention(q, k, v, attn_mask).reshape(B, Lq, self.dim)
        return self.out_proj(out)


class MLP(nn.Module):
    """``num_layers``-deep ReLU MLP; layers named ``layer_<i>``."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, dtype=torch.float32):
        super().__init__()
        self.num_layers = num_layers
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        for i in range(num_layers):
            self.add_module(f"layer_{i}", Dense(dims[i], dims[i + 1], dtype=dtype))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x
