"""CLIP text and image towers, including the MaskCLIP reader path.

Counterpart of ``odise_tpu/models/clip/model.py``: OpenAI CLIP blocks
(QuickGELU, pre-LN), a fused ``in_proj``, and the split-stream MaskCLIP mode
in which ``reader`` tokens attend into the image tokens under
``reader_mask`` while nobody attends to them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .modules import Conv, Dense, LayerNorm, attention, param

CLIP_PIXEL_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_PIXEL_STD = (0.26862954, 0.26130258, 0.27577711)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class MultiheadAttention(nn.Module):
    """Attention with a fused in-projection (torch layout).

    ``attn_mask``: bool [L, L] or [B, L, L]; True = masked out.
    ``reader``/``reader_mask``: [B, Q, C] tokens that attend into ``x``
    (masked per ``reader_mask`` [B, Q, L]) and are attended by nobody.
    Returns ``out_x``, or ``(out_x, out_reader)`` with a reader.
    """

    def __init__(self, width: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.width, self.heads = width, heads
        self.in_proj = Dense(width, 3 * width, dtype=dtype)
        self.out_proj = Dense(width, width, dtype=dtype)

    def forward(self, x, attn_mask: Optional[torch.Tensor] = None,
                reader: Optional[torch.Tensor] = None,
                reader_mask: Optional[torch.Tensor] = None):
        B, L, _ = x.shape
        hd = self.width // self.heads
        q, k, v = (t.reshape(B, L, self.heads, hd)
                   for t in self.in_proj(x).chunk(3, dim=-1))
        if attn_mask is not None:
            attn_mask = attn_mask[None, None] if attn_mask.dim() == 2 \
                else attn_mask[:, None]
        out = self.out_proj(attention(q, k, v, attn_mask).reshape(B, L, self.width))
        if reader is None:
            return out
        Q = reader.shape[1]
        q_r = self.in_proj(reader)[..., : self.width].reshape(B, Q, self.heads, hd)
        m = None if reader_mask is None else reader_mask[:, None]
        out_r = attention(q_r, k, v, m).reshape(B, Q, self.width)
        return out, self.out_proj(out_r)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.ln_1 = LayerNorm(width, eps=1e-5)
        self.attn = MultiheadAttention(width, heads, dtype)
        self.ln_2 = LayerNorm(width, eps=1e-5)
        self.c_fc = Dense(width, width * 4, dtype=dtype)
        self.c_proj = Dense(width * 4, width, dtype=dtype)

    def mlp(self, t):
        return self.c_proj(quick_gelu(self.c_fc(t)))

    def forward(self, x, attn_mask=None, reader=None, reader_mask=None):
        if reader is None:
            x = x + self.attn(self.ln_1(x).to(x.dtype), attn_mask)
            return x + self.mlp(self.ln_2(x).to(x.dtype))
        dx, dr = self.attn(self.ln_1(x).to(x.dtype), None,
                           reader=self.ln_1(reader).to(reader.dtype),
                           reader_mask=reader_mask)
        x = x + dx
        reader = reader + dr
        x = x + self.mlp(self.ln_2(x).to(x.dtype))
        reader = reader + self.mlp(self.ln_2(reader).to(reader.dtype))
        return x, reader


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"resblock_{i}",
                            ResidualAttentionBlock(width, heads, dtype))

    def forward(self, x, attn_mask=None, reader=None, reader_mask=None):
        for i in range(self.layers):
            block = getattr(self, f"resblock_{i}")
            if reader is None:
                x = block(x, attn_mask)
            else:
                x, reader = block(x, attn_mask, reader=reader,
                                  reader_mask=reader_mask)
        return x if reader is None else (x, reader)


class TextTransformer(nn.Module):
    """CLIP text tower. ``forward(tokens)`` -> (text_embed, text_encodings)."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77,
                 width: int = 768, layers: int = 12, heads: int = 12,
                 embed_dim: int = 768, dtype=torch.float32):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width, dtype=dtype)
        # flax's nn.Embed start: a normal of variance 1 / width
        nn.init.normal_(self.token_embedding.weight, std=width ** -0.5)
        self.positional_embedding = param((context_length, width), std=0.01)
        self.transformer = Transformer(width, layers, heads, dtype)
        self.ln_final = LayerNorm(width, eps=1e-5)
        self.text_projection = param((width, embed_dim), std=width ** -0.5)

    def forward(self, tokens: torch.Tensor):
        B, L = tokens.shape
        x = self.token_embedding(tokens)
        x = x + self.positional_embedding[:L].to(x.dtype)[None]
        causal = torch.ones((L, L), dtype=torch.bool,
                            device=tokens.device).triu(1)
        x = self.ln_final(self.transformer(x, causal))  # float32
        # features at the eot token = the highest token id in the sequence
        eot = tokens.argmax(dim=-1)
        pooled = x[torch.arange(B, device=x.device), eot]
        return pooled @ self.text_projection.float(), x


class VisionTransformer(nn.Module):
    """CLIP ViT with the MaskCLIP reader forward; images are NCHW."""

    def __init__(self, image_size: int = 224, patch_size: int = 14,
                 width: int = 1024, layers: int = 24, heads: int = 16,
                 embed_dim: int = 768, dtype=torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.conv1 = Conv(3, width, patch_size, stride=patch_size, bias=False,
                          dtype=dtype)
        self.class_embedding = param((width,), std=width ** -0.5)
        n_pos = (image_size // patch_size) ** 2 + 1
        self.positional_embedding = param((n_pos, width), std=width ** -0.5)
        self.ln_pre = LayerNorm(width, eps=1e-5)
        self.transformer = Transformer(width, layers, heads, dtype)
        self.ln_post = LayerNorm(width, eps=1e-5)
        self.proj = param((width, embed_dim), std=width ** -0.5)

    def _embed_patches(self, image):
        """image [B, 3, S, S] -> tokens [B, 1+N, width], (gh, gw)."""
        x = self.conv1(image)
        B, C, gh, gw = x.shape
        x = x.reshape(B, C, gh * gw).transpose(1, 2)
        cls = self.class_embedding.to(x.dtype).expand(B, 1, C)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)[None]
        return self.ln_pre(x).to(x.dtype), (gh, gw)

    def forward(self, image: torch.Tensor, *, mask_tokens: Optional[int] = None,
                reader_mask: Optional[torch.Tensor] = None):
        """Plain forward -> (image_embed [B, D], image_encodings
        [B, gh, gw, D]). With ``mask_tokens=Q`` and ``reader_mask``
        [B, Q, 1+N] -> the projected mask-token features [B, Q, D]."""
        x, (gh, gw) = self._embed_patches(image)
        B = x.shape[0]
        if mask_tokens is not None:
            if reader_mask is None:
                raise ValueError("the masked forward needs reader_mask")
            reader = x[:, 0:1].expand(B, mask_tokens, x.shape[-1])
            _, r = self.transformer(x, reader=reader, reader_mask=reader_mask)
            return self.ln_post(r) @ self.proj.float()
        x = self.ln_post(self.transformer(x)) @ self.proj.float()
        return x[:, 0], x[:, 1:].reshape(B, gh, gw, -1)
