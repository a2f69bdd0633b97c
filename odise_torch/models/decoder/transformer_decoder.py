"""Masked-attention transformer decoder (counterpart of
``odise_tpu/models/decoder/transformer_decoder.py``).

``training=False`` is the inference path: intermediate layers only need the
next attention mask, which is computed at the attention resolution against
pre-resized mask features; the prediction heads run once, after the last
layer, and no aux outputs are produced. ``training=True`` runs the
prediction heads after every layer at full resolution, as the JAX code
does: each layer's mask logits, ``PooledMaskEmbed`` and the next attention
mask from a bilinear, antialiased downsize of the logits thresholded
without gradient, and returns every layer but the last as aux outputs.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..helper import mask_pooling
from ..modules import Dense, LayerNorm, add_modules, param
from ..resize import resize
from .layers import MLP, MultiheadAttention, position_embedding_sine


class PseudoClassEmbed(nn.Module):
    """Constant fg=1 / bg=0 logits."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.num_classes = num_classes

    def forward(self, x):
        fg = x.new_ones(x.shape[:-1] + (self.num_classes,))
        bg = x.new_zeros(x.shape[:-1] + (1,))
        return torch.cat([fg, bg], dim=-1)


class PooledMaskEmbed(nn.Module):
    """Mask-pooled features + decoder output -> CLIP-space mask embed with a
    learnable logit scale (clipped at 100)."""

    def __init__(self, hidden_dim: int, mask_dim: int, projection_dim: int,
                 temperature: float = 0.07, dtype=torch.float32):
        super().__init__()
        self.pool_norm = LayerNorm(mask_dim, eps=1e-5)
        self.pool_proj = Dense(mask_dim, hidden_dim, dtype=dtype)
        self.embed_norm = LayerNorm(hidden_dim, eps=1e-5)
        self.embed_mlp = MLP(hidden_dim, hidden_dim, projection_dim, 3, dtype)
        self.logit_scale = param((), fill=math.log(1 / temperature))

    def forward(self, decoder_output, input_mask_embed, mask_features,
                pred_logits, pred_masks):
        """decoder_output [B, Q, C]; mask_features [B, C, H, W];
        pred_masks [B, Q, H, W]."""
        pooled = mask_pooling(mask_features, pred_masks)
        pooled = self.pool_norm(pooled).to(decoder_output.dtype)
        pooled = self.pool_proj(pooled) + decoder_output
        h = self.embed_norm(pooled).to(pooled.dtype)
        return {
            "mask_embed": self.embed_mlp(h),
            "mask_pooled_features": pooled,
            "logit_scale": torch.clamp(torch.exp(self.logit_scale), max=100.0),
        }


class _CrossAttentionLayer(nn.Module):
    def __init__(self, dim: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.attn = MultiheadAttention(dim, heads, dtype)
        self.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, tgt, memory, memory_mask, pos, query_pos):
        h = self.attn(tgt + query_pos, memory + pos, memory, memory_mask)
        return self.norm(tgt + h).to(h.dtype)


class _SelfAttentionLayer(nn.Module):
    def __init__(self, dim: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.attn = MultiheadAttention(dim, heads, dtype)
        self.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, tgt, query_pos):
        q = tgt + query_pos
        h = self.attn(q, q, tgt)
        return self.norm(tgt + h).to(h.dtype)


class _FFNLayer(nn.Module):
    def __init__(self, dim: int, ffn_dim: int, dtype=torch.float32):
        super().__init__()
        self.linear1 = Dense(dim, ffn_dim, dtype=dtype)
        self.linear2 = Dense(ffn_dim, dim, dtype=dtype)
        self.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, tgt):
        h = self.linear2(F.relu(self.linear1(tgt)))
        return self.norm(tgt + h).to(h.dtype)


class ODISEMultiScaleMaskedTransformerDecoder(nn.Module):
    """The ODISE mask-generator decoder.

    ``forward(x: list of [B, C, h, w] coarsest first, mask_features
    [B, C, H, W], training)`` -> dict with pred_logits, pred_masks,
    mask_embed, mask_pooled_features, logit_scale and aux_outputs (empty
    unless ``training``).
    """

    def __init__(self, hidden_dim: int = 256, num_queries: int = 100,
                 nheads: int = 8, dim_feedforward: int = 2048,
                 dec_layers: int = 9, mask_dim: int = 256,
                 num_classes: int = 133, in_channels: int = 256,
                 num_feature_levels: int = 3, class_embed: nn.Module = None,
                 post_mask_embed: nn.Module = None, enforce_input_project: bool = False,
                 dtype=torch.float32):
        """``class_embed`` is required (the JAX module builds a linear one
        when it is None)."""
        if class_embed is None:
            raise ValueError("the decoder needs a class_embed")
        super().__init__()
        self.hidden_dim, self.dec_layers = hidden_dim, dec_layers
        self.num_feature_levels = num_feature_levels
        self.query_feat = param((num_queries, hidden_dim), std=1.0)
        self.query_embed = param((num_queries, hidden_dim), std=1.0)
        self.level_embed = param((num_feature_levels, hidden_dim), std=1.0)
        self.cross = add_modules(self, "cross_", [
            _CrossAttentionLayer(hidden_dim, nheads, dtype) for _ in range(dec_layers)])
        self.self_ = add_modules(self, "self_", [
            _SelfAttentionLayer(hidden_dim, nheads, dtype) for _ in range(dec_layers)])
        self.ffn = add_modules(self, "ffn_", [
            _FFNLayer(hidden_dim, dim_feedforward, dtype) for _ in range(dec_layers)])
        self.decoder_norm = LayerNorm(hidden_dim, eps=1e-5)
        self.class_embed = class_embed
        self.mask_embed_mlp = MLP(hidden_dim, hidden_dim, mask_dim, 3, dtype)
        self.post_mask_embed = post_mask_embed
        self.input_proj = None
        if enforce_input_project or in_channels != hidden_dim:
            self.input_proj = add_modules(self, "input_proj_", [
                Dense(in_channels, hidden_dim, dtype=dtype)
                for _ in range(num_feature_levels)])

    @staticmethod
    def _threshold_attn_mask(mask_logits_hw):
        """[B, Q, h, w] mask logits -> bool [B, 1, Q, h*w], True = masked
        out, with fully masked rows unmasked."""
        B, Q, h, w = mask_logits_hw.shape
        am = torch.sigmoid(mask_logits_hw).reshape(B, Q, h * w) < 0.5
        am = am & ~am.all(dim=-1, keepdim=True)
        return am[:, None]

    def _prediction_heads(self, output, mask_features, attn_target_hw=None):
        """One prediction-head pass -> (class logits, mask logits, the next
        attention mask or None, the post-mask-embed extras)."""
        x = self.decoder_norm(output).to(output.dtype)
        outputs_class = self.class_embed(x)
        mask_embed = self.mask_embed_mlp(x)
        outputs_mask = torch.einsum("bqc,bchw->bqhw", mask_embed, mask_features)
        extra = {}
        if self.post_mask_embed is not None:
            extra = self.post_mask_embed(x, mask_embed, mask_features,
                                         outputs_class, outputs_mask)
        am = None
        if attn_target_hw is not None:
            with torch.no_grad():
                am = self._threshold_attn_mask(
                    resize(outputs_mask, attn_target_hw, "bilinear"))
        return outputs_class, outputs_mask, am, extra

    def _fast_attn_mask(self, output, mask_features_lvl):
        x = self.decoder_norm(output).to(output.dtype)
        m = torch.einsum("bqc,bchw->bqhw", self.mask_embed_mlp(x),
                         mask_features_lvl)
        return self._threshold_attn_mask(m)

    def forward(self, x: Sequence[torch.Tensor], mask_features: torch.Tensor,
                training: bool = False):
        if len(x) != self.num_feature_levels:
            raise ValueError(f"{len(x)} feature levels, expected "
                             f"{self.num_feature_levels}")
        B = x[0].shape[0]
        srcs, poss, sizes = [], [], []
        for i, feat in enumerate(x):
            _, C, H, W = feat.shape
            sizes.append((H, W))
            pos = position_embedding_sine(H, W, self.hidden_dim // 2,
                                          dtype=feat.dtype, device=feat.device)
            poss.append(pos.reshape(1, H * W, -1).expand(B, H * W, self.hidden_dim))
            f = feat.flatten(2).transpose(1, 2)
            if self.input_proj is not None:
                f = self.input_proj[i](f)
            srcs.append(f + self.level_embed[i].to(f.dtype))
        dtype = srcs[0].dtype
        output = self.query_feat[None].expand(B, -1, -1).to(dtype)
        query_pos = self.query_embed[None].expand(B, -1, -1).to(dtype)
        if training:
            return self._forward_train(output, query_pos, srcs, poss, sizes,
                                       mask_features)
        mf_small = [resize(mask_features, hw, "bilinear") for hw in sizes]

        attn_mask = self._fast_attn_mask(output, mf_small[0])
        for i in range(self.dec_layers):
            li = i % self.num_feature_levels
            output = self.cross[i](output, srcs[li], attn_mask, poss[li], query_pos)
            output = self.self_[i](output, query_pos)
            output = self.ffn[i](output)
            if i < self.dec_layers - 1:
                attn_mask = self._fast_attn_mask(
                    output, mf_small[(i + 1) % self.num_feature_levels])

        # prediction heads, once, on the last layer's output
        x_n = self.decoder_norm(output).to(output.dtype)
        outputs_class = self.class_embed(x_n)
        mask_embed = self.mask_embed_mlp(x_n)
        outputs_mask = torch.einsum("bqc,bchw->bqhw", mask_embed, mask_features)
        out = {"pred_logits": outputs_class, "pred_masks": outputs_mask,
               "aux_outputs": []}
        if self.post_mask_embed is not None:
            out.update(self.post_mask_embed(x_n, mask_embed, mask_features,
                                            outputs_class, outputs_mask))
        return out

    def _forward_train(self, output, query_pos, srcs, poss, sizes, mask_features):
        L = self.num_feature_levels
        heads = [self._prediction_heads(output, mask_features, sizes[0])]
        for i in range(self.dec_layers):
            li = i % L
            output = self.cross[i](output, srcs[li], heads[-1][2], poss[li], query_pos)
            output = self.self_[i](output, query_pos)
            output = self.ffn[i](output)
            last = i == self.dec_layers - 1
            heads.append(self._prediction_heads(
                output, mask_features, None if last else sizes[(i + 1) % L]))
        outs = [{"pred_logits": c, "pred_masks": m, **extra}
                for c, m, _, extra in heads]
        out = dict(outs[-1])
        out["aux_outputs"] = outs[:-1]
        return out


class MaskFormerHead(nn.Module):
    """pixel decoder -> transformer predictor."""

    def __init__(self, pixel_decoder: nn.Module, transformer_predictor: nn.Module):
        super().__init__()
        self.pixel_decoder = pixel_decoder
        self.transformer_predictor = transformer_predictor

    def forward(self, features: Dict[str, torch.Tensor], training: bool = False):
        mask_features, multi_scale_features = self.pixel_decoder(features)
        return self.transformer_predictor(multi_scale_features, mask_features,
                                          training=training)
