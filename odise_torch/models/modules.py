"""Building blocks with the JAX package's dtype policy.

A flax ``nn.Dense(dtype=bf16)`` or ``nn.Conv(dtype=bf16)`` casts its input
and weights to bf16 and returns bf16; its normalisations are built with
``dtype=float32`` and return float32. These modules keep that policy
explicitly (no ``torch.autocast``): ``Dense`` and ``Conv`` compute in the
dtype they are built with, casting their input and their weights to it;
they are built holding their weights in that dtype (the eval models), and
training holds its trainable weights in float32 as the JAX package does
(``engine.train_loop.partition_params``). ``LayerNorm`` and ``GroupNorm``
hold float32 parameters, compute in float32 and return float32, leaving the
cast back to the caller as the JAX code does.

Parameters start as flax's start them: ``Dense`` and ``Conv`` kernels from
flax's ``lecun_normal`` (a normal of variance 1 / fan_in cut at two standard
deviations), biases at zero, where ``torch.nn`` would draw both from a
uniform of a third of that variance. Where the JAX code starts a kernel at
zero (the SD UNet's residual branches), the port's module zeroes it too.
A model built from a seed is then a random draw of the JAX package's own
distribution; the training recipe's learning rates were tuned on it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


# the standard deviation of a unit normal cut at +-2, which flax's
# truncated-normal initialisers divide by
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's ``lecun_normal``: variance 1 / fan_in, truncated at two
    standard deviations."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)


def _flax_reset(layer) -> None:
    lecun_normal_(layer.weight, layer.weight[0].numel())
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)


def zero_init(layer):
    """``layer`` with its kernel at zero (flax's ``kernel_init=zeros``)."""
    with torch.no_grad():
        layer.weight.zero_()
    return layer


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``dtype`` (flax ``nn.Dense``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias, dtype=dtype)
        self.compute_dtype = dtype

    def reset_parameters(self) -> None:
        _flax_reset(self)

    def forward(self, x):
        cd = self.compute_dtype
        return F.linear(x.to(cd), self.weight.to(cd), _cast(self.bias, cd))


class Conv(nn.Conv2d):
    """NCHW ``nn.Conv2d`` that computes in ``dtype`` (flax ``nn.Conv``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=bias, dtype=dtype)
        self.compute_dtype = dtype

    def reset_parameters(self) -> None:
        _flax_reset(self)

    def forward(self, x):
        cd = self.compute_dtype
        return self._conv_forward(x.to(cd), self.weight.to(cd), _cast(self.bias, cd))


class LayerNorm(nn.Module):
    """LayerNorm over the last dim in float32; returns float32."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, self.eps)


def num_groups(channels: int) -> int:
    """32 groups, or gcd(C, 32) where C is not a multiple of 32."""
    return 32 if channels % 32 == 0 else math.gcd(channels, 32)


class GroupNorm(nn.Module):
    """GroupNorm over NCHW maps in float32; returns float32."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.groups = num_groups(channels)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        # the aten op: F.group_norm refuses groups of one value, which the
        # tiny configuration has at its 1x1 level (the result is the bias)
        return torch.group_norm(x.float(), self.groups, self.weight, self.bias,
                                self.eps)


class GroupNorm32(nn.Module):
    """The SD towers' GroupNorm: float32 inside, the input's dtype out.

    The inner ``norm`` child mirrors the flax scope ``<name>/norm``.
    """

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.norm = GroupNorm(channels, eps)

    def forward(self, x):
        return self.norm(x).to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              masked: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention over [B, L, heads, head_dim] tensors, scaled by
    head_dim**-0.5, returning [B, Lq, heads, head_dim].

    ``masked`` uses the JAX package's polarity: True means masked out. It
    broadcasts to [B, heads, Lq, Lk] and no row may be masked entirely
    (callers unmask such rows first, as the JAX code does). The logits and
    the softmax are float32 inside ``scaled_dot_product_attention`` and the
    probabilities meet ``v`` in its dtype, as the JAX einsums do.
    """
    attend = None if masked is None else ~masked
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=attend)
    return out.transpose(1, 2)


def add_modules(parent: nn.Module, prefix: str, modules) -> list:
    """Register ``modules`` as ``<prefix>0``, ``<prefix>1``, ... (the flax
    scope names) and return them as a plain list."""
    out = []
    for i, m in enumerate(modules):
        parent.add_module(f"{prefix}{i}", m)
        out.append(m)
    return out


def param(shape, fill: Optional[float] = None, std: float = 0.02) -> nn.Parameter:
    """A raw float32 parameter (flax ``self.param``): constant or normal."""
    if fill is not None:
        return nn.Parameter(torch.full(shape, float(fill)))
    return nn.Parameter(torch.randn(shape) * std)
