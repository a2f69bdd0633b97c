"""Seeded weights for the program and the reference alike.

Every parameter is drawn from one ``torch.Generator`` seeded with the run's
seed, in a few large ``randn`` calls on the device, in the order of the
parameters' sorted names, and shaped by a rule of its name and shape:

- two or more dimensions (kernels, embedding tables): N(0, 1 / fan_in),
  fan_in = numel / shape[0], the variance of flax's ``lecun_normal``;
- one dimension named ``weight`` (norm scales): 1 + 0.1 N(0, 1);
- any other one dimension (biases, class embeddings): 0.02 N(0, 1);
- ``logit_scale`` (a scalar): log(1 / 0.07), CLIP's starting temperature.

The values are made in float32 and loaded through ``load_state_dict``, so
each side holds them in its own dtype: the program rounds what it holds in
bf16, the reference keeps float32. A scalar other than ``logit_scale`` is
refused, so that a new kind of parameter is given a rule before it is run.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch

CHUNK = 1 << 28  # elements per randn call: 1 GiB of float32


def specs(model: torch.nn.Module) -> List[Tuple[str, torch.Size]]:
    """(name, shape) of every parameter, sorted by name."""
    return sorted((n, p.shape) for n, p in model.named_parameters())


def _shaped(name: str, shape: torch.Size, z: torch.Tensor) -> torch.Tensor:
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) == 0:
        if leaf != "logit_scale":
            raise ValueError(f"no rule for the scalar parameter {name}")
        return torch.full((), math.log(1 / 0.07), device=z.device)
    z = z.reshape(shape)
    if len(shape) >= 2:
        return z * (shape[0] / z.numel()) ** 0.5
    if leaf == "weight":
        return 1.0 + 0.1 * z
    return 0.02 * z


def chunks(seed: int, spec: List[Tuple[str, torch.Size]], device
           ) -> Iterator[Dict[str, torch.Tensor]]:
    """The seeded values, a dict of name -> float32 tensor per randn call."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    group, total = [], 0
    for name, shape in spec + [(None, None)]:
        n = 0 if name is None else max(math.prod(shape), 1)
        if group and (name is None or total + n > CHUNK):
            z = torch.randn(total, generator=gen, device=device)
            out, at = {}, 0
            for gname, gshape in group:
                k = max(math.prod(gshape), 1)
                out[gname] = _shaped(gname, gshape, z[at:at + k])
                at += k
            yield out
            del z, out
            group, total = [], 0
        if name is not None:
            group.append((name, shape))
            total += n


@torch.no_grad()
def fill_(model: torch.nn.Module, seed: int, spec=None) -> int:
    """Load the seeded values into ``model`` chunk by chunk; ``spec``
    (default: the model's own) names and shapes the parameters. Every
    parameter the model has must be written, and nothing else. Returns the
    number of values."""
    spec = specs(model) if spec is None else spec
    device = next(model.parameters()).device
    missing = None
    for chunk in chunks(seed, spec, device):
        m, unexpected = model.load_state_dict(chunk, strict=False)
        if unexpected:
            raise KeyError(f"the model has no parameters {unexpected[:5]}")
        missing = set(m) if missing is None else missing & set(m)
    own = {n for n, _ in model.named_parameters()}
    left = sorted(own & (missing or set()))
    if left:
        raise KeyError(f"no seeded values for {left[:5]} ({len(left)} parameters)")
    return sum(max(math.prod(s), 1) for _, s in spec)
