"""Carry the JAX package's flax parameters into the port.

The port names its submodules after the flax scopes, so the map is
mechanical by leaf kind: a Dense ``kernel`` [in, out] becomes ``weight``
[out, in]; a Conv ``kernel`` HWIO becomes ``weight`` OIHW; a norm's
``scale`` and an Embed's ``embedding`` become ``weight``; every other leaf
(biases and raw parameters) is copied as it is.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

_RENAME = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def flax_to_torch_name(path: Tuple[str, ...]) -> str:
    return ".".join(path[:-1] + (_RENAME.get(path[-1], path[-1]),))


def flax_leaf_to_torch(path: Tuple[str, ...], arr: np.ndarray) -> np.ndarray:
    if path[-1] == "kernel":
        if arr.ndim == 2:  # Dense [in, out] -> [out, in]
            return arr.T
        if arr.ndim == 4:  # Conv HWIO -> OIHW
            return arr.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {arr.ndim} at {'/'.join(path)}")
    return arr


def load_flax_params(module: nn.Module, params: Mapping) -> None:
    """Fill ``module``'s parameters and persistent buffers from a flax
    ``{"params": ...}`` tree of numpy arrays, in place.

    Raises on a flax leaf that matches no port tensor (by name or shape)
    and on a port tensor that no flax leaf filled.
    """
    tree = params["params"] if "params" in params else params
    targets: Dict[str, torch.Tensor] = module.state_dict(keep_vars=True)
    unused, filled = [], set()
    with torch.no_grad():
        for path, arr in _leaves(tree):
            name = flax_to_torch_name(path)
            target = targets.get(name)
            if target is None:
                unused.append("/".join(path))
                continue
            value = flax_leaf_to_torch(path, arr)
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(f"{'/'.join(path)}: flax shape {arr.shape} "
                                 f"does not fit {name} {tuple(target.shape)}")
            target.copy_(torch.from_numpy(np.array(value, order="C")))
            filled.add(name)
    missing = sorted(set(targets) - filled)
    if unused or missing:
        raise KeyError(f"flax leaves with no port tensor: {unused}; port "
                       f"tensors not filled: {missing}")
