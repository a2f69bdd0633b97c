"""Carry the JAX package's flax parameters into the port.

The port names its submodules after the flax scopes, so the map is
mechanical by leaf kind: a Dense ``kernel`` [in, out] becomes ``weight``
[out, in]; a Conv ``kernel`` HWIO becomes ``weight`` OIHW; a norm's
``scale`` and an Embed's ``embedding`` become ``weight``; every other leaf
(biases and raw parameters) is copied as it is.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Tuple

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


def match_flax_tree(module: nn.Module, tree: Mapping
                    ) -> Tuple[List[Tuple[str, np.ndarray]], List[str]]:
    """Match every leaf of a (partial) flax tree to a tensor of ``module``
    without copying anything.

    Returns ((port name, value in the port's layout) for every leaf, the
    names of the module's tensors that no leaf matched). Raises ``KeyError``
    on a leaf that names no port tensor and ``ValueError`` on a leaf whose
    shape does not fit its tensor, before anything is written.
    """
    targets: Dict[str, torch.Tensor] = module.state_dict(keep_vars=True)
    matched, unused = [], []
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
        matched.append((name, value))
    if unused:
        raise KeyError(f"flax leaves with no port tensor: {unused}")
    filled = {name for name, _ in matched}
    return matched, sorted(set(targets) - filled)


def load_flax_subtree(module: nn.Module, tree: Mapping) -> List[str]:
    """Fill the tensors of ``module`` that a partial flax tree of numpy
    arrays names (one tower, the trainable set, ...), in place; returns the
    names of the module's tensors that the tree left unfilled, so that a
    caller can check it filled a whole tower. Raises as ``match_flax_tree``,
    with nothing written."""
    matched, unfilled = match_flax_tree(module, tree)
    targets = module.state_dict(keep_vars=True)
    with torch.no_grad():
        for name, value in matched:
            targets[name].copy_(torch.from_numpy(np.array(value, order="C")))
    return unfilled


def load_flax_params(module: nn.Module, params: Mapping) -> None:
    """Fill ``module``'s parameters and persistent buffers from a flax
    ``{"params": ...}`` tree of numpy arrays, in place.

    Raises on a flax leaf that matches no port tensor (by name or shape)
    and on a port tensor that no flax leaf filled.
    """
    tree = params["params"] if "params" in params else params
    missing = load_flax_subtree(module, tree)
    if missing:
        raise KeyError(f"port tensors not filled: {missing}")
