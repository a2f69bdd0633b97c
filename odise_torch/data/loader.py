"""The training loader (counterpart of ``odise_tpu/data/loader.py`` for one
process): an infinite seeded shuffle of in-memory records, mapped and
collated into batches, with the JAX loader's sampler and augmentation
seeds, so that both packages see the same images with the same flips,
scales and crops."""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List

import numpy as np
import torch

from .dataset_mapper import collate

__all__ = ["TrainingSampler", "build_train_loader"]


class TrainingSampler:
    """Infinite index stream, a fresh permutation per epoch from seed + epoch."""

    def __init__(self, size: int, seed: int = 42):
        self.size = size
        self.seed = seed

    def __iter__(self) -> Iterator[int]:
        epoch = 0
        while True:
            yield from np.random.RandomState(self.seed + epoch).permutation(self.size).tolist()
            epoch += 1


def build_train_loader(records: List[dict], mapper: Callable, batch_size: int,
                       *, seed: int = 42) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield collated batches, forever, on the mapper's device (CUDA unless
    the mapper was built with ``device="cpu"``)."""
    sampler = iter(TrainingSampler(len(records), seed=seed))
    rng = np.random.RandomState(seed * 1000)  # the JAX loader's, for host 0
    while True:
        yield collate([mapper(records[next(sampler)], rng=rng) for _ in range(batch_size)])
