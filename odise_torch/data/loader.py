"""Data loaders (counterpart of ``odise_tpu/data/loader.py``): an infinite
seeded shuffle of records, mapped and collated into batches, each host (a
rank of a multi-process run) taking its own slice of the stream, with the
JAX loader's sampler and augmentation seeds, so that both packages see the
same images with the same flips, scales and crops; and a sequential test
pass.

A dataset is a list of records or the name of one registered in
``data.catalog.DatasetCatalog``.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from .catalog import DatasetCatalog
from .dataset_mapper import collate

__all__ = ["TrainingSampler", "build_test_loader", "build_train_loader"]

Dataset = Union[str, List[dict]]


def _records(dataset: Dataset) -> List[dict]:
    return DatasetCatalog.get(dataset) if isinstance(dataset, str) else dataset


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


def build_train_loader(dataset: Dataset, mapper: Callable, total_batch_size: int,
                       *, num_hosts: int = 1, host_id: int = 0,
                       seed: int = 42) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield collated batches of ``total_batch_size / num_hosts``, forever,
    on the mapper's device (CUDA unless the mapper was built with
    ``device="cpu"``). Host ``host_id`` takes every ``num_hosts``-th index of
    the shared stream from the ``host_id``-th on, and augments with its own
    ``RandomState(seed * 1000 + host_id)``."""
    if total_batch_size % num_hosts:
        raise ValueError(f"a total batch of {total_batch_size} does not split over "
                         f"{num_hosts} hosts")
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"host {host_id} of {num_hosts}")
    records = _records(dataset)
    per_host = total_batch_size // num_hosts
    sampler = itertools.islice(iter(TrainingSampler(len(records), seed=seed)),
                               host_id, None, num_hosts)
    rng = np.random.RandomState(seed * 1000 + host_id)
    while True:
        yield collate([mapper(records[next(sampler)], rng=rng) for _ in range(per_host)])


def build_test_loader(dataset: Dataset, mapper: Optional[Callable] = None,
                      batch_size: int = 1, limit: Optional[int] = None) -> Iterator[list]:
    """One pass over the dataset in order, ``batch_size`` records a list
    (mapped where a ``mapper`` is given)."""
    records = _records(dataset)
    if limit is not None:
        records = records[:limit]
    for i in range(0, len(records), batch_size):
        chunk = records[i:i + batch_size]
        yield chunk if mapper is None else [mapper(r) for r in chunk]
