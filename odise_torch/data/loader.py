"""Data loaders (counterpart of ``odise_tpu/data/loader.py``): an infinite
seeded shuffle of records, mapped and collated into batches, each host (a
rank of a multi-process run) taking its own slice of the stream, with the
JAX loader's sampler and augmentation seeds, so that both packages see the
same images with the same flips, scales and crops; and a sequential test
pass.

``build_grain_train_loader`` (the JAX function's name and arguments, the
counterpart of the reference's d2 worker processes) yields the same
batches, bitwise, with ``worker_count`` processes reading the next records
ahead of the step: the mapper's ``read`` (file bytes, PNG decoding,
``rgb2id``) in the workers, its ``augment`` (the draws, in order, and the
device work) on the consuming thread. The workers are forked from a
``forkserver`` process: started fresh, as ``spawn`` starts a worker, it
never touches CUDA and runs no threads, and it imports the mapper's module
once, where each spawned worker would import torch anew. The loader
reproduces neither grain's shuffle nor its per-record seeds (ROADMAP C37):
its stream is the one the JAX function yields where grain is absent, as on
the card's machine.

A dataset is a list of records or the name of one registered in
``data.catalog.DatasetCatalog``.
"""

from __future__ import annotations

import collections
import itertools
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from .catalog import DatasetCatalog
from .dataset_mapper import collate

__all__ = ["TrainingSampler", "build_grain_train_loader", "build_test_loader",
           "build_train_loader"]

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


def _host_stream(dataset: Dataset, total_batch_size: int, num_hosts: int, host_id: int,
                 seed: int):
    """The records, the per-host batch, this host's index stream and its
    augmentation draws."""
    if total_batch_size % num_hosts:
        raise ValueError(f"a total batch of {total_batch_size} does not split over "
                         f"{num_hosts} hosts")
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"host {host_id} of {num_hosts}")
    records = _records(dataset)
    sampler = itertools.islice(iter(TrainingSampler(len(records), seed=seed)),
                               host_id, None, num_hosts)
    return (records, total_batch_size // num_hosts, sampler,
            np.random.RandomState(seed * 1000 + host_id))


def build_train_loader(dataset: Dataset, mapper: Callable, total_batch_size: int,
                       *, num_hosts: int = 1, host_id: int = 0,
                       seed: int = 42) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield collated batches of ``total_batch_size / num_hosts``, forever,
    on the mapper's device (CUDA unless the mapper was built with
    ``device="cpu"``). Host ``host_id`` takes every ``num_hosts``-th index of
    the shared stream from the ``host_id``-th on, and augments with its own
    ``RandomState(seed * 1000 + host_id)``."""
    records, per_host, sampler, rng = _host_stream(dataset, total_batch_size, num_hosts,
                                                   host_id, seed)
    while True:
        yield collate([mapper(records[next(sampler)], rng=rng) for _ in range(per_host)])


def build_grain_train_loader(dataset: Dataset, mapper: Callable, total_batch_size: int,
                             *, num_hosts: int = 1, host_id: int = 0, seed: int = 42,
                             worker_count: int = 4) -> Iterator[Dict[str, torch.Tensor]]:
    """``build_train_loader``'s batches, bitwise, with ``worker_count``
    worker processes running ``mapper.read`` on the records ahead of the
    consumer; ``worker_count <= 0`` is ``build_train_loader`` itself.

    At most ``read_ahead(per_host, worker_count)`` records are read or being
    read beyond the batches yielded: two batches, or one record a worker
    where there are more workers, so that while a step runs the next two
    batches are read. A worker's error is raised at the batch of its record,
    after every earlier batch. Closing the generator cancels the reads not
    started and waits for the rest, and the workers exit."""
    if worker_count <= 0:
        yield from build_train_loader(dataset, mapper, total_batch_size, num_hosts=num_hosts,
                                      host_id=host_id, seed=seed)
        return
    if not (callable(getattr(mapper, "read", None))
            and callable(getattr(mapper, "augment", None))):
        raise TypeError(f"worker processes need a mapper with read and augment stages, not "
                        f"{type(mapper).__name__}")
    records, per_host, sampler, rng = _host_stream(dataset, total_batch_size, num_hosts,
                                                   host_id, seed)
    bound = read_ahead(per_host, worker_count)
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload([type(mapper).__module__])
    pool = ProcessPoolExecutor(max_workers=worker_count, mp_context=ctx)
    pending: collections.deque = collections.deque()  # (record, its read) in stream order

    def fill():
        while len(pending) < bound:
            record = records[next(sampler)]
            pending.append((record, pool.submit(mapper.read, record)))

    try:
        fill()
        while True:
            samples = []
            for _ in range(per_host):
                record, read = pending.popleft()
                samples.append(mapper.augment(record, read.result(), rng=rng))
            fill()
            yield collate(samples)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def read_ahead(per_host: int, worker_count: int) -> int:
    """The most records ``build_grain_train_loader`` reads beyond the batches
    it has yielded."""
    return max(2 * per_host, worker_count)


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
