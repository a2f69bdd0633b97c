"""Compute a function of each item ahead of its consumer, in a worker thread
(counterpart of ``odise_tpu/utils/prefetch.py``).

The eval loop alternates host work (decode, resize, ground-truth rasters)
with device work (inference and statistics). ``prefetch_iter`` runs
``fn(item)`` up to ``depth`` items ahead in one worker thread, so that the
next records are prepared while the card runs the current one: the
counterpart of the reference's ``num_workers`` test loader. Results come in
order; an exception raised by ``fn`` is raised at its own item, after every
earlier item has been yielded; ``depth <= 0`` runs ``fn`` inline.

When the consumer stops early (it closes the generator, or an exception
leaves its loop), the items not yet started are cancelled and the one
running is waited for, so that no thread outlives the loop.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

__all__ = ["prefetch_iter"]

T = TypeVar("T")
U = TypeVar("U")


def prefetch_iter(items: Iterable[T], fn: Callable[[T], U], depth: int = 2) -> Iterator[U]:
    """Yield ``fn(item)`` for each item in order, computed up to ``depth``
    items ahead in a worker thread."""
    if depth <= 0:
        for item in items:
            yield fn(item)
        return
    ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix="prefetch")
    try:
        pending: collections.deque = collections.deque()
        it = iter(items)
        exhausted = False
        while True:
            while not exhausted and len(pending) < depth:
                try:
                    pending.append(ex.submit(fn, next(it)))
                except StopIteration:
                    exhausted = True
            if not pending:
                return
            yield pending.popleft().result()
    finally:
        ex.shutdown(wait=True, cancel_futures=True)
