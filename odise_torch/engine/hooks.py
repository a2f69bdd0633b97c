"""Training hooks (counterpart of ``odise_tpu/engine/hooks.py``).

A hook is ``callable(iteration, metrics) -> None``, the signature the port's
``Trainer`` calls (the JAX hooks also take the train state; here the model
and the optimizer hold it, so a hook that saves them holds them itself). A
hook that reads the model as an iteration left it has ``due(iteration)``,
which makes the ``Trainer`` flush its pending metrics right after that
iteration instead of at the end of its log window.
"""

from __future__ import annotations

from typing import Callable


class EvalHook:
    """Run ``eval_fn(final_iter, next_iter)`` every ``period`` iterations and
    at the end of training; skips the in-loop eval that would duplicate the
    final one."""

    def __init__(self, period: int, eval_fn: Callable, max_iter: int,
                 eval_after_train: bool = True):
        self.period = period
        self.eval_fn = eval_fn
        self.max_iter = max_iter
        self.eval_after_train = eval_after_train

    def due(self, iteration: int) -> bool:
        next_iter = iteration + 1
        return ((self.period > 0 and next_iter % self.period == 0)
                or (self.eval_after_train and next_iter == self.max_iter))

    def __call__(self, iteration: int, metrics) -> None:
        next_iter = iteration + 1
        if self.period > 0 and next_iter % self.period == 0:
            if next_iter != self.max_iter:
                self.eval_fn(final_iter=False, next_iter=next_iter)
        if self.eval_after_train and next_iter == self.max_iter:
            self.eval_fn(final_iter=True, next_iter=next_iter)


class PeriodicCheckpointer:
    """Save ``params`` (name -> tensor) and ``optimizer`` every ``period``
    iterations as ``model_{iteration:07d}``, and as ``model_final`` after
    the last, with the iteration to resume at."""

    def __init__(self, checkpointer, params, optimizer, period: int, max_iter: int):
        self.checkpointer = checkpointer
        self.params = params
        self.optimizer = optimizer
        self.period = period
        self.max_iter = max_iter

    def due(self, iteration: int) -> bool:
        next_iter = iteration + 1
        return next_iter % self.period == 0 or next_iter == self.max_iter

    def __call__(self, iteration: int, metrics) -> None:
        next_iter = iteration + 1
        if self.due(iteration):
            name = ("model_final" if next_iter == self.max_iter
                    else f"model_{iteration:07d}")
            self.checkpointer.save(name, self.params, self.optimizer, next_iter)


class PeriodicWriter:
    """Put each iteration's metrics into ``storage`` and write every
    ``period`` iterations."""

    def __init__(self, writers, storage, period: int = 20):
        self.writers = writers
        self.storage = storage
        self.period = period

    def due(self, iteration: int) -> bool:
        return (iteration + 1) % self.period == 0

    def __call__(self, iteration: int, metrics) -> None:
        self.storage.put_scalars(**metrics)
        if self.due(iteration):
            for w in self.writers:
                w.write(self.storage)
        self.storage.step()
