"""Named ranges on the profiler's clock, by layer (the port's own; the JAX
package has none).

``span(name)`` opens a ``record_function`` range named ``name`` around a
layer's forward work; ``bracket(name, inputs)`` brackets the same layer's
backward with a range ``<name>.bwd``. Both act only while a profiler
records (``torch.profiler.profile``, ``tools/train_net.py --profile``):
the profiler is the switch and the only writer. Host ranges and the
device's kernels share the profiler's clock, so every kernel launched
inside a range, and every idle gap of the device while it is open, can be
put down to its layer.

With no profiler recording, each site reads one module attribute
(``torch.autograd.profiler._is_profiler_enabled``, read at each call,
never bound at import): ``span`` returns one shared null context, and
``bracket`` returns the inputs as they are and a function that returns the
outputs as they are. No ``record_function`` is called, no autograd node
is made and no memory is kept.

A backward bracket opens when the first gradient reaches any of the
layer's outputs and closes when the last of its inputs that needs a
gradient has its gradient, or, where no input needs one (the backbone's
image), when the engine's backward pass ends. It is two autograd
functions that return views of what they are given, so values stay
bitwise the same and no kernel is launched. The node that closes the
range has to sit between the inputs and the layer's first use of them,
so a layer brackets its inputs before it runs and its outputs after::

    with span("odise.sem_seg_head"):
        features, bwd = bracket("odise.sem_seg_head", features)
        ...
        return bwd(outputs)

Under activation checkpointing a bracket goes outside the ``checkpoint``
call, never inside it; a span inside replays in the recompute.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Tuple

import torch
import torch.utils._pytree as pytree
from torch.autograd import profiler as _profiler
from torch.autograd.profiler import record_function
from torch.autograd.variable import Variable

__all__ = ["bracket", "span"]

_NULL = contextlib.nullcontext()


def _same(outputs):
    return outputs


def span(name: str, args: Any = None):
    """A ``record_function`` range ``name`` (with ``str(args)``, where
    given) while a profiler records; else one shared null context."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return record_function(name, None if args is None else str(args))


class Range:
    """A named host range that opens and closes in different places, at
    most once each."""

    def __init__(self, name: str, end_with_backward: bool):
        self.name = name
        self.end_with_backward = end_with_backward
        self.handle = None
        self.state = 0  # 0 not opened, 1 open, 2 closed

    def open(self) -> None:
        if self.state:
            return
        self.state = 1
        self.handle = torch.ops.profiler._record_function_enter_new(self.name, None)
        if self.end_with_backward:
            Variable._execution_engine.queue_callback(self.close)

    def close(self) -> None:
        if self.state == 1:
            torch.ops.profiler._record_function_exit._RecordFunction(self.handle)
            self.handle = None
        self.state = 2


class _Open(torch.autograd.Function):
    """A view of one output; its backward opens the range."""

    @staticmethod
    def forward(ctx, rng, out):
        ctx.rng = rng
        ctx.set_materialize_grads(False)  # no gradient stays none, not zeros
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        ctx.rng.open()
        return None, grad


class _Close(torch.autograd.Function):
    """Views of the inputs that need a gradient; its backward, which runs
    once all of theirs are in, closes the range."""

    @staticmethod
    def forward(ctx, rng, *xs):
        ctx.rng = rng
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.rng.close()
        return (None,) + grads


def _needs_grad(x) -> bool:
    return isinstance(x, torch.Tensor) and x.requires_grad


def bracket(name: str, inputs: Any) -> Tuple[Any, Callable[[Any], Any]]:
    """Bracket a layer's backward with a range ``<name>.bwd``. Call it on
    the layer's inputs (a tensor or a nested dict, list or tuple of them)
    before the layer uses them; returns (the inputs to use, ``bwd``), and
    the layer returns ``bwd(outputs)``. Without a profiler, or without
    gradients, both are the arguments as given."""
    if not _profiler._is_profiler_enabled or not torch.is_grad_enabled():
        return inputs, _same
    leaves, spec = pytree.tree_flatten(inputs)
    # one view of each tensor, however often it appears, so that its uses'
    # gradients add up in the order they would without the bracket (and in
    # bwd too); a gradient that never comes stays none, not zeros, so the
    # bracket adds no kernel
    distinct = {id(x): x for x in leaves if _needs_grad(x)}
    rng = Range(name + ".bwd", end_with_backward=not distinct)
    if distinct:
        views = dict(zip(distinct, _Close.apply(rng, *distinct.values())))
        inputs = pytree.tree_unflatten([views.get(id(x), x) for x in leaves], spec)

    def bwd(outputs):
        outs, out_spec = pytree.tree_flatten(outputs)
        views = {id(x): _Open.apply(rng, x) for x in outs if _needs_grad(x)}
        return pytree.tree_unflatten([views.get(id(x), x) for x in outs], out_spec)

    return inputs, bwd
