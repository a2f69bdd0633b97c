"""Named ranges around an op's entry point, for the traced run only.

``wrap(entry, fwd, bwd, work)`` replaces the attribute ``entry``
("module:attribute") with a function that runs the op inside a
``record_function`` range named ``fwd`` and, where autograd will run its
backward, opens a range named ``bwd`` when the gradient reaches the op's
output and closes it when the op's inputs have theirs. Every device kernel
launched inside a range counts for it, whatever implements the op.
``work(*args)`` is called before the forward range opens, so its own
kernels count for neither.
"""

from __future__ import annotations

import importlib
from typing import Callable

import torch
from torch.profiler import record_function

from .trace import Range


class _Open(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rng, out):
        ctx.rng = rng
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        ctx.rng.enter()
        return None, grad


class _Close(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rng, *xs):
        ctx.rng = rng
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.rng.exit()
        return (None,) + grads


def wrap(entry: str, fwd: str, bwd: str, work: Callable) -> Callable[[], None]:
    """Install the wrapper; returns the function that takes it out."""
    mod_name, attr = entry.split(":")
    mod = importlib.import_module(mod_name)
    orig = getattr(mod, attr)

    def wrapped(value, shapes, loc, attn):
        work(value, shapes, loc, attn)
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in (value, loc, attn))
        if grad:
            rng = Range(bwd)
            value, loc, attn = _Close.apply(rng, value, loc, attn)
        with record_function(fwd):
            out = orig(value, shapes, loc, attn)
        return _Open.apply(rng, out) if grad else out

    setattr(mod, attr, wrapped)
    return lambda: setattr(mod, attr, orig)
