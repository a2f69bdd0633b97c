"""Several processes, one per GPU (counterpart of
``odise_tpu/parallel/multihost.py``), on ``torch.distributed``.

The reference scales past one card with detectron2's ``launch``: a process
per GPU, a rendezvous at ``--dist-url``, gradients averaged over NCCL. The
port does the same (``engine/launch.py`` starts the processes). What maps
to what:

* ``jax.distributed.initialize``     -> ``initialize_multihost``: one
  ``init_process_group`` from a URL, a world size and a rank; NCCL for CUDA,
  gloo for the CPU (and for ranks that share one card, which NCCL refuses)
* the mesh's ``data`` axis           -> the default process group
* the gradient psum XLA inserts      -> ``all_reduce_mean_`` over one flat
  buffer of the trainable gradients (``engine/train_loop.py``)
* ``lax.all_gather`` in the grounding loss -> ``all_gather_rows``, with
  gradients (``"diff"``) or without (``"concat"``)
* ``is_main_process``, ``sync_global_devices`` (a barrier) and
  ``gather_pickled`` (``all_gather_object``) as in JAX.

``global_batch_from_local`` has no counterpart: each rank keeps its local
batch and the collectives above make its step the global one, where JAX
stitches the ranks' batches into one global array for one jitted step.

At world size 1, or before ``initialize_multihost``, every helper is the
local path and touches no backend.
"""

from __future__ import annotations

import datetime
import logging
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

__all__ = ["all_gather_rows", "all_reduce_mean_", "all_reduce_sum", "gather_pickled",
           "get_rank", "get_world_size", "initialize_multihost", "is_main_process",
           "sync_global_devices"]


# how long a collective waits for the other ranks: a rank may reach a
# barrier minutes after another (an evaluation shared out unevenly, rank 0
# writing checkpoints)
TIMEOUT = datetime.timedelta(minutes=30)


def initialize_multihost(dist_url: str, world_size: int, rank: int,
                         backend: Optional[str] = None, device=None) -> bool:
    """Join the process group at ``dist_url`` (``tcp://host:port``,
    ``file:///path`` or ``env://``) as ``rank`` of ``world_size``. The
    backend defaults to NCCL where ``device`` is CUDA and to gloo elsewhere.
    A barrier follows, so that a rank that cannot reach the others fails
    here. Returns whether more than one process takes part."""
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    device = torch.device(device) if device is not None else torch.device("cpu")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, not {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=dist_url, world_size=world_size,
                            rank=rank, timeout=TIMEOUT)
    sync_global_devices("initialize_multihost")
    logger.info("process %d of %d, backend %s, device %s", rank, world_size, backend,
                device)
    return world_size > 1


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def _barrier_kwargs() -> dict:
    # NCCL's barrier runs on the rank's own card; name it, or NCCL guesses
    if dist.get_backend() == "nccl":
        return {"device_ids": [torch.cuda.current_device()]}
    return {}


def sync_global_devices(tag: str) -> None:
    """Wait for every rank (a no-op at world size 1); the counterpart of
    ``comm.synchronize()``. ``tag`` names the barrier in the log."""
    if get_world_size() == 1:
        return
    logger.debug("barrier %s", tag)
    dist.barrier(**_barrier_kwargs())


def gather_pickled(obj) -> list:
    """Every rank's ``obj``, in rank order, on every rank (``[obj]`` at world
    size 1): how the evaluators' statistics are merged."""
    if get_world_size() == 1:
        return [obj]
    out: List = [None] * get_world_size()
    dist.all_gather_object(out, obj)
    return out


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, as a new tensor outside autograd."""
    x = x.detach().clone()
    if get_world_size() > 1:
        dist.all_reduce(x)
    return x


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks, through one
    collective on one flat float32 buffer (the tensors all lie on one
    device)."""
    world = get_world_size()
    if world == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat /= world
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def _gather(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    out = x.new_empty((get_world_size() * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x)
    return out


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 with the gradient of the ranks' sum: each
    rank's rows get the sum over the ranks of the gradients that reached
    them (an all-reduce of the incoming gradient, then this rank's slice)."""

    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        return _gather(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        start = get_rank() * ctx.rows
        return grad[start:start + ctx.rows]


def all_gather_rows(x: torch.Tensor, differentiable: bool) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order (``x`` at
    world size 1). ``differentiable`` carries the gradient back to the rank
    that owns each row (the grounding loss's ``"diff"``); otherwise the
    gathered rows are constants (``"concat"``)."""
    if get_world_size() == 1:
        return x
    if differentiable:
        return _GatherRows.apply(x)
    with torch.no_grad():
        return _gather(x.detach())
