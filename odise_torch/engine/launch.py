"""Start one process per GPU (counterpart of detectron2's ``launch``, which
the reference's ``tools/train_net.py`` calls, and of the multi-host start
of the JAX package's ``tools/train_net.py``).

    launch(main_func, num_gpus_per_machine, num_machines=1, machine_rank=0,
           dist_url="auto", args=())

At a world size of 1 ``main_func(*args)`` runs in this process, with no
process group, and its result is returned. Otherwise the processes are
started with the ``spawn`` method (CUDA may be live in this one); process
``local_rank`` of this machine is rank ``machine_rank *
num_gpus_per_machine + local_rank``, meets the others at ``dist_url`` and
runs ``main_func(*args)`` on its device:

* ``device=None`` or ``"cuda"``: ``cuda:local_rank``, over NCCL. A machine
  with fewer cards than ``num_gpus_per_machine`` raises.
* ``device="cuda:k"``: every rank on card k. NCCL refuses two ranks on one
  card, so this needs ``backend="gloo"`` passed with it, and raises
  otherwise: two ranks never share a card unless the caller asks.
* ``device="cpu"``: the CPU, over gloo.

Each rank takes its share of the machine's cores as intra-op threads unless
``OMP_NUM_THREADS`` is set. A rank that raises makes ``launch`` raise. With
``timeout`` (seconds), ranks still running after it are terminated and
``launch`` raises ``TimeoutError``: a rank that never reaches the others, or
a collective that never completes, fails instead of waiting.
"""

from __future__ import annotations

import logging
import os
import socket
import time
from typing import Callable, Optional, Tuple

import torch

from ..parallel.multihost import initialize_multihost, set_data_axis

__all__ = ["launch", "rank_device"]

logger = logging.getLogger(__name__)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_device(device, local_rank: int, nprocs: int, backend: Optional[str]
                ) -> Tuple[torch.device, str]:
    """The device and backend of process ``local_rank`` of ``nprocs`` on a
    machine, by the rules of ``launch``; raises where they are not met."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU: only gloo runs there")
        return device, "gloo"
    if device.type != "cuda":
        raise ValueError(f"cannot launch on {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    if device.index is None:
        if nprocs > torch.cuda.device_count():
            raise RuntimeError(f"{nprocs} processes on this machine need {nprocs} cards; "
                               f"it has {torch.cuda.device_count()}")
        return torch.device("cuda", local_rank), backend or "nccl"
    if device.index >= torch.cuda.device_count():
        raise RuntimeError(f"there is no {device}: this machine has "
                           f"{torch.cuda.device_count()} cards")
    if nprocs > 1 and backend != "gloo":
        raise ValueError(f"{nprocs} ranks on one card ({device}): NCCL refuses that; pass "
                         "backend='gloo' to share a card")
    return device, backend or "nccl"


def launch(main_func: Callable, num_gpus_per_machine: int, num_machines: int = 1,
           machine_rank: int = 0, dist_url: Optional[str] = "auto", args: tuple = (),
           backend: Optional[str] = None, device=None, timeout: Optional[float] = None):
    """Run ``main_func(*args)`` in every rank (see the module's docstring).
    ``dist_url="auto"`` picks a free port on this machine (one machine only).
    Returns ``main_func``'s result at a world size of 1, else None."""
    world_size = num_machines * num_gpus_per_machine
    if world_size < 1 or not 0 <= machine_rank < num_machines:
        raise ValueError(f"{num_machines} machines of {num_gpus_per_machine} processes, "
                         f"machine rank {machine_rank}")
    # the first process's device and backend: raises here, before any start
    rank_device(device, 0, num_gpus_per_machine, backend)
    if world_size == 1:
        return main_func(*args)
    if dist_url in (None, "auto"):
        if num_machines > 1:
            raise ValueError("dist_url='auto' works on one machine only")
        dist_url = f"tcp://localhost:{_free_port()}"
    context = torch.multiprocessing.start_processes(
        _distributed_worker, nprocs=num_gpus_per_machine,
        args=(main_func, world_size, num_gpus_per_machine, machine_rank, dist_url, args,
              backend, device),
        join=False, start_method="spawn", daemon=False)
    deadline = None if timeout is None else time.monotonic() + timeout
    while not context.join(None if deadline is None else max(0.0, deadline - time.monotonic())):
        if deadline is not None and time.monotonic() >= deadline:
            for p in context.processes:
                if p.is_alive():
                    p.kill()
                p.join()
            raise TimeoutError(f"{num_gpus_per_machine} ranks still running after "
                               f"{timeout:g} s; terminated")
    return None


def _distributed_worker(local_rank, main_func, world_size, num_gpus_per_machine,
                        machine_rank, dist_url, args, backend, device):
    dev, backend = rank_device(device, local_rank, num_gpus_per_machine, backend)
    if "OMP_NUM_THREADS" not in os.environ:
        # the machine's cores shared out: N ranks of a thread per core each
        # oversubscribe it N times over
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // num_gpus_per_machine))
    rank = machine_rank * num_gpus_per_machine + local_rank
    initialize_multihost(dist_url, world_size, rank, backend=backend, device=dev)
    try:
        main_func(*args)
    finally:
        set_data_axis(None)  # a mesh's groups go with the process group
        torch.distributed.destroy_process_group()
