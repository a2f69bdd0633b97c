"""Training and evaluation over several processes (counterpart of
``odise_tpu/parallel``).

The JAX mesh's ``model`` axis, which shards the frozen towers' weights
(``odise_tpu/parallel/mesh.py:45-76``), is not ported: one card holds FULL
training (ROADMAP A4)."""

from .multihost import (
    all_gather_rows,
    all_reduce_mean_,
    all_reduce_sum,
    gather_pickled,
    get_rank,
    get_world_size,
    initialize_multihost,
    is_main_process,
    sync_global_devices,
)

__all__ = ["all_gather_rows", "all_reduce_mean_", "all_reduce_sum", "gather_pickled",
           "get_rank", "get_world_size", "initialize_multihost", "is_main_process",
           "sync_global_devices"]
