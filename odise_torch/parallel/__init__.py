"""Training and evaluation over several processes (counterpart of
``odise_tpu/parallel``): the ranks' collectives (``multihost``) and the
(data, model) mesh, whose ``model`` axis shards the frozen towers' weights
over ranks (``mesh``)."""

from .mesh import (
    DATA_AXIS,
    FROZEN_TOWER_KEYWORDS,
    MODEL_AXIS,
    Mesh,
    batch_sharding,
    create_mesh,
    is_frozen_path,
    param_sharding_rule,
    replicated,
    shard_params,
    sharding_plan,
)
from .multihost import (
    all_gather_rows,
    all_reduce_mean_,
    all_reduce_sum,
    gather_pickled,
    get_data_rank,
    get_data_world_size,
    get_rank,
    get_world_size,
    initialize_multihost,
    is_main_process,
    sync_global_devices,
)

__all__ = ["DATA_AXIS", "FROZEN_TOWER_KEYWORDS", "MODEL_AXIS", "Mesh", "all_gather_rows",
           "all_reduce_mean_", "all_reduce_sum", "batch_sharding", "create_mesh",
           "gather_pickled", "get_data_rank", "get_data_world_size", "get_rank",
           "get_world_size", "initialize_multihost", "is_frozen_path", "is_main_process",
           "param_sharding_rule", "replicated", "shard_params", "sharding_plan",
           "sync_global_devices"]
