"""Default setup of a run (counterpart of ``odise_tpu/engine/defaults.py``,
without its persistent XLA compile cache): the output directory, the
logger, an environment line, the ``config.yaml`` backup and the seeds. In a
process group rank 0 logs to stdout and ``log.txt`` and writes the config;
rank r > 0 logs to ``log.txt.rank<r>`` only."""

from __future__ import annotations

import logging
import os
import platform
import sys

import numpy as np
import torch

from ..config import save_config
from ..parallel.multihost import get_rank, get_world_size
from ..utils.logging import setup_logger

logger = logging.getLogger(__name__)


def collect_env_info() -> str:
    cuda = (f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}"
            if torch.cuda.is_available() else "no CUDA device")
    return (f"Python {sys.version.split()[0]}, numpy {np.__version__}, torch "
            f"{torch.__version__}, {cuda}, {platform.platform()}")


def default_setup(cfg, args=None) -> None:
    output_dir = cfg.train.output_dir
    rank = get_rank()
    os.makedirs(output_dir, exist_ok=True)
    setup_logger(output_dir, rank=rank)
    logger.info("Rank %d of %d. Environment info: %s", rank, get_world_size(),
                collect_env_info())
    if args is not None:
        logger.info("Command line arguments: %s", args)
    if rank == 0:
        save_config(cfg, os.path.join(output_dir, "config.yaml"))
        logger.info("Full config saved to %s", os.path.join(output_dir, "config.yaml"))
    seed = cfg.train.get("seed", 42)
    np.random.seed(seed)
    torch.manual_seed(seed)
