"""Default setup of a run (counterpart of ``odise_tpu/engine/defaults.py``,
without its persistent XLA compile cache): the output directory, the
logger, an environment line, the ``config.yaml`` backup and the seeds."""

from __future__ import annotations

import logging
import os
import platform
import sys

import numpy as np
import torch

from ..config import save_config
from ..utils.logging import setup_logger

logger = logging.getLogger(__name__)


def collect_env_info() -> str:
    cuda = (f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}"
            if torch.cuda.is_available() else "no CUDA device")
    return (f"Python {sys.version.split()[0]}, numpy {np.__version__}, torch "
            f"{torch.__version__}, {cuda}, {platform.platform()}")


def default_setup(cfg, args=None) -> None:
    output_dir = cfg.train.output_dir
    os.makedirs(output_dir, exist_ok=True)
    setup_logger(output_dir)
    logger.info("Environment info: %s", collect_env_info())
    if args is not None:
        logger.info("Command line arguments: %s", args)
    save_config(cfg, os.path.join(output_dir, "config.yaml"))
    logger.info("Full config saved to %s", os.path.join(output_dir, "config.yaml"))
    seed = cfg.train.get("seed", 42)
    np.random.seed(seed)
    torch.manual_seed(seed)
