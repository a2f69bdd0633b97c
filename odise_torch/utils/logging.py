"""Logger setup (counterpart of ``odise_tpu/utils/logging.py``): the
package logger writes to stdout and to ``log.txt`` in the output directory."""

from __future__ import annotations

import functools
import logging
import os
import sys


@functools.lru_cache()
def setup_logger(output: str | None = None, *, name: str = "odise_torch",
                 rank: int = 0) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    fmt = logging.Formatter(
        "[%(asctime)s %(name)s %(levelname)s]: %(message)s", datefmt="%m/%d %H:%M:%S"
    )
    if rank == 0:
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(logging.DEBUG)
        ch.setFormatter(fmt)
        logger.addHandler(ch)
    if output is not None:
        filename = output if output.endswith(".txt") or output.endswith(".log") else os.path.join(output, "log.txt")
        if rank > 0:
            filename = filename + f".rank{rank}"
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        fh = logging.FileHandler(filename)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
