"""Lazy configs, scaling and model instantiation (counterpart of
``odise_tpu/config``)."""

from .lazy import (
    L,
    LazyObject,
    ConfigDict,
    load_config,
    save_config,
    apply_overrides,
    resolve,
    instantiate,
    locate,
    get_config,
)
from .utils import auto_scale_workers
from .build import instantiate_odise

__all__ = [
    "L",
    "LazyObject",
    "ConfigDict",
    "load_config",
    "save_config",
    "apply_overrides",
    "resolve",
    "instantiate",
    "instantiate_odise",
    "locate",
    "get_config",
    "auto_scale_workers",
]
