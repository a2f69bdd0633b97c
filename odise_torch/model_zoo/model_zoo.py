"""Model zoo: config path -> released checkpoint, and ``get()``
(counterpart of ``odise_tpu/model_zoo/model_zoo.py``).

``get_config_file`` and ``get_config`` resolve the port's packaged configs
(``odise_torch/configs``); ``get_checkpoint_url`` maps a config path to its
released weights; ``get`` builds the model and, with ``trained=True``,
installs the released checkpoint's trainable set (``convert.py``). As in
the JAX package, the frozen SD and CLIP towers keep their seeded start:
``convert.install_sd_weights`` and ``install_clip_weights`` fill them.
"""

from __future__ import annotations

import os

import torch

from ..config import get_config as _load_config, instantiate_odise, resolve
from ..utils.file_io import get_local_path
from .convert import install_odise_trainable, load_torch_state_dict

_ModelZooUrls = {
    "Panoptic/odise_label_coco_50e.py": "odise://Panoptic/odise_label_coco_50e",
    "Panoptic/odise_caption_coco_50e.py": "odise://Panoptic/odise_caption_coco_50e",
}

_CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs")


def get_checkpoint_url(config_path: str) -> str:
    if config_path not in _ModelZooUrls:
        raise RuntimeError(f"{config_path} not available in Model Zoo!")
    return _ModelZooUrls[config_path]


def get_config_file(config_path: str) -> str:
    path = os.path.normpath(os.path.join(_CONFIG_DIR, config_path))
    if not os.path.isfile(path):
        raise RuntimeError(f"{config_path} not available in Model Zoo!")
    return path


def get_config(config_path: str, trained: bool = False):
    cfg = _load_config(config_path)
    if trained:
        cfg.train.init_checkpoint = get_checkpoint_url(config_path)
    return cfg


def get(config_path: str, trained: bool = False, seed: int = 0, device=None):
    """The config's model on ``device`` (default CUDA), initialised from
    ``seed``, with the released checkpoint's trainable parameters installed
    when ``trained``. The checkpoint is found through ``get_local_path``
    (``ODISE_MODEL_ZOO`` first)."""
    cfg = resolve(get_config(config_path, trained))
    torch.manual_seed(seed)
    model = instantiate_odise(cfg.model, device=device)
    if trained:
        state = load_torch_state_dict(get_local_path(cfg.train.init_checkpoint))
        install_odise_trainable(model, state)
    return model
