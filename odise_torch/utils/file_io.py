"""URI path handlers for model-zoo artifacts (counterpart of
``odise_tpu/utils/file_io.py``).

``odise://`` resolves to the released ODISE checkpoints, ``sd://`` to the
Stable Diffusion checkpoints, and ``ODISE_MODEL_ZOO`` names a local mirror
that is looked at first: ``<mirror>/Panoptic/odise_label_coco_50e.pth`` for
``odise://Panoptic/odise_label_coco_50e``, ``<mirror>/sd-v1-3.ckpt`` for
``sd://v1-3``. Without network only the mirror works; a remote fetch raises
with a message that says so. ``s3://bucket/key`` is fetched with boto3,
where it is installed, into ``~/.cache/odise_torch/s3/bucket/key``.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, Optional

logger = logging.getLogger(__name__)

ODISE_RELEASE_URL = "https://github.com/NVlabs/ODISE/releases/download/v1.0.0/"
SD_URLS = {
    "v1-3": ("https://huggingface.co/CompVis/stable-diffusion-v-1-3-original/"
             "resolve/main/sd-v1-3.ckpt"),
    "v1-4": ("https://huggingface.co/CompVis/stable-diffusion-v-1-4-original/"
             "resolve/main/sd-v1-4.ckpt"),
    "v1-5": ("https://huggingface.co/runwayml/stable-diffusion-v1-5/"
             "resolve/main/v1-5-pruned-emaonly.ckpt"),
}

_HANDLERS: Dict[str, Callable[[str], str]] = {}


def register_handler(prefix: str, fn: Callable[[str], str]) -> None:
    _HANDLERS[prefix] = fn


def _local_zoo() -> Optional[str]:
    return os.environ.get("ODISE_MODEL_ZOO")


def _resolve_odise(path: str) -> str:
    name = path[len("odise://"):]
    zoo = _local_zoo()
    if zoo:
        local = os.path.join(zoo, name + ".pth")
        if os.path.isfile(local):
            return local
    url = ODISE_RELEASE_URL + name.split("/")[-1] + ".pth"
    return _download(url, name.replace("/", "_") + ".pth")


def _resolve_sd(path: str) -> str:
    version = path[len("sd://"):]
    zoo = _local_zoo()
    if zoo:
        local = os.path.join(zoo, f"sd-{version}.ckpt")
        if os.path.isfile(local):
            return local
    if version not in SD_URLS:
        raise FileNotFoundError(f"Unknown SD version {version!r}; known: {list(SD_URLS)}")
    return _download(SD_URLS[version], f"sd-{version}.ckpt")


def _download(url: str, filename: str) -> str:
    cache = os.path.expanduser("~/.cache/odise_torch")
    os.makedirs(cache, exist_ok=True)
    local = os.path.join(cache, filename)
    if os.path.isfile(local):
        return local
    import urllib.request

    logger.info("Downloading %s -> %s", url, local)
    try:
        urllib.request.urlretrieve(url, local + ".tmp")
    except Exception as e:
        raise FileNotFoundError(
            f"Cannot fetch {url} ({e}). Without network set ODISE_MODEL_ZOO "
            f"to a local mirror directory.") from e
    os.replace(local + ".tmp", local)
    return local


def _resolve_s3(path: str) -> str:
    """The ``s3://`` handler (the reference registers one at
    ``tools/train_net.py:53``): boto3 where it is installed, else an error
    that says what to do; the file is kept in the local cache."""
    try:
        import boto3  # type: ignore
    except ImportError as e:
        raise FileNotFoundError(
            f"Cannot fetch {path}: boto3 is not installed. Mirror the file "
            f"locally and point at the local path instead.") from e
    bucket, _, key = path[len("s3://"):].partition("/")
    local = os.path.join(os.path.expanduser("~/.cache/odise_torch/s3"), bucket, key)
    if not os.path.isfile(local):
        os.makedirs(os.path.dirname(local), exist_ok=True)
        logger.info("Downloading %s -> %s", path, local)
        boto3.client("s3").download_file(bucket, key, local + ".tmp")
        os.replace(local + ".tmp", local)
    return local


register_handler("odise://", _resolve_odise)
register_handler("sd://", _resolve_sd)
register_handler("s3://", _resolve_s3)


def get_local_path(path: str) -> str:
    """Resolve a (possibly uri-schemed) path to a local file path."""
    for prefix, fn in _HANDLERS.items():
        if path.startswith(prefix):
            return fn(path)
    return path
