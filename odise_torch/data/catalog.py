"""Dataset and metadata catalogs (counterpart of
``odise_tpu/data/catalog.py``, detectron2's ``DatasetCatalog`` and
``MetadataCatalog``): a dataset is registered as a name -> zero-argument
callable returning a list of per-image record dicts; metadata is a mutable
namespace per dataset name.
"""

from __future__ import annotations

import types
from typing import Callable, Dict, List


class _DatasetCatalog:
    def __init__(self):
        self._registry: Dict[str, Callable[[], List[dict]]] = {}

    def register(self, name: str, func: Callable[[], List[dict]]) -> None:
        if name in self._registry:
            raise ValueError(f"Dataset '{name}' is already registered!")
        if not callable(func):
            raise TypeError("DatasetCatalog.register expects a callable")
        self._registry[name] = func

    def get(self, name: str) -> List[dict]:
        try:
            f = self._registry[name]
        except KeyError:
            raise KeyError(
                f"Dataset '{name}' is not registered. "
                f"Available: {sorted(self._registry)[:20]}..."
            )
        return f()

    def list(self) -> List[str]:
        return sorted(self._registry)

    def remove(self, name: str) -> None:
        self._registry.pop(name, None)

    def __contains__(self, name: str) -> bool:
        return name in self._registry


class Metadata(types.SimpleNamespace):
    """Per-dataset metadata namespace. Set-once semantics like detectron2."""

    name: str = "N/A"

    def __getattr__(self, key):
        raise AttributeError(
            f"Attribute '{key}' does not exist in the metadata of dataset "
            f"'{self.__dict__.get('name', 'N/A')}'."
        )

    def set(self, **kwargs) -> "Metadata":
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self

    def get(self, key, default=None):
        return self.__dict__.get(key, default)

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class _MetadataCatalog:
    def __init__(self):
        self._registry: Dict[str, Metadata] = {}

    def get(self, name: str) -> Metadata:
        assert len(name)
        if name not in self._registry:
            self._registry[name] = Metadata(name=name)
        return self._registry[name]

    def list(self) -> List[str]:
        return sorted(self._registry)

    def remove(self, name: str) -> None:
        self._registry.pop(name, None)

    def __contains__(self, name: str) -> bool:
        return name in self._registry


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()
