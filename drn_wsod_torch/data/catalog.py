"""Global dataset and metadata catalogs (counterpart of
``drn_wsod_tpu/data/catalog.py``)."""

from __future__ import annotations

import types
from typing import Callable, Dict, List


class _DatasetCatalog:
    """Dataset name -> a function returning its records."""

    def __init__(self):
        self._registry: Dict[str, Callable[[], List[dict]]] = {}

    def register(self, name: str, func: Callable[[], List[dict]]):
        if not callable(func):
            raise TypeError(f"dataset {name!r}: {func!r} is not callable")
        if name in self._registry:
            raise KeyError(f"Dataset '{name}' already registered")
        self._registry[name] = func

    def get(self, name: str) -> List[dict]:
        try:
            f = self._registry[name]
        except KeyError:
            raise KeyError(
                f"Dataset '{name}' not registered. Available: "
                f"{sorted(self._registry)}") from None
        return f()

    def list(self) -> List[str]:
        return sorted(self._registry)

    def remove(self, name: str):
        self._registry.pop(name)

    def clear(self):
        self._registry.clear()

    def __contains__(self, name):
        return name in self._registry


class Metadata(types.SimpleNamespace):
    """A dataset's metadata (class names, evaluator type, ...)."""

    def set(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self

    def get(self, key, default=None):
        return getattr(self, key, default)


class _MetadataCatalog:
    """Dataset name -> its :class:`Metadata`, made on first access."""

    def __init__(self):
        self._map: Dict[str, Metadata] = {}

    def get(self, name: str) -> Metadata:
        if name not in self._map:
            self._map[name] = Metadata(name=name)
        return self._map[name]

    def list(self):
        return sorted(self._map)

    def clear(self):
        self._map.clear()


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()
