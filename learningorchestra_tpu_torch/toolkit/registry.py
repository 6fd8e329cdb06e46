"""Constructor registry — port of
``learningorchestra_tpu/toolkit/registry.py``.

Maps ``(module_path, class_name)`` to the port's estimator classes, so an
artifact names its class and a loader rebuilds it.  Only the port's own
module paths are registered (the reference-era aliases come with the REST
pipeline slice).
"""

from __future__ import annotations

import importlib
import threading
from typing import Callable

_lock = threading.RLock()
_registry: dict[tuple[str, str], Callable] = {}
_loaded = False

_MODULES = (
    "learningorchestra_tpu_torch.models.mlp",
    "learningorchestra_tpu_torch.models.text",
)


class RegistryError(KeyError):
    pass


def register(
    module_path: str, class_name: str | None = None
) -> Callable[[Callable], Callable]:
    """Class decorator: ``@register("learningorchestra_tpu_torch...")``."""

    def deco(cls: Callable) -> Callable:
        name = class_name or cls.__name__
        with _lock:
            _registry[(module_path, name)] = cls
        return cls

    return deco


def _ensure_loaded() -> None:
    """Import all implementation modules once so decorators run."""
    global _loaded
    # Reentrant: the imports run the decorators, which take the lock too;
    # holding it across them keeps a concurrent resolve from missing one.
    with _lock:
        if not _loaded:
            for mod in _MODULES:
                importlib.import_module(mod)
            _loaded = True


def resolve(module_path: str, class_name: str) -> Callable:
    _ensure_loaded()
    with _lock:
        factory = _registry.get((module_path, class_name))
    if factory is None:
        raise RegistryError(
            f"unknown model/estimator: modulePath={module_path!r} "
            f"class={class_name!r}"
        )
    return factory
