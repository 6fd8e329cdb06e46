"""Constructor registry — port of
``learningorchestra_tpu/toolkit/registry.py``.

Maps ``(module_path, class_name)`` to the port's classes, so a request
or an artifact names its class and a loader rebuilds it.  The JAX
package's module paths (its zoo and ``learningorchestra_tpu.toolkit.
estimators.*``) and the reference-era ones (``sklearn.*``,
``tensorflow.keras.*``, ``torch.nn``) alias to the port's modules, so
one request body resolves on both servers.
"""

from __future__ import annotations

import importlib
import inspect
from typing import Any, Callable

from learningorchestra_tpu_torch.concurrency_rt import make_rlock

_lock = make_rlock("registry._lock")
_registry: dict[tuple[str, str], Callable] = {}
_loaded = False

_MLP = "learningorchestra_tpu_torch.models.mlp"
_TEXT = "learningorchestra_tpu_torch.models.text"
_VISION = "learningorchestra_tpu_torch.models.vision"
_MOE = "learningorchestra_tpu_torch.models.moe"
_LONG = "learningorchestra_tpu_torch.models.longcontext"
_ZOO = (_MLP, _TEXT, _VISION, _MOE, _LONG)
_ESTIMATORS = "learningorchestra_tpu_torch.toolkit.estimators."
_CLASSICAL = ("linear", "trees", "bayes", "cluster", "decomposition",
              "preprocessing", "neighbors", "svm")
_MODULES = _ZOO + tuple(_ESTIMATORS + m for m in _CLASSICAL)

#: Request module path -> the port's modules to look the class up in.
MODULE_ALIASES: dict[str, tuple[str, ...]] = {
    "learningorchestra_tpu.models.mlp": (_MLP,),
    "learningorchestra_tpu.models.text": (_TEXT,),
    "learningorchestra_tpu.models.vision": (_VISION,),
    "learningorchestra_tpu.models.moe": (_MOE,),
    "learningorchestra_tpu.models.longcontext": (_LONG,),
    "learningorchestra_tpu.models": _ZOO,
    "tensorflow.keras.applications": (_VISION,),
    "tensorflow.keras.models": _ZOO,
    "torch.nn": _ZOO,
    "sklearn.linear_model": (_ESTIMATORS + "linear",),
    "sklearn.ensemble": (_ESTIMATORS + "trees",),
    "sklearn.tree": (_ESTIMATORS + "trees",),
    "sklearn.naive_bayes": (_ESTIMATORS + "bayes",),
    "sklearn.cluster": (_ESTIMATORS + "cluster",),
    "sklearn.decomposition": (_ESTIMATORS + "decomposition",),
    "sklearn.manifold": (_ESTIMATORS + "decomposition",),
    "sklearn.preprocessing": (_ESTIMATORS + "preprocessing",),
    "sklearn.neighbors": (_ESTIMATORS + "neighbors",),
    "sklearn.svm": (_ESTIMATORS + "svm",),
    **{f"learningorchestra_tpu.toolkit.estimators.{m}": (_ESTIMATORS + m,)
       for m in _CLASSICAL},
}


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
    """The factory for a request's ``(modulePath, class)``."""
    _ensure_loaded()
    with _lock:
        for native in MODULE_ALIASES.get(module_path, (module_path,)):
            factory = _registry.get((native, class_name))
            if factory is not None:
                return factory
    raise RegistryError(
        f"unknown model/estimator: modulePath={module_path!r} "
        f"class={class_name!r}"
    )


def _unaccepted(fn: Callable, params: dict, *, drop=()) -> list[str]:
    sig = inspect.signature(fn)
    if any(p.kind == inspect.Parameter.VAR_KEYWORD
           for p in sig.parameters.values()):
        return []
    accepted = set(sig.parameters) - {"self", *drop}
    return [k for k in params if k not in accepted]


def validate_init_params(
    module_path: str, class_name: str, params: dict
) -> list[str]:
    """Names in ``params`` the constructor does not accept.  ``device``
    is the service context's to set, never a request's."""
    return _unaccepted(resolve(module_path, class_name).__init__, params,
                       drop=("device",))


def validate_method(class_or_factory: Any, method: str) -> bool:
    """Whether the class has a callable ``method``."""
    return callable(getattr(class_or_factory, method, None))


def validate_method_params(
    class_or_factory: Any, method: str, params: dict
) -> list[str]:
    fn = getattr(class_or_factory, method, None)
    if fn is None:
        return list(params)
    return _unaccepted(fn, params)


def list_registered() -> list[dict]:
    """Every registered (modulePath, class), the port's module paths."""
    _ensure_loaded()
    with _lock:
        return [{"modulePath": mod, "class": name}
                for (mod, name) in sorted(_registry)]


def constructors() -> dict[str, Callable]:
    """class_name -> factory (for the ``#`` spec namespace)."""
    _ensure_loaded()
    with _lock:
        return {name: fac for (_, name), fac in _registry.items()}
