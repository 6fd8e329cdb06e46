"""The request-parameter DSL — port of ``learningorchestra_tpu/dsl.py``.

Request JSON values are rewritten before a toolkit method is called:

- ``"$name"``     -> load artifact ``name`` (a dataset collection as a
  :class:`~learningorchestra_tpu_torch.services.frame.Frame`, anything
  else as its volume binary);
- ``"$name.key"`` -> the whole body as a name first (names may hold
  dots), else load ``name`` and index ``instance[key]``;
- ``"#<expr>"``   -> a Python *expression* evaluated with no builtins
  against a whitelisted namespace: ``torch`` (tensor constructors, dtypes
  and elementwise math, not the module), ``np``/``numpy``, ``zoo`` (the
  port's model classes by module) and the registry's constructors by
  class name.

The ``#`` gate is the JAX package's: an AST whitelist (calls, attributes,
names, literals, simple arithmetic), no double underscores, and
file/OS-touching attribute names denied at every level of a chain.  The
port denies more: any name starting with ``_``, any name holding
``load``, ``dump`` or ``save``, and torch's code-loading and process-wide
surfaces.  ``jax``, ``jnp``, ``optax`` and ``nn`` are not in the
namespace, so a spec naming them fails the gate as an unknown name.
"""

from __future__ import annotations

import ast
import re
from types import SimpleNamespace
from typing import Any, Protocol

_DOLLAR_RE = re.compile(r"^\$(?P<name>[A-Za-z0-9_.\-]+)$")

_ALLOWED_NODES = (
    ast.Expression, ast.Call, ast.Attribute, ast.Name, ast.Load,
    ast.Constant, ast.List, ast.Tuple, ast.Dict, ast.keyword,
    ast.UnaryOp, ast.UAdd, ast.USub,
    ast.BinOp, ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Pow,
    ast.FloorDiv, ast.Mod,
    ast.Subscript, ast.Slice,
)

# The JAX package's denied names, plus torch's file, code-loading and
# process-wide surface, for chains that start from a tensor a spec made.
_DENIED_ATTRS = frozenset({
    "load", "loads", "save", "savez", "savez_compressed", "dump",
    "loadtxt", "savetxt", "genfromtxt", "fromfile", "tofile", "memmap",
    "open", "open_memmap", "ctypeslib", "f2py", "distutils", "testing",
    "os", "sys", "subprocess", "importlib", "builtins", "eval", "exec",
    "compile", "getattr", "setattr", "delattr",
    "from_file", "hub", "utils", "library", "ops", "classes", "package",
    "cuda", "jit", "set_default_device", "set_default_dtype",
})
# Denied wherever they occur in a name (``load_library``,
# ``_dump_snapshot``, ``save_for_backward``, ...).
_DENIED_PARTS = ("load", "dump", "save")

# What ``torch`` means in a spec: the scope ``jnp`` has in the JAX
# package.  The module itself would reach ``torch.ops.load_library``,
# ``torch._C`` and the process-wide setters.
_TORCH_NAMES = (
    "tensor", "as_tensor", "zeros", "ones", "full", "arange", "linspace",
    "eye", "zeros_like", "ones_like", "full_like", "stack", "cat",
    "float16", "bfloat16", "float32", "float64", "int8", "int16", "int32",
    "int64", "uint8", "bool", "half", "float", "double", "int", "long",
    "abs", "exp", "log", "sqrt", "tanh", "sigmoid", "clamp", "maximum",
    "minimum", "where", "sum", "mean", "matmul",
)


class DSLResolutionError(Exception):
    pass


class ArtifactLoader(Protocol):
    """How ``$name`` becomes an object (the service layer's loader)."""

    def load(self, name: str) -> Any: ...


def _denied(attr: str) -> bool:
    return (attr.startswith("_") or attr in _DENIED_ATTRS
            or any(part in attr for part in _DENIED_PARTS))


def _validate_spec(expr: str, allowed_roots: frozenset[str]) -> None:
    try:
        tree = ast.parse(expr, mode="eval")
    except SyntaxError as exc:
        raise DSLResolutionError(
            f"spec {expr!r} does not parse: {exc}"
        ) from exc
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise DSLResolutionError(
                f"spec {expr!r} rejected: "
                f"{type(node).__name__} is not allowed"
            )
        if isinstance(node, ast.Name) and node.id not in allowed_roots:
            raise DSLResolutionError(
                f"spec {expr!r} rejected: unknown name {node.id!r}"
            )
        if isinstance(node, ast.Attribute) and _denied(node.attr):
            raise DSLResolutionError(
                f"spec {expr!r} rejected: attribute {node.attr!r} "
                f"is not allowed"
            )


def _spec_namespace() -> dict:
    """Whitelisted namespace of ``#`` expressions."""
    import numpy as np
    import torch

    from learningorchestra_tpu_torch.toolkit import registry

    # A process's first tensor made from a list imports a module through
    # the caller's builtins, which a spec's frame has none of.
    torch.tensor([0])
    classes = registry.constructors()
    # ``zoo.<module>.<Class>``: the model classes alone, not the modules,
    # whose globals hold the whole of ``torch``.
    zoo: dict[str, dict] = {}
    for name, cls in classes.items():
        zoo.setdefault(cls.__module__.rsplit(".", 1)[-1], {})[name] = cls
    ns: dict[str, Any] = {
        "torch": SimpleNamespace(
            **{n: getattr(torch, n) for n in _TORCH_NAMES}),
        "np": np,
        "numpy": np,
        "zoo": SimpleNamespace(
            **{mod: SimpleNamespace(**c) for mod, c in zoo.items()}),
        "True": True,
        "False": False,
        "None": None,
    }
    # Every registered model is addressable by class name, e.g.
    # "#MLPClassifier(num_classes=3)".
    ns.update(classes)
    return ns


def evaluate_spec(expr: str, extra_namespace: dict | None = None) -> Any:
    """Evaluate a ``#`` spec expression against the whitelisted
    namespace with ``__builtins__`` stripped."""
    if "__" in expr:
        # Dunder access would walk ().__class__.__mro__ out of the gate.
        raise DSLResolutionError(
            f"spec {expr!r} rejected: double underscores are not allowed"
        )
    ns = _spec_namespace()
    if extra_namespace:
        ns.update(extra_namespace)
    _validate_spec(expr, frozenset(ns))
    try:
        return eval(expr, {"__builtins__": {}}, ns)  # noqa: S307
    except Exception as exc:
        raise DSLResolutionError(
            f"cannot evaluate spec {expr!r}: {exc!r}"
        ) from exc


def resolve_value(
    value: Any,
    loader: ArtifactLoader,
    spec_namespace: dict | None = None,
) -> Any:
    """Resolve one request-JSON value; lists and dicts element-wise."""
    if isinstance(value, str):
        if value.startswith("$"):
            if not _DOLLAR_RE.match(value):
                raise DSLResolutionError(f"bad artifact reference {value!r}")
            body = value[1:]
            if "." in body:
                # Whole body as a name first ("titanic.csv"), then the
                # name.key split.
                try:
                    return loader.load(body)
                except KeyError:
                    pass
                name, key = body.split(".", 1)
                return _index(loader.load(name), key)
            return loader.load(body)
        if value.startswith("#"):
            return evaluate_spec(value[1:], spec_namespace)
        return value
    if isinstance(value, list):
        return [resolve_value(v, loader, spec_namespace) for v in value]
    if isinstance(value, dict):
        return {
            k: resolve_value(v, loader, spec_namespace)
            for k, v in value.items()
        }
    return value


def resolve_params(
    params: dict | None,
    loader: ArtifactLoader,
    spec_namespace: dict | None = None,
) -> dict:
    if not params:
        return {}
    return {
        k: resolve_value(v, loader, spec_namespace)
        for k, v in params.items()
    }


def _index(instance: Any, key: str) -> Any:
    """``$name.key``: tuple/list positions by int, mappings and frames by
    key."""
    try:
        if isinstance(instance, (tuple, list)):
            return instance[int(key)]
        return instance[key]
    except Exception as exc:
        raise DSLResolutionError(
            f"cannot index loaded artifact with {key!r}: {exc!r}"
        ) from exc


def split_special_params(
    params: dict | None, special_keys: tuple[str, ...]
) -> tuple[dict, dict]:
    """Split request params into (special, rest)."""
    params = dict(params or {})
    special = {k: params.pop(k) for k in special_keys if k in params}
    return special, params
