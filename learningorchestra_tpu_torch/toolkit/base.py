"""Estimator protocol and array coercion helpers — port of
``learningorchestra_tpu/toolkit/base.py``, over numpy and torch instead of
jnp.  The helpers coerce to numpy the way ``jnp.asarray`` does with x64
off (float64 -> float32, int64 -> int32), so the port batches the same
dtypes the JAX package trains on.

:class:`TensorEstimator` is the base of the classical estimators: their
fitted state lives as tensors on the estimator's ``device`` (where the
JAX package keeps jnp arrays), labels and host-side bookkeeping stay
numpy, and a pickle of one holds CPU tensors only, so an artifact made
on the card loads where there is none (:meth:`TensorEstimator.to`
places it again)."""

from __future__ import annotations

import inspect
from typing import Any

import numpy as np
import torch

from learningorchestra_tpu_torch.device import resolve_device

_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32}


def _host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    if hasattr(x, "to_numpy"):  # pandas DataFrame / Series
        x = x.to_numpy()
    return np.asarray(x)


def as_array(x: Any, dtype=None) -> np.ndarray:
    """Coerce DataFrames / lists / numpy / torch tensors to a numpy array
    (object columns to float32, 64-bit numbers to 32-bit)."""
    arr = _host(x)
    if arr.dtype == object:
        arr = arr.astype(np.float32)
    arr = arr.astype(_NARROW.get(arr.dtype, arr.dtype), copy=False)
    if dtype is not None:
        arr = arr.astype(dtype)
    return arr


def as_labels(y: Any) -> np.ndarray:
    """Coerce labels to a flat vector (classes kept by the caller)."""
    return as_array(y).reshape(-1)


def encode_classes(y: Any) -> tuple[np.ndarray, np.ndarray]:
    """(classes, encoded int ids) — np.unique inverse mapping."""
    arr = _host(y).reshape(-1)
    classes, inv = np.unique(arr, return_inverse=True)
    return classes, inv.astype(np.int32)


def map_tensors(obj: Any, fn) -> Any:
    """``obj`` with ``fn`` applied to every tensor in it, through dicts,
    lists and tuples (named tuples keep their type)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(map_tensors(v, fn) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(map_tensors(v, fn) for v in obj)
    return obj


def r2_score(y: Any, pred: Any) -> float:
    """Coefficient of determination (the regressors' ``score``)."""
    y = as_array(y, np.float32)
    pred = _host(pred).reshape(y.shape)
    ss_res = float(((y - pred) ** 2).sum())
    ss_tot = float(((y - y.mean(0)) ** 2).sum())
    return 1.0 - ss_res / max(ss_tot, 1e-12)


class Estimator:
    """Base class: get_params/set_params over __init__ kwargs, repr."""

    def get_params(self) -> dict:
        sig = inspect.signature(type(self).__init__)
        return {
            name: getattr(self, name)
            for name in sig.parameters
            if name != "self" and hasattr(self, name)
        }

    def set_params(self, **params) -> "Estimator":
        for key, val in params.items():
            setattr(self, key, val)
        return self

    def __repr__(self) -> str:
        params = ", ".join(f"{k}={v!r}" for k, v in self.get_params().items())
        return f"{type(self).__name__}({params})"

    # Classification scorer shared by classifiers.
    def score(self, x, y) -> float:
        preds = _host(self.predict(x)).reshape(-1)
        truth = _host(y).reshape(-1)
        return float((preds == truth).mean())


class TensorEstimator(Estimator):
    """A classical estimator whose fitted state is tensors on
    ``self.device`` (set by each ``__init__`` from its ``device``
    argument through ``resolve_device``)."""

    device: torch.device

    def _put(self, x: Any, dtype=torch.float32) -> torch.Tensor:
        """A host array (DataFrame, list, numpy, tensor anywhere) as a
        ``dtype`` tensor on the estimator's device."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device, dtype)
        arr = np.ascontiguousarray(as_array(x))
        # torch cannot alias a read-only array (one handed out by JAX).
        return torch.from_numpy(arr if arr.flags.writeable else arr.copy()
                                ).to(self.device, dtype)

    def to(self, device) -> "TensorEstimator":
        """Move the fitted state to ``device`` (in place)."""
        self.device = resolve_device(device)
        self.__dict__.update(map_tensors(
            self.__dict__, lambda t: t.to(self.device)))
        return self

    def __getstate__(self) -> dict:
        # CPU tensors only: a pickle with CUDA tensors does not load
        # where there is no card.
        return map_tensors(dict(self.__dict__), lambda t: t.detach().cpu())
