"""Estimator protocol and array coercion helpers — port of
``learningorchestra_tpu/toolkit/base.py``, over numpy and torch instead of
jnp.  The helpers coerce to numpy the way ``jnp.asarray`` does with x64
off (float64 -> float32, int64 -> int32), so the port batches the same
dtypes the JAX package trains on."""

from __future__ import annotations

import inspect
from typing import Any

import numpy as np
import torch

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
