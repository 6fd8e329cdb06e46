"""Preprocessing transforms: StandardScaler, MinMaxScaler, OneHotEncoder —
port of ``learningorchestra_tpu/toolkit/estimators/preprocessing.py``.

The reference's Transform service instantiates exactly these kinds of
classes generically (``databaseExecutor`` with type=transform).
Transforms return tensors on the estimator's device, as the JAX package
returns device arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from learningorchestra_tpu_torch.device import resolve_device
from learningorchestra_tpu_torch.toolkit.base import TensorEstimator
from learningorchestra_tpu_torch.toolkit.registry import register

_MODULE = "learningorchestra_tpu_torch.toolkit.estimators.preprocessing"


@register(_MODULE)
class StandardScaler(TensorEstimator):
    def __init__(self, with_mean: bool = True, with_std: bool = True,
                 device="cuda"):
        self.device = resolve_device(device)
        self.with_mean = with_mean
        self.with_std = with_std
        self.mean_ = None
        self.scale_ = None

    def fit(self, x, y=None):
        x = self._put(x)
        d = x.shape[1]
        self.mean_ = x.mean(0) if self.with_mean \
            else torch.zeros(d, device=self.device)
        std = x.std(0, correction=0) if self.with_std \
            else torch.ones(d, device=self.device)
        self.scale_ = torch.where(std == 0, 1.0, std)
        return self

    def transform(self, x):
        return (self._put(x) - self.mean_) / self.scale_

    def fit_transform(self, x, y=None):
        return self.fit(x).transform(x)

    def inverse_transform(self, x):
        return self._put(x) * self.scale_ + self.mean_


@register(_MODULE)
class MinMaxScaler(TensorEstimator):
    def __init__(self, feature_range: tuple = (0.0, 1.0), device="cuda"):
        self.device = resolve_device(device)
        self.feature_range = tuple(feature_range)
        self.min_ = None
        self.scale_ = None

    def fit(self, x, y=None):
        x = self._put(x)
        lo, hi = x.amin(0), x.amax(0)
        span = torch.where(hi - lo == 0, 1.0, hi - lo)
        a, b = self.feature_range
        self.scale_ = (b - a) / span
        self.min_ = a - lo * self.scale_
        return self

    def transform(self, x):
        return self._put(x) * self.scale_ + self.min_

    def fit_transform(self, x, y=None):
        return self.fit(x).transform(x)


def _host_columns(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    arr = np.asarray(x if not hasattr(x, "to_numpy") else x.to_numpy())
    return arr[:, None] if arr.ndim == 1 else arr


@register(_MODULE)
class OneHotEncoder(TensorEstimator):
    """Categories are found on the host (``np.unique`` per column, any
    dtype); the encoding is placed on the device."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.categories_ = None

    def fit(self, x, y=None):
        arr = _host_columns(x)
        self.categories_ = [np.unique(arr[:, j]) for j in range(arr.shape[1])]
        return self

    def transform(self, x):
        arr = _host_columns(x)
        cols = []
        for j, cats in enumerate(self.categories_):
            idx = np.searchsorted(cats, arr[:, j])
            idx = np.clip(idx, 0, len(cats) - 1)
            valid = cats[idx] == arr[:, j]
            block = np.zeros((arr.shape[0], len(cats)), np.float32)
            block[np.arange(arr.shape[0])[valid], idx[valid]] = 1.0
            cols.append(block)
        return self._put(np.concatenate(cols, axis=1))

    def fit_transform(self, x, y=None):
        return self.fit(x).transform(x)
