"""Naive Bayes (Gaussian + Multinomial) — port of
``learningorchestra_tpu/toolkit/estimators/bayes.py``.

Fitting is a handful of one-hot matmuls on the device; prediction a
joint log-likelihood and an argmax.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from learningorchestra_tpu_torch.device import resolve_device
from learningorchestra_tpu_torch.toolkit.base import (
    TensorEstimator,
    encode_classes,
)
from learningorchestra_tpu_torch.toolkit.registry import register

_MODULE = "learningorchestra_tpu_torch.toolkit.estimators.bayes"


class _NaiveBayes(TensorEstimator):
    def _one_hot(self, y):
        self.classes_, y_idx = encode_classes(y)
        return F.one_hot(self._put(y_idx, torch.long),
                         len(self.classes_)).float()

    def predict_proba(self, x):
        return torch.softmax(self._joint_log_likelihood(x), dim=-1)

    def predict(self, x):
        idx = self._joint_log_likelihood(x).argmax(-1).cpu().numpy()
        return self.classes_[idx]


@register(_MODULE)
class GaussianNB(_NaiveBayes):
    def __init__(self, var_smoothing: float = 1e-9, device="cuda"):
        self.device = resolve_device(device)
        self.var_smoothing = var_smoothing
        self.classes_ = None
        self.theta_ = None  # (k, d) means
        self.var_ = None  # (k, d) variances
        self.class_log_prior_ = None

    def fit(self, x, y):
        x = self._put(x)
        y1h = self._one_hot(y)  # (n, k)
        counts = y1h.sum(0)
        self.theta_ = (y1h.T @ x) / counts[:, None]
        var = (y1h.T @ (x * x)) / counts[:, None] - self.theta_ ** 2
        eps = self.var_smoothing * x.var(0, correction=0).max()
        self.var_ = var + eps
        self.class_log_prior_ = torch.log(counts / counts.sum())
        return self

    def _joint_log_likelihood(self, x):
        x = self._put(x)
        diff = x[:, None, :] - self.theta_[None, :, :]
        ll = -0.5 * torch.sum(
            torch.log(2.0 * math.pi * self.var_)[None]
            + diff ** 2 / self.var_[None],
            dim=-1,
        )
        return ll + self.class_log_prior_[None]


@register(_MODULE)
class MultinomialNB(_NaiveBayes):
    def __init__(self, alpha: float = 1.0, device="cuda"):
        self.device = resolve_device(device)
        self.alpha = alpha
        self.classes_ = None
        self.feature_log_prob_ = None
        self.class_log_prior_ = None

    def fit(self, x, y):
        x = self._put(x)
        y1h = self._one_hot(y)
        counts = y1h.sum(0)
        feat = y1h.T @ x + self.alpha  # (k, d)
        self.feature_log_prob_ = torch.log(feat) - torch.log(
            feat.sum(1, keepdim=True))
        self.class_log_prior_ = torch.log(counts / counts.sum())
        return self

    def _joint_log_likelihood(self, x):
        return self._put(x) @ self.feature_log_prob_.T \
            + self.class_log_prior_[None]
