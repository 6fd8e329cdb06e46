"""Linear models: LinearRegression, Ridge, LogisticRegression,
SGDClassifier — port of
``learningorchestra_tpu/toolkit/estimators/linear.py``.

Closed-form solves where they exist: ``LinearRegression`` is
``jnp.linalg.lstsq``'s SVD solve (singular values under
``eps * max(n, d) * s_max`` dropped, so a rank-deficient design gets the
minimum-norm solution on every device), ``Ridge`` a normal-equation
solve.  Logistic regression is a full-batch loop of the port's
optax-layout Adam steps on the device, where the JAX package scans optax
``adam`` under one jit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from learningorchestra_tpu_torch.device import resolve_device
from learningorchestra_tpu_torch.toolkit.base import (
    TensorEstimator,
    encode_classes,
    r2_score,
)
from learningorchestra_tpu_torch.toolkit.registry import register
from learningorchestra_tpu_torch.train.neural import resolve_optimizer

_MODULE = "learningorchestra_tpu_torch.toolkit.estimators.linear"


def _add_bias(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_ones((x.shape[0], 1))], dim=1)


def _lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.lstsq(a, b)[0]``: the SVD solve with rcond = eps *
    max(n, d) relative to the largest singular value."""
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    rcond = torch.finfo(a.dtype).eps * max(a.shape)
    mask = s >= rcond * s[0]
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, 1.0), 0.0)
    return vt.T @ (s_inv[:, None] * (u.T @ b))


class _LinearBase(TensorEstimator):
    def _finish(self, w: torch.Tensor, y2: torch.Tensor, squeeze: bool):
        if self.fit_intercept:
            self.coef_, self.intercept_ = w[:-1], w[-1]
        else:
            self.coef_ = w
            self.intercept_ = y2.new_zeros(y2.shape[1])
        if squeeze:
            self.coef_ = self.coef_[:, 0]
            self.intercept_ = self.intercept_[0]
        return self

    def predict(self, x):
        x = self._put(x)
        coef = self.coef_ if self.coef_.ndim == 2 else self.coef_[:, None]
        out = x @ coef + self.intercept_
        return out[:, 0] if self.coef_.ndim == 1 else out

    def score(self, x, y):  # R^2 for regressors
        return r2_score(y, self.predict(x))


@register(_MODULE)
class LinearRegression(_LinearBase):
    def __init__(self, fit_intercept: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.fit_intercept = fit_intercept
        self.coef_ = None
        self.intercept_ = None

    def fit(self, x, y):
        x, y = self._put(x), self._put(y)
        y2 = y.reshape(y.shape[0], -1)
        xb = _add_bias(x) if self.fit_intercept else x
        return self._finish(_lstsq(xb, y2), y2, y.ndim == 1)


@register(_MODULE)
class Ridge(_LinearBase):
    def __init__(self, alpha: float = 1.0, fit_intercept: bool = True,
                 device="cuda"):
        self.device = resolve_device(device)
        self.fit_intercept = fit_intercept
        self.alpha = alpha
        self.coef_ = None
        self.intercept_ = None

    def fit(self, x, y):
        x, y = self._put(x), self._put(y)
        y2 = y.reshape(y.shape[0], -1)
        xb = _add_bias(x) if self.fit_intercept else x
        reg = self.alpha * torch.eye(xb.shape[1], device=self.device)
        if self.fit_intercept:
            reg[-1, -1] = 0.0  # don't penalize the bias
        w = torch.linalg.solve(xb.T @ xb + reg, xb.T @ y2)
        return self._finish(w, y2, y.ndim == 1)


def _fit_logreg(x, y_onehot, lr: float, l2: float, n_steps: int):
    """Full-batch softmax regression: ``n_steps`` Adam updates from zero
    weights; returns (w, b, per-step losses before each update)."""
    d, k = x.shape[1], y_onehot.shape[1]
    w = x.new_zeros((d, k), requires_grad=True)
    b = x.new_zeros((k,), requires_grad=True)
    opt = resolve_optimizer("adam", lr).build([w, b])
    losses = x.new_empty(n_steps)
    for i in range(n_steps):
        opt.zero_grad(set_to_none=True)
        logp = F.log_softmax(x @ w + b, dim=-1)
        nll = -(y_onehot * logp).sum(-1).mean()
        loss = nll + l2 * (w * w).sum()
        loss.backward()
        opt.step()
        losses[i] = loss.detach()
    return w.detach(), b.detach(), losses


@register(_MODULE)
class LogisticRegression(TensorEstimator):
    """Multinomial logistic regression, full-batch Adam on the device."""

    def __init__(
        self,
        max_iter: int = 200,
        learning_rate: float = 0.1,
        C: float = 1.0,
        fit_intercept: bool = True,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.max_iter = max_iter
        self.learning_rate = learning_rate
        self.C = C
        self.fit_intercept = fit_intercept
        self.classes_ = None
        self.coef_ = None
        self.intercept_ = None
        self.losses_ = None

    def fit(self, x, y):
        x = self._put(x)
        self.classes_, y_idx = encode_classes(y)
        y1h = F.one_hot(self._put(y_idx, torch.long),
                        len(self.classes_)).float()
        l2 = 1.0 / (2.0 * self.C * x.shape[0])
        self.coef_, self.intercept_, losses = _fit_logreg(
            x, y1h, self.learning_rate, l2, self.max_iter)
        self.losses_ = losses.cpu().numpy()
        return self

    def decision_function(self, x):
        return self._put(x) @ self.coef_ + self.intercept_

    def predict_proba(self, x):
        return torch.softmax(self.decision_function(x), dim=-1)

    def predict(self, x):
        idx = self.decision_function(x).argmax(-1).cpu().numpy()
        return self.classes_[idx]


@register(_MODULE)
class SGDClassifier(LogisticRegression):
    """Alias surface for sklearn.linear_model.SGDClassifier (log loss)."""

    def __init__(self, max_iter: int = 200, learning_rate: float = 0.05,
                 C: float = 1.0, device="cuda"):
        super().__init__(max_iter=max_iter, learning_rate=learning_rate,
                         C=C, device=device)
