"""Support vector machines — port of
``learningorchestra_tpu/toolkit/estimators/svm.py``.

- ``LinearSVC``: the primal squared-hinge objective (one-vs-rest, every
  class at once) minimised by full-batch Adam steps on the device;
- ``SVC``: kernelised by random Fourier features, z(x) =
  sqrt(2/D) cos(xW + b) with W ~ N(0, 2 gamma I), b ~ U(0, 2 pi), then
  the same solver; ``kernel="linear"`` skips the map.

The JAX package draws W and b with ``jax.random`` (threefry); the port
draws the same distributions from a ``torch.Generator`` seeded with
``random_state`` on the CPU, so one seed gives one map on every device
but not the JAX package's bits.  A map drawn elsewhere is carried with
:meth:`SVC.pin_feature_map` (``convert.carry_estimator`` does it for a
JAX package's ``_w``/``_b``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from learningorchestra_tpu_torch.device import resolve_device
from learningorchestra_tpu_torch.toolkit.base import (
    TensorEstimator,
    encode_classes,
)
from learningorchestra_tpu_torch.toolkit.registry import register
from learningorchestra_tpu_torch.train.neural import resolve_optimizer

_MODULE = "learningorchestra_tpu_torch.toolkit.estimators.svm"


def _add_bias(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_ones((x.shape[0], 1))], dim=1)


def _fit_squared_hinge(x, y_pm, c: float, learning_rate: float,
                       max_iter: int):
    """One-vs-rest squared-hinge SVM, every class in one weight matrix
    (features, classes); returns (w, per-step losses)."""
    n, d = x.shape
    w = x.new_zeros((d, y_pm.shape[1]), requires_grad=True)
    opt = resolve_optimizer("adam", learning_rate).build([w])
    losses = x.new_empty(max_iter)
    for i in range(max_iter):
        opt.zero_grad(set_to_none=True)
        hinge = torch.clamp_min(1.0 - y_pm * (x @ w), 0.0)
        loss = 0.5 * (w * w).sum() / n + c * (hinge ** 2).mean()
        loss.backward()
        opt.step()
        losses[i] = loss.detach()
    return w.detach(), losses


class _HingeSVMBase(TensorEstimator):
    def __init__(self, C: float = 1.0, max_iter: int = 300,
                 learning_rate: float = 0.05, random_state: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.C = C
        self.max_iter = max_iter
        self.learning_rate = learning_rate
        self.random_state = random_state
        self.coef_ = None
        self.classes_ = None

    # feature map hook (identity for the linear machine)
    def _features(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def _init_features(self, x: torch.Tensor) -> None:
        pass

    def fit(self, x, y):
        x = self._put(x)
        self.classes_, y_idx = encode_classes(y)
        if len(self.classes_) < 2:
            raise ValueError(
                "fit needs at least 2 classes; got "
                f"{list(self.classes_)!r}"
            )
        self._init_features(x)
        feats = _add_bias(self._features(x))
        onehot = F.one_hot(self._put(y_idx, torch.long),
                           len(self.classes_)).float()
        coef, losses = _fit_squared_hinge(
            feats, 2.0 * onehot - 1.0, float(self.C),
            float(self.learning_rate), self.max_iter)
        self.coef_, self.losses_ = coef, losses.cpu().numpy()
        return self

    def decision_function(self, x):
        return _add_bias(self._features(self._put(x))) @ self.coef_

    def predict(self, x):
        idx = self.decision_function(x).argmax(-1).cpu().numpy()
        return np.asarray(self.classes_)[idx]
    # score() inherited from Estimator — handles string labels.


@register(_MODULE)
class LinearSVC(_HingeSVMBase):
    """Primal linear SVM (squared hinge, one-vs-rest)."""


@register(_MODULE)
class SVC(_HingeSVMBase):
    """RBF-kernel SVM via random Fourier features.

    ``gamma``: "scale" (sklearn default, 1/(d var)) or a float.
    ``n_components``: feature-map width (quality/compute trade-off).
    """

    def __init__(self, C: float = 1.0, kernel: str = "rbf",
                 gamma: str | float = "scale", n_components: int = 256,
                 max_iter: int = 300, learning_rate: float = 0.05,
                 random_state: int = 0, device="cuda"):
        super().__init__(C=C, max_iter=max_iter,
                         learning_rate=learning_rate,
                         random_state=random_state, device=device)
        if kernel not in ("rbf", "linear"):
            raise ValueError(f"unsupported kernel: {kernel!r}")
        self.kernel = kernel
        self.gamma = gamma
        self.n_components = n_components
        self._w = None
        self._b = None
        self._pinned = None

    def pin_feature_map(self, w, b) -> "SVC":
        """Fit on the map (w (d, n_components), b (n_components,))
        instead of drawing one: how a map drawn by the JAX package is
        carried."""
        self._pinned = (self._put(w), self._put(b))
        return self

    def _init_features(self, x: torch.Tensor) -> None:
        if self.kernel == "linear":
            return
        if self._pinned is not None:
            self._w, self._b = self._pinned
            return
        d = x.shape[1]
        if self.gamma == "scale":
            var = float(x.var(correction=0))
            gamma = 1.0 / (d * var) if var > 0 else 1.0 / d
        else:
            gamma = float(self.gamma)
        gen = torch.Generator().manual_seed(int(self.random_state))
        w = torch.randn((d, self.n_components), generator=gen)
        b = torch.rand((self.n_components,), generator=gen)
        self._w = w.to(self.device) * math.sqrt(2.0 * gamma)
        self._b = b.to(self.device) * (2.0 * math.pi)

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel == "linear":
            return x
        proj = x @ self._w + self._b
        return math.sqrt(2.0 / self.n_components) * torch.cos(proj)
