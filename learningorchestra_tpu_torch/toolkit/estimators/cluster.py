"""KMeans: kmeans++ seeding on the host + Lloyd iterations on the device —
port of ``learningorchestra_tpu/toolkit/estimators/cluster.py``.

The seeding is the JAX package's numpy (the same centers from the same
``random_state``); each Lloyd step is one (n, k) distance matmul, an
argmin and a one-hot matmul for the new means.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from learningorchestra_tpu_torch.device import resolve_device
from learningorchestra_tpu_torch.toolkit.base import TensorEstimator
from learningorchestra_tpu_torch.toolkit.registry import register

_MODULE = "learningorchestra_tpu_torch.toolkit.estimators.cluster"


def _assign(x, centers):
    # ||x-c||^2 = ||x||^2 - 2 x.c + ||c||^2 ; argmin over k.
    d = ((x * x).sum(1, keepdim=True) - 2.0 * x @ centers.T
         + (centers * centers).sum(1)[None])
    return d.argmin(1)


def _lloyd(x, centers, n_iter: int):
    """``n_iter`` Lloyd steps (an empty cluster keeps its center);
    returns (centers, labels, inertia)."""
    k = centers.shape[0]
    for _ in range(n_iter):
        one_hot = F.one_hot(_assign(x, centers), k).to(x.dtype)
        counts = one_hot.sum(0)[:, None]
        centers = torch.where(counts > 0,
                              (one_hot.T @ x) / counts.clamp_min(1),
                              centers)
    labels = _assign(x, centers)
    return centers, labels, ((x - centers[labels]) ** 2).sum()


@register(_MODULE)
class KMeans(TensorEstimator):
    def __init__(
        self,
        n_clusters: int = 8,
        max_iter: int = 100,
        random_state: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.n_clusters = n_clusters
        self.max_iter = max_iter
        self.random_state = random_state
        self.cluster_centers_ = None
        self.labels_ = None
        self.inertia_ = None

    def _init_centers(self, x: np.ndarray) -> np.ndarray:
        """kmeans++ seeding on host (data-dependent control flow)."""
        rng = np.random.default_rng(self.random_state)
        n = x.shape[0]
        centers = [x[rng.integers(n)]]
        for _ in range(1, self.n_clusters):
            d2 = np.min(
                ((x[:, None, :] - np.stack(centers)[None]) ** 2).sum(-1),
                axis=1,
            )
            probs = d2 / max(d2.sum(), 1e-12)
            centers.append(x[rng.choice(n, p=probs)])
        return np.stack(centers)

    def fit(self, x, y=None):
        xt = self._put(x)
        centers0 = self._put(self._init_centers(xt.cpu().numpy()))
        centers, labels, inertia = _lloyd(xt, centers0, self.max_iter)
        self.cluster_centers_ = centers
        self.labels_ = labels.cpu().numpy()
        self.inertia_ = float(inertia)
        return self

    def predict(self, x):
        return _assign(self._put(x), self.cluster_centers_).cpu().numpy()

    def score(self, x, y=None):
        x = self._put(x)
        labels = _assign(x, self.cluster_centers_)
        return -float(((x - self.cluster_centers_[labels]) ** 2).sum())
