"""PCA and t-SNE — the Explore-service projections; port of
``learningorchestra_tpu/toolkit/estimators/decomposition.py``.

PCA is an SVD on the device (singular vectors' signs are the solver's,
as in the JAX package, which flips none).  t-SNE is the exact O(n^2)
algorithm: dense (n, n) affinities, a per-row bisection for the
perplexity and momentum gradient steps, each a loop of device ops —
exact t-SNE at the few thousand points Explore plots is dense work that
belongs on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from learningorchestra_tpu_torch.device import resolve_device
from learningorchestra_tpu_torch.toolkit.base import TensorEstimator
from learningorchestra_tpu_torch.toolkit.registry import register

_MODULE = "learningorchestra_tpu_torch.toolkit.estimators.decomposition"


@register(_MODULE)
class PCA(TensorEstimator):
    def __init__(self, n_components: int = 2, device="cuda"):
        self.device = resolve_device(device)
        self.n_components = n_components
        self.mean_ = None
        self.components_ = None
        self.explained_variance_ratio_ = None

    def fit(self, x, y=None):
        x = self._put(x)
        self.mean_ = x.mean(0)
        _, s, vt = torch.linalg.svd(x - self.mean_, full_matrices=False)
        self.components_ = vt[: self.n_components]
        var = (s ** 2) / (x.shape[0] - 1)
        self.explained_variance_ratio_ = var[: self.n_components] / var.sum()
        return self

    def transform(self, x):
        return (self._put(x) - self.mean_) @ self.components_.T

    def fit_transform(self, x, y=None):
        return self.fit(x).transform(x)

    def inverse_transform(self, z):
        return self._put(z) @ self.components_ + self.mean_


def _pairwise_sq_dists(x):
    s = (x * x).sum(1)
    return s[:, None] - 2.0 * x @ x.T + s[None, :]


def _binary_search_perplexity(d2, target_entropy: float,
                              max_bisect: int = 50):
    """Per-point beta (precision) search so each row's conditional
    distribution hits the target perplexity."""
    n = d2.shape[0]
    off_diag = 1.0 - torch.eye(n, device=d2.device)

    def row_probs(beta):
        p = torch.exp(-d2 * beta[:, None]) * off_diag
        return p / p.sum(1, keepdim=True).clamp_min(1e-12)

    beta = d2.new_ones(n)
    lo = d2.new_zeros(n)
    hi = d2.new_full((n,), math.inf)
    for _ in range(max_bisect):
        p = row_probs(beta)
        h = -torch.where(p > 0, p * torch.log(p), 0.0).sum(1)
        too_high = h > target_entropy  # entropy too high -> beta too small
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(
            too_high,
            torch.where(torch.isinf(hi), beta * 2.0, (beta + hi) / 2.0),
            torch.where(lo == 0, beta / 2.0, (beta + lo) / 2.0),
        )
    return row_probs(beta)


def _q_numerators(y):
    """Student-t kernel 1 / (1 + |yi - yj|^2), zero on the diagonal."""
    num = 1.0 / (1.0 + _pairwise_sq_dists(y))
    return num * (1.0 - torch.eye(y.shape[0], device=y.device))


def _tsne_optimize(p, y, learning_rate: float, n_iter: int,
                   early_exaggeration_iters: int):
    vel = torch.zeros_like(y)
    for i in range(n_iter):
        early = i < early_exaggeration_iters
        num = _q_numerators(y)
        q = num / num.sum().clamp_min(1e-12)
        pq = (p * (12.0 if early else 1.0) - q) * num  # (n, n)
        g = 4.0 * (y * pq.sum(1, keepdim=True) - pq @ y)
        vel = (0.5 if early else 0.8) * vel - learning_rate * g
        y = y + vel
    return y


def kl_divergence(p, y) -> float:
    """KL(P || Q) of an embedding ``y`` under the joint affinities ``p``:
    the objective t-SNE minimises, in f64."""
    num = _q_numerators(y.double())
    q = (num / num.sum()).clamp_min(1e-12)
    p = p.double()
    return float((p * torch.log(p / q)).sum())


@register(_MODULE)
class TSNE(TensorEstimator):
    """Exact t-SNE (dense affinities).  ``kl_divergence_`` is the fitted
    embedding's KL(P || Q)."""

    def __init__(
        self,
        n_components: int = 2,
        perplexity: float = 30.0,
        learning_rate: float = 200.0,
        n_iter: int = 500,
        random_state: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.n_components = n_components
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.n_iter = n_iter
        self.random_state = random_state
        self.embedding_ = None
        self.kl_divergence_ = None

    def affinities(self, x):
        """The symmetric joint probabilities P of ``x`` (n, n)."""
        x = self._put(x)
        n = x.shape[0]
        cond = _binary_search_perplexity(
            _pairwise_sq_dists(x), float(np.log(np.float32(self.perplexity))))
        return ((cond + cond.T) / (2.0 * n)).clamp_min(1e-12)

    def fit_transform(self, x, y=None):
        p = self.affinities(x)
        rng = np.random.default_rng(self.random_state)
        y0 = self._put(rng.normal(scale=1e-4,
                                  size=(p.shape[0], self.n_components)))
        emb = _tsne_optimize(
            p, y0, self.learning_rate, n_iter=self.n_iter,
            early_exaggeration_iters=min(250, self.n_iter // 2),
        )
        self.embedding_ = emb
        self.kl_divergence_ = kl_divergence(p, emb)
        return emb

    def fit(self, x, y=None):
        self.fit_transform(x)
        return self
