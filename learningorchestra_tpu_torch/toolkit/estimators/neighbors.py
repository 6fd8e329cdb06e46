"""KNeighborsClassifier — port of
``learningorchestra_tpu/toolkit/estimators/neighbors.py``.

Brute force by design: squared distances as one (m, n) matmul, top-k,
one-hot votes.  Queries go in row blocks so a large predict bounds its
distance matrix (the rows are independent).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from learningorchestra_tpu_torch.device import resolve_device
from learningorchestra_tpu_torch.toolkit.base import (
    TensorEstimator,
    encode_classes,
)
from learningorchestra_tpu_torch.toolkit.registry import register

_MODULE = "learningorchestra_tpu_torch.toolkit.estimators.neighbors"

#: Distance-matrix elements per query block.
_BLOCK_ELEMENTS = 1 << 27


def _knn_votes(train_x, train_y, test_x, k: int, n_classes: int):
    """Per query row, the class counts among its ``k`` nearest training
    rows (tied distances may order differently from ``jax.lax.top_k``)."""
    sq = (train_x * train_x).sum(1)[None]
    block = max(1, _BLOCK_ELEMENTS // max(1, train_x.shape[0]))
    out = []
    for s in range(0, test_x.shape[0], block):
        q = test_x[s:s + block]
        d = (q * q).sum(1, keepdim=True) - 2.0 * q @ train_x.T + sq
        _, idx = torch.topk(-d, k)  # (m, k) nearest indices
        out.append(F.one_hot(train_y[idx], n_classes).sum(1).float())
    return torch.cat(out)


@register(_MODULE)
class KNeighborsClassifier(TensorEstimator):
    def __init__(self, n_neighbors: int = 5, device="cuda"):
        self.device = resolve_device(device)
        self.n_neighbors = n_neighbors
        self.classes_ = None
        self._x = None
        self._y = None

    def fit(self, x, y):
        self._x = self._put(x)
        self.classes_, y_idx = encode_classes(y)
        self._y = self._put(y_idx, torch.long)
        return self

    def _votes(self, x):
        return _knn_votes(self._x, self._y, self._put(x),
                          k=self.n_neighbors, n_classes=len(self.classes_))

    def predict_proba(self, x):
        votes = self._votes(x)
        return votes / votes.sum(1, keepdim=True)

    def predict(self, x):
        return self.classes_[self._votes(x).argmax(1).cpu().numpy()]
