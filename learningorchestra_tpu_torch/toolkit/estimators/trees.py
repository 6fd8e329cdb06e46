"""Decision trees, random forests, gradient boosting — histogram-based;
port of ``learningorchestra_tpu/toolkit/estimators/trees.py``.

Covers the Spark-MLlib builder whitelist (DecisionTree, RandomForest,
GBT) and ``sklearn.tree``/``sklearn.ensemble`` through the model
service.  As in the JAX package:

- features are quantized once into <= ``n_bins`` quantile bins, so split
  search is array math over (features x bins);
- trees grow greedily on the host (sequential, pointer-y control flow)
  into flat arrays ``(feature, threshold, left, right, leaf_value)``;
  the binning, bootstrap draws, split search and growth are the JAX
  package's numpy, line for line, so a tree fitted here equals the JAX
  package's array for array;
- prediction is a level-synchronous walk on the device: ``max_depth``
  rounds of gather + select over the whole batch.  The JAX package vmaps
  one tree's walk over the trees; here one walk advances every tree at
  once, with ``torch.gather`` over a (trees, rows) node index.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from learningorchestra_tpu_torch.device import resolve_device
from learningorchestra_tpu_torch.toolkit.base import (
    TensorEstimator,
    as_array,
    encode_classes,
    r2_score,
)
from learningorchestra_tpu_torch.toolkit.registry import register

_MODULE = "learningorchestra_tpu_torch.toolkit.estimators.trees"

#: Elements of a (trees, rows) node index per walk: larger batches walk
#: in row chunks (one chunk of 581,012 rows under 50 trees is 29 M).
_WALK_ELEMENTS = 1 << 25


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------


def _quantize(x: np.ndarray, n_bins: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-feature quantile binning.

    Returns (binned int16 array (n, d), edges (d, n_bins-1) float32 with
    +inf padding).  bin b holds values in (edges[b-1], edges[b]].
    """
    n, d = x.shape
    edges = np.full((d, n_bins - 1), np.inf, np.float32)
    binned = np.zeros((n, d), np.int16)
    qs = np.linspace(0, 100, n_bins + 1)[1:-1]
    for j in range(d):
        col = x[:, j]
        e = np.unique(np.percentile(col, qs))
        edges[j, : len(e)] = e
        binned[:, j] = np.searchsorted(e, col, side="left")
    return binned, edges


# ---------------------------------------------------------------------------
# Flat trees and the batched walk
# ---------------------------------------------------------------------------


class _FlatTree(NamedTuple):
    """feature, left, right (int64, child -1 = none), threshold (f32),
    leaf_value (n_nodes, out_dim) f32: tensors on one device."""

    feature: torch.Tensor
    threshold: torch.Tensor
    left: torch.Tensor
    right: torch.Tensor
    leaf_value: torch.Tensor
    max_depth: int


def _flat_tree(feature, threshold, left, right, leaf_value, max_depth,
               device) -> _FlatTree:
    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return _FlatTree(put(feature, torch.int64), put(threshold, torch.float32),
                     put(left, torch.int64), put(right, torch.int64),
                     put(leaf_value, torch.float32), int(max_depth))


def _traverse_forest(feature, threshold, left, right, leaf_value, x,
                     depth: int) -> torch.Tensor:
    """Walk every tree at once: (T, M) node arrays, leaf values (T, M,
    out), x (n, d) -> (T, n, out).  Rows walk in chunks of at most
    ``_WALK_ELEMENTS // T``."""
    n_trees, out_dim = feature.shape[0], leaf_value.shape[2]
    xt = x.T.contiguous()  # (d, n): xt.gather(0, f)[t, i] = x[i, f[t, i]]
    chunk = max(1, _WALK_ELEMENTS // n_trees)
    outs = []
    for s in range(0, x.shape[0], chunk):
        xs = xt[:, s:s + chunk]
        node = torch.zeros((n_trees, xs.shape[1]), dtype=torch.int64,
                           device=x.device)
        for _ in range(depth):
            xv = xs.gather(0, feature.gather(1, node))
            child = torch.where(xv <= threshold.gather(1, node),
                                left.gather(1, node), right.gather(1, node))
            node = torch.where(child >= 0, child, node)
        outs.append(leaf_value.gather(
            1, node[:, :, None].expand(-1, -1, out_dim)))
    return torch.cat(outs, dim=1)


def _traverse(tree: _FlatTree, x: torch.Tensor) -> torch.Tensor:
    """One tree's walk: (n, out_dim)."""
    return _traverse_forest(*(a[None] for a in tree[:5]), x,
                            tree.max_depth)[0]


# ---------------------------------------------------------------------------
# Histogram split search (vectorized over features x bins), on the host
# ---------------------------------------------------------------------------


def _best_gini_split(binned, y_idx, idx, n_bins, k, feat_mask,
                     min_samples_leaf):
    """Best (feature, bin, gain) under Gini impurity.

    Per feature, a bincount over bin*k+y builds the (bins, k) histogram;
    cumulative sums give every left/right partition at once.
    """
    m = len(idx)
    d = binned.shape[1]
    sub = binned[idx]
    ys = y_idx[idx]
    best = (-1, -1, 0.0)
    total = np.bincount(ys, minlength=k).astype(np.float64)
    gini_parent = 1.0 - np.sum((total / m) ** 2)
    for j in range(d):
        if not feat_mask[j]:
            continue
        hist = np.bincount(
            sub[:, j].astype(np.int64) * k + ys, minlength=n_bins * k
        ).reshape(n_bins, k).astype(np.float64)
        left = np.cumsum(hist, axis=0)[:-1]  # (n_bins-1, k)
        ln = left.sum(1)
        rn = m - ln
        valid = (ln >= min_samples_leaf) & (rn >= min_samples_leaf)
        if not valid.any():
            continue
        with np.errstate(divide="ignore", invalid="ignore"):
            gl = 1.0 - np.sum((left / np.maximum(ln[:, None], 1)) ** 2, 1)
            right = total[None] - left
            gr = 1.0 - np.sum((right / np.maximum(rn[:, None], 1)) ** 2, 1)
        weighted = (ln * gl + rn * gr) / m
        weighted[~valid] = np.inf
        b = int(np.argmin(weighted))
        gain = gini_parent - weighted[b]
        if gain > best[2]:
            best = (j, b, float(gain))
    return best


def _best_grad_split(binned, grad, hess, idx, n_bins, feat_mask,
                     min_samples_leaf, reg_lambda):
    """Best split for gradient boosting: maximize the XGBoost-style gain
    GL^2/(HL+l) + GR^2/(HR+l) - G^2/(H+l)."""
    m = len(idx)
    d = binned.shape[1]
    sub = binned[idx]
    g = grad[idx]
    h = hess[idx]
    gtot, htot = g.sum(), h.sum()
    parent = gtot * gtot / (htot + reg_lambda)
    best = (-1, -1, 0.0)
    for j in range(d):
        if not feat_mask[j]:
            continue
        bins = sub[:, j].astype(np.int64)
        gh = np.bincount(bins, weights=g, minlength=n_bins)
        hh = np.bincount(bins, weights=h, minlength=n_bins)
        cnt = np.bincount(bins, minlength=n_bins)
        gl = np.cumsum(gh)[:-1]
        hl = np.cumsum(hh)[:-1]
        nl = np.cumsum(cnt)[:-1]
        nr = m - nl
        valid = (nl >= min_samples_leaf) & (nr >= min_samples_leaf)
        if not valid.any():
            continue
        gr_ = gtot - gl
        hr_ = htot - hl
        gain = (
            gl * gl / (hl + reg_lambda)
            + gr_ * gr_ / (hr_ + reg_lambda)
            - parent
        )
        gain[~valid] = -np.inf
        b = int(np.argmax(gain))
        if gain[b] > best[2]:
            best = (j, b, float(gain[b]))
    return best


# ---------------------------------------------------------------------------
# Greedy builder
# ---------------------------------------------------------------------------


def _build_tree(
    binned,
    edges,
    *,
    mode: str,  # "gini" | "grad"
    device,
    y_idx=None,
    k: int = 0,
    grad=None,
    hess=None,
    max_depth: int = 6,
    min_samples_split: int = 2,
    min_samples_leaf: int = 1,
    max_features: int | None = None,
    reg_lambda: float = 1.0,
    rng: np.random.Generator | None = None,
) -> _FlatTree:
    n, d = binned.shape
    n_bins = edges.shape[1] + 1
    feature, threshold, left, right, values = [], [], [], [], []

    def leaf_value(idx):
        if mode == "gini":
            counts = np.bincount(y_idx[idx], minlength=k).astype(np.float64)
            return counts / max(counts.sum(), 1)
        g, h = grad[idx].sum(), hess[idx].sum()
        return np.array([-g / (h + reg_lambda)])

    def new_node():
        feature.append(-1)
        threshold.append(0.0)
        left.append(-1)
        right.append(-1)
        values.append(None)
        return len(feature) - 1

    root = new_node()
    stack = [(root, np.arange(n), 0)]
    while stack:
        node, idx, depth = stack.pop()
        values[node] = leaf_value(idx)
        if depth >= max_depth or len(idx) < min_samples_split:
            continue
        if max_features is not None and max_features < d:
            sel = (rng or np.random.default_rng()).choice(
                d, size=max_features, replace=False
            )
            feat_mask = np.zeros(d, bool)
            feat_mask[sel] = True
        else:
            feat_mask = np.ones(d, bool)
        if mode == "gini":
            j, b, gain = _best_gini_split(
                binned, y_idx, idx, n_bins, k, feat_mask, min_samples_leaf
            )
        else:
            j, b, gain = _best_grad_split(
                binned, grad, hess, idx, n_bins, feat_mask,
                min_samples_leaf, reg_lambda,
            )
        if j < 0 or gain <= 1e-12:
            continue
        go_left = binned[idx, j] <= b
        li, ri = idx[go_left], idx[~go_left]
        if len(li) == 0 or len(ri) == 0:
            continue
        feature[node] = j
        threshold[node] = float(edges[j, b])
        lnode, rnode = new_node(), new_node()
        left[node], right[node] = lnode, rnode
        stack.append((lnode, li, depth + 1))
        stack.append((rnode, ri, depth + 1))

    out_dim = k if mode == "gini" else 1
    vals = np.zeros((len(feature), out_dim), np.float32)
    for i, v in enumerate(values):
        vals[i] = v
    return _flat_tree(
        np.maximum(np.array(feature), 0),  # -1 -> 0; leaves have child=-1
        np.array(threshold, np.float32),
        np.array(left),
        np.array(right),
        vals,
        max_depth,
        device,
    )


def _pad_trees(trees: list[_FlatTree]):
    """Stack flat trees into (T, max_nodes) tensors for the batched walk;
    a padding node is a leaf (children -1) of value 0."""
    max_nodes = max(t.feature.shape[0] for t in trees)

    def pad(arrs, fill):
        return torch.stack([torch.nn.functional.pad(
            a, (0, max_nodes - a.shape[0]), value=fill) for a in arrs])

    return (pad([t.feature for t in trees], 0),
            pad([t.threshold for t in trees], 0.0),
            pad([t.left for t in trees], -1),
            pad([t.right for t in trees], -1),
            torch.stack([torch.nn.functional.pad(
                t.leaf_value, (0, 0, 0, max_nodes - t.leaf_value.shape[0]))
                for t in trees]))


# ---------------------------------------------------------------------------
# Public estimators
# ---------------------------------------------------------------------------


class _TreeClassifier(TensorEstimator):
    def predict(self, x):
        idx = self.predict_proba(x).argmax(1).cpu().numpy()
        return self.classes_[idx]


@register(_MODULE)
class DecisionTreeClassifier(_TreeClassifier):
    def __init__(
        self,
        max_depth: int = 6,
        min_samples_split: int = 2,
        min_samples_leaf: int = 1,
        n_bins: int = 64,
        random_state: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.max_depth = max_depth
        self.min_samples_split = min_samples_split
        self.min_samples_leaf = min_samples_leaf
        self.n_bins = n_bins
        self.random_state = random_state
        self.classes_ = None
        self._tree = None

    def fit(self, x, y):
        x = as_array(x, np.float32)
        self.classes_, y_idx = encode_classes(y)
        binned, edges = _quantize(x, self.n_bins)
        self._tree = _build_tree(
            binned,
            edges,
            mode="gini",
            device=self.device,
            y_idx=y_idx,
            k=len(self.classes_),
            max_depth=self.max_depth,
            min_samples_split=self.min_samples_split,
            min_samples_leaf=self.min_samples_leaf,
            rng=np.random.default_rng(self.random_state),
        )
        return self

    def predict_proba(self, x):
        return _traverse(self._tree, self._put(x))


@register(_MODULE)
class RandomForestClassifier(_TreeClassifier):
    def __init__(
        self,
        n_estimators: int = 50,
        max_depth: int = 8,
        min_samples_split: int = 2,
        min_samples_leaf: int = 1,
        max_features: str | int | None = "sqrt",
        n_bins: int = 64,
        random_state: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.min_samples_split = min_samples_split
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.n_bins = n_bins
        self.random_state = random_state
        self.classes_ = None
        self._stacked = None

    def _n_features_per_split(self, d: int) -> int | None:
        if self.max_features is None:
            return None
        if self.max_features == "sqrt":
            return max(1, int(np.sqrt(d)))
        if self.max_features == "log2":
            return max(1, int(np.log2(d)))
        return int(self.max_features)

    def fit(self, x, y):
        x = as_array(x, np.float32)
        self.classes_, y_idx = encode_classes(y)
        n, d = x.shape
        binned, edges = _quantize(x, self.n_bins)
        rng = np.random.default_rng(self.random_state)
        trees = []
        for _ in range(self.n_estimators):
            boot = rng.integers(0, n, size=n)
            trees.append(
                _build_tree(
                    binned[boot],
                    edges,
                    mode="gini",
                    device=self.device,
                    y_idx=y_idx[boot],
                    k=len(self.classes_),
                    max_depth=self.max_depth,
                    min_samples_split=self.min_samples_split,
                    min_samples_leaf=self.min_samples_leaf,
                    max_features=self._n_features_per_split(d),
                    rng=rng,
                )
            )
        self._stacked = _pad_trees(trees)
        return self

    def predict_proba(self, x):
        per_tree = _traverse_forest(*self._stacked, self._put(x),
                                    self.max_depth)
        probs = per_tree.mean(0)
        return probs / probs.sum(1, keepdim=True).clamp_min(1e-12)


@register(_MODULE)
class GradientBoostingClassifier(_TreeClassifier):
    """Histogram GBT with XGBoost-style second-order splits; binary or
    multiclass (one tree per class per round)."""

    def __init__(
        self,
        n_estimators: int = 100,
        learning_rate: float = 0.3,
        max_depth: int = 4,
        min_samples_leaf: int = 1,
        n_bins: int = 64,
        reg_lambda: float = 1.0,
        random_state: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.n_estimators = n_estimators
        self.learning_rate = learning_rate
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.n_bins = n_bins
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.classes_ = None
        self._stacked = None
        self._n_rounds = 0

    def fit(self, x, y):
        x = as_array(x, np.float32)
        self.classes_, y_idx = encode_classes(y)
        k = len(self.classes_)
        n = x.shape[0]
        binned, edges = _quantize(x, self.n_bins)
        x_dev = self._put(x)
        rng = np.random.default_rng(self.random_state)
        y1h = np.eye(k)[y_idx]  # (n, k)
        scores = np.zeros((n, k), np.float64)
        trees: list[_FlatTree] = []
        for _ in range(self.n_estimators):
            # softmax gradients/hessians per class
            exp = np.exp(scores - scores.max(1, keepdims=True))
            probs = exp / exp.sum(1, keepdims=True)
            grad = probs - y1h  # (n, k)
            hess = np.maximum(probs * (1.0 - probs), 1e-6)
            for c in range(k):
                tree = _build_tree(
                    binned,
                    edges,
                    mode="grad",
                    device=self.device,
                    grad=grad[:, c],
                    hess=hess[:, c],
                    max_depth=self.max_depth,
                    min_samples_leaf=self.min_samples_leaf,
                    reg_lambda=self.reg_lambda,
                    rng=rng,
                )
                trees.append(tree)
                pred = _traverse(tree, x_dev)[:, 0].cpu().numpy()
                scores[:, c] += self.learning_rate * pred
        self._n_rounds = self.n_estimators
        self._stacked = _pad_trees(trees)
        return self

    def decision_function(self, x):
        k = len(self.classes_)
        per_tree = _traverse_forest(*self._stacked, self._put(x),
                                    self.max_depth)
        # trees ordered round-major: (rounds*k, n, 1) -> (rounds, k, n)
        per_tree = per_tree[:, :, 0].reshape(self._n_rounds, k, -1)
        return self.learning_rate * per_tree.sum(0).T  # (n, k)

    def predict_proba(self, x):
        return torch.softmax(self.decision_function(x), dim=-1)


@register(_MODULE)
class DecisionTreeRegressor(TensorEstimator):
    """Squared-error regression tree (grad-mode with unit hessians)."""

    def __init__(
        self,
        max_depth: int = 6,
        min_samples_split: int = 2,
        min_samples_leaf: int = 1,
        n_bins: int = 64,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.max_depth = max_depth
        self.min_samples_split = min_samples_split
        self.min_samples_leaf = min_samples_leaf
        self.n_bins = n_bins
        self._tree = None
        self._mean = 0.0

    def fit(self, x, y):
        x = as_array(x, np.float32)
        y = as_array(y, np.float32).reshape(-1)
        self._mean = float(y.mean())
        binned, edges = _quantize(x, self.n_bins)
        # Squared loss: grad = -(y - mean residual), hess = 1 -> leaf
        # values become mean residuals.
        self._tree = _build_tree(
            binned,
            edges,
            mode="grad",
            device=self.device,
            grad=-(y - self._mean),
            hess=np.ones_like(y),
            max_depth=self.max_depth,
            min_samples_split=self.min_samples_split,
            min_samples_leaf=self.min_samples_leaf,
            reg_lambda=0.0,
        )
        return self

    def predict(self, x):
        return self._mean + _traverse(self._tree, self._put(x))[:, 0]

    def score(self, x, y):
        return r2_score(as_array(y, np.float32).reshape(-1),
                        self.predict(x))
