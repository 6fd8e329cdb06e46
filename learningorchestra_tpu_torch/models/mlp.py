"""MLP classifier/regressor — port of ``learningorchestra_tpu/models/mlp.py``,
the generic dense-net workhorse (the canonical REST drive's estimator).

Like the flax module, the MLP sizes its first layer from the first input
it sees: :class:`_MLP` has no parameters until ``build`` (at the first
``fit``, or from a loaded state's ``Dense_0`` kernel).  Layer names follow
the flax tree (``Dense_0`` .. ``Dense_n``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from learningorchestra_tpu_torch.ops.layers import Dense
from learningorchestra_tpu_torch.toolkit.registry import register
from learningorchestra_tpu_torch.train.neural import (
    SizedEstimator,
    SizedModule,
)

_MODULE = __name__


class _MLP(SizedModule):
    def __init__(self, features: tuple, out_dim: int):
        super().__init__()
        self.features = tuple(features)
        self.out_dim = out_dim

    def build(self, in_features: int) -> None:
        widths = (int(in_features), *self.features, self.out_dim)
        for i in range(len(widths) - 1):
            setattr(self, f"Dense_{i}", Dense(widths[i], widths[i + 1]))
        self.built = True

    @staticmethod
    def dims_of_input(x0) -> dict:
        return {"in_features": np.prod(x0.shape[1:])}

    @staticmethod
    def dims_of_tree(params: dict) -> dict:
        return {"in_features": params["Dense_0"]["kernel"].shape[0]}

    def forward(self, x):
        self._check_built()
        x = x.reshape(x.shape[0], -1)
        if not x.is_floating_point():
            # Integer features (token ids, counts) promote to the kernel's
            # dtype, as flax's Dense promotes them.
            x = x.to(self.Dense_0.weight.dtype)
        for i in range(len(self.features)):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{len(self.features)}")(x)


@register(_MODULE)
class MLPClassifier(SizedEstimator):
    def __init__(
        self,
        hidden_layer_sizes: Sequence[int] = (128, 64),
        num_classes: int = 2,
        learning_rate: float = 1e-3,
        seed: int = 0,
        device="cuda",
    ):
        self.hidden_layer_sizes = tuple(hidden_layer_sizes)
        self.num_classes = num_classes
        super().__init__(
            _MLP(self.hidden_layer_sizes, num_classes),
            loss="softmax_ce",
            learning_rate=learning_rate,
            seed=seed,
            device=device,
        )


@register(_MODULE)
class MLPRegressor(SizedEstimator):
    def __init__(
        self,
        hidden_layer_sizes: Sequence[int] = (128, 64),
        out_dim: int = 1,
        learning_rate: float = 1e-3,
        seed: int = 0,
        device="cuda",
    ):
        self.hidden_layer_sizes = tuple(hidden_layer_sizes)
        self.out_dim = out_dim
        super().__init__(
            _MLP(self.hidden_layer_sizes, out_dim),
            loss="mse",
            learning_rate=learning_rate,
            seed=seed,
            device=device,
        )
