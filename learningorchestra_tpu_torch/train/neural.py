"""NeuralEstimator, inference subset — port of
``learningorchestra_tpu/train/neural.py``.

Parameters live on the estimator's device from construction (seeded from
a ``torch.Generator`` on the CPU, so one seed gives the same weights on
every device).  ``predict`` pads its ragged tail to a power-of-two bucket
as the JAX estimator does; ``state_dict``/``load_state_dict`` keep the
JAX package's artifact layout: the flax-shaped numpy tree, with
``QuantizedLeaf``s where ``quantize_pytree`` puts them.  ``fit`` comes
with the training slice.

An artifact is a plain dict (:meth:`NeuralEstimator.to_artifact`) naming
its class through the registry; :func:`load_artifact` rebuilds it on any
device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from learningorchestra_tpu_torch import convert
from learningorchestra_tpu_torch.device import resolve_device
from learningorchestra_tpu_torch.ops.layers import (
    MultiHeadSelfAttention,
    has_separate_qkv,
    migrate_separate_qkv,
)
from learningorchestra_tpu_torch.ops.quant import (
    dequantize_pytree,
    has_quantized_leaves,
    quantize_pytree,
)
from learningorchestra_tpu_torch.serve.bucketing import bucket_for, pad_rows
from learningorchestra_tpu_torch.toolkit import registry
from learningorchestra_tpu_torch.toolkit.base import Estimator


def init_params(module: nn.Module, seed: int) -> None:
    """Seeded init in module order: Linear weights N(0, 1/fan_in) (flax's
    lecun scale), embeddings N(0, 1/features), zero biases, unit norms."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.copy_(torch.randn(
                    mod.weight.shape, generator=gen
                ) / math.sqrt(mod.in_features))
                mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.copy_(torch.randn(
                    mod.weight.shape, generator=gen
                ) / math.sqrt(mod.embedding_dim))
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()


class NeuralEstimator(Estimator):
    """Wraps a ``nn.Module`` with predict/save/load (inference subset)."""

    def __init__(self, module: nn.Module, *, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.seed = seed
        self.module = module
        self.history: dict = {}
        init_params(module, seed)
        module.to(self.device).eval()

    # -- inference ------------------------------------------------------------

    def check_input(self, x: np.ndarray) -> None:
        """Raise ValueError for input the module cannot take (validated on
        the host: a bad index on the card would fault the device)."""

    def apply(self, x: np.ndarray) -> np.ndarray:
        """One forward over a host batch; returns host f32 outputs."""
        with torch.inference_mode():
            xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            return self.module(xt).float().cpu().numpy()

    def predict(self, x, batch_size: int = 512, **_):
        x = np.asarray(x)
        self.check_input(x)
        outs = []
        for i in range(0, len(x), batch_size):
            xb = x[i:i + batch_size]
            k = xb.shape[0]
            # The ragged final slice pads up to its power-of-two bucket
            # (capped at batch_size) and the pad rows are sliced off: the
            # same discipline as the serving path.
            bucket = bucket_for(k, batch_size)
            outs.append(self.apply(pad_rows(xb, bucket))[:k])
        return np.concatenate(outs, axis=0)

    # -- persistence ----------------------------------------------------------

    def state_dict(self, *, quantize: bool = False) -> dict:
        """The JAX package's artifact state: ``params`` is the flax tree of
        numpy arrays; ``quantize=True`` stores large tensors int8 (the
        quantize kernel runs on the estimator's device)."""
        tree = convert.flax_tree(self.module)
        if quantize:
            tree = quantize_pytree(tree)
        return {
            "params": convert.to_host(tree),
            "opt_state": None,
            "history": dict(self.history),
            "accumulate_steps": 1,
            "sharded_fit_cols": None,
        }

    def load_state_dict(self, state: dict) -> None:
        params = state["params"]
        if has_quantized_leaves(params):
            params = dequantize_pytree(params, device=self.device)
        if has_separate_qkv(params) and not any(
            isinstance(m, MultiHeadSelfAttention) and not m.fused_qkv
            for m in self.module.modules()
        ):
            # Legacy separate-projection artifact meeting the fused
            # default: block-stack into the qkv layout.
            params = migrate_separate_qkv(params)
        self.module.load_state_dict(convert.params_from_jax(params))
        self.history = dict(state.get("history") or {})

    def to_artifact(self, *, quantize: bool = False) -> dict:
        """A picklable artifact: class name, constructor kwargs (minus the
        device) and :meth:`state_dict`."""
        params = self.get_params()
        params.pop("device", None)
        return {
            "modulePath": type(self).__module__,
            "class": type(self).__name__,
            "classParameters": params,
            "state": self.state_dict(quantize=quantize),
        }


def load_artifact(doc: dict, *, device="cuda") -> NeuralEstimator:
    """Rebuild an estimator from :meth:`NeuralEstimator.to_artifact` on
    ``device`` (int8 leaves dequantize there)."""
    cls = registry.resolve(doc["modulePath"], doc["class"])
    est = cls(**doc["classParameters"], device=device)
    est.load_state_dict(doc["state"])
    return est
