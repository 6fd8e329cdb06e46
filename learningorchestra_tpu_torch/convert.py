"""Weight carry between the JAX package's flax parameter trees and the
port's modules.

The port's modules name their submodules after the flax tree
(``encoder.TransformerBlock_0.MultiHeadSelfAttention_0.qkv`` is
``params/encoder/TransformerBlock_0/MultiHeadSelfAttention_0/qkv``), so
the carry is a per-leaf layout change:

- ``Dense``/``DenseGeneral`` ``kernel`` (in, *features) <-> ``nn.Linear``
  ``weight`` (prod(features), in); ``bias`` (*features) <-> (prod,);
- ``Embed`` ``embedding`` <-> ``nn.Embedding`` ``weight``;
- ``LayerNorm`` ``scale``/``bias`` <-> ``nn.LayerNorm`` ``weight``/``bias``.

A flax tree is the variables dict ``{"params": {...}}`` whose leaves are
numpy arrays (or tensors, e.g. a dequantized artifact on the card).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    x = np.ascontiguousarray(x)
    # torch cannot alias a read-only array (e.g. one handed out by JAX).
    return torch.from_numpy(x if x.flags.writeable else x.copy())


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """Flax variables ``{"params": ...}`` -> a state_dict for the port's
    module of the same architecture."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}.")
                continue
            t = _tensor(val)
            if key == "kernel":
                out[prefix + "weight"] = t.reshape(t.shape[0], -1).T \
                    .contiguous()
            elif key == "bias":
                out[prefix + "bias"] = t.reshape(-1)
            elif key in ("embedding", "scale"):
                out[prefix + "weight"] = t
            else:
                raise KeyError(f"unknown flax leaf {prefix}{key}")

    walk(tree["params"], "")
    return out


def flax_tree(module: nn.Module, pick=None) -> dict:
    """The module's parameters in the flax layout, as detached tensors on
    the module's device: ``{"params": {...}}``.  ``pick(param)`` replaces
    each parameter with a tensor of its shape (an optimizer slot, say),
    laid out the same way."""
    pick = pick or (lambda p: p)

    def leaf(p):
        return pick(p).detach()

    root: dict = {}
    for name, mod in module.named_modules():
        if isinstance(mod, nn.Linear):
            features = getattr(mod, "features", (mod.out_features,))
            leaves = {
                "kernel": leaf(mod.weight).T.reshape(
                    mod.in_features, *features
                ),
                "bias": leaf(mod.bias).reshape(features),
            }
        elif isinstance(mod, nn.Embedding):
            leaves = {"embedding": leaf(mod.weight)}
        elif isinstance(mod, nn.LayerNorm):
            leaves = {"scale": leaf(mod.weight), "bias": leaf(mod.bias)}
        elif next(mod.parameters(recurse=False), None) is not None:
            raise TypeError(
                f"no flax layout for {type(mod).__name__} at {name!r}"
            )
        else:
            continue
        node = root
        for part in name.split("."):
            node = node.setdefault(part, {})
        node.update(leaves)
    return {"params": root}


def to_host(tree):
    """Tensor leaves of a nested dict -> numpy arrays that own their
    memory (a CPU tensor's ``.numpy()`` would alias it, and a saved state
    would follow the live parameters); others pass."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True).contiguous().numpy()
    return tree


def params_to_jax(module: nn.Module) -> dict:
    """The module's parameters as the JAX package's flax tree of numpy
    arrays."""
    return to_host(flax_tree(module))
