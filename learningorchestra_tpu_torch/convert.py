"""Weight carry between the JAX package's flax parameter trees and the
port's modules, and state carry for the classical estimators
(:func:`carry_estimator`).

The port's modules name their submodules after the flax tree
(``encoder.TransformerBlock_0.MultiHeadSelfAttention_0.qkv`` is
``params/encoder/TransformerBlock_0/MultiHeadSelfAttention_0/qkv``), so
the carry is a per-leaf layout change:

- ``Dense``/``DenseGeneral`` ``kernel`` (in, *features) <-> ``nn.Linear``
  ``weight`` (prod(features), in); ``bias`` (*features) <-> (prod,);
  a Dense without a bias (the LSTM cell's input kernels) has no ``bias``;
  the long-context attention's ``qkv`` kernel (hidden, 3, H, D) is the
  one 4-D DenseGeneral kernel (its bias (3, H, D));
- ``Conv`` ``kernel`` HWIO (kh, kw, cin/groups, cout) <-> ``nn.Conv2d``
  ``weight`` OIHW (cout, cin/groups, kh, kw); a depthwise kernel
  (kh, kw, 1, C) is (C, 1, kh, kw);
- ``Embed`` ``embedding`` <-> ``nn.Embedding`` ``weight``;
- ``LayerNorm``/``GroupNorm`` ``scale``/``bias`` <-> ``weight``/``bias``;
- a pipelined transformer's parameters (parallel/pipeline.py) are the
  JAX tuple ``(embed, stages, head)``, each a flax tree, the stage trees
  stacked on a leading (pp,) axis: :func:`load_pipeline` carries it into
  the embedding, stage and head modules (stage s from slice s) and
  :func:`pipeline_to_jax` carries the modules back;
- an MoE layer's expert leaves (``ops/moe.py::EXPERT_LEAVES``: the 3-D
  ``expert_w1`` (E, H, M) and ``expert_w2`` (E, M, H), the biases
  (E, M) and (E, H)) keep their names and layouts both ways; its
  ``router`` is a bias-free Dense.  Under expert parallelism a rank
  holds E/ep of them: :func:`split_experts` cuts a tree (parameters,
  optimizer slots, accumulated gradients) to an ep index's experts and
  :func:`join_experts` puts the ep ranks' slices back together in the
  layout above.

A flax tree is the variables dict ``{"params": {...}}`` whose leaves are
numpy arrays (or tensors, e.g. a dequantized artifact on the card).  A
0-d leaf (an optimizer's per-parameter scalar, as novograd's ``nu``)
keeps its layout both ways.  The port's Dense kernels are at most 3-D
but ``qkv``'s, so any other 4-D ``kernel`` is a conv's.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from learningorchestra_tpu_torch.ops.moe import EXPERT_LEAVES, MoEMlp


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    x = np.ascontiguousarray(x)
    # torch cannot alias a read-only array (e.g. one handed out by JAX).
    return torch.from_numpy(x if x.flags.writeable else x.copy())


#: Nodes whose 4-D ``kernel`` is a DenseGeneral's, not a conv's: the
#: long-context attention's ``qkv`` (hidden, 3, H, D).
_DENSE_GENERAL_4D = (".qkv.",)


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
            if key in EXPERT_LEAVES:
                out[prefix + key] = t
            elif t.dim() == 0:
                out[prefix + ("bias" if key == "bias" else "weight")] = t
            elif key == "kernel" and t.dim() == 4 and \
                    not ("." + prefix).endswith(_DENSE_GENERAL_4D):
                out[prefix + "weight"] = t.permute(3, 2, 0, 1).contiguous()
            elif key == "kernel":
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

    def leaf(p, layout=lambda t: t):
        t = pick(p).detach()
        return t if t.dim() == 0 else layout(t)

    root: dict = {}
    for name, mod in module.named_modules():
        if isinstance(mod, nn.Linear):
            features = getattr(mod, "features", (mod.out_features,))
            leaves = {"kernel": leaf(mod.weight, lambda t: t.T.reshape(
                mod.in_features, *features))}
            if mod.bias is not None:
                leaves["bias"] = leaf(mod.bias,
                                      lambda t: t.reshape(features))
        elif isinstance(mod, nn.Conv2d):
            leaves = {"kernel": leaf(mod.weight,
                                     lambda t: t.permute(2, 3, 1, 0))}
            if mod.bias is not None:
                leaves["bias"] = leaf(mod.bias)
        elif isinstance(mod, nn.Embedding):
            leaves = {"embedding": leaf(mod.weight)}
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            leaves = {"scale": leaf(mod.weight), "bias": leaf(mod.bias)}
        elif isinstance(mod, MoEMlp):
            leaves = {key: leaf(getattr(mod, key)) for key in EXPERT_LEAVES}
        elif next(mod.parameters(recurse=False), None) is not None:
            raise TypeError(
                f"no flax layout for {type(mod).__name__} at {name!r}"
            )
        else:
            continue
        node = root
        for part in filter(None, name.split(".")):  # "" is the root
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


def expert_layers(module: nn.Module) -> set:
    """The flax paths (tuples of names) of ``module``'s MoE layers split
    over an expert group (``MoEMlp.bind_experts``)."""
    return {tuple(filter(None, name.split(".")))
            for name, mod in module.named_modules()
            if isinstance(mod, MoEMlp) and mod.ep_group is not None}


def map_expert_leaves(tree, layers: set, fn):
    """``tree`` with ``fn`` applied to every expert leaf of the layers
    ``layers`` (:func:`expert_layers`); ``tree`` is a flax variables tree
    or a state holding such trees (an optimizer's slots, ``acc_grads``),
    each expert leaf found under its layer's path after a ``params`` key.
    A 0-d leaf (a per-leaf scalar) is left as it is."""

    def walk(node, path):
        out = {}
        for key, val in node.items():
            if isinstance(val, dict):
                out[key] = walk(val, path + (key,))
            elif key in EXPERT_LEAVES and getattr(val, "ndim", 0) >= 1 \
                    and "params" in path and path[len(path) - path[
                        ::-1].index("params"):] in layers:
                out[key] = fn(val)
            else:
                out[key] = val
        return out

    return walk(tree, ())


def split_experts(tree, layers: set, index: int, ep: int):
    """Each expert leaf of ``layers`` cut to experts
    ``[index*E/ep, (index+1)*E/ep)``."""
    # Imported here: the parallel package imports this module.
    from learningorchestra_tpu_torch.parallel.sharding import expert_slice

    return map_expert_leaves(
        tree, layers,
        lambda leaf: leaf[expert_slice(leaf.shape[0], index, ep)])


def join_experts(tree, layers: set, gather):
    """Each expert leaf of ``layers`` replaced by ``gather(leaf)``, the ep
    ranks' slices concatenated in ep order (a collective every rank of
    the group makes, leaf by leaf in the same order)."""
    return map_expert_leaves(tree, layers, gather)


def stack_trees(trees: list):
    """Nested dicts of arrays stacked leaf by leaf on a new leading axis
    (the JAX pipeline's (pp, ...) stage stack)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return np.stack([np.asarray(t) for t in trees])


def slice_tree(tree, index: int):
    """Slice ``index`` of every leaf's leading axis."""
    if isinstance(tree, dict):
        return {k: slice_tree(v, index) for k, v in tree.items()}
    return tree[index]


def load_pipeline(params, embed: nn.Module, stages: dict, head: nn.Module
                  ) -> None:
    """Carry the JAX pipeline's ``(embed, stages, head)`` params into the
    port's modules; ``stages`` maps a stage index to its module (a rank
    of the pipeline holds one stage, which loads its slice alone)."""
    ep, sp, hp = params
    embed.load_state_dict(params_from_jax(ep))
    for s, stage in stages.items():
        stage.load_state_dict(params_from_jax(slice_tree(sp, s)))
    head.load_state_dict(params_from_jax(hp))


def pipeline_to_jax(embed: nn.Module, stages: list, head: nn.Module
                    ) -> tuple:
    """The modules as the JAX pipeline's ``(embed, stages, head)`` tuple
    of numpy flax trees, the stages (in order) stacked."""
    return (params_to_jax(embed),
            stack_trees([params_to_jax(st) for st in stages]),
            params_to_jax(head))


def params_to_jax(module: nn.Module) -> dict:
    """The module's parameters as the JAX package's flax tree of numpy
    arrays."""
    return to_host(flax_tree(module))


#: Classical-estimator attributes that stay host numpy in the port
#: (labels and bookkeeping, as the JAX package keeps them).
_HOST_ATTRS = frozenset({"classes_", "labels_", "losses_", "categories_"})


def carry_estimator(est, state: dict):
    """A fitted JAX estimator's state -> the port's estimator ``est`` of
    the same class, on ``est.device``.  ``state`` maps attribute names to
    numpy arrays (a flat tree as the tuple ``(feature, threshold, left,
    right, leaf_value, max_depth)``, a forest as its five padded arrays);
    arrays become tensors except labels and bookkeeping, Python scalars
    stay as they are.  An ``SVC``'s ``_w``/``_b`` pin its feature map, so
    a fit after the carry runs on the JAX package's draw."""
    from learningorchestra_tpu_torch.toolkit.estimators import svm, trees

    def place(key, value):
        if key in _HOST_ATTRS:
            return value
        if isinstance(value, (tuple, list)):
            out = [place(None, v) for v in value]
            return trees._FlatTree(*out[:5], int(out[5])) \
                if key == "_tree" else tuple(out)
        if isinstance(value, np.ndarray):
            dtype = torch.int64 if value.dtype.kind in "iu" else \
                torch.float32
            return torch.as_tensor(np.array(value), dtype=dtype,
                                   device=est.device)
        return value

    for key, value in state.items():
        setattr(est, key, place(key, value))
    if isinstance(est, svm.SVC) and state.get("_w") is not None:
        est.pin_feature_map(state["_w"], state["_b"])
    return est
