"""Attention layer — port of ``learningorchestra_tpu/ops/layers.py``.

``MultiHeadSelfAttention`` is the transformer models' attention layer:
QKV and output projections around :func:`flash_attention`, which runs
kernel K1 on CUDA tensors and its plain version on CPU tensors.  Only the
non-decode branch is ported; the KV cache, rope and remat come with the
LM slice.

Submodule and parameter names follow the flax tree (``qkv``, ``out``,
``query``/``key``/``value``) so ``convert.py`` maps one onto the other by
name.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from learningorchestra_tpu_torch.ops.attention import flash_attention


class Dense(nn.Linear):
    """``nn.Linear`` that remembers the flax feature shape of its output
    (``DenseGeneral((heads, head_dim))`` flattens to ``heads*head_dim``
    outputs here), so the weight carry can restore the flax kernel
    ``(in, *features)``."""

    def __init__(self, in_features: int, features, **kw):
        self.features = (
            (int(features),) if np.isscalar(features)
            else tuple(int(f) for f in features)
        )
        super().__init__(in_features, math.prod(self.features), **kw)


class MultiHeadSelfAttention(nn.Module):
    """Self-attention with a key-side padding mask (B, T).

    ``fused_qkv`` keeps one (H + 2*H_kv, head_dim) projection (the JAX
    default); ``num_kv_heads`` < ``num_heads`` is grouped-query attention,
    each KV head widened to its group of query heads before the kernel.
    """

    def __init__(self, num_heads: int, qkv_features: int, *,
                 num_kv_heads: int | None = None, causal: bool = False,
                 window: int | None = None, fused_qkv: bool = True):
        super().__init__()
        head_dim = qkv_features // num_heads
        if head_dim * num_heads != qkv_features:
            raise ValueError("qkv_features must be divisible by num_heads")
        kv_heads = num_heads if num_kv_heads is None else num_kv_heads
        if kv_heads < 1:
            raise ValueError(f"num_kv_heads must be >= 1, got {kv_heads}")
        if num_heads % kv_heads:
            raise ValueError(
                f"num_heads={num_heads} not divisible by "
                f"num_kv_heads={kv_heads}"
            )
        self.num_heads = num_heads
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.qkv_features = qkv_features
        self.causal = causal
        self.window = window
        self.fused_qkv = fused_qkv
        if fused_qkv:
            self.qkv = Dense(
                qkv_features, (num_heads + 2 * kv_heads, head_dim)
            )
        else:
            self.query = Dense(qkv_features, (num_heads, head_dim))
            self.key = Dense(qkv_features, (kv_heads, head_dim))
            self.value = Dense(qkv_features, (kv_heads, head_dim))
        self.out = Dense(qkv_features, qkv_features)

    def forward(self, x, key_mask=None):
        b, t, _ = x.shape
        h, hkv, hd = self.num_heads, self.kv_heads, self.head_dim
        if self.fused_qkv:
            # (B, T, H+2H_kv, hd) -> (B, H+2H_kv, T, hd) views: the kernel
            # takes their strides as they are, no copy.
            qkv = self.qkv(x).view(b, t, h + 2 * hkv, hd).transpose(1, 2)
            q = qkv[:, :h]
            k = qkv[:, h:h + hkv]
            v = qkv[:, h + hkv:]
        else:
            def proj(layer, heads):
                return layer(x).view(b, t, heads, hd).transpose(1, 2)

            q = proj(self.query, h)
            k = proj(self.key, hkv)
            v = proj(self.value, hkv)

        def widen(kv):
            if hkv == h:
                return kv
            return kv.repeat_interleave(h // hkv, dim=1)

        out = flash_attention(
            q, widen(k), widen(v), key_mask,
            causal=self.causal, window=self.window,
        )  # (B, H, T, hd)
        out = out.transpose(1, 2).reshape(b, t, self.qkv_features)
        return self.out(out)


def migrate_separate_qkv(tree):
    """Convert a legacy separate-projection parameter tree
    (query/key/value DenseGeneral triplets) to the fused ``qkv`` layout —
    the exact block-stack the fused layer computes.  Non-matching
    subtrees pass through."""

    def _is_proj(node):
        return isinstance(node, dict) and "kernel" in node

    def walk(node):
        if not isinstance(node, dict):
            return node
        if (
            {"query", "key", "value"} <= set(node)
            and all(_is_proj(node[k]) for k in ("query", "key", "value"))
        ):
            node = dict(node)
            q = node.pop("query")
            k = node.pop("key")
            v = node.pop("value")
            node["qkv"] = {
                "kernel": _cat(
                    [q["kernel"], k["kernel"], v["kernel"]], axis=1
                ),
                "bias": _cat([q["bias"], k["bias"], v["bias"]], axis=0),
            }
        return {kk: walk(vv) for kk, vv in node.items()}

    return walk(tree)


def _cat(parts, axis):
    """Concatenate numpy leaves with numpy, or on the device of the
    first tensor leaf when any is a tensor (a dequantized artifact)."""
    tensors = [p for p in parts if isinstance(p, torch.Tensor)]
    if not tensors:
        return np.concatenate([np.asarray(p) for p in parts], axis=axis)
    dev = tensors[0].device
    return torch.cat(
        [torch.as_tensor(p, device=dev) for p in parts], dim=axis
    )


def has_separate_qkv(tree) -> bool:
    """True when the tree holds legacy query/key/value triplets."""
    if not isinstance(tree, dict):
        return False
    if {"query", "key", "value"} <= set(tree):
        return True
    return any(has_separate_qkv(v) for v in tree.values())
