"""Layers — port of ``learningorchestra_tpu/ops/layers.py``, plus the
flax layers the port's models need in torch's terms.

``MultiHeadSelfAttention`` is the transformer models' attention layer:
QKV and output projections around :func:`flash_attention`, which runs
kernel K1 on CUDA tensors and its plain version on CPU tensors.  Only the
non-decode branch is ported; the KV cache and rope come with the LM
slice.  :func:`remat_block` is the family-wide ``remat`` knob on
``torch.utils.checkpoint``.  :class:`Conv`, :class:`GroupNorm` and
:func:`max_pool_same` are flax's ``nn.Conv``, ``nn.GroupNorm`` and
``nn.max_pool(padding="SAME")`` on NCHW activations, with flax's padding
and epsilon.

Submodule and parameter names follow the flax tree (``qkv``, ``out``,
``query``/``key``/``value``) so ``convert.py`` maps one onto the other by
name.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils import checkpoint as _ckpt

from learningorchestra_tpu_torch.ops.attention import flash_attention

# Under remat="dots" these outputs stay saved and the rest is recomputed
# in the backward pass (the JAX package saves its dot_generals).
_SAVED_OPS = (
    torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
    torch.ops.aten.bmm.default, torch.ops.aten.convolution.default,
)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_OPS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat_block(cls, remat):
    """Wrap a block module class per the family-wide ``remat`` knob.

    ``False`` — the class as it is.  ``True`` — the block's forward runs
    under ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in the backward pass.  ``"dots"`` — matmul and conv outputs
    stay saved and only the rest is recomputed (a selective checkpoint).
    The subclass keeps the block's submodules, so parameter names do not
    change with ``remat``.

    The recomputation reads the parameters the forward read: the fit
    loop swaps bf16 copies in with ``functional_call`` only for the
    forward, so the block hands the tensors it saw to the checkpoint."""
    if not remat:
        return cls
    if remat == "dots":
        context_fn = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _dots_policy)
    elif remat is True:
        context_fn = _ckpt.noop_context_fn
    else:
        raise ValueError(f"remat must be False|True|'dots', got {remat!r}")

    class Remat(cls):
        _replaying = False

        def forward(self, *args, **kwargs):
            if self._replaying or not torch.is_grad_enabled():
                return super().forward(*args, **kwargs)
            return _ckpt.checkpoint(
                self._replay, dict(self.named_parameters()), *args,
                use_reentrant=False, context_fn=context_fn, **kwargs)

        def _replay(self, params, *args, **kwargs):
            self._replaying = True
            try:
                return functional_call(self, params, args, kwargs)
            finally:
                self._replaying = False

    Remat.__name__ = Remat.__qualname__ = cls.__name__
    return Remat


def _same_pads(size, kernel, stride) -> tuple[int, int]:
    """flax/XLA SAME padding of one spatial axis: (low, high), the odd
    element at the high end (a strided or even-kernel conv pads
    asymmetrically)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` (SAME padding) on NCHW activations.  Symmetric
    padding goes to the convolution itself; an asymmetric one is an
    explicit ``F.pad`` first (torch's ``padding=`` would shift the
    windows)."""

    def __init__(self, in_channels: int, features: int, kernel_size,
                 strides=(1, 1), *, use_bias: bool = True, groups: int = 1):
        super().__init__(in_channels, features, kernel_size, stride=strides,
                         padding=0, bias=use_bias, groups=groups)

    def forward(self, x):
        (ht, hb), (wl, wr) = (
            _same_pads(n, k, s) for n, k, s in
            zip(x.shape[-2:], self.kernel_size, self.stride))
        if ht == hb and wl == wr:
            return F.conv2d(x, self.weight, self.bias, self.stride,
                            (ht, wl), 1, self.groups)
        x = F.pad(x, (wl, wr, ht, hb))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, 1,
                        self.groups)


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm``: epsilon 1e-6 (torch's default is 1e-5)."""

    def __init__(self, num_groups: int, channels: int):
        super().__init__(num_groups, channels, eps=1e-6)


def max_pool_same(x, window: int, stride: int):
    """``nn.max_pool(x, (w, w), (s, s), padding="SAME")`` on NCHW: the
    SAME pads hold -inf."""
    (ht, hb), (wl, wr) = (_same_pads(n, window, stride)
                          for n in x.shape[-2:])
    if ht or hb or wl or wr:
        x = F.pad(x, (wl, wr, ht, hb), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


class Dense(nn.Linear):
    """``nn.Linear`` that remembers the flax feature shape of its output
    (``DenseGeneral((heads, head_dim))`` flattens to ``heads*head_dim``
    outputs here), so the weight carry can restore the flax kernel
    ``(in, *features)``.  ``init`` names the seeded init of its kernel
    (``train/neural.py::init_params``): ``"lecun"`` (flax's Dense
    default) or ``"orthogonal"`` (an LSTM cell's recurrent kernels)."""

    def __init__(self, in_features: int, features, *, init: str = "lecun",
                 **kw):
        self.features = (
            (int(features),) if np.isscalar(features)
            else tuple(int(f) for f in features)
        )
        self.init = init
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
