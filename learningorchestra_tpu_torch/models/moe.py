"""Mixture-of-experts transformers — port of
``learningorchestra_tpu/models/moe.py``: the routed expert FFN
(``ops/moe.py``) in the port's attention stack, MoE blocks interleaved
with dense ones (GShard's every-other-layer pattern).  Parameters grow
with ``num_experts`` while the FLOPs per token stay about those of one
dense FFN times ``top_k``.

``MoETransformerClassifier`` pools position 0 through the tanh [CLS]
head; ``MoEDecoderLM`` is causal with a per-token LM head and the KV
decode cache of ``models/text.py`` (``generate``, and the decode engine's
``module(tok, positions=, key_mask=, cache=)`` step).  Submodules carry
the flax tree's names (``MoEBlock_1.MoEMlp_0.router``,
``TransformerBlock_0``...), which is what ``convert.py`` maps by.

The forward takes ``aux_losses``: given a list, every MoE block appends
its auxiliary loss to it (the JAX modules' ``sow("losses", ...)``); the
fit loop adds their sum to the objective (``train/neural.py``).

Both models train expert-parallel: in a rank of a fit over an ``ep``
mesh axis, ``bind_experts`` splits each MoE layer's experts over the
rank's expert group for the length of the fit (``parallel/rank.py``,
as ``ring_bound`` binds the long-context model).  The estimators of a
server, its predict, ``/generate`` and the captured decode graph are
never bound.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from learningorchestra_tpu_torch.models.text import (
    _LN_EPS,
    GreedyDecodeMixin,
    TransformerBlock,
    _check_tokens,
    cls_head,
    embed_tokens,
)
from learningorchestra_tpu_torch.ops.layers import (
    Dense,
    MultiHeadSelfAttention,
)
from learningorchestra_tpu_torch.ops.moe import MoEMlp
from learningorchestra_tpu_torch.toolkit.registry import register
from learningorchestra_tpu_torch.train.neural import NeuralEstimator

_MODULE = __name__


class MoETransformerBlock(nn.Module):
    """Pre-LN transformer block whose FFN is a routed expert layer."""

    def __init__(self, hidden_dim: int, num_heads: int, mlp_dim: int,
                 num_experts: int, *, top_k: int = 2,
                 capacity_factor: float = 1.5, causal: bool = False,
                 window: int | None = None):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(hidden_dim, eps=_LN_EPS)
        self.MultiHeadSelfAttention_0 = MultiHeadSelfAttention(
            num_heads, hidden_dim, causal=causal, window=window)
        self.LayerNorm_1 = nn.LayerNorm(hidden_dim, eps=_LN_EPS)
        self.MoEMlp_0 = MoEMlp(num_experts, hidden_dim, mlp_dim,
                               top_k=top_k, capacity_factor=capacity_factor)

    def forward(self, x, key_mask=None, cache=None, aux_losses=None):
        y = self.MultiHeadSelfAttention_0(self.LayerNorm_0(x), key_mask,
                                          cache)
        x = x + y
        return x + self.MoEMlp_0(self.LayerNorm_1(x), aux_losses)


class _MoETransformer(nn.Module):
    """Encoder (``head="cls"``) or causal decoder (``head="lm"``) trunk
    with an MoE FFN on the LAST block of each ``moe_every`` group, so a
    1-layer net is still dense-first (the router sees features)."""

    # The fit loop passes ``aux_losses`` to this forward
    # (train/neural.py::_train_step).
    takes_aux_losses = True

    def __init__(self, vocab_size: int, hidden_dim: int, num_layers: int,
                 num_heads: int, mlp_dim: int, max_len: int,
                 num_experts: int, num_classes: int, *, head: str = "cls",
                 moe_every: int = 2, top_k: int = 2,
                 capacity_factor: float = 1.5, window: int | None = None):
        super().__init__()
        if head not in ("cls", "lm"):
            raise ValueError(f"head must be cls|lm, got {head!r}")
        self.head = head
        self.num_layers = num_layers
        self.moe_every = moe_every
        causal = head == "lm"
        window = window if causal else None
        self.Embed_0 = nn.Embedding(vocab_size, hidden_dim)
        self.Embed_1 = nn.Embedding(max_len, hidden_dim)
        for i in range(num_layers):
            if (i + 1) % moe_every == 0:
                setattr(self, f"MoEBlock_{i}", MoETransformerBlock(
                    hidden_dim, num_heads, mlp_dim, num_experts,
                    top_k=top_k, capacity_factor=capacity_factor,
                    causal=causal, window=window))
            else:
                setattr(self, f"TransformerBlock_{i}", TransformerBlock(
                    hidden_dim, num_heads, mlp_dim, causal=causal,
                    window=window))
        self.LayerNorm_0 = nn.LayerNorm(hidden_dim, eps=_LN_EPS)
        if causal:
            self.Dense_0 = Dense(hidden_dim, vocab_size)
        else:
            self.Dense_0 = Dense(hidden_dim, hidden_dim)
            self.Dense_1 = Dense(hidden_dim, num_classes)

    def block_names(self) -> list[str]:
        return [f"MoEBlock_{i}" if (i + 1) % self.moe_every == 0
                else f"TransformerBlock_{i}" for i in range(self.num_layers)]

    def init_cache(self, batch: int, length: int, *, per_row: bool = False,
                   device=None) -> dict:
        """Every layer's empty KV cache of ``length`` positions, by block
        name (the flax ``cache`` collection's tree)."""
        return {
            name: {"MultiHeadSelfAttention_0": getattr(
                self, name).MultiHeadSelfAttention_0.init_cache(
                    batch, length, per_row=per_row, device=device)}
            for name in self.block_names()
        }

    def forward(self, tokens, positions=None, key_mask=None, cache=None,
                aux_losses=None):
        tokens = tokens.to(torch.int64)
        x = embed_tokens(tokens, self.Embed_0, self.Embed_1, positions)
        if key_mask is None:
            key_mask = tokens != 0  # (B, T), pad id 0
        for name in self.block_names():
            blk = getattr(self, name)
            layer = None if cache is None else \
                cache[name]["MultiHeadSelfAttention_0"]
            if isinstance(blk, MoETransformerBlock):
                x = blk(x, key_mask, layer, aux_losses)
            else:
                x = blk(x, key_mask, layer)
        x = self.LayerNorm_0(x)
        if self.head == "lm":
            return self.Dense_0(x)  # (B, T, V)
        return cls_head(x, self.Dense_0, self.Dense_1)


#: Optimizers whose update reads a whole leaf's norm (lamb's trust ratio,
#: novograd's second moment): an expert slice's norm is not the leaf's.
_LEAF_NORM_OPTIMIZERS = ("lamb", "novograd")


class _ExpertParallel:
    """``bind_experts`` for an estimator whose module holds MoE layers."""

    def bind_experts(self, group) -> list[str]:
        """Split every MoE layer whose expert count divides by
        ``group.size`` over the expert group ``group`` (a rank's
        ``GroupComm``): the rank holds and computes ``group.index``'s
        E/ep experts of each.  The parameters are replaced, so a rank
        binds before it loads its state.  Returns the split layers'
        names."""
        if group.size > 1 and self.optimizer.name in _LEAF_NORM_OPTIMIZERS:
            raise ValueError(
                f"optimizer {self.optimizer.name!r} reads each leaf's norm;"
                " an expert-parallel rank holds a slice of the expert "
                "leaves (use another optimizer, or ep=1)")
        split = [name for name, mod in self.module.named_modules()
                 if isinstance(mod, MoEMlp) and mod.bind_experts(group)]
        self.opt_state = None
        self._invalidate_programs()
        return split


@register(_MODULE)
class MoETransformerClassifier(_ExpertParallel, NeuralEstimator):
    """Sequence classifier with routed-expert FFNs."""

    def __init__(
        self,
        vocab_size: int = 20000,
        hidden_dim: int = 128,
        num_layers: int = 2,
        num_heads: int = 4,
        mlp_dim: int | None = None,
        max_len: int = 256,
        num_experts: int = 8,
        top_k: int = 2,
        capacity_factor: float = 1.5,
        moe_every: int = 2,
        num_classes: int = 2,
        learning_rate: float = 1e-3,
        seed: int = 0,
        device="cuda",
    ):
        self.vocab_size = vocab_size
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.mlp_dim = mlp_dim or hidden_dim * 4
        self.max_len = max_len
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.moe_every = moe_every
        self.num_classes = num_classes
        super().__init__(
            _MoETransformer(
                vocab_size, hidden_dim, num_layers, num_heads, self.mlp_dim,
                max_len, num_experts, num_classes, head="cls",
                moe_every=moe_every, top_k=top_k,
                capacity_factor=capacity_factor,
            ),
            loss="softmax_ce",
            learning_rate=learning_rate,
            seed=seed,
            device=device,
        )

    def check_input(self, x: np.ndarray) -> None:
        _check_tokens(x, self.vocab_size, self.max_len)


@register(_MODULE)
class MoEDecoderLM(_ExpertParallel, GreedyDecodeMixin, NeuralEstimator):
    """Causal LM with routed-expert FFNs (a sparse GPT shape).

    ``fit(x, y)`` with y the next-token targets; ``generate`` decodes
    through the KV cache, one position per step, each batch row its own
    routing group: with top-2 of E >= 2 experts a one-token step is
    drop-free (``cap`` >= 1 per expert and the two choices differ)."""

    def __init__(
        self,
        vocab_size: int = 32000,
        hidden_dim: int = 256,
        num_layers: int = 4,
        num_heads: int = 8,
        mlp_dim: int | None = None,
        max_len: int = 1024,
        num_experts: int = 8,
        top_k: int = 2,
        capacity_factor: float = 1.5,
        moe_every: int = 2,
        learning_rate: float = 3e-4,
        seed: int = 0,
        attention_window: int | None = None,
        device="cuda",
    ):
        self.vocab_size = vocab_size
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.mlp_dim = mlp_dim or hidden_dim * 4
        self.max_len = max_len
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.moe_every = moe_every
        self.attention_window = attention_window
        super().__init__(
            _MoETransformer(
                vocab_size, hidden_dim, num_layers, num_heads, self.mlp_dim,
                max_len, num_experts, vocab_size, head="lm",
                moe_every=moe_every, top_k=top_k,
                capacity_factor=capacity_factor, window=attention_window,
            ),
            loss="softmax_ce",
            learning_rate=learning_rate,
            seed=seed,
            device=device,
        )

    def check_input(self, x: np.ndarray) -> None:
        _check_tokens(x, self.vocab_size, self.max_len)
