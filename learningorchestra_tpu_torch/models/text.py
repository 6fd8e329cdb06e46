"""Text models — port of ``learningorchestra_tpu/models/text.py``: the
BERT encoder, its classifier head and the estimators over them
(``BertModel``, BASELINE config 4; ``TransformerClassifier``).

Parity with the flax modules: ``LayerNorm`` eps 1e-6, ``gelu`` in its
tanh form, pre-LN blocks, learned positions, pad id 0 masking keys, the
[CLS] head pooling position 0.  Submodules carry the flax tree's names
(``Embed_0``, ``TransformerBlock_3``, ``Dense_1``...), which is what
``convert.py`` maps by.  ``LSTMClassifier`` and ``DecoderLM`` come with
later slices.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from learningorchestra_tpu_torch.ops.layers import Dense, MultiHeadSelfAttention
from learningorchestra_tpu_torch.toolkit.registry import register
from learningorchestra_tpu_torch.train.neural import NeuralEstimator

_MODULE = __name__
_LN_EPS = 1e-6  # flax.linen.LayerNorm's default


def embed_tokens(tokens, token_table: nn.Embedding,
                 position_table: nn.Embedding, positions=None):
    """Token + learned positional embedding (pad id 0 convention)."""
    if positions is None:
        positions = torch.arange(tokens.shape[-1], device=tokens.device)[None]
    return token_table(tokens) + position_table(positions)


def cls_head(x, pooler: nn.Linear, classifier: nn.Linear):
    """[CLS]-pool position 0 through a tanh projection + classifier."""
    return classifier(torch.tanh(pooler(x[:, 0])))


class TransformerBlock(nn.Module):
    """Pre-LN block over the port's attention layer (kernel K1 on CUDA)."""

    def __init__(self, hidden_dim: int, num_heads: int, mlp_dim: int, *,
                 num_kv_heads: int | None = None, causal: bool = False,
                 window: int | None = None):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(hidden_dim, eps=_LN_EPS)
        self.MultiHeadSelfAttention_0 = MultiHeadSelfAttention(
            num_heads, hidden_dim, num_kv_heads=num_kv_heads,
            causal=causal, window=window,
        )
        self.LayerNorm_1 = nn.LayerNorm(hidden_dim, eps=_LN_EPS)
        self.Dense_0 = Dense(hidden_dim, mlp_dim)
        self.Dense_1 = Dense(mlp_dim, hidden_dim)

    def forward(self, x, key_mask=None):
        y = self.MultiHeadSelfAttention_0(self.LayerNorm_0(x), key_mask)
        x = x + y
        y = self.Dense_0(self.LayerNorm_1(x))
        y = F.gelu(y, approximate="tanh")  # flax nn.gelu is the tanh form
        return x + self.Dense_1(y)


class BertEncoder(nn.Module):
    """BERT-style bidirectional transformer encoder (pre-LN)."""

    def __init__(self, vocab_size: int = 30522, hidden_dim: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, max_len: int = 512):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.Embed_0 = nn.Embedding(vocab_size, hidden_dim)
        self.Embed_1 = nn.Embedding(max_len, hidden_dim)
        for i in range(num_layers):
            setattr(self, f"TransformerBlock_{i}", TransformerBlock(
                hidden_dim, num_heads, mlp_dim,
            ))
        self.LayerNorm_0 = nn.LayerNorm(hidden_dim, eps=_LN_EPS)

    def forward(self, tokens):
        tokens = tokens.to(torch.int64)
        x = embed_tokens(tokens, self.Embed_0, self.Embed_1)
        # Key-side padding mask (pad id 0): exact for every non-pad query
        # row; pad query rows produce values no one reads.  An all-pad row
        # masks every key and attends to nothing (O = 0).
        pad_mask = tokens != 0
        for i in range(self.num_layers):
            x = getattr(self, f"TransformerBlock_{i}")(x, pad_mask)
        return self.LayerNorm_0(x)


class _BertClassifier(nn.Module):
    def __init__(self, encoder: BertEncoder, num_classes: int):
        super().__init__()
        self.encoder = encoder
        self.Dense_0 = Dense(encoder.hidden_dim, encoder.hidden_dim)
        self.Dense_1 = Dense(encoder.hidden_dim, num_classes)

    def forward(self, tokens):
        return cls_head(self.encoder(tokens), self.Dense_0, self.Dense_1)


@register(_MODULE)
class BertModel(NeuralEstimator):
    """BERT encoder + classification head.

    Defaults are BERT-base (L=12, H=768, A=12) per BASELINE.md config 4;
    shrink for tests with num_layers/hidden_dim kwargs.
    """

    def __init__(
        self,
        vocab_size: int = 30522,
        hidden_dim: int = 768,
        num_layers: int = 12,
        num_heads: int = 12,
        mlp_dim: int | None = None,
        max_len: int = 512,
        num_classes: int = 2,
        seed: int = 0,
        device="cuda",
    ):
        self.vocab_size = vocab_size
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.mlp_dim = mlp_dim or hidden_dim * 4
        self.max_len = max_len
        self.num_classes = num_classes
        encoder = BertEncoder(
            vocab_size=vocab_size,
            hidden_dim=hidden_dim,
            num_layers=num_layers,
            num_heads=num_heads,
            mlp_dim=self.mlp_dim,
            max_len=max_len,
        )
        super().__init__(
            _BertClassifier(encoder, num_classes), seed=seed, device=device,
        )

    def check_input(self, x: np.ndarray) -> None:
        if x.ndim != 2 or not np.issubdtype(x.dtype, np.integer):
            raise ValueError(
                f"expected a 2-D integer token matrix, got {x.dtype} "
                f"{x.shape}"
            )
        if not 1 <= x.shape[1] <= self.max_len:
            raise ValueError(
                f"sequence length {x.shape[1]} outside 1..{self.max_len}"
            )
        if x.size and (x.min() < 0 or x.max() >= self.vocab_size):
            raise ValueError(
                f"token ids must lie in [0, {self.vocab_size})"
            )


@register(_MODULE)
class TransformerClassifier(BertModel):
    """Small-transformer alias with test-friendly defaults."""

    def __init__(
        self,
        vocab_size: int = 20000,
        hidden_dim: int = 128,
        num_layers: int = 2,
        num_heads: int = 4,
        max_len: int = 256,
        num_classes: int = 2,
        seed: int = 0,
        device="cuda",
    ):
        super().__init__(
            vocab_size=vocab_size,
            hidden_dim=hidden_dim,
            num_layers=num_layers,
            num_heads=num_heads,
            max_len=max_len,
            num_classes=num_classes,
            seed=seed,
            device=device,
        )
