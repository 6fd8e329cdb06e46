"""Long-context transformer — port of
``learningorchestra_tpu/models/longcontext.py``.

A pre-LN encoder classifier whose attention (``RingSelfAttention``,
parallel/ring_attention.py) runs as ring attention once a ring of more
than one rank is bound: each rank of a sequence-parallel fit holds T/sp
of every row and the key/value blocks travel the ring.  Unbound, the
same parameters run flash attention over the whole sequence (K1, and
K2/K3 in the backward, on a card), so the parameter tree is the same
either way: the ring is runtime state, not architecture.

``DistributedTrainer`` with an ``sp`` axis binds each rank's ring for the
length of its call (``bind_mesh``); the estimator's own ``predict`` and
every artifact see the unbound model, and a pickled module keeps no ring
(``RingBound.__getstate__``, the JAX estimator's ``__getstate__``).
Under a ring, positions are global (rank ``s`` embeds
``s * T_loc + arange(T_loc)``) and the mean pool's cross-rank sum is a
differentiable all-reduce over the ring.

Submodules carry the flax tree's names (``Embed_0``, ``Embed_1``,
``_LongBlock_<i>`` with ``attention.qkv`` (hidden, 3, H, D) and
``attention.out``, ``LayerNorm_0``, ``Dense_0``), which ``convert.py``
maps by.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from learningorchestra_tpu_torch.models.text import _LN_EPS, _check_tokens
from learningorchestra_tpu_torch.ops.layers import Dense
from learningorchestra_tpu_torch.parallel.ring_attention import (
    Ring,
    RingBound,
    RingSelfAttention,
    ring_sum,
)
from learningorchestra_tpu_torch.toolkit.registry import register
from learningorchestra_tpu_torch.train.neural import NeuralEstimator

_MODULE = __name__


class _LongBlock(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int, mlp_dim: int,
                 causal: bool):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(hidden_dim, eps=_LN_EPS)
        self.attention = RingSelfAttention(num_heads, hidden_dim,
                                           causal=causal)
        self.LayerNorm_1 = nn.LayerNorm(hidden_dim, eps=_LN_EPS)
        self.Dense_0 = Dense(hidden_dim, mlp_dim)
        self.Dense_1 = Dense(mlp_dim, hidden_dim)

    def forward(self, x, kmask):
        x = x + self.attention(self.LayerNorm_0(x), kmask)
        y = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_1(y)


class _LongClassifier(RingBound):
    def __init__(self, vocab_size: int, hidden_dim: int, num_layers: int,
                 num_heads: int, mlp_dim: int, max_len: int,
                 num_classes: int, causal: bool):
        super().__init__()
        self.num_layers = num_layers
        self.Embed_0 = nn.Embedding(vocab_size, hidden_dim)
        self.Embed_1 = nn.Embedding(max_len, hidden_dim)
        for i in range(num_layers):
            setattr(self, f"_LongBlock_{i}",
                    _LongBlock(hidden_dim, num_heads, mlp_dim, causal))
        self.LayerNorm_0 = nn.LayerNorm(hidden_dim, eps=_LN_EPS)
        self.Dense_0 = Dense(hidden_dim, num_classes)

    def forward(self, tokens):
        tokens = tokens.to(torch.int64)
        t = tokens.shape[1]
        ring = self._ring
        start = 0 if ring is None else ring.index * t
        x = self.Embed_0(tokens) + self.Embed_1(
            torch.arange(start, start + t, device=tokens.device))[None]
        kmask = tokens != 0
        for i in range(self.num_layers):
            x = getattr(self, f"_LongBlock_{i}")(x, kmask)
        x = self.LayerNorm_0(x)
        # Mean-pool the valid positions; under a ring the sums run over
        # every rank's block (in f32: the sum crosses ranks).
        m = kmask.to(torch.float32)[..., None]
        total = (x.float() * m).sum(1)
        count = m.sum(1)
        if ring is not None and ring.size > 1:
            total = ring_sum(total, ring)
            count = ring.all_reduce(count)
        pooled = (total / torch.clamp_min(count, 1.0)).to(x.dtype)
        return self.Dense_0(pooled)


@register(_MODULE)
class LongContextTransformer(NeuralEstimator):
    """Sequence-parallel transformer classifier.

    Train on one device like any estimator, or through
    ``DistributedTrainer(est, spec=MeshSpec(sp=...))`` for sequences that
    do not fit one device: each rank then holds T/sp of every row."""

    def __init__(
        self,
        vocab_size: int = 32000,
        hidden_dim: int = 256,
        num_layers: int = 4,
        num_heads: int = 8,
        mlp_dim: int | None = None,
        max_len: int = 65536,
        num_classes: int = 2,
        causal: bool = False,
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
        self.num_classes = num_classes
        self.causal = causal
        super().__init__(
            _LongClassifier(vocab_size, hidden_dim, num_layers, num_heads,
                            self.mlp_dim, max_len, num_classes, causal),
            loss="softmax_ce",
            learning_rate=learning_rate,
            seed=seed,
            device=device,
        )

    def bind_mesh(self, ring: Ring | None) -> None:
        """Run attention over ``ring`` (None: over the whole sequence on
        this device).  Parameters are untouched; the cached programs,
        keyed by the module's fingerprint (which reads the ring's size),
        are resolved again."""
        self.module.bind_ring(ring)
        self._invalidate_programs()

    def check_input(self, x: np.ndarray) -> None:
        _check_tokens(x, self.vocab_size, self.max_len)
