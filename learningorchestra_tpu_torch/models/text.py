"""Text models — port of ``learningorchestra_tpu/models/text.py``: the
LSTM sentiment classifier (``LSTMClassifier``, BASELINE config 3), the
BERT encoder, its classifier head and the estimators over them
(``BertModel``, BASELINE config 4; ``TransformerClassifier``), and the
causal language model ``DecoderLM`` with its KV-cache ``generate``.

Parity with the flax modules: ``LayerNorm`` eps 1e-6, ``gelu`` in its
tanh form, pre-LN blocks, learned positions, pad id 0 masking keys, the
[CLS] head pooling position 0; the LSTM runs over every position, pad
tokens included, then mean-pools the non-pad ones.  Submodules carry the
flax tree's names (``Embed_0``, ``TransformerBlock_3``,
``OptimizedLSTMCell_0.hf``, ``Dense_1``...), which is what ``convert.py``
maps by.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from learningorchestra_tpu_torch.ops.layers import (
    Dense,
    MultiHeadSelfAttention,
    remat_block,
)
from learningorchestra_tpu_torch.toolkit.registry import register
from learningorchestra_tpu_torch.train import aot_store
from learningorchestra_tpu_torch.train import compile_cache as cc
from learningorchestra_tpu_torch.train.neural import NeuralEstimator

_MODULE = __name__
_LN_EPS = 1e-6  # flax.linen.LayerNorm's default


_GATES = ("i", "f", "g", "o")  # torch's packed order; flax names them so


class OptimizedLSTMCell(nn.Module):
    """flax ``nn.OptimizedLSTMCell`` with its per-gate leaves as they are
    in the flax tree: input kernels ``ii``/``if``/``ig``/``io`` (no bias)
    and hidden kernels ``hi``/``hf``/``hg``/``ho`` with one bias each.

    Each gate is its own parameter, so per-leaf optimizer statistics
    (lamb's trust ratio, novograd's ``nu``) see flax's leaves, and there is
    one trainable bias per gate (``nn.LSTM`` trains two, ``bias_ih`` and
    ``bias_hh``, which double the bias's step).  :meth:`run` packs the
    gates in torch's order (i, f, g, o) into one flat buffer each call and
    runs the fused LSTM (cuDNN on the card) with a zero ``bias_hh``."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for gate in _GATES:
            setattr(self, f"i{gate}", Dense(in_features, hidden, bias=False))
        for gate in _GATES:
            setattr(self, f"h{gate}", Dense(hidden, hidden,
                                            init="orthogonal"))

    def run(self, x):
        """(B, T, E) -> every position's hidden state (B, T, H), from a
        zero carry."""
        h = self.hidden
        parts = [getattr(self, f"i{g}").weight for g in _GATES] + \
            [getattr(self, f"h{g}").weight for g in _GATES] + \
            [getattr(self, f"h{g}").bias for g in _GATES]
        parts.append(parts[-1].new_zeros(4 * h))  # bias_hh
        # One contiguous buffer in cuDNN's order [w_ih | w_hh | b_ih |
        # b_hh]: cuDNN takes it as its weight buffer as it is (separate
        # tensors would be repacked each call, with a warning).
        flat = torch.cat([p.reshape(-1) for p in parts])
        n_ih, n_hh = 4 * h * x.shape[-1], 4 * h * h
        weights = [flat[:n_ih].view(4 * h, -1),
                   flat[n_ih:n_ih + n_hh].view(4 * h, h),
                   flat[n_ih + n_hh:n_ih + n_hh + 4 * h],
                   flat[n_ih + n_hh + 4 * h:]]
        zeros = x.new_zeros(1, x.shape[0], h)
        out, _, _ = torch.lstm(x, (zeros, zeros), weights, True, 1, 0.0,
                               self.training, False, True)
        return out


class _LSTMClassifier(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int, hidden_dim: int,
                 num_classes: int):
        super().__init__()
        self.Embed_0 = nn.Embedding(vocab_size, embed_dim)
        self.OptimizedLSTMCell_0 = OptimizedLSTMCell(embed_dim, hidden_dim)
        self.Dense_0 = Dense(hidden_dim, num_classes)

    def forward(self, tokens):
        tokens = tokens.to(torch.int64)
        x = self.OptimizedLSTMCell_0.run(self.Embed_0(tokens))  # (B, T, H)
        # Mean-pool over non-pad positions (pad id 0).
        mask = (tokens != 0).to(x.dtype)[..., None]
        pooled = (x * mask).sum(1) / torch.clamp_min(mask.sum(1), 1.0)
        return self.Dense_0(pooled)


def _check_tokens(x: np.ndarray, vocab_size: int, max_len=None) -> None:
    """A 2-D integer token matrix with ids in [0, vocab_size) (checked on
    the host: a bad index on the card would fault the device)."""
    if x.ndim != 2 or not np.issubdtype(x.dtype, np.integer):
        raise ValueError(
            f"expected a 2-D integer token matrix, got {x.dtype} {x.shape}"
        )
    if max_len is not None and not 1 <= x.shape[1] <= max_len:
        raise ValueError(f"sequence length {x.shape[1]} outside 1..{max_len}")
    if x.size and (x.min() < 0 or x.max() >= vocab_size):
        raise ValueError(f"token ids must lie in [0, {vocab_size})")


@register(_MODULE)
class LSTMClassifier(NeuralEstimator):
    """Embedding + LSTM + masked mean pool + Dense (IMDb sentiment,
    BASELINE config 3).  The defaults are the Keras IMDb LSTM example's
    (``max_features=20000``, ``Embedding(20000, 128)``, ``LSTM(128)``).
    Trains in f32: bf16 cell-state drift over T steps is the classic
    failure, so this family opts out of the zoo's mixed precision."""

    def __init__(
        self,
        vocab_size: int = 20000,
        embed_dim: int = 128,
        hidden_dim: int = 128,
        num_classes: int = 2,
        learning_rate: float = 1e-3,
        seed: int = 0,
        device="cuda",
    ):
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.hidden_dim = hidden_dim
        self.num_classes = num_classes
        super().__init__(
            _LSTMClassifier(vocab_size, embed_dim, hidden_dim, num_classes),
            loss="softmax_ce",
            learning_rate=learning_rate,
            seed=seed,
            compute_dtype="float32",
            device=device,
        )

    def check_input(self, x: np.ndarray) -> None:
        _check_tokens(x, self.vocab_size)


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
    """Pre-LN block over the port's attention layer (kernel K1 on CUDA);
    ``rope`` and a decode ``cache`` pass through to the attention."""

    def __init__(self, hidden_dim: int, num_heads: int, mlp_dim: int, *,
                 num_kv_heads: int | None = None, causal: bool = False,
                 window: int | None = None, rope: bool = False):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(hidden_dim, eps=_LN_EPS)
        self.MultiHeadSelfAttention_0 = MultiHeadSelfAttention(
            num_heads, hidden_dim, num_kv_heads=num_kv_heads,
            causal=causal, window=window, rope=rope,
        )
        self.LayerNorm_1 = nn.LayerNorm(hidden_dim, eps=_LN_EPS)
        self.Dense_0 = Dense(hidden_dim, mlp_dim)
        self.Dense_1 = Dense(mlp_dim, hidden_dim)

    def forward(self, x, key_mask=None, cache=None):
        y = self.MultiHeadSelfAttention_0(self.LayerNorm_0(x), key_mask,
                                          cache)
        x = x + y
        y = self.Dense_0(self.LayerNorm_1(x))
        y = F.gelu(y, approximate="tanh")  # flax nn.gelu is the tanh form
        return x + self.Dense_1(y)


class BertEncoder(nn.Module):
    """BERT-style bidirectional transformer encoder (pre-LN)."""

    def __init__(self, vocab_size: int = 30522, hidden_dim: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, max_len: int = 512,
                 remat: bool | str = False):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.Embed_0 = nn.Embedding(vocab_size, hidden_dim)
        self.Embed_1 = nn.Embedding(max_len, hidden_dim)
        # remat recomputes each block's activations in the backward pass;
        # the names stay TransformerBlock_i whether it is on or off.
        block_cls = remat_block(TransformerBlock, remat)
        for i in range(num_layers):
            setattr(self, f"TransformerBlock_{i}", block_cls(
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
    """BERT encoder + classification head (fine-tune surface).

    Defaults are BERT-base (L=12, H=768, A=12) per BASELINE.md config 4,
    fine-tuned at the JAX default learning rate 2e-5; shrink for tests with
    num_layers/hidden_dim kwargs.  Training runs K1 forward and K2/K3
    backward in every layer on CUDA.  ``remat`` (False | True | "dots")
    recomputes each block's activations in the backward pass
    (:func:`~ops.layers.remat_block`), which runs K1 again there.
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
        learning_rate: float = 2e-5,
        seed: int = 0,
        remat: bool | str = False,
        device="cuda",
    ):
        self.vocab_size = vocab_size
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.mlp_dim = mlp_dim or hidden_dim * 4
        self.max_len = max_len
        self.num_classes = num_classes
        self.remat = remat
        encoder = BertEncoder(
            vocab_size=vocab_size,
            hidden_dim=hidden_dim,
            num_layers=num_layers,
            num_heads=num_heads,
            mlp_dim=self.mlp_dim,
            max_len=max_len,
            remat=remat,
        )
        super().__init__(
            _BertClassifier(encoder, num_classes), loss="softmax_ce",
            learning_rate=learning_rate, seed=seed, device=device,
        )

    def check_input(self, x: np.ndarray) -> None:
        _check_tokens(x, self.vocab_size, self.max_len)


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
        learning_rate: float = 1e-3,
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
            learning_rate=learning_rate,
            seed=seed,
            device=device,
        )


class _DecoderLM(nn.Module):
    """GPT-style causal transformer: pre-LN decoder blocks over the causal
    flash kernel, a final LayerNorm and a per-token LM head.  Positions
    are a learned table (``Embed_1``) or rotary inside attention
    (``positional="rope"``, no table)."""

    def __init__(self, vocab_size: int, hidden_dim: int, num_layers: int,
                 num_heads: int, mlp_dim: int, max_len: int, *,
                 remat: bool | str = False, window: int | None = None,
                 num_kv_heads: int | None = None,
                 positional: str = "learned"):
        super().__init__()
        self.num_layers = num_layers
        self.positional = positional
        self.Embed_0 = nn.Embedding(vocab_size, hidden_dim)
        if positional != "rope":
            self.Embed_1 = nn.Embedding(max_len, hidden_dim)
        block_cls = remat_block(TransformerBlock, remat)
        for i in range(num_layers):
            setattr(self, f"TransformerBlock_{i}", block_cls(
                hidden_dim, num_heads, mlp_dim, num_kv_heads=num_kv_heads,
                causal=True, window=window, rope=positional == "rope",
            ))
        self.LayerNorm_0 = nn.LayerNorm(hidden_dim, eps=_LN_EPS)
        self.Dense_0 = Dense(hidden_dim, vocab_size)

    def blocks(self):
        return [getattr(self, f"TransformerBlock_{i}")
                for i in range(self.num_layers)]

    def init_cache(self, batch: int, length: int, *, per_row: bool = False,
                   device=None) -> dict:
        """Every layer's empty KV cache of ``length`` positions, by block
        name (the flax ``cache`` collection's tree)."""
        return {
            f"TransformerBlock_{i}": {"MultiHeadSelfAttention_0":
                                      blk.MultiHeadSelfAttention_0.init_cache(
                                          batch, length, per_row=per_row,
                                          device=device)}
            for i, blk in enumerate(self.blocks())
        }

    def forward(self, tokens, positions=None, key_mask=None, cache=None):
        tokens = tokens.to(torch.int64)
        if self.positional == "rope":
            x = self.Embed_0(tokens)
        else:
            x = embed_tokens(tokens, self.Embed_0, self.Embed_1, positions)
        if key_mask is None:
            key_mask = tokens != 0  # (B, T), pad id 0
        for i, blk in enumerate(self.blocks()):
            layer = None if cache is None else \
                cache[f"TransformerBlock_{i}"]["MultiHeadSelfAttention_0"]
            x = blk(x, key_mask, layer)
        return self.Dense_0(self.LayerNorm_0(x))  # (B, T, V)


def _nucleus(scaled, top_p):
    """Drop the tokens outside the smallest prefix, by descending
    probability, whose mass passes ``top_p``."""
    probs = torch.softmax(scaled, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(srt, dim=-1)
    cut = (csum < top_p).sum(-1, keepdim=True).clamp_max(srt.shape[-1] - 1)
    thresh = srt.gather(-1, cut)
    return torch.where(probs < thresh, -torch.inf, scaled)


class GreedyDecodeMixin:
    """Autoregressive decoding for an estimator whose module maps token ids
    (B, T) to per-token logits (B, T, V) and takes a decode cache."""

    def generate(self, prompts, max_new_tokens: int = 32,
                 temperature: float | None = None,
                 top_k: int | None = None,
                 top_p: float | None = None, seed: int = 0):
        """Continuation of int prompts (B, T0) -> the int32 buffer (B,
        total), total = min(max_len, T0 + max_new_tokens): greedy by f32
        argmax by default, sampled with ``temperature`` (optionally
        ``top_k``- and/or ``top_p``-truncated) from a ``torch.Generator``
        seeded with ``seed``.  Pad id 0 is never sampled.

        KV-cache decoding as the JAX package's scan does it: every buffer
        position is one step (the prompt's too: prefill feeds one token
        per step), each step embeds one token at its position, attends
        against the per-layer cache and writes the next token.  The loop
        makes no host transfer until the end, so the card runs ahead of
        the host as the scan does.  The loop is the cached ``decode``
        program of the prompt's shape (:func:`_decode_program`)."""
        sample = temperature is not None and temperature > 0.0
        if top_k is not None and not sample:
            raise ValueError(
                "top_k requires a positive temperature (top_k without "
                "sampling silently degrades to greedy)"
            )
        if top_p is not None:
            if not sample:
                raise ValueError("top_p requires a positive temperature")
            if not 0.0 < top_p <= 1.0:
                raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if top_k == 1:
            # Deterministic by definition: the greedy path.
            sample, top_k = False, None
        prompts = np.asarray(prompts, dtype=np.int32)
        bsz, t0 = prompts.shape
        if t0 > self.max_len:
            raise ValueError(
                f"prompt length {t0} exceeds max_len={self.max_len}; "
                "truncate the prompt or build the model with a larger "
                "max_len"
            )
        self.check_input(prompts)
        total = min(self.max_len, t0 + max_new_tokens)
        # The solo decode program of this prompt shape, through the
        # process-wide program cache under the JAX ``decode`` key: two
        # estimators of one architecture share it (the module is an
        # argument, never closed over).
        shape_sig = (bsz, total, t0, sample, top_k, top_p is not None)
        key = cc.program_key(
            "decode",
            module=cc.module_fingerprint(self.module),
            optimizer=None,
            loss="-",
            dtype="-",
            shapes=("decode", *shape_sig),
        )
        label = f"decode:{type(self.module).__name__}:b{bsz}:t{total}"
        program = cc.get_cache().get_or_build(
            key, lambda: cc.Program(_decode_program, key, label,
                                    analyze=False), label=label)
        return program(self.module, prompts, total, temperature if sample
                       else None, top_k, top_p, seed)


@aot_store.program_function
def _decode_program(module, prompts: np.ndarray, total: int, temperature,
                    top_k, top_p, seed: int) -> np.ndarray:
    """The solo ``decode`` program: every buffer position is one step
    (the prompt's too), each step embeds one token at its position,
    attends against the per-layer cache and writes the next token; no host
    transfer until the end.  ``temperature`` None is greedy."""
    sample = temperature is not None
    bsz, t0 = prompts.shape
    dev = next(module.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(int(seed)) \
        if sample else None
    with torch.inference_mode():
        cache = module.init_cache(bsz, total, device=dev)
        buf = torch.zeros((bsz, total), dtype=torch.int64, device=dev)
        buf[:, :t0] = torch.from_numpy(prompts).to(dev)
        slots = torch.arange(total, device=dev)[None, :]
        for i in range(total - 1):
            kmask = (slots <= i) & (buf != 0)
            logits = module(
                buf[:, i:i + 1],
                positions=torch.full((bsz, 1), i, device=dev),
                key_mask=kmask, cache=cache)
            if i + 1 < t0:
                continue  # prefill: the next token is the prompt's
            step = logits[:, 0].float()
            if not sample:
                nxt = step.argmax(-1)
            else:
                # A mid-stream pad would be masked out of every later
                # step and read as the end of the sequence.
                step[:, 0] = -torch.inf
                if top_k is not None:
                    kth = torch.topk(step, top_k, dim=-1).values[..., -1:]
                    step = torch.where(step < kth, -torch.inf, step)
                scaled = step / temperature
                if top_p is not None:
                    scaled = _nucleus(scaled, top_p)
                nxt = torch.multinomial(torch.softmax(scaled, -1), 1,
                                        generator=gen)[:, 0]
            buf[:, i + 1] = nxt
        # The program's one host transfer, the finished tokens:
        # lo-check: disable=jit-host-sync
        return buf.to(torch.int32).cpu().numpy()


@register(_MODULE)
class DecoderLM(GreedyDecodeMixin, NeuralEstimator):
    """Causal (decoder-only) language model.

    ``fit(x, y)`` with x the token ids (B, T) and y the next-token
    targets (B, T) (``x[:, 1:]`` padded with 0): the softmax_ce loss
    averages per token over the non-pad targets.  ``generate`` continues
    prompts through the KV cache.  GPT-2 small's widths are
    ``DecoderLM(vocab_size=50257, hidden_dim=768, num_layers=12,
    num_heads=12, max_len=1024)``; training runs K1 forward and K2/K3
    backward (causal) in every layer on CUDA.
    """

    def __init__(
        self,
        vocab_size: int = 32000,
        hidden_dim: int = 256,
        num_layers: int = 4,
        num_heads: int = 8,
        mlp_dim: int | None = None,
        max_len: int = 1024,
        learning_rate: float = 3e-4,
        seed: int = 0,
        remat: bool | str = False,
        attention_window: int | None = None,
        num_kv_heads: int | None = None,
        positional: str = "learned",
        device="cuda",
    ):
        if positional not in ("learned", "rope"):
            raise ValueError(f"positional must be learned|rope, "
                             f"got {positional!r}")
        self.vocab_size = vocab_size
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.mlp_dim = mlp_dim or hidden_dim * 4
        self.max_len = max_len
        self.remat = remat
        self.attention_window = attention_window
        self.num_kv_heads = num_kv_heads
        self.positional = positional
        super().__init__(
            _DecoderLM(
                vocab_size, hidden_dim, num_layers, num_heads, self.mlp_dim,
                max_len, remat=remat, window=attention_window,
                num_kv_heads=num_kv_heads, positional=positional,
            ),
            loss="softmax_ce",
            learning_rate=learning_rate,
            seed=seed,
            device=device,
        )

    def check_input(self, x: np.ndarray) -> None:
        _check_tokens(x, self.vocab_size,
                      None if self.positional == "rope" else self.max_len)
