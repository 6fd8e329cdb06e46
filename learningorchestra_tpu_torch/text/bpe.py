"""Byte-pair-encoding tokenizer, trained from a streaming word counter —
port of ``learningorchestra_tpu/text/bpe.py``, line for line.

Classic BPE (Sennrich et al. 2016): start from characters, repeatedly
merge the most frequent adjacent symbol pair across the corpus, stop at
``vocab_size``.  Training updates pair counts only for the word types a
merge touched.  The port's merges, vocabulary and token ids are the JAX
package's, so a tokenizer trained by either encodes alike:

- **counter in, rows out**: training consumes a ``{word: count}``
  mapping (:func:`count_words`), so only the vocabulary of word types
  stays resident;
- **fixed-length rows**: ``encode`` returns an int32 row
  ``[BOS, tok..., EOS, PAD...]``; pad id is 0, the model zoo's key-mask
  convention (``tokens != 0``);
- **deterministic artifacts**: ties in pair frequency break
  lexicographically (the heap pops the smallest pair), and
  ``to_json``/``from_json`` round-trip the tokenizer across packages.
"""

from __future__ import annotations

import json
import re
from collections import Counter

import numpy as np

PAD_ID = 0
UNK_ID = 1
BOS_ID = 2
EOS_ID = 3
_SPECIALS = ("<pad>", "<unk>", "<s>", "</s>")
_EOW = "</w>"  # end-of-word marker: makes merges word-boundary-aware

_WORD_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)


def pretokenize(text: str, *, lowercase: bool = True) -> list[str]:
    """Split into words + punctuation (the BPE alphabet's units)."""
    if lowercase:
        text = text.lower()
    return _WORD_RE.findall(text)


def count_words(texts, *, lowercase: bool = True) -> Counter:
    """Streaming word counter — feed it row by row; only the counter
    (vocabulary of word TYPES, not the corpus) stays in memory."""
    counts: Counter = Counter()
    for text in texts:
        counts.update(pretokenize(str(text), lowercase=lowercase))
    return counts


class BpeTokenizer:
    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 *, lowercase: bool = True):
        self.vocab = dict(vocab)
        self.merges = [tuple(m) for m in merges]
        self.lowercase = lowercase
        self._ranks = {m: i for i, m in enumerate(self.merges)}
        self._word_cache: dict[str, list[int]] = {}

    # -- training ----------------------------------------------------------

    @classmethod
    def train(cls, word_counts: Counter | dict, *, vocab_size: int = 8000,
              lowercase: bool = True) -> "BpeTokenizer":
        """Learn merges until the vocab reaches ``vocab_size`` (or no
        pair repeats).  Incremental pair bookkeeping: each merge only
        re-scans the word types that contain the merged pair."""
        if vocab_size < len(_SPECIALS) + 1:
            raise ValueError(f"vocab_size too small: {vocab_size}")
        # Word types as symbol tuples, weighted by corpus count.
        words: list[list[str]] = []
        counts: list[int] = []
        for w, c in word_counts.items():
            if not w:
                continue
            words.append(list(w) + [_EOW])
            counts.append(int(c))

        # pair -> total count; pair -> {word indices containing it}
        pair_counts: Counter = Counter()
        pair_words: dict[tuple[str, str], set[int]] = {}
        for i, syms in enumerate(words):
            for a, b in zip(syms, syms[1:]):
                pair_counts[(a, b)] += counts[i]
                pair_words.setdefault((a, b), set()).add(i)

        alphabet = sorted({s for syms in words for s in syms})
        merges: list[tuple[str, str]] = []
        n_tokens = len(_SPECIALS) + len(alphabet)
        if n_tokens > vocab_size:
            # Specials + the full corpus alphabet are always in the
            # vocab, so a smaller request can't be honored — and
            # letting ids overflow the requested size silently breaks
            # the downstream embedding gather.
            raise ValueError(
                f"vocab_size={vocab_size} is smaller than the corpus "
                f"alphabet ({len(alphabet)} symbols + "
                f"{len(_SPECIALS)} specials = {n_tokens}); raise "
                "vocab_size to at least that"
            )

        # Best-pair selection via a lazy-invalidation max-heap: a full
        # max() over pair_counts per merge would be O(#distinct pairs)
        # per iteration — minutes of pure Python at IMDb scale.  Heap
        # entries go stale when counts change; pop-and-check against
        # the live count until the top is current.  Equal counts pop
        # the lexicographically smallest pair — any total order works,
        # it only has to be deterministic.
        import heapq

        heap = [(-c, p) for p, c in pair_counts.items()]
        heapq.heapify(heap)

        while n_tokens + len(merges) < vocab_size and heap:
            negc, best = heapq.heappop(heap)
            if pair_counts.get(best) != -negc:
                continue  # stale entry; the live count was re-pushed
            a, b = best
            freq = -negc
            if freq < 2:
                break  # merging singletons only memorizes the corpus
            merges.append((a, b))
            merged = a + b
            # Re-tokenize ONLY the affected word types, updating the
            # pair books by delta; every touched pair re-enters the
            # heap with its new count after the merge.
            changed: set[tuple[str, str]] = set()
            for i in sorted(pair_words.get((a, b), ())):
                syms = words[i]
                c = counts[i]
                for x, y in zip(syms, syms[1:]):
                    pair_counts[(x, y)] -= c
                    changed.add((x, y))
                    if pair_counts[(x, y)] <= 0:
                        del pair_counts[(x, y)]
                    s = pair_words.get((x, y))
                    if s:
                        s.discard(i)
                out = []
                j = 0
                while j < len(syms):
                    if (j + 1 < len(syms) and syms[j] == a
                            and syms[j + 1] == b):
                        out.append(merged)
                        j += 2
                    else:
                        out.append(syms[j])
                        j += 1
                words[i] = out
                for x, y in zip(out, out[1:]):
                    pair_counts[(x, y)] += c
                    changed.add((x, y))
                    pair_words.setdefault((x, y), set()).add(i)
            for p in changed:
                c = pair_counts.get(p)
                if c:
                    heapq.heappush(heap, (-c, p))

        vocab: dict[str, int] = {s: i for i, s in enumerate(_SPECIALS)}
        for s in alphabet:
            vocab[s] = len(vocab)
        for a, b in merges:
            tok = a + b
            if tok not in vocab:
                vocab[tok] = len(vocab)
        return cls(vocab, merges, lowercase=lowercase)

    # -- encoding ----------------------------------------------------------

    def _bpe_word(self, word: str) -> list[int]:
        cached = self._word_cache.get(word)
        if cached is not None:
            return cached
        syms = list(word) + [_EOW]
        # Repeatedly apply the lowest-rank merge present in the word —
        # replays training order, so encoding matches training exactly.
        while len(syms) > 1:
            ranked = [
                (self._ranks.get((x, y)), k)
                for k, (x, y) in enumerate(zip(syms, syms[1:]))
            ]
            ranked = [(r, k) for r, k in ranked if r is not None]
            if not ranked:
                break
            _, k = min(ranked)
            syms = syms[:k] + [syms[k] + syms[k + 1]] + syms[k + 2:]
        ids = [self.vocab.get(s, UNK_ID) for s in syms]
        if len(self._word_cache) < 1_000_000:
            self._word_cache[word] = ids
        return ids

    def encode(self, text: str, max_len: int) -> np.ndarray:
        """``[BOS, tokens..., EOS]`` padded (id 0) / truncated to
        ``max_len``, the fixed-shape rows the sharded dataset stores.
        Truncation keeps the head (BERT convention) and always
        terminates with EOS."""
        ids = [BOS_ID]
        for w in pretokenize(text, lowercase=self.lowercase):
            ids.extend(self._bpe_word(w))
            if len(ids) >= max_len:  # early stop: row is full anyway
                break
        ids = ids[: max_len - 1] + [EOS_ID]
        out = np.full((max_len,), PAD_ID, dtype=np.int32)
        out[: len(ids)] = ids
        return out

    def encode_batch(self, texts, max_len: int) -> np.ndarray:
        return np.stack([self.encode(str(t), max_len) for t in texts])

    def decode(self, ids) -> str:
        inv = getattr(self, "_inv", None)
        if inv is None:
            inv = self._inv = {i: s for s, i in self.vocab.items()}
        words, cur = [], ""
        for i in np.asarray(ids).reshape(-1).tolist():
            if i in (PAD_ID, BOS_ID):
                continue
            if i == EOS_ID:
                break
            tok = inv.get(int(i), "")
            if tok.endswith(_EOW):
                words.append(cur + tok[: -len(_EOW)])
                cur = ""
            else:
                cur += tok
        if cur:
            words.append(cur)
        return " ".join(words)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # -- persistence -------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps({
            "vocab": self.vocab,
            "merges": [list(m) for m in self.merges],
            "lowercase": self.lowercase,
        })

    @classmethod
    def from_json(cls, blob: str) -> "BpeTokenizer":
        d = json.loads(blob)
        return cls(d["vocab"], [tuple(m) for m in d["merges"]],
                   lowercase=d.get("lowercase", True))
