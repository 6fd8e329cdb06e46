"""The port's BPE tokenizer and the text transform's label rules against
the JAX package's, on the CPU.

- ``BpeTokenizer.train`` on a seeded corpus (words, punctuation, digits,
  accents, mixed case) gives equal merges and vocabularies, lowercased or
  not and at several sizes, and raises alike on a vocabulary too small;
- ``encode_batch`` gives equal arrays (truncation, padding, empty text,
  symbols the corpus never had), ``decode`` equal strings;
- ``to_json`` is equal and round-trips across the two packages, and a
  tokenizer the JAX package pickled with dill loads as the port's class
  without importing the JAX package (its other classes are refused);
- the text transform's labels through both REST servers: dense integers
  stored as they are; sparse, negative and string labels remapped in
  sorted order with ``labelClasses``; a missing label fails the job with
  the same message.
"""

import pickle

import dill
import numpy as np
import pytest

from learningorchestra_tpu.store.sharded import WeightedMetrics
from learningorchestra_tpu.text import bpe as jbpe
from learningorchestra_tpu_torch.store.volumes import VolumeStorage
from learningorchestra_tpu_torch.text import bpe as pbpe
from tests.torch_rest_pair import server_pair

WORDS = ["the", "film", "was", "great", "terrible", "acting", "plot",
         "Loved", "hated", "movie", "don't", "it's", "café", "naïve", "42",
         "1999", "U.S.", "e-mail", "wow!!", "(sort", "of)", "réalisé"]


def _corpus(n=120, seed=0):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(WORDS) + 1)
    return [" ".join(rng.choice(WORDS, rng.integers(1, 25), p=p / p.sum()))
            for _ in range(n)]


@pytest.fixture(scope="module", params=[(60, True), (200, True),
                                        (120, False)],
                ids=["v60", "v200", "v120-cased"])
def pair(request):
    vocab_size, lowercase = request.param
    corpus = _corpus()
    return tuple(
        mod.BpeTokenizer.train(mod.count_words(corpus, lowercase=lowercase),
                               vocab_size=vocab_size, lowercase=lowercase)
        for mod in (jbpe, pbpe))


def test_training_gives_equal_merges_and_vocab(pair):
    jtok, ptok = pair
    assert ptok.merges == jtok.merges
    assert ptok.vocab == jtok.vocab
    assert ptok.vocab_size == jtok.vocab_size
    assert len(ptok.merges) > 10


def test_pretokenize_and_counts_are_equal():
    text = "Don't STOP -- naïve café, 3.5 stars!! (sort of)"
    for lowercase in (True, False):
        assert pbpe.pretokenize(text, lowercase=lowercase) == \
            jbpe.pretokenize(text, lowercase=lowercase)
    assert pbpe.count_words(_corpus()) == jbpe.count_words(_corpus())


@pytest.mark.parametrize("max_len", [4, 9, 40])
def test_encode_batch_and_decode_are_equal(pair, max_len):
    jtok, ptok = pair
    texts = _corpus(30, seed=1) + [
        "", "   ", "unseen ✓ symbols € here", "x" * 60,
        " ".join(WORDS * 3)]
    got = ptok.encode_batch(texts, max_len)
    want = jtok.encode_batch(texts, max_len)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == pbpe.BOS_ID).all()
    assert [ptok.decode(r) for r in got] == [jtok.decode(r) for r in want]


def test_json_round_trips_across_packages(pair):
    jtok, ptok = pair
    assert ptok.to_json() == jtok.to_json()
    texts = _corpus(10, seed=2)
    crossed = pbpe.BpeTokenizer.from_json(jtok.to_json())
    back = jbpe.BpeTokenizer.from_json(ptok.to_json())
    np.testing.assert_array_equal(crossed.encode_batch(texts, 16),
                                  jtok.encode_batch(texts, 16))
    np.testing.assert_array_equal(back.encode_batch(texts, 16),
                                  ptok.encode_batch(texts, 16))


@pytest.mark.parametrize("vocab_size", [3, 10])
def test_vocab_too_small_raises_alike(vocab_size):
    counts = jbpe.count_words(_corpus())
    with pytest.raises(ValueError) as want:
        jbpe.BpeTokenizer.train(counts, vocab_size=vocab_size)
    with pytest.raises(ValueError) as got:
        pbpe.BpeTokenizer.train(counts, vocab_size=vocab_size)
    assert str(got.value) == str(want.value)


def test_jax_pickled_tokenizer_loads_as_the_port_class(tmp_path):
    jtok = jbpe.BpeTokenizer.train(jbpe.count_words(_corpus()),
                                   vocab_size=80)
    jtok.encode("warm the word cache", 8)
    vols = VolumeStorage(tmp_path)
    path = vols.path_for("transform/text", "tok.tokenizer")
    with open(path, "wb") as fh:
        dill.dump(jtok, fh)
    got = vols.read_object("transform/text", "tok.tokenizer")
    assert type(got) is pbpe.BpeTokenizer
    texts = _corpus(10, seed=3)
    np.testing.assert_array_equal(got.encode_batch(texts, 12),
                                  jtok.encode_batch(texts, 12))
    # Any other class of the JAX package is refused, not imported.
    with open(vols.path_for("transform/text", "other"), "wb") as fh:
        dill.dump(WeightedMetrics(), fh)
    with pytest.raises(pickle.UnpicklingError, match="JAX package"):
        vols.read_object("transform/text", "other")


LABELS = {
    "dense": (["0", "1", "2", "1"], None),
    "float-dense": (["0.0", "1.0", "1.0", "0.0"], None),
    "sparse": (["1", "3", "3", "1"], ["1", "3"]),
    "negative": (["-1", "1", "1", "-1"], ["-1", "1"]),
    "string": (["pos", "neg", "neg", "mixed"], ["mixed", "neg", "pos"]),
    "missing": (["1", "", "0", "1"], None),
}


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("text_labels")
    with server_pair(tmp) as (srv, clients):
        yield tmp, srv, clients


@pytest.mark.parametrize("kind", sorted(LABELS))
def test_label_rules_are_the_jax_packages(servers, kind):
    tmp, srv, clients = servers
    values, classes = LABELS[kind]
    csv = tmp / f"{kind}.csv"
    csv.write_text("review,label\n" + "".join(
        f"\"{t}\",{v}\n" for t, v in zip(_corpus(4, seed=4), values)))
    out = {}
    for side, c in clients.items():
        c.dataset_csv.insert(f"d_{kind}", f"file://{csv}")
        c.observe.wait(f"d_{kind}", 30)
        c.text.create(f"t_{kind}", f"d_{kind}", text_field="review",
                      label_field="label", vocab_size=40, max_len=8,
                      shard_rows=3)
        meta = c.observe.wait(f"t_{kind}", 30)
        labels = None
        if meta["jobState"] == "finished":
            root = srv[side].ctx.volumes.path_for("transform/text",
                                                  f"t_{kind}")
            labels = np.concatenate([
                np.load(root / f"shard_{k:05d}.npz")["label"]
                for k in range(meta["shards"])])
        out[side] = (meta, labels)
    (jmeta, jlabels), (pmeta, plabels) = out["jax"], out["port"]
    assert pmeta["jobState"] == jmeta["jobState"]
    assert pmeta.get("labelClasses") == jmeta.get("labelClasses") == classes
    if kind == "missing":
        assert pmeta["jobState"] == "failed"
        assert pmeta["exception"] == jmeta["exception"]
        assert "1 row(s) have no 'label' value" in pmeta["exception"]
    else:
        assert plabels.dtype == jlabels.dtype
        np.testing.assert_array_equal(plabels, jlabels)
