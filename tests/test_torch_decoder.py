"""The port's DecoderLM and its KV-cache decode against the JAX package,
at a small size (vocab 32, hidden 32, 2 layers), weights carried from
the JAX params with ``convert.py``:

- ``apply_rope`` (positions (T,) and (B, T)) and ``_grouped_decode_attend``
  (grouped-query, a fully masked row exactly 0);
- the forward logits for learned and rotary positions, grouped-query
  attention and a sliding window, at the model-logits bar 1e-4;
- the decode branch with no caller mask equals the causal forward
  (``tests/test_ops.py::TestDecodeStandaloneValidity``);
- cached ``generate`` equals JAX's ``generate`` and the naive full
  re-forward loop (``tests/lm_oracle.py``) token for token;
- sampling: JAX's validation errors, tokens inside the top-k or nucleus
  set, never pad 0, reproducible by seed;
- a ``fit`` whose loss history matches JAX's with the batches in order.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu.models.text import DecoderLM as JaxLM
from learningorchestra_tpu.ops import layers as jl
from learningorchestra_tpu_torch import convert
from learningorchestra_tpu_torch.models.text import DecoderLM
from learningorchestra_tpu_torch.ops import layers as pl
from learningorchestra_tpu_torch.toolkit import registry
from tests.lm_oracle import naive_greedy_decode

SMALL = dict(vocab_size=32, hidden_dim=32, num_layers=2, num_heads=2,
             max_len=16)
VARIANTS = {
    "learned": {},
    "rope": {"positional": "rope"},
    "gqa": {"num_kv_heads": 1},
    "window": {"attention_window": 4},
}
TOL = dict(atol=1e-4, rtol=1e-4)


def _tokens(rows=8, t=12, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, SMALL["vocab_size"], (rows, t)).astype(np.int32)
    x[1, 9:] = 0  # a pad tail
    return x, np.concatenate([x[:, 1:], np.zeros((rows, 1), np.int32)], 1)


def _tree(est):
    return jax.tree_util.tree_map(np.asarray, est.params)


def _port_of(jest, variant):
    pest = DecoderLM(**SMALL, **VARIANTS[variant], device="cpu")
    pest.load_state_dict({"params": _tree(jest)})
    return pest


@pytest.fixture(scope="module")
def fitted():
    """One JAX DecoderLM per variant, fitted 2 epochs in f32 (the decode
    tests want a trained model's decisive logits, not a seed's)."""
    x, y = _tokens()
    out = {}
    for variant, kw in VARIANTS.items():
        jest = JaxLM(**SMALL, **kw)
        jest.compute_dtype = "float32"
        jest.fit(x, y, epochs=2, batch_size=8)
        out[variant] = jest
    return out


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5, 8)).astype(np.float32)
    for pos in (np.arange(5), rng.integers(0, 100, (2, 5))):
        ref = np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos)))
        out = pl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos))
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    with pytest.raises(ValueError, match="even head_dim"):
        pl.apply_rope(torch.zeros(1, 1, 2, 3), torch.arange(2))
    with pytest.raises(ValueError, match=r"\(T,\) or \(B, T\)"):
        pl.apply_rope(torch.zeros(1, 1, 2, 4), torch.zeros(1, 1, 2))


def test_grouped_decode_attend_matches_jax_and_zeroes_masked_rows():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((3, 4, 1, 8)).astype(np.float32)
    k = rng.standard_normal((3, 2, 6, 8)).astype(np.float32)  # GQA: 4 / 2
    v = rng.standard_normal((3, 2, 6, 8)).astype(np.float32)
    mask = rng.random((3, 6)) > 0.3
    mask[0, 0] = True
    mask[2] = False  # a fully masked row
    for m in (mask, None):
        ref = np.asarray(jl._grouped_decode_attend(
            *map(jnp.asarray, (q, k, v)),
            None if m is None else jnp.asarray(m)))
        out = pl._grouped_decode_attend(
            *map(torch.from_numpy, (q, k, v)),
            None if m is None else torch.from_numpy(m)).numpy()
        np.testing.assert_allclose(out, ref, atol=2e-6)
    masked = pl._grouped_decode_attend(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(mask)).numpy()
    assert np.array_equal(masked[2], np.zeros_like(masked[2]))
    assert np.isfinite(masked).all()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_logits_match_jax(fitted, variant):
    x, _ = _tokens(seed=9)
    x[2, 5:] = 0
    ref = np.asarray(fitted[variant].predict(x))
    out = _port_of(fitted[variant], variant).predict(x)
    assert out.shape == (8, 12, SMALL["vocab_size"])
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cached_generate_matches_jax_and_naive_loop(fitted, variant):
    x, _ = _tokens()
    prompts = x[:2, :6]
    jest = fitted[variant]
    ref = np.asarray(jest.generate(prompts, max_new_tokens=4))
    out = _port_of(jest, variant).generate(prompts, max_new_tokens=4)
    assert out.dtype == np.int32 and out.shape == (2, 10)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, naive_greedy_decode(jest, prompts,
                                                           10))


@pytest.mark.parametrize("window", [None, 3])
def test_decode_without_key_mask_matches_causal_forward(window):
    """The layer owns ``cache_index``: fed one position at a time with no
    caller mask, it never gives weight to an uninitialized cache slot."""
    b, t, f = 2, 8, 8
    x = np.random.default_rng(11).standard_normal((b, t, f)).astype(
        np.float32)
    full = jl.MultiHeadSelfAttention(num_heads=2, qkv_features=f,
                                     causal=True, window=window,
                                     use_flash=False)
    variables = full.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(full.apply(variables, jnp.asarray(x)))
    layer = pl.MultiHeadSelfAttention(2, f, causal=True, window=window)
    layer.load_state_dict(convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, dict(variables))))
    cache = layer.init_cache(b, t)
    with torch.no_grad():
        got = torch.cat([layer(torch.from_numpy(x[:, i:i + 1]), None, cache)
                         for i in range(t)], dim=1).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    with pytest.raises(ValueError, match="ONE position per step"):
        layer(torch.from_numpy(x[:, :2]), None, cache)


def test_per_row_cache_index_matches_scalar():
    """A (B,) cache_index at equal positions is the scalar index's decode
    bit for bit (rows at different positions: the serving tests'
    mid-flight admission), and its last step is the full forward's."""
    layer = pl.MultiHeadSelfAttention(2, 8, causal=True, rope=True)
    x = torch.randn(2, 5, 8, generator=torch.Generator().manual_seed(2))
    scalar, rows = layer.init_cache(2, 5), layer.init_cache(2, 5,
                                                            per_row=True)
    with torch.no_grad():
        for i in range(5):
            a = layer(x[:, i:i + 1], None, scalar)
            b = layer(x[:, i:i + 1], None, rows)
            assert torch.equal(a, b)
        full = layer(x)
    np.testing.assert_allclose(a[:, 0].numpy(), full[:, -1].numpy(), **TOL)
    assert rows["cache_index"].tolist() == [5, 5]


def test_sampling_validation_matches_jax(fitted):
    jest = fitted["learned"]
    pest = _port_of(jest, "learned")
    prompts = _tokens()[0][:1, :4]
    bad = [dict(top_k=3), dict(top_p=0.5), dict(temperature=1.0, top_p=0.0),
           dict(temperature=0.0, top_k=2),
           dict(temperature=1.0, top_p=1.5)]
    for kw in bad:
        with pytest.raises(ValueError) as jerr:
            jest.generate(prompts, max_new_tokens=2, **kw)
        with pytest.raises(ValueError) as perr:
            pest.generate(prompts, max_new_tokens=2, **kw)
        assert str(perr.value) == str(jerr.value), kw
    long = np.ones((1, SMALL["max_len"] + 1), np.int32)
    with pytest.raises(ValueError, match="exceeds max_len"):
        pest.generate(long)
    # top_k == 1 is greedy by definition.
    np.testing.assert_array_equal(
        pest.generate(prompts, max_new_tokens=4, temperature=0.7, top_k=1),
        pest.generate(prompts, max_new_tokens=4))


def test_sampling_stays_inside_top_k_and_nucleus(fitted):
    pest = _port_of(fitted["learned"], "learned")
    prompts = _tokens()[0][:3, :4]
    t0, new = 4, 8
    for kw in (dict(top_k=3), dict(top_p=0.6), dict(top_k=5, top_p=0.9)):
        out = pest.generate(prompts, max_new_tokens=new, temperature=0.8,
                            seed=5, **kw)
        again = pest.generate(prompts, max_new_tokens=new, temperature=0.8,
                              seed=5, **kw)
        np.testing.assert_array_equal(out, again)  # reproducible by seed
        assert (out[:, t0:] != 0).all()  # pad 0 is never sampled
        # Each sampled token lies in its step's allowed set, read off a
        # full forward of the prefix it was drawn after.
        logits = pest.predict(out)
        for row in range(out.shape[0]):
            for i in range(t0 - 1, out.shape[1] - 1):
                step = logits[row, i].astype(np.float64)
                step[0] = -np.inf
                allowed = np.ones_like(step, bool)
                if "top_k" in kw:
                    allowed &= step >= np.sort(step)[-kw["top_k"]] - 1e-5
                if "top_p" in kw:
                    masked = np.where(allowed, step / 0.8, -np.inf)
                    p = np.exp(masked - masked.max())
                    p /= p.sum()
                    order = np.sort(p)[::-1]
                    cut = min(int((np.cumsum(order) < kw["top_p"]).sum()),
                              len(p) - 1)
                    allowed &= p >= order[cut] - 1e-6
                assert allowed[out[row, i + 1]], (kw, row, i)
    other = pest.generate(prompts, max_new_tokens=new, temperature=0.8,
                          seed=6, top_k=5)
    assert not np.array_equal(other, pest.generate(
        prompts, max_new_tokens=new, temperature=0.8, seed=5, top_k=5))


def test_fit_loss_history_matches_jax():
    x, y = _tokens(rows=12)
    jest = JaxLM(**SMALL, seed=1)
    jest.compute_dtype = "float32"
    jest._init_params(jnp.asarray(x[:1]))
    pest = DecoderLM(**SMALL, device="cpu")
    pest.load_state_dict({"params": _tree(jest)})
    pest.compute_dtype = "float32"
    jest.fit(x, y, epochs=2, batch_size=8, shuffle=False)
    pest.fit(x, y, epochs=2, batch_size=8, shuffle=False)
    for key in ("loss", "accuracy", "perplexity"):
        np.testing.assert_allclose(pest.history[key], jest.history[key],
                                   **TOL)
    assert pest.history["loss"][-1] < pest.history["loss"][0]


def test_weight_carry_names_and_registry(fitted):
    for variant in ("learned", "rope", "gqa"):
        pest = _port_of(fitted[variant], variant)
        tree = convert.params_to_jax(pest.module)["params"]
        assert ("Embed_1" in tree) == (variant != "rope")
        qkv = tree["TransformerBlock_0"]["MultiHeadSelfAttention_0"]["qkv"]
        h, hkv = 2, 1 if variant == "gqa" else 2
        assert qkv["kernel"].shape == (32, h + 2 * hkv, 16)
        assert {"LayerNorm_0", "Dense_0", "Embed_0"} <= set(tree)
        ref = jax.tree_util.tree_leaves(_tree(fitted[variant]))
        back = jax.tree_util.tree_leaves(tree)
        assert all(np.array_equal(a, b) for a, b in zip(ref, back))
    assert registry.resolve("learningorchestra_tpu.models.text",
                            "DecoderLM") is DecoderLM


def test_generate_leaves_no_decode_state_to_pickle(fitted):
    pest = _port_of(fitted["learned"], "learned")
    before = set(vars(pest))
    size = len(pickle.dumps(pest))
    pest.generate(_tokens()[0][:2, :5], max_new_tokens=3)
    assert set(vars(pest)) == before
    assert len(pickle.dumps(pest)) == size
