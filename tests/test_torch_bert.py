"""The port's BERT slice against the JAX package at a small size.

JAX parameters are carried into the port by ``convert.py``; the port's
logits are held against ``BertModel(use_flash=True)`` (Pallas flash in
interpret mode) at atol/rtol 1e-4, the bar of tests/test_ops.py's
encoder check.  Also: the weight carry round-trips, int8 artifacts cross
between the packages, legacy separate-qkv trees migrate, and the
attention layer (fused, separate, grouped-query) matches flax's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu.models.text import BertModel as JaxBert
from learningorchestra_tpu.ops import quant as jq
from learningorchestra_tpu.ops.layers import (
    MultiHeadSelfAttention as JaxMHSA,
)
from learningorchestra_tpu_torch import convert
from learningorchestra_tpu_torch.device import resolve_device
from learningorchestra_tpu_torch.models.text import BertModel
from learningorchestra_tpu_torch.ops import quant as pq
from learningorchestra_tpu_torch.ops.layers import MultiHeadSelfAttention
from learningorchestra_tpu_torch.train.neural import load_artifact

SMALL = dict(vocab_size=64, hidden_dim=32, num_layers=2, num_heads=2,
             max_len=16)
TOL = dict(atol=1e-4, rtol=1e-4)


def _tokens(seed=0, rows=5):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, SMALL["vocab_size"], (rows, SMALL["max_len"]),
                     dtype=np.int32)
    x[0, 10:] = 0  # pad tails
    x[1, 4:] = 0
    x[3, :] = 0  # an all-pad row masks every key
    return x


@pytest.fixture(scope="module")
def jax_model():
    est = JaxBert(**SMALL, use_flash=True, seed=3)
    est._init_params(jnp.asarray(_tokens()))
    return est


def _jax_tree(est):
    return jax.tree_util.tree_map(np.asarray, est.params)


def _port_from(tree, **kw):
    est = BertModel(**SMALL, device="cpu", **kw)
    est.load_state_dict({"params": tree})
    return est


def test_logits_match_jax_flash(jax_model):
    x = _tokens()
    ref = np.asarray(jax_model.predict(x))
    out = _port_from(_jax_tree(jax_model)).predict(x)
    assert out.shape == (5, 2) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, **TOL)


def test_ragged_batches_bucket_like_jax(jax_model):
    x = _tokens(seed=1, rows=7)
    ref = np.asarray(jax_model.predict(x, batch_size=4))
    out = _port_from(_jax_tree(jax_model)).predict(x, batch_size=4)
    np.testing.assert_allclose(out, ref, **TOL)


def test_weight_carry_round_trips(jax_model):
    tree = _jax_tree(jax_model)
    back = convert.params_to_jax(_port_from(tree).module)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)


def _to_jax_leaves(tree):
    if isinstance(tree, dict):
        return {k: _to_jax_leaves(v) for k, v in tree.items()}
    if isinstance(tree, pq.QuantizedLeaf):
        return jq.QuantizedLeaf(tree.values, tree.scales, tree.shape,
                                tree.dtype)
    return tree


def test_port_int8_artifact_matches_jax_on_the_same_params(jax_model):
    x = _tokens(seed=2)
    port = _port_from(_jax_tree(jax_model))
    art = port.to_artifact(quantize=True)
    assert art["classParameters"]["hidden_dim"] == 32
    assert "device" not in art["classParameters"]
    params = art["state"]["params"]
    mlp = params["params"]["encoder"]["TransformerBlock_0"]["Dense_0"]
    assert isinstance(mlp["kernel"], pq.QuantizedLeaf)
    assert mlp["kernel"].shape == (32, 128)
    assert isinstance(mlp["bias"], np.ndarray)
    reloaded = load_artifact(art, device="cpu")
    out = reloaded.predict(x)
    # The same artifact's params, dequantized and run by the JAX package.
    ref_params = jq.dequantize_pytree(_to_jax_leaves(params))
    ref = np.asarray(jax_model.module.apply(ref_params, jnp.asarray(x)))
    np.testing.assert_allclose(out, ref, **TOL)
    # int8 moved the logits, but not by much.
    assert not np.allclose(out, port.predict(x), atol=1e-7)
    np.testing.assert_allclose(out, port.predict(x), atol=5e-2)


def test_jax_int8_state_loads_in_the_port(jax_model):
    x = _tokens(seed=4)
    qtree = jq.quantize_pytree(_jax_tree(jax_model))
    ref = np.asarray(jax_model.module.apply(
        jq.dequantize_pytree(qtree), jnp.asarray(x)
    ))

    def port_leaves(t):
        if isinstance(t, dict):
            return {k: port_leaves(v) for k, v in t.items()}
        if isinstance(t, jq.QuantizedLeaf):
            return pq.QuantizedLeaf(t.values, t.scales, t.shape, t.dtype)
        return t

    est = _port_from(port_leaves(qtree))
    np.testing.assert_allclose(est.predict(x), ref, **TOL)


def _split_qkv(tree, heads):
    """The legacy layout: query/key/value triplets instead of qkv."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k == "qkv":
            for i, name in enumerate(("query", "key", "value")):
                out[name] = {
                    "kernel": v["kernel"][:, i * heads:(i + 1) * heads],
                    "bias": v["bias"][i * heads:(i + 1) * heads],
                }
        else:
            out[k] = _split_qkv(v, heads)
    return out


def test_legacy_separate_qkv_artifact_migrates(jax_model):
    x = _tokens(seed=5)
    tree = _jax_tree(jax_model)
    legacy = _split_qkv(tree, SMALL["num_heads"])
    est = _port_from(legacy)
    np.testing.assert_allclose(
        est.predict(x), _port_from(tree).predict(x), atol=0, rtol=0
    )


@pytest.mark.parametrize("kv_heads,fused", [
    (None, True), (None, False), (1, True), (2, False),
])
def test_attention_layer_matches_flax(kv_heads, fused):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 12, 32), dtype=np.float32)
    mask = np.ones((2, 12), bool)
    mask[1, 7:] = False
    jmod = JaxMHSA(num_heads=4, qkv_features=32, num_kv_heads=kv_heads,
                   use_flash=True, fused_qkv=fused)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x),
                       jnp.asarray(mask))
    ref = np.asarray(jmod.apply(params, jnp.asarray(x), jnp.asarray(mask)))
    pmod = MultiHeadSelfAttention(4, 32, num_kv_heads=kv_heads,
                                  fused_qkv=fused)
    pmod.load_state_dict(convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)
    ))
    with torch.inference_mode():
        out = pmod(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_input_checks_and_device_default(monkeypatch):
    est = BertModel(**SMALL, device="cpu")
    for bad in (np.zeros((2, 17), np.int32), np.full((1, 4), 64),
                np.full((1, 4), -1), np.zeros((2, 4), np.float32)):
        with pytest.raises(ValueError):
            est.predict(bad)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        BertModel(**SMALL)


def test_seeded_init_is_deterministic():
    a = convert.params_to_jax(BertModel(**SMALL, seed=1, device="cpu").module)
    b = convert.params_to_jax(BertModel(**SMALL, seed=1, device="cpu").module)
    c = convert.params_to_jax(BertModel(**SMALL, seed=2, device="cpu").module)
    la, lb, lc = (jax.tree_util.tree_leaves(t) for t in (a, b, c))
    assert all(np.array_equal(u, v) for u, v in zip(la, lb))
    assert not all(np.array_equal(u, v) for u, v in zip(la, lc))
