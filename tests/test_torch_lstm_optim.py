"""The port's ``LSTMClassifier`` and its four optimizers written after
optax (lamb, lion, novograd, radam) against the JAX package:

- LSTM logits in f32 within 1e-4 from weights carried out of the JAX init
  (the per-gate leaves ``ii``..``ho`` land in torch's packed i, f, g, o
  order), with pad tails and an all-pad row;
- LSTM ``fit`` under ``shuffle=False``: loss history and final params
  within 1e-4 in f32 (adam, lamb, novograd), loss history within 3e-2 in
  bf16; the exported optimizer state against optax's state leaf by leaf
  (novograd's ``nu`` is one scalar per flax leaf, so per gate);
- each optimizer's steps against optax's on the same gradients, with its
  defaults and with other settings, and its state against optax's;
- an MLP fit under each optimizer, params and exported state;
- ``quantize_pytree`` of an LSTM tree bit-identical to the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from learningorchestra_tpu.models.mlp import MLPClassifier as JaxMLPC
from learningorchestra_tpu.models.text import LSTMClassifier as JaxLSTM
from learningorchestra_tpu.ops import quant as jq
from learningorchestra_tpu_torch import convert
from learningorchestra_tpu_torch.models.mlp import MLPClassifier
from learningorchestra_tpu_torch.models.text import LSTMClassifier
from learningorchestra_tpu_torch.ops import quant as pq
from learningorchestra_tpu_torch.toolkit import registry
from learningorchestra_tpu_torch.train.neural import (
    load_artifact,
    resolve_optimizer,
)

SMALL = dict(vocab_size=50, embed_dim=8, hidden_dim=8, num_classes=2)
TOL = dict(atol=1e-4, rtol=1e-4)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(rows=20, t=7, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, SMALL["vocab_size"], (rows, t)).astype(np.int32)
    x[0, 4:] = 0  # pad tails
    x[-1, 2:] = 0
    x[min(3, rows - 1)] = 0  # an all-pad row: the pool divides by max(0, 1)
    return x, (x[:, 0] % 2).astype(np.int32)


def _assert_tree_close(got, want, **tol):
    a = jax.tree_util.tree_leaves_with_path(_np_tree(want))
    b = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, u), (_, v) in zip(a, b):
        np.testing.assert_allclose(np.asarray(v), u,
                                   err_msg=jax.tree_util.keystr(path), **tol)


def _lstm_pair(dtype="float32", optimizer=None, lr=1e-2):
    x, _ = _tokens()
    jest = JaxLSTM(**SMALL, learning_rate=lr, seed=4)
    pest = LSTMClassifier(**SMALL, learning_rate=lr, seed=4, device="cpu")
    if optimizer is not None:
        jest.compile(optimizer=optimizer)
        pest.compile(optimizer=optimizer)
    jest.compute_dtype = pest.compute_dtype = dtype
    jest._init_params(jnp.asarray(x[:1]))
    pest.load_state_dict({"params": _np_tree(jest.params)})
    return jest, pest


def test_lstm_logits_match_jax():
    jest, pest = _lstm_pair()
    x, _ = _tokens(rows=6, seed=1)
    x[2] = 0
    want = np.asarray(jest.predict(x))
    np.testing.assert_allclose(pest.predict(x), want, **TOL)
    # The carry is exact both ways under flax's per-gate names.
    _assert_tree_close(convert.params_to_jax(pest.module), jest.params,
                       rtol=0, atol=0)
    cell = convert.params_to_jax(pest.module)["params"][
        "OptimizedLSTMCell_0"]
    assert sorted(cell) == ["hf", "hg", "hi", "ho", "if", "ig", "ii", "io"]
    assert set(cell["ii"]) == {"kernel"} and set(cell["hi"]) == {
        "kernel", "bias"}
    # One trainable bias per gate.
    assert sum("bias" in n for n in pest.params) == 4 + 1


LSTM_FITS = {
    "adam_f32": ("float32", None),
    "adam_bf16": ("bfloat16", None),
    "lamb": ("float32", {"name": "lamb"}),
    "novograd": ("float32", {"name": "novograd"}),
}


@pytest.fixture(scope="module")
def lstm_fits():
    x, y = _tokens()
    out = {}
    for key, (dtype, opt) in LSTM_FITS.items():
        jest, pest = _lstm_pair(dtype, opt)
        for est in (jest, pest):
            est.fit(x, y, epochs=2, batch_size=8, shuffle=False)
        out[key] = (jest, pest)
    return out


@pytest.mark.parametrize("key", ["adam_f32", "lamb", "novograd"])
def test_lstm_fit_matches_jax_f32(lstm_fits, key):
    jest, pest = lstm_fits[key]
    for name in ("loss", "accuracy"):
        np.testing.assert_allclose(pest.history[name], jest.history[name],
                                   err_msg=name, **TOL)
    _assert_tree_close(convert.params_to_jax(pest.module), jest.params,
                       **TOL)
    x, _ = _tokens(rows=5, seed=2)
    np.testing.assert_allclose(pest.predict(x), np.asarray(jest.predict(x)),
                               **TOL)


def test_lstm_fit_matches_jax_bf16(lstm_fits):
    jest, pest = lstm_fits["adam_bf16"]
    np.testing.assert_allclose(pest.history["loss"], jest.history["loss"],
                               atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("key", ["lamb", "novograd"])
def test_lstm_opt_state_has_optax_layout(lstm_fits, key):
    jest, pest = lstm_fits[key]
    state = pest.state_dict()["opt_state"]
    inner = jest.opt_state[0]
    assert int(state["count"]) == int(inner.count) == 6
    for field in ("mu", "nu"):
        _assert_tree_close(state[field], getattr(inner, field), atol=1e-6,
                           rtol=1e-3)
    if key == "novograd":  # a scalar per flax leaf, each gate its own
        nu = state["nu"]["params"]["OptimizedLSTMCell_0"]
        assert nu["hf"]["kernel"].shape == () and nu["ii"]["kernel"] \
            .shape == ()
    # The state survives a save: both continue the same trajectory.
    twin = LSTMClassifier(**SMALL, learning_rate=1e-2, device="cpu")
    twin.compile(optimizer=LSTM_FITS[key][1])
    twin.load_state_dict(pest.state_dict())
    x, y = _tokens(seed=3)
    for est in (pest, twin):
        est.fit(x, y, epochs=1, batch_size=8, shuffle=False)
    assert twin.history["loss"] == pest.history["loss"]
    for a, b in zip(pest.module.parameters(), twin.module.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- the four optimizers, step by step -----------------------------------------


OPTIMIZERS = {
    "lamb": ({"name": "lamb"}, optax.lamb(0.05)),
    "lamb_decay": ({"name": "lamb", "weightDecay": 0.1},
                   optax.lamb(0.05, weight_decay=0.1)),
    "lion": ({"name": "lion"}, optax.lion(0.05)),
    "lion_betas": ({"name": "lion", "b1": 0.8, "b2": 0.95,
                    "weight_decay": 0.0},
                   optax.lion(0.05, b1=0.8, b2=0.95, weight_decay=0.0)),
    "novograd": ({"name": "novograd"}, optax.novograd(0.05)),
    "novograd_decay": ({"name": "novograd", "b2": 0.5, "weightDecay": 0.01},
                       optax.novograd(0.05, b2=0.5, weight_decay=0.01)),
    "radam": ({"name": "radam"}, optax.radam(0.05)),
    "radam_threshold": ({"name": "radam", "threshold": 3.0, "b2": 0.99},
                        optax.radam(0.05, b2=0.99, threshold=3.0)),
}
_STATE = {"lamb": ("mu", "nu"), "lion": ("mu",), "novograd": ("mu", "nu"),
          "radam": ("mu", "nu")}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    spec, ref = OPTIMIZERS[name]
    rng = np.random.default_rng(12)
    p0 = {"w": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(4).astype(np.float32)}
    steps = 14  # radam rectifies from update 6 (b2 0.999) on
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) * 1e-2
              for k, v in p0.items()} for _ in range(steps)]
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in p0.items()}
    opt = resolve_optimizer(spec, learning_rate=0.05).build(
        list(params.values()))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = ref.init(jp)
    # Jitted, as the JAX package runs it: XLA fuses radam's f32 ro
    # differently from op-by-op dispatch (5.9747 against 5.9548 at update
    # 6), and the port matches the fused value.
    update = jax.jit(ref.update)
    for step, g in enumerate(grads):
        updates, state = update({k: jnp.asarray(v) for k, v in g.items()},
                                state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=1e-5,
                                       err_msg=f"{k} step {step}")
    inner = state[0]
    for k, p in params.items():
        st = opt.state[p]
        assert int(st["step"]) == int(inner.count) == steps
        for field in _STATE[name.split("_")[0]]:
            np.testing.assert_allclose(
                np.asarray(st[field]), np.asarray(getattr(inner, field)[k]),
                atol=1e-7, rtol=1e-5, err_msg=f"{field} {k}")


@pytest.mark.parametrize("name", sorted(_STATE))
def test_mlp_fit_under_optimizer_matches_jax(name):
    rng = np.random.default_rng(8)
    y = rng.integers(0, 3, 26)
    x = (rng.standard_normal((26, 5)) + y[:, None]).astype(np.float32)
    kw = dict(hidden_layer_sizes=(8,), num_classes=3, seed=1)
    jest, pest = JaxMLPC(**kw), MLPClassifier(**kw, device="cpu")
    jest.compute_dtype = pest.compute_dtype = "float32"
    jest._init_params(jnp.asarray(x[:1]))
    pest.load_state_dict({"params": _np_tree(jest.params)})
    spec = {"name": name, "learningRate": 0.01}
    for est in (jest, pest):
        est.compile(optimizer=spec)
        est.fit(x, y, epochs=3, batch_size=8, shuffle=False)
    np.testing.assert_allclose(pest.history["loss"], jest.history["loss"],
                               **TOL)
    _assert_tree_close(convert.params_to_jax(pest.module), jest.params,
                       **TOL)
    state, inner = pest.state_dict()["opt_state"], jest.opt_state[0]
    assert int(state["count"]) == int(inner.count) == 12
    assert set(state) == {"count", *_STATE[name]}
    for field in _STATE[name]:
        _assert_tree_close(state[field], getattr(inner, field), atol=1e-6,
                           rtol=1e-3)


def test_resolve_optimizer_takes_every_optax_name():
    for name in ("adam", "adamw", "sgd", "rmsprop", "adagrad", "lamb",
                 "lion", "novograd", "radam"):
        assert resolve_optimizer(name).name == name
    assert resolve_optimizer("lion").build(
        [torch.zeros(1, requires_grad=True)]).defaults["weight_decay"] == 1e-3
    with pytest.raises(TypeError):
        resolve_optimizer({"name": "radam", "nesterov": True})


# -- artifacts -----------------------------------------------------------------


def test_lstm_quantize_pytree_matches_jax_bits():
    jest = JaxLSTM(vocab_size=300, embed_dim=16, hidden_dim=64, seed=1)
    jest._init_params(jnp.asarray(_tokens(rows=1)[0]))
    pest = LSTMClassifier(vocab_size=300, embed_dim=16, hidden_dim=64,
                          device="cpu")
    pest.load_state_dict({"params": _np_tree(jest.params)})
    ref = jq.quantize_pytree(_np_tree(jest.params))
    out = pq.quantize_pytree(convert.flax_tree(pest.module))
    got = jax.tree_util.tree_leaves_with_path(
        out, is_leaf=lambda v: isinstance(v, pq.QuantizedLeaf))
    want = jax.tree_util.tree_leaves_with_path(
        ref, is_leaf=lambda v: isinstance(v, jq.QuantizedLeaf))
    assert [p for p, _ in got] == [p for p, _ in want]
    quantized = 0
    for (path, a), (_, b) in zip(got, want):
        if isinstance(b, jq.QuantizedLeaf):
            np.testing.assert_array_equal(a.values, b.values)
            np.testing.assert_array_equal(a.scales, b.scales)
            quantized += 1
        else:
            assert not isinstance(a, pq.QuantizedLeaf), path
    # Embed (300, 16) and the four (64, 64) hidden kernels.
    assert quantized == 5


def test_lstm_registry_and_int8_artifact():
    assert registry.resolve("learningorchestra_tpu_torch.models.text",
                            "LSTMClassifier") is LSTMClassifier
    x, y = _tokens()
    est = LSTMClassifier(vocab_size=300, embed_dim=16, hidden_dim=64,
                         device="cpu")
    assert est.compute_dtype == "float32"
    est.fit(x, y, epochs=1, batch_size=8)
    back = load_artifact(est.to_artifact(quantize=True), device="cpu")
    np.testing.assert_allclose(back.predict(x), est.predict(x), atol=5e-2)
    with pytest.raises(ValueError, match="token ids"):
        est.predict(np.full((1, 3), 300))
