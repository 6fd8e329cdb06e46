"""The port's training slice (``NeuralEstimator.fit``) against the JAX
package, from the same initial parameters (carried with ``convert.py``)
and the same batch order (``shuffle=False``).

- a 2-layer BERT with flash attention (Pallas in interpret mode on the JAX
  side, the plain K1/K2/K3 arithmetic on the port's): loss history and
  final params within 1e-4 in f32, loss history within 3e-2 in bf16;
- the MLP estimators' fit / evaluate / score, ``accumulate_steps``,
  ``validation_split``;
- the five optimizers against optax with optax's defaults, and the
  learning-rate schedules against optax's for steps 0..N.

Under Adam the bar for the final params is the key bias: its gradient is
zero in exact arithmetic (softmax ignores a per-row shift), so each side
normalizes its own rounding noise into steps of up to the learning rate.
At BERT's 2e-5 that stays inside 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from learningorchestra_tpu.models.mlp import MLPClassifier as JaxMLPC
from learningorchestra_tpu.models.mlp import MLPRegressor as JaxMLPR
from learningorchestra_tpu.models.text import BertModel as JaxBert
from learningorchestra_tpu.toolkit import base as jax_base
from learningorchestra_tpu.train.neural import (
    resolve_learning_rate as jax_lr,
)
from learningorchestra_tpu_torch import convert
from learningorchestra_tpu_torch.models.mlp import MLPClassifier, MLPRegressor
from learningorchestra_tpu_torch.models.text import BertModel
from learningorchestra_tpu_torch.ops.quant import has_quantized_leaves
from learningorchestra_tpu_torch.toolkit import base, registry
from learningorchestra_tpu_torch.train import neural
from learningorchestra_tpu_torch.train.neural import (
    EarlyStopping,
    load_artifact,
    resolve_learning_rate,
    resolve_optimizer,
)

SMALL = dict(vocab_size=64, hidden_dim=32, num_layers=2, num_heads=2,
             max_len=16)
TOL = dict(atol=1e-4, rtol=1e-4)


def _tokens(rows=20, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, SMALL["vocab_size"], (rows, SMALL["max_len"]),
                     dtype=np.int32)
    x[0, 10:] = 0  # pad tails
    x[5, 3:] = 0
    x[3] = 0  # an all-pad row masks every key
    return x, (x[:, 0] % 2).astype(np.int32)


def _leaves(tree):
    return jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, tree))


def _assert_params_match(jax_est, port_est, **tol):
    a = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jax_est.params))
    b = _leaves(convert.params_to_jax(port_est.module))
    assert len(a) == len(b)
    for (path, u), v in zip(a, b):
        np.testing.assert_allclose(v, u, err_msg=jax.tree_util.keystr(path),
                                   **tol)


def _pair_bert(dtype):
    x, _ = _tokens()
    jest = JaxBert(**SMALL, use_flash=True, seed=3)
    jest.compute_dtype = dtype
    jest._init_params(jnp.asarray(x[:1]))
    pest = BertModel(**SMALL, device="cpu")
    pest.load_state_dict({"params": _leaves_tree(jest.params)})
    pest.compute_dtype = dtype
    return jest, pest


def _leaves_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def bert_fits():
    """Both packages fit 2 epochs of 3 batches (the last padded) in f32
    and in bf16; the JAX side is the slow part (interpret-mode flash)."""
    x, y = _tokens()
    out = {}
    for dtype in ("float32", "bfloat16"):
        jest, pest = _pair_bert(dtype)
        jest.fit(x, y, epochs=2, batch_size=8, shuffle=False)
        pest.fit(x, y, epochs=2, batch_size=8, shuffle=False)
        out[dtype] = (jest, pest)
    return out


def test_bert_fit_matches_jax_f32(bert_fits):
    jest, pest = bert_fits["float32"]
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(pest.history[key], jest.history[key],
                                   **TOL)
    assert len(pest.history["epoch_time"]) == 2
    _assert_params_match(jest, pest, **TOL)
    x, y = _tokens(seed=1)
    got, want = pest.evaluate(x, y), jest.evaluate(x, y)
    assert set(got) == set(want) == {"loss", "accuracy"}
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **TOL)
    np.testing.assert_allclose(pest.predict(x), np.asarray(jest.predict(x)),
                               **TOL)


def test_bert_fit_matches_jax_bf16(bert_fits):
    jest, pest = bert_fits["bfloat16"]
    np.testing.assert_allclose(pest.history["loss"], jest.history["loss"],
                               atol=3e-2, rtol=3e-2)
    x, y = _tokens(seed=1)
    np.testing.assert_allclose(pest.evaluate(x, y)["loss"],
                               jest.evaluate(x, y)["loss"], atol=3e-2,
                               rtol=3e-2)


def test_bert_opt_state_has_optax_layout(bert_fits):
    jest, pest = bert_fits["float32"]
    state = pest.state_dict()["opt_state"]
    adam = jest.opt_state[0]
    assert int(state["count"]) == int(adam.count) == 6
    for field in ("mu", "nu"):
        got = jax.tree_util.tree_leaves_with_path(state[field])
        want = jax.tree_util.tree_leaves_with_path(
            _leaves_tree(getattr(adam, field)))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-3,
                                       err_msg=f"{field}{path}")


def test_bert_artifact_resumes_the_same_trajectory(bert_fits):
    _, pest = bert_fits["float32"]
    x, y = _tokens(seed=2)
    art = pest.to_artifact()
    assert art["classParameters"]["learning_rate"] == 2e-5
    twin = load_artifact(art, device="cpu")
    twin.compute_dtype = pest.compute_dtype = "float32"
    state = pest.state_dict()
    pest.fit(x, y, epochs=1, batch_size=8, shuffle=False)
    twin.fit(x, y, epochs=1, batch_size=8, shuffle=False,
             quantize_checkpoint=True)
    assert twin.history["loss"][:2] == state["history"]["loss"]
    assert twin.history["loss"][-1] == pest.history["loss"][-1]
    for a, b in zip(pest.module.parameters(), twin.module.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # quantize_checkpoint marks the saved artifact int8, moments dropped.
    saved = twin.to_artifact()["state"]
    assert saved["opt_state"] is None
    assert has_quantized_leaves(saved["params"])
    assert pest.to_artifact()["state"]["opt_state"] is not None


def _mlp_pair(jax_cls, port_cls, x, **kw):
    jest = jax_cls(**kw)
    jest.compute_dtype = "float32"
    jest._init_params(jnp.asarray(x[:1]))
    pest = port_cls(**kw, device="cpu")
    pest.load_state_dict({"params": _leaves_tree(jest.params)})
    pest.compute_dtype = "float32"
    return jest, pest


def _blobs(n=26, d=5, classes=3, seed=4):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n)
    x = rng.standard_normal((n, d)) + y[:, None] * 1.5  # float64 on purpose
    return x, y


def test_mlp_classifier_fit_evaluate_score_match_jax():
    x, y = _blobs()
    jest, pest = _mlp_pair(JaxMLPC, MLPClassifier, x,
                           hidden_layer_sizes=(16, 8), num_classes=3,
                           learning_rate=1e-2, seed=1)
    jest.fit(x, y, epochs=3, batch_size=8, shuffle=False,
             validation_split=0.25)
    pest.fit(x, y, epochs=3, batch_size=8, shuffle=False,
             validation_split=0.25)
    assert set(pest.history) == set(jest.history)
    for key in ("loss", "accuracy", "val_loss", "val_accuracy"):
        np.testing.assert_allclose(pest.history[key], jest.history[key],
                                   err_msg=key, **TOL)
    _assert_params_match(jest, pest, **TOL)
    for key, val in jest.evaluate(x, y).items():
        np.testing.assert_allclose(pest.evaluate(x, y)[key], val, **TOL)
    assert pest.score(x, y) == pytest.approx(jest.score(x, y), abs=1e-6)
    np.testing.assert_array_equal(pest.predict_classes(x),
                                  np.asarray(jest.predict_classes(x)))


@pytest.mark.parametrize("out_dim", [1, 2])
def test_mlp_regressor_matches_jax(out_dim):
    x, _ = _blobs(n=20, seed=6)
    y = (x[:, :out_dim] * 0.5 + 0.1).astype(np.float32)
    if out_dim == 1:
        y = y[:, 0]
    jest, pest = _mlp_pair(JaxMLPR, MLPRegressor, x,
                           hidden_layer_sizes=(8,), out_dim=out_dim,
                           learning_rate=1e-2)
    jest.fit(x, y, epochs=2, batch_size=8, shuffle=False)
    pest.fit(x, y, epochs=2, batch_size=8, shuffle=False)
    np.testing.assert_allclose(pest.history["loss"], jest.history["loss"],
                               **TOL)
    _assert_params_match(jest, pest, **TOL)
    np.testing.assert_allclose(pest.evaluate(x, y)["loss"],
                               jest.evaluate(x, y)["loss"], **TOL)


def test_accumulate_steps_match_multisteps():
    x, y = _blobs(n=28, seed=8)
    jest, pest = _mlp_pair(JaxMLPC, MLPClassifier, x,
                           hidden_layer_sizes=(8,), num_classes=3,
                           learning_rate=1e-2)
    # 7 batches an epoch: the third epoch starts mid-accumulation.
    for est in (jest, pest):
        est.fit(x, y, epochs=3, batch_size=4, shuffle=False,
                accumulate_steps=2)
    np.testing.assert_allclose(pest.history["loss"], jest.history["loss"],
                               **TOL)
    _assert_params_match(jest, pest, **TOL)
    state = pest.state_dict()["opt_state"]
    assert int(state["mini_step"]) == 1 and int(state["gradient_step"]) == 10
    assert int(state["inner_opt_state"]["count"]) == 10
    # The pending half-accumulated gradient survives an artifact.
    twin = load_artifact(pest.to_artifact(), device="cpu")
    twin.compute_dtype = "float32"
    for est in (pest, twin):
        est.fit(x, y, epochs=1, batch_size=4, shuffle=False,
                accumulate_steps=2)
    assert twin.history["loss"] == pest.history["loss"]
    for a, b in zip(pest.module.parameters(), twin.module.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_early_stopping_restores_best_weights():
    x, y = _blobs(seed=9)
    est = MLPClassifier(hidden_layer_sizes=(8,), num_classes=3,
                        learning_rate=0.5, device="cpu")
    seen = []

    def spy(epoch, metrics, model):
        seen.append((metrics["loss"], neural.snapshot_params(model.params)))

    stop = EarlyStopping(monitor="loss", patience=1,
                         restore_best_weights=True)
    # min_delta larger than any gain: epoch 0 is the best, epoch 1 stops.
    stop.min_delta = 1e9
    est.fit(x, y, epochs=5, batch_size=8, callbacks=[spy, stop])
    assert len(est.history["loss"]) == 2 and est.stop_training
    assert stop.best_epoch == 0 and est.opt_state is None
    for name, p in est.params.items():
        torch.testing.assert_close(p.detach(), seen[0][1][name])
    est.fit(x, y, epochs=1, batch_size=8)  # fresh moments, trains again
    assert est.opt_state is not None
    spec = EarlyStopping.from_spec({"monitor": "val_loss",
                                    "restoreBestWeights": True})
    assert spec.restore_best_weights and spec.monitor == "val_loss"


def test_shuffled_epoch_sees_every_row_once():
    x = np.arange(10, dtype=np.float32)[:, None]
    est = MLPRegressor(hidden_layer_sizes=(2,), device="cpu")
    est.fit(x, x[:, 0], epochs=1)  # builds the module and optimizer
    seen = []
    real_step = est._train_step

    def spy(xb, yb, mb, *args):
        seen.append((xb[mb > 0, 0].tolist(), int(mb.sum())))
        return real_step(xb, yb, mb, *args)

    est._train_step = spy
    xs = torch.from_numpy(x)
    loss_fn = est._loss_and_metrics("mse")
    orders = []
    for epoch in (0, 1):
        seen.clear()
        est._device_epoch(xs, xs[:, 0], loss_fn, None, 4, True, epoch)
        rows = [r for batch, _ in seen for r in batch]
        assert sorted(rows) == list(range(10))
        assert [m for _, m in seen] == [4, 4, 2]  # the tail is padded
        orders.append(rows)
    assert orders[0] != orders[1] and orders[0] != list(range(10))


OPTIMIZERS = {
    "adam": ({"name": "adam"}, optax.adam(0.05)),
    "adamw": ({"name": "adamw"}, optax.adamw(0.05)),
    "sgd": ({"name": "sgd"}, optax.sgd(0.05)),
    "sgd_nesterov": ({"name": "sgd", "momentum": 0.9, "nesterov": True},
                     optax.sgd(0.05, momentum=0.9, nesterov=True)),
    "rmsprop": ({"name": "rmsprop"}, optax.rmsprop(0.05)),
    "rmsprop_momentum": ({"name": "rmsprop", "momentum": 0.5},
                         optax.rmsprop(0.05, momentum=0.5)),
    "adagrad": ({"name": "adagrad"}, optax.adagrad(0.05)),
    "adam_warmup_cosine": (
        {"name": "adam", "learningRate": {
            "schedule": "warmup_cosine", "peakValue": 0.05,
            "warmupSteps": 2, "decaySteps": 5}},
        optax.adam(optax.warmup_cosine_decay_schedule(0.0, 0.05, 2, 5)),
    ),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    spec, ref = OPTIMIZERS[name]
    rng = np.random.default_rng(11)
    p0 = rng.standard_normal((3, 4)).astype(np.float32)
    grads = rng.standard_normal((6, 3, 4)).astype(np.float32) * 1e-2
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt_spec = resolve_optimizer(spec, learning_rate=0.05)
    opt = opt_spec.build([p])
    jp, state = jnp.asarray(p0), ref.init(jnp.asarray(p0))
    for step, g in enumerate(grads):
        updates, state = ref.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for group in opt.param_groups:
            group["lr"] = opt_spec.lr(step)
        p.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                   atol=1e-6, rtol=1e-5,
                                   err_msg=f"step {step}")


SCHEDULES = [
    {"schedule": "warmup_cosine", "peakValue": 3e-4, "warmupSteps": 3,
     "decaySteps": 10, "endValue": 1e-5},
    {"schedule": "cosine", "initValue": 1e-3, "decaySteps": 7, "alpha": 0.1},
    {"schedule": "exponential", "initValue": 1e-2, "transitionSteps": 3,
     "decayRate": 0.5},
    {"schedule": "exponential", "initValue": 1e-2, "transitionSteps": 3,
     "decayRate": 0.5, "staircase": True},
    {"schedule": "piecewise", "initValue": 0.1,
     "boundariesAndScales": {"3": 0.5, "6": 0.1}},
    {"schedule": "constant", "value": 0.02},
]


@pytest.mark.parametrize("spec", SCHEDULES,
                         ids=lambda s: s["schedule"] + str(len(s)))
def test_schedules_match_optax(spec):
    ours, ref = resolve_learning_rate(spec), jax_lr(spec)
    for step in range(13):
        got = ours(step) if callable(ours) else ours
        want = float(ref(step)) if callable(ref) else ref
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


def test_optimizer_specs_and_compile():
    with pytest.raises(NotImplementedError, match="A.1"):
        resolve_optimizer("lamb")
    with pytest.raises(ValueError, match="unknown optimizer"):
        resolve_optimizer("bogus")
    with pytest.raises(TypeError):
        resolve_optimizer({"name": "adam", "nope": 1})
    assert resolve_optimizer({"name": "adamw"}).kwargs == {}
    opt = resolve_optimizer({"name": "adamw"}).build(
        [torch.zeros(1, requires_grad=True)])
    assert opt.defaults["weight_decay"] == 1e-4  # optax's, not torch's
    est = MLPClassifier(hidden_layer_sizes=(4,), device="cpu",
                        learning_rate=1e-3)
    est.compile(optimizer="sgd")
    est.compile(learningRate=0.5)
    assert est.optimizer.name == "sgd" and est.optimizer.lr(0) == 0.5
    est.compile(optimizer=resolve_optimizer("adam"))
    with pytest.raises(ValueError, match="baked in"):
        est.compile(learning_rate=0.1)
    with pytest.raises(NotImplementedError, match="A.5"):
        est.fit(np.zeros((2, 3)), np.zeros(2), checkpoint_dir="/nowhere")


def test_mlp_registry_and_artifact_round_trip():
    x, y = _blobs(n=12)
    est = MLPClassifier(hidden_layer_sizes=(6,), num_classes=3,
                        device="cpu")
    with pytest.raises(RuntimeError, match="before fit"):
        est.predict(x)
    est.fit(x, y, epochs=1, batch_size=4)
    assert registry.resolve(
        "learningorchestra_tpu_torch.models.mlp", "MLPClassifier"
    ) is MLPClassifier
    back = load_artifact(est.to_artifact(), device="cpu")
    np.testing.assert_array_equal(back.predict(x), est.predict(x))
    assert back.hidden_layer_sizes == (6,)


@pytest.mark.parametrize("value", [
    [[1.5, 2.0], [3.0, 4.0]], np.arange(6, dtype=np.int64).reshape(2, 3),
    np.array([[1, "2"], [3, 4]], dtype=object), np.float64([0.25, 1e-3]),
])
def test_toolkit_coercion_matches_jax(value):
    want = np.asarray(jax_base.as_array(value))
    got = base.as_array(value)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    torch_in = base.as_array(torch.from_numpy(np.asarray(got)))
    np.testing.assert_array_equal(torch_in, want)
    if np.asarray(value).dtype != object:  # jnp refuses object labels
        np.testing.assert_array_equal(base.as_labels(value),
                                      np.asarray(jax_base.as_labels(value)))


def test_encode_classes_set_params_and_score():
    y = np.array(["b", "a", "c", "a"])
    for got, want in zip(base.encode_classes(y), jax_base.encode_classes(y)):
        np.testing.assert_array_equal(got, want)

    class Fixed(base.Estimator):
        def __init__(self, answer=1):
            self.answer = answer

        def predict(self, x):
            return torch.full((len(x),), self.answer)

    est = Fixed().set_params(answer=2)
    assert est.get_params() == {"answer": 2}
    assert est.score(np.zeros((4, 1)), [2, 2, 0, 2]) == 0.75
