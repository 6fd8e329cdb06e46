"""The port's mixture-of-experts layer and models against the JAX package
(``learningorchestra_tpu.ops.moe``, ``learningorchestra_tpu.models.moe``)
at a small size, weights carried from the JAX params with ``convert.py``:

- ``MoEMlp``: output, dispatch and combine (recorded from the JAX layer's
  einsums) at capacities that drop tokens, the one-expert layer against
  the dense gelu FFN, the aux loss and its gradient, the router kept in
  f32 under the bf16 cast;
- both models: logits, a few-step f32 fit (aux loss in the objective,
  batches in order) to the final parameters, and a dense model that
  takes no aux path;
- ``MoEDecoderLM``: ``generate`` equal to the JAX package's and to the
  naive full re-forward loop (``tests/lm_oracle.py``) in the drop-free
  configurations of ``tests/test_moe.py``, and the decode engine's
  continuous batching equal to a solo ``generate``;
- the int8 artifact (expert leaves flattened to (-1, last)), the program
  cache's fingerprint and the registry's aliases.

Tolerances are the ground rules': f32 forward 2e-5, f32 gradients 5e-5,
bf16 3e-2, model logits and fit trajectories 1e-4.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu.models.moe import MoEDecoderLM as JaxMoELM
from learningorchestra_tpu.models.moe import (
    MoETransformerClassifier as JaxMoEClassifier,
)
from learningorchestra_tpu.models.text import (
    TransformerClassifier as JaxTransformerClassifier,
)
from learningorchestra_tpu.ops import moe as jmoe
from learningorchestra_tpu.ops import quant as jquant
from learningorchestra_tpu.train.neural import _param_cast_for
from learningorchestra_tpu_torch import convert
from learningorchestra_tpu_torch.api.server import APIServer
from learningorchestra_tpu_torch.config import Config, StoreConfig
from learningorchestra_tpu_torch.models.moe import (
    MoEDecoderLM,
    MoETransformerClassifier,
)
from learningorchestra_tpu_torch.models.text import (
    DecoderLM,
    TransformerClassifier,
)
from learningorchestra_tpu_torch.ops import moe as pmoe
from learningorchestra_tpu_torch.ops.quant import QuantizedLeaf
from learningorchestra_tpu_torch.serve.decode import engine as dec_engine
from learningorchestra_tpu_torch.toolkit import registry
from learningorchestra_tpu_torch.train import compile_cache as cc
from learningorchestra_tpu_torch.train import neural
from tests.lm_oracle import naive_greedy_decode

F32 = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=5e-5, rtol=5e-5)
BF16 = dict(atol=3e-2, rtol=3e-2)
LOGITS = dict(atol=1e-4, rtol=1e-4)

CLS = dict(vocab_size=64, hidden_dim=16, num_layers=2, num_heads=2,
           max_len=8, num_experts=4, mlp_dim=16)
# tests/test_moe.py:223 and :250: two experts, top-2, capacity 1.5, so a
# teacher-forced forward never drops a token and decode equals it.
LM = dict(vocab_size=32, hidden_dim=32, num_layers=2, num_heads=2,
          max_len=16, num_experts=2, mlp_dim=16)
LM_VARIANTS = {"full": {}, "window": {"attention_window": 4}}
SGD_LR = 0.5


def _tree(variables):
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(rows, t, vocab, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, vocab, (rows, t)).astype(np.int32)
    x[1, t // 2:] = 0  # a pad tail
    return x


def _layer_pair(seed=0, **kw):
    """A flax ``MoEMlp`` with its variables and the port's layer carrying
    the same weights."""
    jl = jmoe.MoEMlp(**kw)
    x = _x((3, 10, kw["hidden_dim"]), seed)
    variables = jl.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    pl = pmoe.MoEMlp(kw["num_experts"], kw["hidden_dim"], kw["mlp_dim"],
                     top_k=kw.get("top_k", 2),
                     capacity_factor=kw.get("capacity_factor", 1.5))
    pl.load_state_dict(convert.params_from_jax(_tree(variables)))
    return jl, variables, pl, x


class _EinsumRecorder:
    """Stands in for ``jnp`` inside the JAX layer's module: records every
    einsum's operands (the dispatch tensor is the first einsum's first,
    the combine tensor the last one's first)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *operands):
        self.calls.append((spec, [np.asarray(o) for o in operands]))
        return jnp.einsum(spec, *operands)


# -- MoEMlp ---------------------------------------------------------------

LAYER_CASES = {
    "top2": dict(num_experts=4, top_k=2, capacity_factor=1.5),
    "top1": dict(num_experts=4, top_k=1, capacity_factor=1.0),
    "tight": dict(num_experts=4, top_k=2, capacity_factor=0.5),
    "k_over_e": dict(num_experts=2, top_k=3, capacity_factor=0.7),
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_mlp_output_matches_jax(case):
    jl, variables, pl, x = _layer_pair(hidden_dim=16, mlp_dim=32,
                                       **LAYER_CASES[case])
    ref = np.asarray(jl.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        out = pl(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, **F32)


@pytest.mark.parametrize("case", ["tight", "k_over_e", "top1"])
def test_dispatch_and_combine_equal_the_jax_layers(case, monkeypatch):
    """At capacities that drop tokens the port routes exactly as the JAX
    layer: the same (B, T, E, C) dispatch, bit for bit, and the same
    combine support with its gates within f32 rounding."""
    kw = LAYER_CASES[case]
    jl, variables, pl, x = _layer_pair(seed=5, hidden_dim=16, mlp_dim=32,
                                       **kw)
    rec = _EinsumRecorder()
    monkeypatch.setattr(jmoe, "jnp", rec)
    jl.apply(variables, jnp.asarray(x))
    monkeypatch.undo()
    assert [s for s, _ in rec.calls][0] == "btec,bth->ebch"
    want_dispatch = rec.calls[0][1][0]
    want_combine = rec.calls[-1][1][0]

    b, t, h = x.shape
    cap = pmoe.capacity(kw["num_experts"], kw["top_k"], t,
                        kw["capacity_factor"])
    logits = torch.nn.functional.linear(torch.from_numpy(x),
                                        pl.router.weight.detach())
    dispatch, combine, _, _ = pmoe.route(logits, kw["top_k"], cap)
    assert dispatch.shape == want_dispatch.shape
    np.testing.assert_array_equal(dispatch.numpy(), want_dispatch)
    np.testing.assert_array_equal(combine.numpy() > 0, want_combine > 0)
    np.testing.assert_allclose(combine.numpy(), want_combine, **F32)
    # Tokens were dropped: fewer admitted slots than routing choices.
    assert dispatch.sum() < b * t * min(kw["top_k"], kw["num_experts"])


def test_single_expert_equals_dense_ffn():
    """E=1, top-1, ample capacity (``tests/test_moe.py:49``): every token
    goes to the one expert with combine weight 1."""
    jl, variables, pl, x = _layer_pair(
        seed=1, num_experts=1, hidden_dim=8, mlp_dim=16, top_k=1,
        capacity_factor=2.0)
    p = variables["params"]
    w1, b1 = np.asarray(p["expert_w1"][0]), np.asarray(p["expert_b1"][0])
    w2, b2 = np.asarray(p["expert_w2"][0]), np.asarray(p["expert_b2"][0])
    dense = np.asarray(jax.nn.gelu(jnp.asarray(x @ w1 + b1))) @ w2 + b2
    with torch.no_grad():
        out = pl(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, dense, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out, np.asarray(jl.apply(
        variables, jnp.asarray(x))), **F32)


def test_aux_loss_and_its_gradient_match_jax():
    jl, variables, pl, x = _layer_pair(seed=3, num_experts=4, hidden_dim=8,
                                       mlp_dim=8, top_k=2)

    def objective(v):
        _, sown = jl.apply(v, jnp.asarray(x), mutable="losses")
        return sum(jnp.sum(s) for s in jax.tree_util.tree_leaves(sown))

    want = float(objective(variables))
    grads = _tree(jax.grad(objective)(variables))
    aux = []
    pl(torch.from_numpy(x), aux)
    assert len(aux) == 1 and aux[0].dtype == torch.float32
    np.testing.assert_allclose(aux[0].item(), want, **F32)
    aux[0].backward()
    got = convert.params_to_jax(pl)  # layout only; grads below
    assert set(got["params"]) == set(grads["params"])
    router = pl.router.weight.grad.T.numpy()  # (H, E), the flax kernel
    np.testing.assert_allclose(
        router, grads["params"]["router"]["kernel"], **GRAD)
    assert np.abs(router).max() > 0
    for key in pmoe.EXPERT_LEAVES:  # the aux loss never reaches them
        assert getattr(pl, key).grad is None
        assert not np.any(grads["params"][key])
    # Without a list the layer computes no aux loss.
    assert pl(torch.from_numpy(x)).shape == x.shape


def test_router_stays_f32_under_the_bf16_cast():
    jl, variables, pl, x = _layer_pair(seed=4, num_experts=4, hidden_dim=16,
                                       mlp_dim=32, top_k=2)
    cast = neural._cast_params(pl, torch.bfloat16)
    assert cast["router.weight"].dtype == torch.float32
    assert all(v.dtype == torch.bfloat16 for k, v in cast.items()
               if k != "router.weight")
    ref = jl.apply(_param_cast_for(jnp.bfloat16)(variables),
                   jnp.asarray(x, jnp.bfloat16))
    assert ref.dtype == jnp.bfloat16
    with torch.no_grad():
        out = torch.func.functional_call(
            pl, cast, (torch.from_numpy(x).to(torch.bfloat16),))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), **BF16)


# -- models ---------------------------------------------------------------


def _pair(jax_cls, port_cls, kw, x0, seed=3):
    """A JAX estimator initialised on ``x0`` and the port's carrying its
    weights, both in f32 and on plain SGD: Adam would turn the key bias's
    null gradient (its rounding noise) into learning-rate-sized steps on
    each side."""
    jest = jax_cls(**kw, seed=seed)
    jest.compute_dtype = "float32"
    jest._init_params(jnp.asarray(x0[:1]))
    pest = port_cls(**kw, device="cpu")
    pest.load_state_dict({"params": _tree(jest.params)})
    pest.compute_dtype = "float32"
    for est in (jest, pest):
        est.compile(optimizer="sgd", learning_rate=SGD_LR)
    return jest, pest


def _assert_params_match(jest, pest, **tol):
    a = jax.tree_util.tree_leaves_with_path(_tree(jest.params))
    b = jax.tree_util.tree_leaves(convert.params_to_jax(pest.module))
    assert len(a) == len(b)
    for (path, u), v in zip(a, b):
        np.testing.assert_allclose(v, u, err_msg=jax.tree_util.keystr(path),
                                   **tol)


def _cls_data(seed=0):
    x = _tokens(20, CLS["max_len"], CLS["vocab_size"], seed)
    return x, (x.sum(1) % 2).astype(np.int32)


def _lm_data(rows=16, t=10, seed=0):
    x = _tokens(rows, t, LM["vocab_size"], seed)
    return x, np.concatenate([x[:, 1:], np.zeros((rows, 1), np.int32)], 1)


MODELS = {
    "classifier": (JaxMoEClassifier, MoETransformerClassifier, CLS,
                   _cls_data),
    "decoder": (JaxMoELM, MoEDecoderLM, LM, _lm_data),
}


@pytest.fixture(scope="module")
def fits():
    """Each model fitted 2 epochs in f32 with the batches in order, from
    one carried initialisation, on both packages."""
    out = {}
    for name, (jcls, pcls, kw, data) in MODELS.items():
        x, y = data()
        jest, pest = _pair(jcls, pcls, kw, x)
        logits0 = (np.asarray(jest.predict(x)), pest.predict(x))
        jest.fit(x, y, epochs=2, batch_size=8, shuffle=False)
        pest.fit(x, y, epochs=2, batch_size=8, shuffle=False)
        out[name] = (jest, pest, logits0)
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_initial_logits_match_jax(fits, name):
    ref, out = fits[name][2]
    np.testing.assert_allclose(out, ref, **LOGITS)


@pytest.mark.parametrize("name", list(MODELS))
def test_fit_trajectory_with_aux_loss_matches_jax(fits, name):
    jest, pest, _ = fits[name]
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(pest.history[key], jest.history[key],
                                   **LOGITS)
    _assert_params_match(jest, pest, **LOGITS)
    x, _ = MODELS[name][3](seed=1)
    np.testing.assert_allclose(pest.predict(x), np.asarray(jest.predict(x)),
                               **LOGITS)


def test_fit_without_the_aux_loss_leaves_the_jax_trajectory(monkeypatch):
    """The aux term is in the objective: a port fit that drops it ends
    further from the JAX fit's router than the trajectory bar allows."""
    x, y = _cls_data()
    jest, pest = _pair(JaxMoEClassifier, MoETransformerClassifier, CLS, x)
    jest.fit(x, y, epochs=2, batch_size=8, shuffle=False)
    monkeypatch.setattr(type(pest.module), "takes_aux_losses", False)
    pest.fit(x, y, epochs=2, batch_size=8, shuffle=False)
    want = _tree(jest.params)["params"]["MoEBlock_1"]["MoEMlp_0"][
        "router"]["kernel"]
    got = pest.module.MoEBlock_1.MoEMlp_0.router.weight.detach().T.numpy()
    assert np.abs(got - want).max() > 10 * LOGITS["atol"]


def test_dense_model_takes_no_aux_path(monkeypatch):
    """A dense model's train step passes no ``aux_losses`` and adds
    nothing to its loss: its fit is the JAX one's within the bar."""
    x, y = _cls_data()
    kw = dict(vocab_size=64, hidden_dim=16, num_layers=2, num_heads=2,
              max_len=8)
    jest, pest = _pair(JaxTransformerClassifier, TransformerClassifier, kw,
                       x)
    calls = []
    real = neural.functional_call

    def spy(module, params, args, kwargs=None, **kw_):
        calls.append(kwargs)
        return real(module, params, args, kwargs, **kw_)

    monkeypatch.setattr(neural, "functional_call", spy)
    jest.fit(x, y, epochs=2, batch_size=8, shuffle=False)
    pest.fit(x, y, epochs=2, batch_size=8, shuffle=False)
    assert calls and all(not c for c in calls)
    np.testing.assert_allclose(pest.history["loss"], jest.history["loss"],
                               **LOGITS)
    _assert_params_match(jest, pest, **LOGITS)


def test_bf16_fit_matches_jax():
    x, y = _cls_data()
    jest, pest = _pair(JaxMoEClassifier, MoETransformerClassifier, CLS, x)
    jest.compute_dtype = pest.compute_dtype = "bfloat16"
    jest.fit(x, y, epochs=2, batch_size=8, shuffle=False)
    pest.fit(x, y, epochs=2, batch_size=8, shuffle=False)
    np.testing.assert_allclose(pest.history["loss"], jest.history["loss"],
                               **BF16)


# -- MoEDecoderLM decode ----------------------------------------------------


@pytest.fixture(scope="module")
def lms():
    """One JAX MoEDecoderLM per variant, fitted in f32 (decisive logits),
    and the port's with its weights."""
    out = {}
    for variant, extra in LM_VARIANTS.items():
        x, y = _lm_data(rows=8, t=12, seed=2)
        jest = JaxMoELM(**LM, **extra)
        jest.compute_dtype = "float32"
        jest.fit(x, y, epochs=2, batch_size=8, verbose=0)
        pest = MoEDecoderLM(**LM, **extra, device="cpu")
        pest.load_state_dict({"params": _tree(jest.params)})
        out[variant] = (jest, pest, x)
    return out


@pytest.mark.parametrize("variant", list(LM_VARIANTS))
def test_generate_matches_jax_and_the_naive_loop(lms, variant):
    jest, pest, x = lms[variant]
    prompts = x[:2, :6]
    out = pest.generate(prompts, max_new_tokens=4)
    assert out.dtype == np.int32 and out.shape == (2, 10)
    np.testing.assert_array_equal(
        out, np.asarray(jest.generate(prompts, max_new_tokens=4)))
    np.testing.assert_array_equal(out, naive_greedy_decode(jest, prompts,
                                                           10))


def test_engine_continuous_batching_equals_solo_generate(lms, tmp_path,
                                                         monkeypatch):
    """Slots admitted into a pool while another stream is mid-flight (each
    batch row its own routing group) decode what a solo generate of their
    prompt decodes."""
    _, est, x = lms["window"]
    server = APIServer(Config(store=StoreConfig(
        root=str(tmp_path / "store"), volume_root=str(tmp_path / "vols"))),
        device="cpu")
    server.ctx.volumes.save_estimator("train/pytorch", "moe_lm", est)
    server.ctx.artifacts.metadata.create("moe_lm", "train/pytorch")
    server.ctx.artifacts.metadata.mark_finished("moe_lm")
    real = dec_engine._ModelDecoder._step_pool

    def slowed(self, pool):
        time.sleep(0.03)
        return real(self, pool)

    monkeypatch.setattr(dec_engine._ModelDecoder, "_step_pool", slowed)
    eng = server.serving.decode
    try:
        first = [int(v) for v in x[0, :4]]
        a = eng.generate("moe_lm", first, max_new_tokens=10, stream=True)
        deadline = time.monotonic() + 30
        while len(a.tokens) < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert 0 < len(a.tokens) < 10, "stream A not mid-flight"
        late = [[int(v) for v in x[r, :n]] for r, n in ((2, 5), (3, 7))]
        out = eng.generate("moe_lm", late, max_new_tokens=6)
        assert a.wait_done(30)
        for prompt, got in zip(late, out["tokens"]):
            assert got == est.generate(np.asarray([prompt], np.int32),
                                       max_new_tokens=6)[0].tolist()
        assert first + a.tokens == est.generate(
            np.asarray([first], np.int32), max_new_tokens=10)[0].tolist()
    finally:
        server.shutdown()


# -- artifact, program cache, registry -------------------------------------


def test_int8_artifact_round_trips_the_expert_leaves():
    """The 3-D expert leaves go through ``quantize_pytree`` flattened to
    (-1, last), as the JAX package writes them, bit for bit; the load
    dequantizes them into the model, and an f32 state round-trips
    exactly (``tests/test_moe.py:158``)."""
    kw = dict(LM, num_experts=8, mlp_dim=64)  # b1 (8, 64) under the floor
    est = MoEDecoderLM(**kw, seed=2, device="cpu")
    tree = convert.params_to_jax(est.module)
    want = jquant.quantize_pytree(tree)["params"]["MoEBlock_1"]["MoEMlp_0"]
    art = est.to_artifact(quantize=True)
    moe = art["state"]["params"]["params"]["MoEBlock_1"]["MoEMlp_0"]
    for key in pmoe.EXPERT_LEAVES:
        leaf, ref = moe[key], want[key]
        shape = tree["params"]["MoEBlock_1"]["MoEMlp_0"][key].shape
        if len(shape) < 3:  # the biases: under 4,096 elements, kept f32
            assert not isinstance(leaf, QuantizedLeaf), key
            np.testing.assert_array_equal(leaf, ref)
            continue
        assert isinstance(leaf, QuantizedLeaf), key
        assert tuple(leaf.shape) == shape
        assert np.shape(leaf.values) == (shape[0] * shape[1], shape[2])
        np.testing.assert_array_equal(leaf.values, ref.values)
        np.testing.assert_array_equal(leaf.scales, ref.scales)
    loaded = neural.load_artifact(art, device="cpu")
    assert type(loaded) is MoEDecoderLM and loaded.num_experts == 8
    ref = jquant.dequantize_pytree(want)
    for key in pmoe.EXPERT_LEAVES:
        np.testing.assert_array_equal(
            getattr(loaded.module.MoEBlock_1.MoEMlp_0, key).detach().numpy(),
            ref[key])
    x, _ = _lm_data(seed=4)
    twin = MoEDecoderLM(**kw, device="cpu")
    twin.load_state_dict(est.state_dict())
    np.testing.assert_array_equal(twin.predict(x), est.predict(x))


def test_fingerprint_tells_moe_decoders_apart():
    def fp(cls, **kw):
        return cc.module_fingerprint(cls(**{**LM, **kw}, device="cpu")
                                     .module)

    dense = {k: v for k, v in LM.items() if k != "num_experts"}
    base = fp(MoEDecoderLM)
    assert base == fp(MoEDecoderLM)
    assert base != cc.module_fingerprint(DecoderLM(**dense,
                                                   device="cpu").module)
    for change in ({"top_k": 1}, {"capacity_factor": 2.0},
                   {"moe_every": 1}):
        assert fp(MoEDecoderLM, **change) != base, change


def test_registry_resolves_the_moe_classes():
    for path in ("learningorchestra_tpu.models.moe",
                 "learningorchestra_tpu.models",
                 "learningorchestra_tpu_torch.models.moe"):
        assert registry.resolve(path, "MoEDecoderLM") is MoEDecoderLM
        assert registry.resolve(path, "MoETransformerClassifier") is \
            MoETransformerClassifier
    # The long-context family resolves through the same zoo paths.
    from learningorchestra_tpu_torch.models.longcontext import (
        LongContextTransformer,
    )

    for path in ("learningorchestra_tpu.models",
                 "learningorchestra_tpu.models.longcontext"):
        assert registry.resolve(path, "LongContextTransformer") is \
            LongContextTransformer
    est = registry.resolve("learningorchestra_tpu.models",
                           "LongContextTransformer")(
        vocab_size=64, hidden_dim=16, num_layers=1, num_heads=2,
        max_len=32, device="cpu")
    assert est.max_len == 32 and est.module.Embed_1.num_embeddings == 32
    with pytest.raises(registry.RegistryError):
        registry.resolve("learningorchestra_tpu.models", "NoSuchModel")
    assert registry.validate_init_params(
        "learningorchestra_tpu.models.moe", "MoEDecoderLM",
        {"num_experts": 4, "device": "cpu"}) == ["device"]
