"""The port's vision zoo (``models/vision.py``) against the JAX package's,
from weights carried out of the JAX init with ``convert.py``:

- forward logits in f32 within 1e-4 for every model at an odd and an
  even spatial size (the even sizes pad strided and even-kernel SAME
  convs asymmetrically, the odd ones symmetrically), the small ``_ResNet``
  with both block types with and without the space-to-depth stem,
  ResNet50 itself at 32x32, VGG16 at 28x28 and MobileNet at width
  multipliers 0.25 and 0.75;
- ``fit`` of MnistCNN and a small ``_ResNet`` under ``shuffle=False``:
  loss history and final params within 1e-4 in f32, loss history within
  3e-2 in bf16;
- ``remat`` (True, "dots") against ``remat=False``: the same parameter
  names and f32 gradients, for ``_ResNet`` and ``BertModel``;
- ``quantize_pytree`` of a vision tree bit-identical to the JAX
  package's, leaf by leaf, and an int8 artifact round trip.

The small ResNet's even size is 64, not 32: at 32 its last stage runs at
1x1 with two channels per GroupNorm group, where a variance of two nearly
equal numbers makes the logits ill-conditioned (each f32 side strays ~1e-4
from the f64 value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu.models import vision as jv
from learningorchestra_tpu.ops import quant as jq
from learningorchestra_tpu.train.neural import NeuralEstimator as JaxEstimator
from learningorchestra_tpu_torch import convert
from learningorchestra_tpu_torch.models import vision as pv
from learningorchestra_tpu_torch.models.text import BertModel
from learningorchestra_tpu_torch.ops import quant as pq
from learningorchestra_tpu_torch.toolkit import registry
from learningorchestra_tpu_torch.train.neural import SizedEstimator, load_artifact

TOL = dict(atol=1e-4, rtol=1e-4)
SMALL = dict(stage_sizes=(1, 1, 1, 1), num_classes=5, width=8)
BLOCKS = {"basic": (jv._ResNetBlock, pv._ResNetBlock),
          "bottleneck": (jv._BottleneckBlock, pv._BottleneckBlock)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _image(n, hw, c, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, hw, hw, c)).astype(np.float32)


def _pair(name, hw):
    """(JAX module, port module, input) of one forward case."""
    if name == "mnist":
        return jv._MnistCNN(num_classes=10), pv._MnistCNN(10), \
            _image(3, hw, 1)
    if name.startswith("resnet_"):
        _, block, stem = name.split("_")
        jb, pb = BLOCKS[block]
        s2d = stem == "s2d"
        return (jv._ResNet(block=jb, s2d_stem=s2d, **SMALL),
                pv._ResNet(block=pb, s2d_stem=s2d, **SMALL),
                _image(2, hw, 3))
    if name == "resnet50":
        return (jv._ResNet(stage_sizes=(3, 4, 6, 3),
                           block=jv._BottleneckBlock, num_classes=10),
                pv._ResNet((3, 4, 6, 3), pv._BottleneckBlock,
                           num_classes=10), _image(2, hw, 3))
    if name == "vgg16":
        return jv._VGG(num_classes=5), pv._VGG(5), _image(2, hw, 1)
    wm = float(name.split("_")[1])
    return (jv._MobileNet(num_classes=5, width_multiplier=wm),
            pv._MobileNet(5, wm), _image(2, hw, 3))


_INITS: dict = {}


def _jax_init(jmod, x):
    """The JAX init of ``jmod`` for inputs shaped like ``x``, once per
    architecture: only MnistCNN's parameters depend on the spatial size.
    The counter-based ``unsafe_rbg`` key compiles in half threefry's time;
    the init is flax's all the same."""
    key = (repr(jmod), x.shape[1:] if isinstance(jmod, jv._MnistCNN)
           else x.shape[-1])
    if key not in _INITS:
        _INITS[key] = jax.jit(jmod.init)(
            jax.random.key(1, impl="unsafe_rbg"), jnp.asarray(x[:1]))
    return _INITS[key]


def _carry(jmod, pmod, x):
    params = _jax_init(jmod, x)
    tree = _np_tree(params)
    pmod.build(**pmod.dims_of_input(x))
    pmod.load_state_dict(convert.params_from_jax(tree))
    return params, tree


FORWARD = [
    ("mnist", 28), ("mnist", 27),
    *[(f"resnet_{b}_{s}", hw) for b in BLOCKS for s in ("conv", "s2d")
      for hw in (33, 64)],
    ("resnet50", 32),
    ("vgg16", 28), ("vgg16", 27),
    *[(f"mobilenet_{wm}", hw) for wm in (0.25, 0.75) for hw in (33, 32)],
]


@pytest.mark.parametrize("name,hw", FORWARD, ids=[f"{n}-{h}" for n, h in
                                                  FORWARD])
def test_forward_logits_match_jax(name, hw):
    jmod, pmod, x = _pair(name, hw)
    params, tree = _carry(jmod, pmod, x)
    want = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = pmod(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    # The carry is exact both ways, leaf by leaf, under the flax names.
    a = jax.tree_util.tree_leaves_with_path(tree)
    b = jax.tree_util.tree_leaves_with_path(convert.params_to_jax(pmod))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, u), (_, v) in zip(a, b):
        np.testing.assert_array_equal(v, u, err_msg=str(path))


def test_mnist_takes_flat_and_channelless_images():
    jmod, pmod, x = _pair("mnist", 28)
    _carry(jmod, pmod, x)
    with torch.no_grad():
        want = pmod(torch.from_numpy(x))
        for shaped in (x.reshape(3, 784), x[..., 0]):
            torch.testing.assert_close(pmod(torch.from_numpy(shaped)), want,
                                       rtol=0, atol=0)


# -- fits ----------------------------------------------------------------------


def _fit_pair(kind, dtype):
    """Both packages fit 2 epochs of 3 batches (the last padded) from the
    JAX init.  The ResNet fits with SGD + momentum: a conv followed by a
    GroupNorm has gradient components that are zero in exact arithmetic
    (the group mean absorbs them), and Adam would normalize each side's
    rounding noise there into steps of up to the learning rate."""
    if kind == "mnist":
        x = _image(20, 28, 1, seed=3)
        jest, pest = jv.MnistCNN(seed=2), pv.MnistCNN(seed=2, device="cpu")
    else:
        x = _image(20, 33, 3, seed=3)
        opt = {"name": "sgd", "momentum": 0.9}
        jest = JaxEstimator(jv._ResNet(block=jv._BottleneckBlock, **SMALL),
                            loss="softmax_ce", optimizer=opt,
                            learning_rate=0.01, seed=2)
        pest = SizedEstimator(
            pv._ResNet(block=pv._BottleneckBlock, **SMALL),
            loss="softmax_ce", optimizer=opt, learning_rate=0.01, seed=2,
            device="cpu")
    y = (np.abs(x).reshape(len(x), -1).sum(1) > np.median(
        np.abs(x).reshape(len(x), -1).sum(1))).astype(np.int32)
    jest.compute_dtype = pest.compute_dtype = dtype
    # A copy: the JAX fit donates its parameter buffers.
    jest.params = jax.tree_util.tree_map(jnp.copy, _jax_init(jest.module, x))
    jest.opt_state = jest.optimizer.init(jest.params)
    pest.load_state_dict({"params": _np_tree(jest.params)})
    for est in (jest, pest):
        est.fit(x, y, epochs=2, batch_size=8, shuffle=False)
    return jest, pest, x, y


@pytest.fixture(scope="module")
def fits():
    return {(kind, dtype): _fit_pair(kind, dtype)
            for kind in ("mnist", "resnet")
            for dtype in ("float32", "bfloat16")}


@pytest.mark.parametrize("kind", ["mnist", "resnet"])
def test_fit_matches_jax_f32(fits, kind):
    jest, pest, x, y = fits[(kind, "float32")]
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(pest.history[key], jest.history[key],
                                   err_msg=key, **TOL)
    a = jax.tree_util.tree_leaves_with_path(_np_tree(jest.params))
    b = jax.tree_util.tree_leaves(convert.params_to_jax(pest.module))
    assert len(a) == len(b)
    for (path, u), v in zip(a, b):
        np.testing.assert_allclose(v, u, err_msg=str(path), **TOL)
    np.testing.assert_allclose(pest.predict(x), np.asarray(jest.predict(x)),
                               **TOL)


@pytest.mark.parametrize("kind", ["mnist", "resnet"])
def test_fit_matches_jax_bf16(fits, kind):
    jest, pest, _, _ = fits[(kind, "bfloat16")]
    np.testing.assert_allclose(pest.history["loss"], jest.history["loss"],
                               atol=3e-2, rtol=3e-2)


# -- remat ---------------------------------------------------------------------


def _grads(module, x, y, dtype=None):
    from torch.func import functional_call

    params = {n: p.to(dtype) if dtype else p
              for n, p in module.named_parameters()}
    if dtype is not None and x.is_floating_point():
        x = x.to(dtype)
    out = functional_call(module, params, (x,))
    torch.nn.functional.cross_entropy(out.float(), y).backward()
    grads = {n: p.grad.clone() for n, p in module.named_parameters()}
    module.zero_grad(set_to_none=True)
    return grads


@pytest.mark.parametrize("remat", [True, "dots"])
def test_resnet_remat_keeps_names_and_gradients(remat):
    x = torch.from_numpy(_image(2, 33, 3, seed=5))
    y = torch.tensor([1, 3])
    ref = pv._ResNet(block=pv._BottleneckBlock, **SMALL)
    ref.build(in_channels=3)
    mod = pv._ResNet(block=pv._BottleneckBlock, remat=remat, **SMALL)
    mod.build(in_channels=3)
    mod.load_state_dict(ref.state_dict())
    assert [n for n, _ in mod.named_parameters()] == \
        [n for n, _ in ref.named_parameters()]
    want, got = _grads(ref, x, y), _grads(mod, x, y)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)
    # bf16 copies swapped in for the forward are what the recompute reads.
    want, got = _grads(ref, x, y, torch.bfloat16), \
        _grads(mod, x, y, torch.bfloat16)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)


def test_remat_rejects_unknown_values():
    with pytest.raises(ValueError, match="remat must be"):
        pv.ResNet18(remat="everything", device="cpu")


@pytest.mark.parametrize("remat", [True, "dots"])
def test_bert_remat_keeps_names_and_f32_gradients(remat):
    kw = dict(vocab_size=64, hidden_dim=32, num_layers=2, num_heads=2,
              max_len=16, device="cpu")
    ref, est = BertModel(**kw), BertModel(**kw, remat=remat)
    est.load_state_dict(ref.state_dict())
    assert list(est.params) == list(ref.params)
    assert type(est.module.encoder.TransformerBlock_1).__name__ == \
        "TransformerBlock"
    tokens = np.random.default_rng(1).integers(1, 64, (3, 16))
    tokens[0, 9:] = 0
    x, y = torch.from_numpy(tokens), torch.tensor([0, 1, 1])
    ref.module.train(), est.module.train()
    want, got = _grads(ref.module, x, y), _grads(est.module, x, y)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)


# -- artifacts -----------------------------------------------------------------


def test_vision_quantize_pytree_matches_jax_bits():
    jmod, pmod, x = _pair("mobilenet_0.75", 33)
    _, tree = _carry(jmod, pmod, x)
    jm2, pm2, x2 = _pair("resnet_bottleneck_conv", 33)
    tree = {"mobilenet": tree, "resnet": _carry(jm2, pm2, x2)[1]}
    ref = jq.quantize_pytree(tree)
    # The port's own tree (tensors) quantizes to the JAX artifact's bytes.
    out = pq.quantize_pytree({"mobilenet": convert.flax_tree(pmod),
                              "resnet": convert.flax_tree(pm2)})
    got = jax.tree_util.tree_leaves_with_path(
        out, is_leaf=lambda v: isinstance(v, pq.QuantizedLeaf))
    want = jax.tree_util.tree_leaves_with_path(
        ref, is_leaf=lambda v: isinstance(v, jq.QuantizedLeaf))
    assert [p for p, _ in got] == [p for p, _ in want]
    widths = set()
    for (path, a), (_, b) in zip(got, want):
        assert isinstance(a, pq.QuantizedLeaf) == isinstance(
            b, jq.QuantizedLeaf), path
        if isinstance(a, pq.QuantizedLeaf):
            assert a.shape == tuple(b.shape), path
            np.testing.assert_array_equal(a.values, b.values)
            np.testing.assert_array_equal(a.scales, b.scales)
            widths.add(a.values.shape[1])
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # Conv kernels flatten to (kh*kw*cin, cout): their cout is the width
    # (MobileNet x0.75's pointwise 96..768, the ResNet's 32..256).
    assert {32, 64, 96, 128, 192, 256, 384, 768} <= widths


@pytest.mark.parametrize("cls", ["MnistCNN", "ResNet18", "ResNet50",
                                 "VGG16", "MobileNet"])
def test_registry_resolves_the_zoo(cls):
    got = registry.resolve("learningorchestra_tpu_torch.models.vision", cls)
    assert got is getattr(pv, cls)
    import inspect

    want = inspect.signature(getattr(jv, cls).__init__).parameters
    have = inspect.signature(got.__init__).parameters
    for name, param in want.items():
        assert have[name].default == param.default, name
    assert have["device"].default == "cuda"


def test_int8_artifact_round_trip_on_cpu():
    x = _image(12, 28, 1, seed=6)
    y = np.arange(12) % 10
    est = pv.MnistCNN(device="cpu")
    with pytest.raises(RuntimeError, match="before fit"):
        est.predict(x)
    est.fit(x, y, epochs=1, batch_size=4)
    art = est.to_artifact(quantize=True)
    assert pq.has_quantized_leaves(art["state"]["params"])
    back = load_artifact(art, device="cpu")
    assert back.module.Dense_0.in_features == 3136
    np.testing.assert_allclose(back.predict(x), est.predict(x), atol=5e-2)
    full = load_artifact(est.to_artifact(), device="cpu")
    np.testing.assert_array_equal(full.predict(x), est.predict(x))
