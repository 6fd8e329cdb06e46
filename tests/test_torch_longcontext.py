"""The port's long-context transformer (``models/longcontext.py``) and its
sequence-parallel fit against the JAX package's, on the CPU, from the same
initial parameters (carried with ``convert.py``), in f32:

- the unsharded model's logits against ``LongContextTransformer``'s flax
  module (its ``reference_attention``; the port's runs flash attention's
  plain version), causal and not, with pad tails and an all-pad row: 1e-4;
- a few-step fit on an ``sp = 2`` mesh (``shuffle=False``, plain SGD, a
  validation set, so evaluation runs the ring too) against the JAX
  ``DistributedTrainer`` on ``MeshSpec(sp=2)`` (its 8 virtual devices:
  dp 4 x sp 2) and against the port's single-device fit: loss and
  validation histories and final parameters within 1e-4, for two gloo
  ranks (one ring) and four (dp 2 x sp 2: metrics count each replica
  once, not sp times);
- ``POST /train/horovod`` with ``"mesh": {"sp": 2}`` on a JAX and a port
  server (``tests/torch_rest_pair.py``), the histories equal; a sequence
  length that sp does not divide fails the job on both with the JAX
  trainer's message;
- the int8 artifact: the 4-D ``qkv`` kernel quantized as the JAX
  package writes it, bit for bit, and loaded back;
- the program cache's module fingerprint tells a ring-bound module from
  the unsharded one, and ``causal`` apart.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import requests
import torch

from learningorchestra_tpu.models.longcontext import (
    LongContextTransformer as JaxLong,
)
from learningorchestra_tpu.ops import quant as jquant
from learningorchestra_tpu.parallel.distributed import (
    DistributedTrainer as JaxTrainer,
)
from learningorchestra_tpu.parallel.mesh import MeshSpec as JaxSpec
from learningorchestra_tpu.parallel.mesh import build_mesh as jax_mesh
from learningorchestra_tpu_torch import convert
from learningorchestra_tpu_torch.models.longcontext import (
    LongContextTransformer,
)
from learningorchestra_tpu_torch.ops.quant import QuantizedLeaf
from learningorchestra_tpu_torch.parallel import DistributedTrainer, MeshSpec
from learningorchestra_tpu_torch.parallel.ring_attention import Ring
from learningorchestra_tpu_torch.train import compile_cache as cc
from learningorchestra_tpu_torch.train import neural
from tests.torch_rest_pair import carry_weights, server_pair

KW = dict(vocab_size=64, hidden_dim=16, num_layers=2, num_heads=2,
          max_len=32)
TOL = dict(atol=1e-4, rtol=1e-4)
SGD = dict(optimizer="sgd", learning_rate=0.1)
PATH = "learningorchestra_tpu.models.longcontext"


def _tokens(n=8, t=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 64, (n, t)).astype(np.int32)
    x[0, 10:] = 0  # a pad tail
    x[3] = 0  # an all-pad row
    y = rng.integers(0, 2, n).astype(np.int32)
    return x, y


def _pair(**kw):
    """A JAX model initialised on the tokens and the port's copy of it,
    both computing in f32."""
    x, _ = _tokens()
    jest = JaxLong(**{**KW, **kw})
    jest.compute_dtype = "float32"
    jest._init_params(jnp.asarray(x[:1]))
    pest = LongContextTransformer(**{**KW, **kw}, device="cpu")
    pest.compute_dtype = "float32"
    pest.load_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, jest.params)})
    return jest, pest


def _leaves(est):
    return jax.tree_util.tree_leaves(convert.params_to_jax(est.module))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_unsharded_logits_match_jax(causal):
    jest, pest = _pair(causal=causal)
    x, _ = _tokens()
    want = np.asarray(jest.module.apply(jest.params, jnp.asarray(x)))
    with torch.no_grad():
        got = pest.module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(pest.predict(x), want, **TOL)


@pytest.fixture(scope="module")
def jax_sp2_fit():
    """The JAX mesh trainer's fit on MeshSpec(sp=2) and its initial
    parameters."""
    jest, _ = _pair()
    jest.compile(**SGD)
    init = jax.tree_util.tree_map(np.asarray, jest.params)
    x, y = _tokens()
    vx, vy = _tokens(4, seed=1)
    trainer = JaxTrainer(jest, mesh=jax_mesh(JaxSpec(sp=2)))
    trainer.fit(x, y, epochs=2, batch_size=4, shuffle=False,
                validation_data=(vx, vy))
    return {"init": init, "history": dict(trainer.history),
            "params": jax.tree_util.tree_leaves(
                jax.tree_util.tree_map(np.asarray, jest.params))}


def _port_from(init):
    est = LongContextTransformer(**KW, device="cpu")
    est.compute_dtype = "float32"
    est.compile(**SGD)
    est.load_state_dict({"params": init})
    return est


@pytest.mark.parametrize("world", [2, 4], ids=["sp2", "dp2xsp2"])
def test_sp2_fit_matches_jax_and_one_device(jax_sp2_fit, world):
    x, y = _tokens()
    vx, vy = _tokens(4, seed=1)
    fit = dict(epochs=2, batch_size=4, shuffle=False,
               validation_data=(vx, vy))
    est = _port_from(jax_sp2_fit["init"])
    trainer = DistributedTrainer(est, spec=MeshSpec(sp=2),
                                 devices=["cpu"] * world)
    assert trainer.shard_sequence and trainer.mesh.shape["sp"] == 2
    trainer.fit(x, y, **fit)
    single = _port_from(jax_sp2_fit["init"])
    single.fit(x, y, **fit)
    for key in ("loss", "accuracy", "val_loss", "val_accuracy"):
        want = jax_sp2_fit["history"][key]
        np.testing.assert_allclose(trainer.history[key], want, **TOL,
                                   err_msg=key)
        np.testing.assert_allclose(single.history[key], want, **TOL,
                                   err_msg=key)
    for got, one, want in zip(_leaves(est), _leaves(single),
                              jax_sp2_fit["params"]):
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, one, **TOL)
    assert [(s["dp_index"], s["sp_index"]) for s in trainer.rank_stats] == \
        [(r // 2, r % 2) for r in range(world)]
    # The estimator's own model is never bound: predict runs unsharded.
    assert est.module._ring is None and est.module.sp == 1


def test_horovod_route_with_sp2_matches_jax(tmp_path):
    x, y = _tokens()
    with server_pair(tmp_path) as (servers, clients):
        servers["port"].config.dist.cpu_ranks = 2
        bases = {side: c.base for side, c in clients.items()}
        for base in bases.values():
            assert requests.post(f"{base}/model/tensorflow", json={
                "name": "rlong", "modulePath": PATH,
                "class": "LongContextTransformer", "classParameters": {
                    **KW, "num_layers": 1}}).status_code == 201
            _poll(base, "/model/tensorflow/rlong")
        carry_weights(servers, "rlong", x[:1])
        for name, tokens in (("rlong_fit", x), ("rlong_odd", x[:, :15])):
            for base in bases.values():
                resp = requests.post(f"{base}/train/horovod", json={
                    "name": name, "parentName": "rlong",
                    "trainingParameters": {
                        "x": tokens.tolist(), "y": y.tolist(),
                        "epochs": 2, "batch_size": 4, "shuffle": False},
                    "mesh": {"sp": 2}})
                assert resp.status_code == 201, resp.text
        done = {side: _poll(base, "/train/horovod/rlong_fit")
                for side, base in bases.items()}
        odd = {side: _poll(base, "/train/horovod/rlong_odd", failed=True)
               for side, base in bases.items()}
        history = {side: [d["loss"] for d in requests.get(
            f"{base}/train/horovod/rlong_fit", params={"limit": 20}).json()
            if d.get("docType") == "history"]
            for side, base in bases.items()}
    assert done["port"]["distributed"] and done["port"]["mesh"] == {"sp": 2}
    assert len(history["port"]) == 2
    np.testing.assert_allclose(history["port"], history["jax"], **TOL)
    for side in ("jax", "port"):
        assert "sequence length 15 not divisible by sp=2" in \
            odd[side]["exception"], (side, odd[side]["exception"])


def _poll(base, path, timeout=300, failed=False):
    deadline = time.time() + timeout
    while time.time() < deadline:
        docs = requests.get(f"{base}{path}", timeout=10).json()
        meta = docs[0] if isinstance(docs, list) and docs else {}
        if meta.get("jobState") == "failed":
            assert failed, meta.get("exception")
            return meta
        if meta.get("finished"):
            assert not failed, meta
            return meta
        time.sleep(0.05)
    raise AssertionError(f"timeout polling {path}")


def test_int8_artifact_round_trips():
    """The 4-D qkv kernel (hidden, 3, H, D) goes through quantize_pytree
    flattened to (-1, D) as the JAX package writes it, bit for bit, and
    loads back as the plain dequantize of those bits."""
    kw = dict(KW, hidden_dim=64, num_heads=4)  # qkv: 64 x 192 > 4,096
    est = LongContextTransformer(**kw, seed=3, device="cpu")
    tree = convert.params_to_jax(est.module)
    want = jquant.quantize_pytree(tree)["params"]["_LongBlock_0"][
        "attention"]["qkv"]["kernel"]
    art = est.to_artifact(quantize=True)
    leaf = art["state"]["params"]["params"]["_LongBlock_0"]["attention"][
        "qkv"]["kernel"]
    assert isinstance(leaf, QuantizedLeaf)
    assert tuple(leaf.shape) == (64, 3, 4, 16)
    np.testing.assert_array_equal(leaf.values, want.values)
    np.testing.assert_array_equal(leaf.scales, want.scales)
    loaded = neural.load_artifact(art, device="cpu")
    assert type(loaded) is LongContextTransformer and loaded.max_len == 32
    np.testing.assert_array_equal(
        convert.params_to_jax(loaded.module)["params"]["_LongBlock_0"][
            "attention"]["qkv"]["kernel"],
        np.asarray(jquant.dequantize_pytree({"k": want})["k"]))
    x, _ = _tokens()
    assert np.isfinite(loaded.predict(x)).all()
    twin = LongContextTransformer(**kw, device="cpu")
    twin.load_state_dict(est.state_dict())
    np.testing.assert_array_equal(twin.predict(x), est.predict(x))


def test_fingerprint_tells_ring_and_causal_apart():
    def fp(est):
        return cc.module_fingerprint(est.module)

    est = LongContextTransformer(**KW, device="cpu")
    base = fp(est)
    assert fp(LongContextTransformer(**KW, device="cpu")) == base
    assert fp(LongContextTransformer(**KW, causal=True,
                                     device="cpu")) != base
    ring = Ring(None, 0, 2, "cpu", "gloo", timeout_s=1.0)
    est.bind_mesh(ring)
    bound = fp(est)
    assert bound != base
    assert est.module._LongBlock_1.attention._ring is ring
    est.bind_mesh(None)
    assert fp(est) == base
    # A ring is runtime state: a pickled module keeps none.
    import pickle

    est.bind_mesh(ring)
    copy = pickle.loads(pickle.dumps(est.module))
    assert copy._ring is None and copy.sp == 1
    assert cc.module_fingerprint(copy) == base
