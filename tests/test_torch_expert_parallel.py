"""The port's expert axis and data-parallel MoE training
(``parallel/mesh.py``, ``parallel/sharding.py``, ``parallel/distributed.py``,
``ops/moe.py``, ``parallel/rank.py``) against the JAX package, on the CPU,
from the same seeded numpy inputs and carried weights, in f32, at the
smallest shape that covers each case (2 layers, hidden 16, E = 4, T = 8,
as ``tests/test_moe.py:191``):

- the mesh: ``{"ep": 2}`` over 4 devices is dp 2 x ep 2, rank
  ``(dp * ep + e) * sp + s``; ep with sp is refused; the JAX
  ``leaf_spec`` expert rule; the groups of a 4-rank gloo world
  (``tests/torch_ep_worker.py``);
- ``MoEMlp`` bound to an ep = 2 group against the JAX layer's ``apply``
  and ``jax.grad`` on each dp index's rows: f32 2e-5 on outputs, 5e-5 on
  gradients (the input, the router, each rank's expert slice);
- the dp = 2 auxiliary loss: each rank's term is the global batch's, and
  the router's gradient summed over the replicas is the single-device
  one, counted once (5e-5);
- after a train step the replicated leaves of the ep ranks of a replica
  are bit-equal;
- ``{"dp": 2}`` and ``{"dp": 2, "ep": 2}`` fits (SGD, a validation set)
  against the JAX ``DistributedTrainer`` on the same mesh of host devices
  and against a one-device port fit: the loss histories within 1e-5,
  every final leaf within 1e-4;
- a checkpoint written under ep = 2 is the single-device layout, resumes
  under ep = 2 to the uninterrupted result and loads into a one-device
  estimator;
- ``POST /train/horovod`` with ``{"ep": 2}`` on both MoE models, then
  ``predict_classes`` / ``generate``, equal to the JAX server's for the
  same bodies; the port's artifact holds all E experts.
"""

import os
import pickle
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import requests
import torch

from learningorchestra_tpu.models.moe import (
    MoETransformerClassifier as JaxMoEClassifier,
)
from learningorchestra_tpu.ops import moe as jmoe
from learningorchestra_tpu.parallel.distributed import (
    DistributedTrainer as JaxTrainer,
)
from learningorchestra_tpu.parallel.mesh import MeshSpec as JaxSpec
from learningorchestra_tpu.parallel.mesh import build_mesh as jax_mesh
from learningorchestra_tpu_torch import convert
from learningorchestra_tpu_torch.models.moe import MoETransformerClassifier
from learningorchestra_tpu_torch.ops import moe as pmoe
from learningorchestra_tpu_torch.parallel import DistributedTrainer, MeshSpec
from learningorchestra_tpu_torch.parallel.mesh import build_mesh
from learningorchestra_tpu_torch.parallel.sharding import (
    expert_slice,
    rank_coords,
    splits_experts,
)
from learningorchestra_tpu_torch.train import checkpoint as ckpt
from tests.torch_rest_pair import carry_weights, data_rows, server_pair

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
WORKER_TIMEOUT_S = 120
CLS = dict(vocab_size=64, hidden_dim=16, num_layers=2, num_heads=2,
           max_len=8, num_experts=4, mlp_dim=16)
LM = dict(vocab_size=64, hidden_dim=16, num_layers=2, num_heads=2,
          max_len=16, num_experts=2, mlp_dim=16)
LAYER = dict(num_experts=4, hidden_dim=16, mlp_dim=16, top_k=2,
             capacity_factor=1.5)
F32 = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=5e-5, rtol=5e-5)
HISTORY = dict(atol=1e-5, rtol=1e-5)
LEAF = dict(atol=1e-4, rtol=1e-4)
SGD = dict(optimizer="sgd", learning_rate=0.5)
MOE_PATH = "learningorchestra_tpu.models.moe"


def _tree(variables):
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def _tokens(n=20, t=8, vocab=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, vocab, (n, t)).astype(np.int32)
    x[1, t // 2:] = 0  # a pad tail
    return x, (x.sum(1) % 2).astype(np.int32)


# -- the mesh -----------------------------------------------------------------

def test_mesh_lays_dp_by_ep_and_refuses_ep_with_sp():
    mesh = build_mesh(MeshSpec(ep=2), ["cpu"] * 4)
    assert mesh.size == 4 and mesh.shape["ep"] == 2 \
        and mesh.shape["dp"] == 2  # spare devices fold into dp
    jmesh = jax_mesh(JaxSpec(ep=2), devices=jax.devices()[:4])
    assert dict(jmesh.shape) == mesh.shape
    # The JAX device grid in rank order: (dp, ep) of device r.
    grid = np.asarray(jmesh.devices).reshape(2, 2)
    ids = [d.id for d in jax.devices()[:4]]
    for r in range(4):
        d, _, e, s = rank_coords(r, 1, 2)
        assert grid[d, e].id == ids[r] and s == 0
    assert [rank_coords(r, 2, 2) for r in (0, 1, 2, 5)] == [
        (0, 0, 0, 0), (0, 0, 0, 1), (0, 0, 1, 0), (1, 0, 0, 1)]
    with pytest.raises(ValueError, match="ep=2 and sp=2 together"):
        build_mesh(MeshSpec(ep=2, sp=2), ["cpu"] * 4)
    # leaf_spec's expert rule: 2-D and 3-D leaves named expert whose
    # leading dimension divides by ep; anything else stays whole.
    assert splits_experts("MoEMlp_0/expert_w1", (8, 4, 16), 2)
    assert splits_experts("MoEMlp_0/expert_b1", (8, 16), 4)
    assert not splits_experts("MoEMlp_0/expert_w1", (6, 4, 16), 4)
    assert not splits_experts("MoEMlp_0/expert_w1", (8, 4, 16), 1)
    assert not splits_experts("Dense_0/kernel", (8, 4), 2)
    assert expert_slice(8, 1, 2) == slice(4, 8)


def _flat(tree, path=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, path + (key,))
        else:
            yield path + (key,), val


def test_split_and_join_of_the_expert_leaves():
    """A state's expert leaves (parameters and optimizer slots) cut to
    each ep index's experts and joined back, bit for bit; the router, a
    0-d slot and the layers not split are left as they are."""
    est = MoETransformerClassifier(**CLS, device="cpu")
    est.compute_dtype = "float32"
    est.compile(optimizer={"name": "sgd", "momentum": 0.9},
                learning_rate=0.1)
    x, y = _tokens()
    est.fit(x, y, epochs=1, batch_size=8)
    state = est.state_dict()
    state["opt_state"]["scalar"] = {"params": {"MoEBlock_1": {
        "MoEMlp_0": {"expert_w1": np.float32(3.0)}}}}
    layers = {("MoEBlock_1", "MoEMlp_0")}
    halves = [convert.split_experts(state, layers, i, 2) for i in (0, 1)]
    second = []
    convert.map_expert_leaves(halves[1], layers,
                              lambda a: second.append(a) or a)
    assert len(second) == 2 * len(pmoe.EXPERT_LEAVES)  # params, trace
    rest = iter(second)
    joined = convert.join_experts(
        halves[0], layers, lambda a: np.concatenate([a, next(rest)]))
    got, want = dict(_flat(joined)), dict(_flat(state))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        if isinstance(leaf, np.ndarray):
            np.testing.assert_array_equal(got[path], leaf, err_msg=path)
        if path[-1] in pmoe.EXPERT_LEAVES and np.ndim(leaf) >= 1:
            half = dict(_flat(halves[1]))[path]
            np.testing.assert_array_equal(half, leaf[2:], err_msg=path)
        elif isinstance(leaf, np.ndarray):
            assert dict(_flat(halves[1]))[path] is leaf, path
    assert convert.split_experts(state, set(), 0, 2)["params"]["params"][
        "MoEBlock_1"]["MoEMlp_0"]["expert_w1"].shape == (4, 16, 16)


def test_leaf_norm_optimizers_are_refused_under_ep():
    class Group:
        index, size = 0, 2

    for name in ("lamb", "novograd"):
        est = MoETransformerClassifier(**CLS, device="cpu")
        est.compile(optimizer=name)
        with pytest.raises(ValueError, match="norm"):
            est.bind_experts(Group())
    est = MoETransformerClassifier(**CLS, device="cpu")
    assert est.bind_experts(Group()) == ["MoEBlock_1.MoEMlp_0"]
    assert est.module.MoEBlock_1.MoEMlp_0.expert_w1.shape == (2, 16, 16)


# -- the rank processes -------------------------------------------------------

def _layer_case() -> dict:
    """The layer's weights from the port's seeded init, in the flax
    layout both sides load."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 10, LAYER["hidden_dim"])).astype(np.float32)
    layer = pmoe.MoEMlp(LAYER["num_experts"], LAYER["hidden_dim"],
                        LAYER["mlp_dim"], top_k=LAYER["top_k"],
                        capacity_factor=LAYER["capacity_factor"])
    torch.nn.init.normal_(layer.router.weight)
    layer.init_leaves(torch.Generator().manual_seed(2))
    return {"kw": LAYER, "variables": convert.params_to_jax(layer), "x": x,
            "cotangent": rng.standard_normal(x.shape).astype(np.float32)}


def _step_case() -> dict:
    x, y = _tokens(8, seed=4)
    est = MoETransformerClassifier(**CLS, seed=3, device="cpu")
    return {"kw": CLS, "params": convert.params_to_jax(est.module), "x": x,
            "y": y}


def _jax_layer(case) -> dict:
    """The JAX layer's output and gradients on each dp index's rows, and
    its aux loss over the whole batch with the router's gradient."""
    jl = jmoe.MoEMlp(**case["kw"])
    variables = jax.tree_util.tree_map(jnp.asarray, case["variables"])

    @jax.jit
    def layer(v, x, g):
        def loss(v, x):
            return jnp.sum(jl.apply(v, x) * g)

        return jl.apply(v, x), jax.grad(loss, argnums=(0, 1))(v, x)

    out = {}
    for d in range(2):
        rows = slice(d * 2, d * 2 + 2)
        y, (grads, dx) = layer(variables, jnp.asarray(case["x"][rows]),
                               jnp.asarray(case["cotangent"][rows]))
        out[d] = {"out": np.asarray(y), "dx": np.asarray(dx),
                  "grads": _tree(grads)["params"]}

    def objective(v):
        _, sown = jl.apply(v, jnp.asarray(case["x"]), mutable="losses")
        return sum(jnp.sum(s) for s in jax.tree_util.tree_leaves(sown))

    value, grads = jax.jit(jax.value_and_grad(objective))(variables)
    out["aux"] = float(value)
    out["aux_router"] = np.asarray(grads["params"]["router"]["kernel"])
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results; the 4 rank processes run while the JAX side
    computes, bounded by WORKER_TIMEOUT_S and killed on any failure."""
    stage = tmp_path_factory.mktemp("ep")
    cases = {"layer": _layer_case(), "step": _step_case()}
    with open(stage / "cases.pkl", "wb") as fh:
        pickle.dump(cases, fh)
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_ep_worker.py"),
         str(stage), str(r), str(WORLD)], env=env,
        stdout=subprocess.DEVNULL, stdin=subprocess.DEVNULL)
        for r in range(WORLD)]
    try:
        jax_out = _jax_layer(cases["layer"])
        deadline = time.monotonic() + WORKER_TIMEOUT_S
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    results = []
    for r in range(WORLD):
        with open(stage / f"rank{r}.pkl", "rb") as fh:
            res = pickle.load(fh)
        assert "error" not in res, res["error"]
        results.append(res)
    return {"ranks": results, "jax": jax_out, "cases": cases}


def test_rank_groups(ranks):
    for r, res in enumerate(ranks["ranks"]):
        d, e = r // 2, r % 2
        assert res["layout"] == {
            "rank": r, "dp_index": d, "ep_index": e, "sp_index": 0,
            "dp_size": 2, "ep": (e, 2), "replicas": (d, 2),
            "ep_group": [2.0 * d, 2.0 * d + 1], "dp_group": [e, 2.0 + e]}


def test_moe_mlp_at_ep2_matches_jax(ranks):
    covered = set()
    for res in ranks["ranks"]:
        got, d = res["layer"], res["layout"]["dp_index"]
        want = ranks["jax"][d]
        assert got["split"] and got["local_experts"] == 2
        assert got["rows"] == (2 * d, 2 * d + 2)
        np.testing.assert_allclose(got["out"], want["out"], **F32)
        np.testing.assert_allclose(got["dx"], want["dx"], **GRAD)
        np.testing.assert_allclose(got["router"],
                                   want["grads"]["router"]["kernel"], **GRAD)
        mine = slice(got["offset"], got["offset"] + 2)
        for key in pmoe.EXPERT_LEAVES:
            np.testing.assert_allclose(got["experts"][key],
                                       want["grads"][key][mine], **GRAD,
                                       err_msg=key)
        covered.add((d, got["offset"]))
    assert covered == {(0, 0), (0, 2), (1, 0), (1, 2)}


def test_dp2_aux_loss_is_the_global_batch_counted_once(ranks):
    want = ranks["jax"]
    for res in ranks["ranks"]:
        got = res["aux"]
        np.testing.assert_allclose(got["aux"], want["aux"], **F32)
        # Each rank's own rows alone give another number.
        assert abs(got["local_aux"] - want["aux"]) > 1e-4
        np.testing.assert_allclose(got["router"], want["aux_router"],
                                   **GRAD)


def test_replicated_leaves_are_bit_equal_after_a_step(ranks):
    res = ranks["ranks"]
    split = {f"{name}.{k}" for name in res[0]["step"]["split"]
             for k in pmoe.EXPERT_LEAVES}
    assert split == {f"MoEBlock_1.MoEMlp_0.{k}" for k in pmoe.EXPERT_LEAVES}
    init = convert.params_from_jax(ranks["cases"]["step"]["params"])
    for name, leaf in res[0]["step"]["params"].items():
        if name in split:
            continue
        assert not np.array_equal(leaf, init[name].numpy()) or \
            "MultiHeadSelfAttention_0.qkv" in name or "Embed" in name
        for other in res[1:]:
            np.testing.assert_array_equal(other["step"]["params"][name],
                                          leaf, err_msg=name)
    for other in res[1:]:
        for name in split:
            assert other["step"]["params"][name].shape[0] == 2


# -- fits ---------------------------------------------------------------------

MESHES = {"dp2": (dict(dp=2), 2), "dp2xep2": (dict(dp=2, ep=2), 4)}


def _port_from(init, optimizer=None):
    est = MoETransformerClassifier(**CLS, device="cpu")
    est.compute_dtype = "float32"
    est.compile(**(SGD if optimizer is None else optimizer))
    est.load_state_dict({"params": init})
    return est


def _leaves(est):
    return jax.tree_util.tree_leaves(convert.params_to_jax(est.module))


@pytest.fixture(scope="module")
def fits():
    """From one JAX initialisation: the JAX mesh trainer's fit on each
    mesh, the port's distributed fit on each (their ranks run while the
    JAX side computes) and the port's one-device fit."""
    x, y = _tokens()
    fit = dict(epochs=2, batch_size=8, shuffle=False,
               validation_data=_tokens(6, seed=1))
    jests = {}
    for key in MESHES:
        jest = jests[key] = JaxMoEClassifier(**CLS, seed=3)
        jest.compute_dtype = "float32"
        jest._init_params(jnp.asarray(x[:1]))
        jest.compile(**SGD)
    init = _tree(jests["dp2"].params)
    port: dict = {}

    def port_fit(key):
        axes, n = MESHES[key]
        try:
            est = _port_from(init)
            trainer = DistributedTrainer(est, spec=MeshSpec(**axes),
                                         devices=["cpu"] * n)
            trainer.fit(x, y, **fit)
            port[key] = (est, trainer)
        except BaseException as exc:  # noqa: BLE001 — raised below
            port[key] = exc

    threads = [threading.Thread(target=port_fit, args=(key,))
               for key in MESHES]
    for thread in threads:
        thread.start()
    out = {"jax": {}, "port": port}
    try:
        for key, (axes, n) in MESHES.items():
            trainer = JaxTrainer(jests[key], mesh=jax_mesh(
                JaxSpec(**axes), devices=jax.devices()[:n]))
            trainer.fit(x, y, **fit)
            out["jax"][key] = {
                "history": dict(trainer.history),
                "params": jax.tree_util.tree_leaves(_tree(jests[key].params))}
        out["one"] = _port_from(init)
        out["one"].fit(x, y, **fit)
    finally:
        for thread in threads:
            thread.join(WORKER_TIMEOUT_S)
    for key in MESHES:
        if isinstance(port.get(key), BaseException):
            raise port[key]
    out["init"] = init
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_fit_matches_jax_mesh_and_one_device(fits, mesh):
    axes, n = MESHES[mesh]
    est, trainer = fits["port"][mesh]
    want, one_device = fits["jax"][mesh], fits["one"]
    for key in ("loss", "accuracy", "val_loss", "val_accuracy"):
        np.testing.assert_allclose(trainer.history[key], want["history"][key],
                                   **HISTORY, err_msg=key)
        np.testing.assert_allclose(trainer.history[key],
                                   one_device.history[key], **HISTORY,
                                   err_msg=key)
    for got, one, ref in zip(_leaves(est), _leaves(one_device),
                             want["params"]):
        assert got.shape == ref.shape  # every expert, the JAX layout
        np.testing.assert_allclose(got, ref, **LEAF)
        np.testing.assert_allclose(got, one, **LEAF)
    ep = axes.get("ep", 1)
    stats = trainer.rank_stats
    assert [(s["dp_index"], s["ep_index"]) for s in stats] == [
        (r // ep, r % ep) for r in range(n)]
    # Each step, the one MoE layer's exchange: a gather forward and a sum
    # backward (3 train batches and 1 validation batch an epoch).
    assert all(len(s["ep_ms"]) == (2 * (3 * 2 + 1) if ep > 1 else 0)
               for s in stats)
    # The estimator's own layer is never bound.
    assert est.module.MoEBlock_1.MoEMlp_0.ep_group is None


def test_checkpoint_under_ep2_resumes_and_loads_on_one_device(
        fits, tmp_path):
    x, y = _tokens()
    momentum = dict(optimizer={"name": "sgd", "momentum": 0.9},
                    learning_rate=0.1)
    fit = dict(batch_size=8, shuffle=False, checkpoint_dir=str(tmp_path),
               checkpoint_min_interval_s=0.0, checkpoint_async=False)
    first = _port_from(fits["init"], momentum)
    DistributedTrainer(first, spec=MeshSpec(ep=2), devices=["cpu"] * 2).fit(
        x, y, epochs=1, **fit)
    state, step, _ = ckpt.load_latest(tmp_path)
    assert step == 1
    moe_params = state["params"]["params"]["MoEBlock_1"]["MoEMlp_0"]
    trace = state["opt_state"]["trace"]["params"]["MoEBlock_1"]["MoEMlp_0"]
    for key in pmoe.EXPERT_LEAVES:
        assert moe_params[key].shape[0] == CLS["num_experts"]
        assert trace[key].shape == moe_params[key].shape
        assert bool(torch.as_tensor(trace[key]).abs().max() > 0)
    # The checkpoint loads into a one-device estimator, moments included.
    single = _port_from(fits["init"], momentum)
    single._reset_optimizer()
    single._restore_checkpoint(state)
    for got, want in zip(_leaves(single), _leaves(first)):
        np.testing.assert_array_equal(got, want)
    resumed = _port_from(fits["init"], momentum)
    trainer = DistributedTrainer(resumed, spec=MeshSpec(ep=2),
                                 devices=["cpu"] * 2)
    trainer.fit(x, y, epochs=2, **fit)
    assert len(trainer.history["loss"]) == 2
    # Uninterrupted, on one device: the same two epochs.
    whole = _port_from(fits["init"], momentum)
    whole.fit(x, y, epochs=2, batch_size=8, shuffle=False)
    single.fit(x, y, epochs=2, batch_size=8, shuffle=False,
               checkpoint_dir=str(tmp_path), checkpoint_async=False)
    np.testing.assert_allclose(trainer.history["loss"],
                               whole.history["loss"], **HISTORY)
    for got, one, want in zip(_leaves(resumed), _leaves(single),
                              _leaves(whole)):
        np.testing.assert_allclose(got, want, **LEAF)
        np.testing.assert_allclose(one, want, **LEAF)


# -- the REST route -----------------------------------------------------------

def _poll(base, path, timeout=300):
    deadline = time.time() + timeout
    while time.time() < deadline:
        docs = requests.get(f"{base}{path}", timeout=10).json()
        meta = docs[0] if isinstance(docs, list) and docs else {}
        assert meta.get("jobState") != "failed", meta.get("exception")
        if meta.get("finished"):
            return meta
        time.sleep(0.05)
    raise AssertionError(f"timeout polling {path}")


@pytest.fixture(scope="module")
def horovod(tmp_path_factory):
    """Both MoE models through ``POST /train/horovod`` with ``{"ep": 2}``
    on a JAX and a port server (the port's two gloo ranks on the CPU),
    then ``predict_classes`` and ``generate`` of the trained models."""
    tmp = tmp_path_factory.mktemp("ep_rest")
    x, y = _tokens(16)
    prompts = _tokens(4, t=8, seed=9)[0]
    out = {"jax": {}, "port": {}}
    with server_pair(tmp) as (servers, clients):
        servers["port"].config.dist.cpu_ranks = 2
        bases = {side: c.base for side, c in clients.items()}
        models = (("rcls", "MoETransformerClassifier", CLS, y),
                  ("rlm", "MoEDecoderLM", LM, x))
        for name, cls, params, _ in models:
            for base in bases.values():
                assert requests.post(f"{base}/model/tensorflow", json={
                    "name": name, "modulePath": MOE_PATH, "class": cls,
                    "classParameters": params}).status_code == 201
                _poll(base, f"/model/tensorflow/{name}")
            carry_weights(servers, name, x[:1])
        for name, _, _, target in models:
            # The port's first: its ranks train while the JAX server does.
            for side in ("port", "jax"):
                resp = requests.post(f"{bases[side]}/train/horovod", json={
                    "name": f"{name}_fit", "parentName": name,
                    "trainingParameters": {
                        "x": x.tolist(), "y": target.tolist(),
                        "epochs": 2, "batch_size": 8, "shuffle": False},
                    "mesh": {"ep": 2}})
                assert resp.status_code == 201, resp.text
            for side, base in bases.items():
                out[side][name] = _poll(base, f"/train/horovod/{name}_fit")
                out[side][f"{name}_history"] = [
                    d["loss"] for d in requests.get(
                        f"{base}/train/horovod/{name}_fit",
                        params={"limit": 20}).json()
                    if d.get("docType") == "history"]
        for c in clients.values():
            c.predict.create("rcls_pred", parent_name="rcls_fit",
                             method="predict_classes",
                             method_parameters={"x": x.tolist()})
            c.predict.create("rlm_gen", parent_name="rlm_fit",
                             method="generate",
                             method_parameters={"prompts": prompts.tolist(),
                                                "max_new_tokens": 4})
        for side, c in clients.items():
            for job, key in (("rcls_pred", "classes"),
                             ("rlm_gen", "generated")):
                assert c.observe.wait(job, 180).get("finished")
                out[side][key] = [d["result"] for d in data_rows(
                    c.predict.search(job, limit=60)) if "result" in d]
        out["port"]["artifacts"] = {
            name: servers["port"].ctx.volumes.load_estimator(
                "train/tensorflow", f"{name}_fit", device="cpu")
            for name in ("rcls", "rlm")}
    return out


@pytest.mark.parametrize("name,key", [("rcls", "classes"),
                                      ("rlm", "generated")],
                         ids=["classifier", "decoder"])
def test_horovod_route_with_ep2_matches_jax(horovod, name, key):
    jax_res, port = horovod["jax"], horovod["port"]
    assert port[name]["distributed"] and port[name]["mesh"] == {"ep": 2}
    assert len(port[f"{name}_history"]) == 2
    np.testing.assert_allclose(port[f"{name}_history"],
                               jax_res[f"{name}_history"], atol=1e-4,
                               rtol=1e-4)
    assert port[key] and port[key] == jax_res[key]
    est = port["artifacts"][name]
    experts = (CLS if name == "rcls" else LM)["num_experts"]
    for layer in (m for m in est.module.modules()
                  if isinstance(m, pmoe.MoEMlp)):
        assert layer.ep_group is None
        for leaf in pmoe.EXPERT_LEAVES:
            assert getattr(layer, leaf).shape[0] == experts
