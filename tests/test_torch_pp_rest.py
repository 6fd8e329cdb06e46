"""``PipelinedTransformer`` through the port's REST surface, beside a JAX
server given the same requests: ``tests/test_sparse_models_rest.py``'s
``test_pipelined_transformer_rest_flow`` (:118) on both servers, the model
created through the JAX package's module path (``learningorchestra_tpu.
parallel.pipeline``, pp 4) and given the same initial weights, in f32.
The port's server runs its fits on four CPU ranks (``dist.cpu_ranks``,
the ``LO_TPU_CPU_RANKS`` knob, 4), one process per pipeline stage; the
JAX server lays pp 4 over its 8 virtual devices (dp 2), so a global
batch of 16 is the same batch on both.

Covered: ``/model`` create, ``/train`` (2 epochs: the loss histories at
``test_torch_train.py``'s bar), ``/evaluate`` (equal metrics),
``/predict`` (equal classes) and a PATCH re-run of the train job."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_rest_pair import data_rows, server_pair

PIPE_PATH = "learningorchestra_tpu.parallel.pipeline"
FIELDS = [f"t{i}" for i in range(8)]
PARAMS = {"vocab_size": 64, "hidden_dim": 16, "num_layers": 4,
          "num_heads": 2, "max_len": 8, "mlp_dim": 16, "num_classes": 2,
          "pp": 4, "compute_dtype": "float32", "learning_rate": 2e-5}
TOL = dict(atol=1e-4, rtol=1e-4)  # test_torch_train.py's bar


def _tokens():
    rng = np.random.default_rng(0)
    xs = rng.integers(1, 64, (48, 8))
    xs[::5, 6:] = 0  # padded tails
    return xs, (xs.sum(1) % 2).astype(int)


def _finished(c, name, timeout=240):
    meta = c.observe.wait(name, timeout)
    assert meta.get("finished"), meta
    return meta


def _carry(servers, name, x0):
    """The JAX model's initial params (flax has none before the first
    fit) into both binaries."""
    jvols = servers["jax"].ctx.volumes
    jest = jvols.read_object("model/tensorflow", name)
    jest._init_params(jnp.asarray(x0))
    jvols.save_object("model/tensorflow", name, jest)
    pvols = servers["port"].ctx.volumes
    pest = pvols.load_estimator("model/tensorflow", name, device="cpu")
    pest.load_state_dict({"params": jax.device_get(jest.params)})
    pvols.save_estimator("model/tensorflow", name, pest)


@pytest.fixture(scope="module")
def flows(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_rest")
    xs, ys = _tokens()
    csv = tmp / "toks.csv"
    with open(csv, "w") as f:
        f.write(",".join(FIELDS) + ",label\n")
        for row, y in zip(xs, ys):
            f.write(",".join(map(str, row)) + f",{y}\n")
    out = {"jax": {}, "port": {}}
    with server_pair(tmp) as (servers, clients):
        servers["port"].ctx.config.dist.cpu_ranks = 4
        for c in clients.values():
            c.dataset_csv.insert("toks", f"file://{csv}")
            _finished(c, "toks")
            c.projection.create("toks_x", "toks", FIELDS)
            _finished(c, "toks_x")
            c.model.create("rpipe", module_path=PIPE_PATH,
                           class_name="PipelinedTransformer",
                           class_parameters=PARAMS)
            _finished(c, "rpipe")
        _carry(servers, "rpipe", xs[:1].astype(np.int32))
        for side, c in clients.items():
            res = out[side]
            fit = {"x": "$toks_x", "y": "$toks.label", "epochs": 2,
                   "batch_size": 16, "shuffle": False}
            c.train.create("rpipe_fit", parent_name="rpipe", method="fit",
                           method_parameters=fit)
            res["fit"] = _finished(c, "rpipe_fit")
            res["history"] = data_rows(c.train.search("rpipe_fit",
                                                      limit=20))
            c.evaluate.create("rpipe_eval", parent_name="rpipe_fit",
                              method="evaluate",
                              method_parameters={"x": "$toks_x",
                                                 "y": "$toks.label"})
            _finished(c, "rpipe_eval")
            res["eval"] = [d for d in data_rows(
                c.evaluate.search("rpipe_eval", limit=5)) if "loss" in d]
            c.predict.create("rpipe_pred", parent_name="rpipe_fit",
                             method="predict",
                             method_parameters={"x": "$toks_x"})
            _finished(c, "rpipe_pred")
            res["classes"] = [d["result"] for d in data_rows(
                c.predict.search("rpipe_pred", limit=60)) if "result" in d]
            # PATCH re-run keeps the artifact name and re-executes.
            c.train.update("rpipe_fit", method_parameters={**fit,
                                                           "epochs": 1})
            res["rerun"] = _finished(c, "rpipe_fit")
            res["rerun_history"] = data_rows(c.train.search("rpipe_fit",
                                                            limit=20))
    return out


def test_pipelined_transformer_rest_flow_matches_jax(flows):
    jres, port = flows["jax"], flows["port"]
    losses = [[row["loss"] for row in side["history"]]
              for side in (jres, port)]
    assert len(losses[1]) == 2
    np.testing.assert_allclose(losses[1], losses[0], **TOL)
    assert port["eval"] and np.isfinite(port["eval"][0]["loss"])
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(port["eval"][0][key],
                                   jres["eval"][0][key], **TOL)
    assert len(port["classes"]) == 48
    assert port["classes"] == jres["classes"]


def test_patch_rerun_trains_again_on_both(flows):
    for side in ("jax", "port"):
        res = flows[side]
        assert res["rerun"]["finished"], res["rerun"]
        # The re-run fits the parent model again, for its one epoch, and
        # re-stores the history.
        assert len(res["rerun_history"]) == 1, (side, res["rerun_history"])
    np.testing.assert_allclose(
        [r["loss"] for r in flows["port"]["rerun_history"]],
        [r["loss"] for r in flows["jax"]["rerun_history"]], **TOL)
