"""The mixture-of-experts models through the port's REST surface, beside a
JAX server given the same requests: ``tests/test_sparse_models_rest.py``'s
``test_moe_classifier_rest_flow`` (:73) and ``test_moe_decoder_generate_rest``
(:154) on both servers, their models created through the JAX package's
module path and given the same initial weights in f32:

- the classifier: create, ``fit`` (2 epochs), ``predict_classes`` of the
  48 rows (equal on both servers) and a PATCH re-run;
- the decoder LM: create, ``fit``, a ``generate`` predict job (8 prompt
  tokens + 4 new, equal on both servers), then one ``/serve/<model>/
  generate`` SSE stream on the port equal to its predict job's tokens;
- ``LongContextTransformer``, through the JAX package's zoo path, is
  created (``tests/test_torch_longcontext.py`` holds the model itself).
"""

import numpy as np
import pytest

from tests.torch_rest_pair import carry_weights, data_rows, server_pair, status

MOE_PATH = "learningorchestra_tpu.models.moe"
FIELDS = [f"t{i}" for i in range(8)]
CLS = {"vocab_size": 64, "hidden_dim": 16, "num_layers": 2, "num_heads": 2,
       "max_len": 8, "num_experts": 4, "mlp_dim": 16, "num_classes": 2}
LM = {"vocab_size": 64, "hidden_dim": 16, "num_layers": 2, "num_heads": 2,
      "max_len": 16, "num_experts": 2, "mlp_dim": 16}


def _tokens():
    rng = np.random.default_rng(0)
    xs = rng.integers(1, 64, (48, 8))
    return xs, (xs.sum(1) % 2).astype(int)


def _finished(c, name, timeout=180):
    meta = c.observe.wait(name, timeout)
    assert meta.get("finished"), meta
    return meta


@pytest.fixture(scope="module")
def flows(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_rest")
    xs, ys = _tokens()
    csv = tmp / "toks.csv"
    with open(csv, "w") as f:
        f.write(",".join(FIELDS) + ",label\n")
        for row, y in zip(xs, ys):
            f.write(",".join(map(str, row)) + f",{y}\n")
    out = {"jax": {}, "port": {}}
    with server_pair(tmp) as (servers, clients):
        for side, c in clients.items():
            c.dataset_csv.insert("toks", f"file://{csv}")
            _finished(c, "toks")
            c.projection.create("toks_x", "toks", FIELDS)
            _finished(c, "toks_x")
            for name, cls, params in (("rmoe", "MoETransformerClassifier",
                                       CLS),
                                      ("rmoelm", "MoEDecoderLM", LM)):
                c.model.create(name, module_path=MOE_PATH, class_name=cls,
                               class_parameters=params)
                _finished(c, name)
        carry_weights(servers, "rmoe", xs[:1].astype(np.int32))
        carry_weights(servers, "rmoelm", xs[:1].astype(np.int32))
        for side, c in clients.items():
            res = out[side]
            fit = {"x": "$toks_x", "y": "$toks.label", "epochs": 2,
                   "batch_size": 16, "shuffle": False}
            c.train.create("rmoe_fit", parent_name="rmoe", method="fit",
                           method_parameters=fit)
            _finished(c, "rmoe_fit")
            res["history"] = data_rows(c.train.search("rmoe_fit", limit=20))
            c.predict.create("rmoe_pred", parent_name="rmoe_fit",
                             method="predict_classes",
                             method_parameters={"x": "$toks_x"})
            _finished(c, "rmoe_pred")
            res["classes"] = [d["result"] for d in data_rows(
                c.predict.search("rmoe_pred", limit=60)) if "result" in d]
            # PATCH re-run keeps the artifact name and re-executes.
            c.train.update("rmoe_fit", method_parameters={**fit,
                                                          "epochs": 1})
            res["rerun"] = _finished(c, "rmoe_fit")
            c.train.create("rmoelm_fit", parent_name="rmoelm", method="fit",
                           method_parameters={"x": "$toks_x",
                                              "y": "$toks_x", "epochs": 1,
                                              "batch_size": 16,
                                              "shuffle": False})
            _finished(c, "rmoelm_fit")
            c.predict.create("rmoelm_gen", parent_name="rmoelm_fit",
                             method="generate",
                             method_parameters={"prompts": "$toks_x",
                                                "max_new_tokens": 4})
            _finished(c, "rmoelm_gen")
            res["generated"] = [d["result"] for d in data_rows(
                c.predict.search("rmoelm_gen", limit=60)) if "result" in d]
        port = clients["port"]
        prompt = [int(v) for v in xs[0]]
        out["port"]["sse"] = [
            (event, doc) for event, doc in port.serve.generate(
                "rmoelm_fit", prompt, stream=True, max_new_tokens=4)]
        out["port"]["unknown"] = status(lambda: port.model.create(
            "rlong", module_path="learningorchestra_tpu.models",
            class_name="LongContextTransformer",
            class_parameters={"vocab_size": 64, "hidden_dim": 16,
                              "num_layers": 1, "num_heads": 2,
                              "max_len": 32}))
        out["port"]["long"] = _finished(port, "rlong")
        out["port"]["decode_stats"] = \
            servers["port"].serving.decode.stats()["models"]
    return out


def test_moe_classifier_rest_flow_matches_jax(flows):
    jax_res, port = flows["jax"], flows["port"]
    assert len(port["classes"]) == 48
    assert all(v in (0, 1) for v in port["classes"])
    assert port["classes"] == jax_res["classes"]
    losses = [[row["loss"] for row in side["history"]]
              for side in (jax_res, port)]
    assert len(losses[1]) == 2
    np.testing.assert_allclose(losses[1], losses[0], atol=1e-4, rtol=1e-4)
    assert port["rerun"]["finished"] and jax_res["rerun"]["finished"]


def test_moe_decoder_generate_rest_matches_jax(flows):
    jax_res, port = flows["jax"], flows["port"]
    xs, _ = _tokens()
    assert len(port["generated"]) == 48
    assert all(len(r) == 12 for r in port["generated"])  # 8 + 4 new
    assert [r[:8] for r in port["generated"]] == xs.tolist()
    assert port["generated"] == jax_res["generated"]


def test_moe_decoder_streams_through_the_decode_engine(flows):
    port = flows["port"]
    names = [event for event, _ in port["sse"]]
    assert names[0] == "open" and names[-1] == "done"
    tokens = [doc["t"] for event, doc in port["sse"] if event == "token"]
    assert port["generated"][0] == [int(v) for v in _tokens()[0][0]] + tokens
    stats = port["decode_stats"]["rmoelm_fit"]
    assert stats["pools"] and stats["activeStreams"] == 0


def test_unported_long_context_model_is_an_unknown_class(flows):
    # Ported since: the JAX package's zoo path resolves the long-context
    # model, and the create job finishes.
    assert flows["port"]["unknown"] == 200
    long = flows["port"]["long"]
    assert long["class"] == "LongContextTransformer"
    assert long["modulePath"] == "learningorchestra_tpu.models"
