"""The program cache and the cost plane over REST, a JAX and a port server
side by side (``tests/torch_rest_pair.py``): two serial identical train
jobs publish equal ``compileCache`` counters (hits, misses, coalesced,
evictions) on both, ``deviceTime`` with the JAX keys; ``GET
/monitoring/<tool>/compileCache`` and ``GET /observability/costs`` answer
with the JAX key sets; a same-architecture tune's counters follow their
arithmetic (one miss per program, every other lookup a hit); the decode
engine's ``decode_step`` and the solo ``decode`` lookups count as the JAX
engine's for the same ``/generate`` sequence; and
``LO_TPU_AOT_ENABLED=1`` boots with a live ``aot`` block.
"""

import jax
import numpy as np
import pytest

from learningorchestra_tpu.obs import costs as jcosts
from learningorchestra_tpu.train import compile_cache as jcc
from learningorchestra_tpu_torch.api.server import APIServer
from learningorchestra_tpu_torch.config import (
    AotConfig,
    Config,
    StoreConfig,
)
from learningorchestra_tpu_torch.obs import costs
from learningorchestra_tpu_torch.train import compile_cache as cc
from tests.torch_rest_pair import server_pair

_COUNTS = ("hits", "misses", "coalesced", "evictions")


@pytest.fixture(autouse=True)
def _fresh_process_state():
    """Empty program caches and cost ledgers on both sides: they are
    process-wide, and jobs of other test files run in this process may
    have carried the same job names."""
    for reset in (cc.reset_cache, jcc.reset_cache, costs.reset,
                  jcosts.reset):
        reset()


def _counts(delta: dict) -> dict:
    return {k: delta[k] for k in _COUNTS}


def _fit_body(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((24, 5)).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.int32)
    return {"x": x.tolist(), "y": y.tolist(), "epochs": 2,
            "batch_size": 8}


def test_train_jobs_cache_counters_and_documents_equal_jax(tmp_path):
    out = {}
    with server_pair(tmp_path) as (servers, clients):
        for side, ctx in clients.items():
            ctx.model.create(
                "mlp", module_path="learningorchestra_tpu.models.mlp",
                class_name="MLPClassifier",
                class_parameters={"hidden_layer_sizes": [11],
                                  "num_classes": 2})
            ctx.observe.wait("mlp", timeout=120)
            metas = []
            for name in ("fit1", "fit2"):
                ctx.train.create(name, parent_name="mlp", method="fit",
                                 method_parameters=_fit_body())
                ctx.observe.wait(name, timeout=300)
                metas.append(ctx.train.metadata(name))
            out[side] = {
                "metas": metas,
                "cache": ctx.monitoring.lookup("compileCache"),
                "costs": ctx.request("GET", "/observability/costs"),
            }
    port, ref = out["port"], out["jax"]
    for pm, jm in zip(port["metas"], ref["metas"]):
        assert pm["jobState"] == jm["jobState"] == "finished"
        assert _counts(pm["compileCache"]) == _counts(jm["compileCache"])
        assert set(pm["compileCache"]) == set(jm["compileCache"])
        assert set(pm["deviceTime"]) == set(jm["deviceTime"])
        assert pm["deviceTime"]["dispatches"] == \
            jm["deviceTime"]["dispatches"] == 2
    first, second = port["metas"]
    assert first["compileCache"]["misses"] >= 1
    assert (second["compileCache"]["misses"],
            second["compileCache"]["hits"]) == (0, 2)
    assert set(port["cache"]) == set(ref["cache"])
    assert set(port["cache"]["aot"]) == set(ref["cache"]["aot"])
    assert port["cache"]["aot"] == ref["cache"]["aot"]  # disabled shape
    assert set(port["cache"]["programCosts"]) == \
        set(ref["cache"]["programCosts"])
    assert set(port["costs"]) == set(ref["costs"])
    assert set(port["costs"]["deviceTime"]) == \
        set(ref["costs"]["deviceTime"])
    assert set(port["costs"]["ledger"]) == set(ref["costs"]["ledger"])
    assert port["costs"]["deviceTime"]["jobs"]["fit2"]["dispatches"] == 2


def test_same_architecture_tune_counts_follow_their_arithmetic(tmp_path):
    server = APIServer(Config(store=StoreConfig(
        root=str(tmp_path / "store"), volume_root=str(tmp_path / "vol"))),
        device="cpu")
    server.start_background()
    try:
        ctx = server.ctx
        from learningorchestra_tpu_torch.services.executor import (
            ExecutorService,
        )
        from learningorchestra_tpu_torch.services.model import ModelService

        ModelService(ctx).create(
            "tmlp", module_path="learningorchestra_tpu.models.mlp",
            class_name="MLPClassifier",
            class_parameters={"hidden_layer_sizes": [13],
                              "num_classes": 2})
        ctx.engine.wait("tmlp", timeout=60)
        ExecutorService(ctx).create_tune(
            "tune", parent_name="tmlp", param_grid={"seed": [1, 2]},
            method_parameters=_fit_body(1))
        ctx.engine.wait("tune", timeout=300)
        meta = ctx.artifacts.metadata.read("tune")
        assert meta["jobState"] == "finished", meta.get("exception")
        delta = meta["compileCache"]
        # Two programs (epoch_fns, device_epoch), two candidates: one
        # miss per program, the other lookup a hit (coalesced when the
        # candidates met mid-build); scoring reuses the evaluate program.
        assert delta["misses"] == 2
        assert delta["hits"] == 2
        assert 0 <= delta["coalesced"] <= delta["hits"]
        assert delta["evictions"] == 0
        assert meta["deviceTime"]["dispatches"] == 2 * 2  # epochs x trials
    finally:
        server.shutdown()


LM = dict(vocab_size=16, hidden_dim=32, num_layers=2, num_heads=4,
          max_len=16)


def test_decode_program_lookups_count_as_the_jax_engine(tmp_path):
    rng = np.random.default_rng(3)
    x = rng.integers(1, LM["vocab_size"], (8, 12)).astype(np.int32)
    y = np.concatenate([x[:, 1:], np.zeros((8, 1), np.int32)], 1)
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6]]
    requests_ = [
        {"prompts": prompts, "max_new_tokens": 6},
        {"prompts": prompts, "max_new_tokens": 6},
        {"prompts": [prompts[0]], "max_new_tokens": 4, "temperature": 0.7,
         "top_k": 3, "seed": 1},
        {"prompts": [prompts[0]], "max_new_tokens": 4, "temperature": 0.9,
         "top_k": 3, "seed": 2},
    ]
    deltas = {}
    with server_pair(tmp_path) as (servers, clients):
        for side, ctx in clients.items():
            ctx.model.create(
                "lm", module_path="learningorchestra_tpu.models.text",
                class_name="DecoderLM", class_parameters=dict(LM, seed=0))
            ctx.observe.wait("lm", timeout=120)
        jvols = servers["jax"].ctx.volumes
        jest = jvols.read_object("model/tensorflow", "lm")
        jest._init_params(x[:1])
        jvols.save_object("model/tensorflow", "lm", jest)
        pvols = servers["port"].ctx.volumes
        pest = pvols.load_estimator("model/tensorflow", "lm", device="cpu")
        pest.load_state_dict({"params": jax.tree_util.tree_map(
            np.asarray, jest.params)})
        pvols.save_estimator("model/tensorflow", "lm", pest)
        mods = {"jax": jcc, "port": cc}
        for side, ctx in clients.items():
            ctx.train.create("lm_fit", parent_name="lm", method="fit",
                             method_parameters={"x": x.tolist(),
                                                "y": y.tolist(),
                                                "epochs": 1,
                                                "batch_size": 8})
            ctx.observe.wait("lm_fit", timeout=300)
            deltas[side] = []
            for body in requests_:
                before = mods[side].counters_snapshot()
                ctx.serve.generate("lm_fit", **body)
                deltas[side].append(_counts(mods[side].delta_since(before)))
    assert deltas["port"] == deltas["jax"]
    # The JSON requests build the engine's step programs once, then hit;
    # each sampled shape builds one solo decode program.
    assert deltas["port"][0]["misses"] >= 1
    assert deltas["port"][1]["misses"] == 0
    assert deltas["port"][2]["misses"] == 1
    assert deltas["port"][3] == {"hits": 1, "misses": 0, "coalesced": 0,
                                 "evictions": 0}


def test_aot_enabled_is_refused_at_boot(monkeypatch, tmp_path):
    """Kept by name: the store was refused at boot until it was ported
    (train/aot_store.py).  ``LO_TPU_AOT_ENABLED=1`` now boots, and the
    ``aot`` block of ``compileCache`` is the store's live counters."""
    from learningorchestra_tpu_torch.train import aot_store

    monkeypatch.setenv("LO_TPU_AOT_ENABLED", "1")
    assert Config.from_env().aot.enabled is True
    server = APIServer(Config(store=StoreConfig(
        root=str(tmp_path / "s"), volume_root=str(tmp_path / "v")),
        aot=AotConfig(enabled=True, dir=str(tmp_path / "aot"))),
        device="cpu")
    try:
        status, doc = server.handle(
            "GET", "/api/learningOrchestra/v1/monitoring/tensorflow/"
            "compileCache", {})
        assert status == 200
        assert doc["aot"]["enabled"] is True
        assert doc["aot"]["dir"] == str(tmp_path / "aot")
    finally:
        server.shutdown()
        aot_store.reset_store()
    monkeypatch.setenv("LO_TPU_AOT_ENABLED", "0")
    assert Config.from_env().aot.enabled is False
