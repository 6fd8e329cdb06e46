"""The port's managed checkpoints (``train/checkpoint.py``, ``fit``'s
checkpoint arguments, the executor's injection), on the CPU.

- the layout (``step_<n>/``, ``latest.json``), the marker as the commit
  point (a save killed before its marker leaves the previous step
  discoverable), ``KEEP = 2`` pruning, async saves published at the next
  save or ``finalize_async``, a writer's failure raised there, and the
  snapshot taken before the caller's next in-place update;
- bit for bit on the port: a 4-epoch ``fit`` against a 2-epoch fit
  resumed to 4 (shuffled: each epoch's order is seeded by its index),
  the same with ``accumulate_steps=2`` under a schedule, and an early
  stop saving as the final epoch with the fresh moments a restore-best
  leaves;
- against the JAX package from carried params in f32: ``latest.json``'s
  history and step 2's params and opt_state (the JAX side restored
  through orbax with a numpy template) within ``TOL`` (1e-4);
- the executor over REST on a JAX and a port server: the injected
  directory, a PATCH of a failed job resuming from it, a PATCH of a
  finished job wiping it, ``DELETE`` removing it and a raw
  ``checkpoint_dir`` answered 406, with the same outcome on both.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu.api import APIServer as JaxServer
from learningorchestra_tpu.config import Config as JaxConfig
from learningorchestra_tpu.models.mlp import MLPClassifier as JaxMLPC
from learningorchestra_tpu.train import checkpoint as jax_ckpt
from learningorchestra_tpu_torch.api.server import APIServer
from learningorchestra_tpu_torch.config import Config, StoreConfig
from learningorchestra_tpu_torch.models.mlp import MLPClassifier
from learningorchestra_tpu_torch.train import checkpoint as ckpt
from learningorchestra_tpu_torch.train.neural import EarlyStopping

TOL = dict(atol=1e-4, rtol=1e-4)
PREFIX = "/api/learningOrchestra/v1"


def _data(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    return x, (x.sum(1) > 0).astype(np.int32)


def _mlp(optimizer=None, **kw):
    est = MLPClassifier(hidden_layer_sizes=(6,), num_classes=2, seed=3,
                        device="cpu", **kw)
    est.compute_dtype = "float32"
    if optimizer is not None:
        est.compile(optimizer=optimizer)
    return est


def _marker(directory):
    return json.loads((directory / "latest.json").read_text())


def _steps(directory):
    return sorted(p.name for p in directory.glob("step_*"))


# -- the module ---------------------------------------------------------------

def test_layout_marker_commit_point_and_pruning(tmp_path):
    state = {"params": {"w": torch.arange(4.0)}, "opt_state": {
        "count": np.asarray(3, np.int32)}}
    for step in (1, 2):
        ckpt.save(tmp_path, step, state, history={"loss": [0.5] * step})
    assert _marker(tmp_path) == {"step": 2, "history": {"loss": [0.5, 0.5]}}
    # A save killed before its marker: the step's data exists, the
    # marker still names step 2, and a reader resumes there.
    (tmp_path / "step_3.tmp").mkdir()
    (tmp_path / "step_3").mkdir()
    got, step, history = ckpt.load_latest(tmp_path)
    assert step == 2 and history == {"loss": [0.5, 0.5]}
    assert torch.equal(got["params"]["w"], torch.arange(4.0))
    assert int(got["opt_state"]["count"]) == 3
    for step in (3, 4):
        ckpt.save(tmp_path, step, state)
    assert _steps(tmp_path) == ["step_3", "step_4"]  # KEEP = 2
    assert ckpt.load_step(tmp_path, 1) is None
    assert ckpt.load_latest(tmp_path / "none") is None


def test_async_save_publishes_later_and_snapshots_first(tmp_path):
    live, history = {"w": torch.zeros(8)}, {"loss": [1.0]}
    ckpt.save(tmp_path, 1, {"params": live}, history, async_save=True)
    # The caller's next epoch updates the parameters in place at once,
    # and appends to its history.
    live["w"].add_(1.0)
    history["loss"].append(2.0)
    ckpt.save(tmp_path, 2, {"params": live}, history, async_save=True)
    live["w"].add_(1.0)
    history["loss"].append(3.0)
    # Step 1's marker, published now, holds step 1's history (the JAX
    # package's holds the lists as they are at publication).
    assert _marker(tmp_path) == {"step": 1, "history": {"loss": [1.0]}}
    ckpt.finalize_async(tmp_path)
    assert _marker(tmp_path) == {"step": 2, "history": {"loss": [1.0, 2.0]}}
    assert torch.equal(ckpt.load_step(tmp_path, 1)["params"]["w"],
                       torch.zeros(8))
    assert torch.equal(ckpt.load_step(tmp_path, 2)["params"]["w"],
                       torch.ones(8))
    saves = [s for s in ckpt.recent_saves if s["dir"] == str(tmp_path)]
    assert [s["step"] for s in saves] == [1, 2]
    assert all(s["bytes"] > 0 and s["async"] for s in saves)


def test_async_write_failure_raises_at_finalize(tmp_path):
    ckpt.save(tmp_path, 1, {"params": {"w": lambda: 0}}, async_save=True)
    with pytest.raises(RuntimeError, match="failed to write"):
        ckpt.finalize_async(tmp_path)
    assert not (tmp_path / "latest.json").exists()


# -- resume on the port, bit for bit --------------------------------------------

@pytest.mark.parametrize("kw", [
    {},
    {"accumulate_steps": 2, "optimizer": {
        "name": "adam", "learningRate": {
            "schedule": "cosine", "initValue": 1e-2, "decaySteps": 7}}},
], ids=["adam", "accumulate_schedule"])
def test_resumed_fit_equals_uninterrupted(tmp_path, kw):
    x, y = _data()
    opt = kw.get("optimizer")
    fit_kw = {k: v for k, v in kw.items() if k != "optimizer"}
    whole = _mlp(optimizer=opt)
    whole.fit(x, y, epochs=4, batch_size=6, **fit_kw)
    first = _mlp(optimizer=opt)
    first.fit(x, y, epochs=2, batch_size=6, checkpoint_dir=tmp_path,
              checkpoint_min_interval_s=0, **fit_kw)
    assert _marker(tmp_path)["step"] == 2
    resumed = _mlp(optimizer=opt)  # a new process's fresh estimator
    resumed.fit(x, y, epochs=4, batch_size=6, checkpoint_dir=tmp_path,
                checkpoint_min_interval_s=0, **fit_kw)
    assert resumed.history["loss"] == whole.history["loss"]
    assert len(resumed.history["epoch_time"]) == 4
    for a, b in zip(whole.module.parameters(), resumed.module.parameters()):
        assert torch.equal(a, b)
    assert resumed._updates == whole._updates
    assert resumed._mini_step == whole._mini_step
    assert _marker(tmp_path)["step"] == 4 and _steps(tmp_path) == [
        "step_3", "step_4"]
    # resume=False starts over and overwrites the tree's steps.
    fresh = _mlp(optimizer=opt)
    fresh.fit(x, y, epochs=1, batch_size=6, checkpoint_dir=tmp_path,
              resume=False, **fit_kw)
    assert fresh.history["loss"] == whole.history["loss"][:1]
    assert _marker(tmp_path)["step"] == 1


def test_resume_refuses_another_accumulation(tmp_path):
    x, y = _data()
    _mlp().fit(x, y, epochs=1, batch_size=6, checkpoint_dir=tmp_path)
    with pytest.raises(ValueError, match="checkpoint resume failed"):
        _mlp().fit(x, y, epochs=2, batch_size=6, checkpoint_dir=tmp_path,
                   accumulate_steps=2)


def test_early_stop_saves_as_final_with_fresh_moments(tmp_path):
    x, y = _data()
    est = _mlp()
    # "max" on a falling loss: epoch 1 does not improve, so the fit
    # stops after it and restores epoch 0's params.
    stop = EarlyStopping(monitor="loss", mode="max", patience=1,
                         restore_best_weights=True)
    est.fit(x, y, epochs=6, batch_size=6, checkpoint_dir=tmp_path,
            checkpoint_every=10, callbacks=[stop])
    assert len(est.history["loss"]) == 2 and est.opt_state is None
    state, step, history = ckpt.load_latest(tmp_path)
    assert step == 2 and history["loss"] == est.history["loss"]
    assert _steps(tmp_path) == ["step_2"]  # no periodic save before
    assert state["opt_state"] == {"count": torch.tensor(0, dtype=torch.int32)}
    for name, p in est.module.named_parameters():
        assert torch.equal(p, _mlp_params(state)[name]), name


def _mlp_params(state):
    from learningorchestra_tpu_torch import convert

    return convert.params_from_jax(state["params"])


# -- against the JAX package -----------------------------------------------------

def test_checkpoint_matches_jax_from_carried_params(tmp_path):
    x, y = _data()
    jest = JaxMLPC(hidden_layer_sizes=(6,), num_classes=2, seed=3,
                   learning_rate=1e-2)
    jest.compute_dtype = "float32"
    jest._init_params(jnp.asarray(x[:1]))
    pest = _mlp(learning_rate=1e-2)
    pest.load_state_dict({"params": jax.tree_util.tree_map(np.asarray,
                                                           jest.params)})
    fit = dict(epochs=3, batch_size=8, shuffle=False,
               checkpoint_every=2, checkpoint_min_interval_s=0)
    jest.fit(x, y, checkpoint_dir=str(tmp_path / "jax"), **fit)
    pest.fit(x, y, checkpoint_dir=str(tmp_path / "port"), **fit)
    markers = {s: _marker(tmp_path / s) for s in ("jax", "port")}
    assert markers["port"]["step"] == markers["jax"]["step"] == 3
    assert set(markers["port"]["history"]) == set(markers["jax"]["history"])
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(markers["port"]["history"][key],
                                   markers["jax"]["history"][key], **TOL)
    assert _steps(tmp_path / "port") == _steps(tmp_path / "jax") == [
        "step_2", "step_3"]
    template = jax.tree_util.tree_map(
        np.asarray, {"params": jest.params, "opt_state": jest.opt_state})
    want = jax_ckpt.load_step(tmp_path / "jax", 2, template)
    got = ckpt.load_step(tmp_path / "port", 2)
    got_np = jax.tree_util.tree_map(lambda t: t.numpy(), got)
    adam = want["opt_state"][0]
    pairs = [("params", got_np["params"], want["params"])] + [
        (f, got_np["opt_state"][f], getattr(adam, f)) for f in ("mu", "nu")]
    for what, ours, theirs in pairs:
        a = jax.tree_util.tree_leaves_with_path(ours)
        b = jax.tree_util.tree_leaves_with_path(theirs)
        assert [p for p, _ in a] == [p for p, _ in b], what
        for (path, u), (_, v) in zip(a, b):
            np.testing.assert_allclose(u, v, err_msg=f"{what}{path}", **TOL)
    assert int(got_np["opt_state"]["count"]) == int(adam.count) == 8


# -- the executor over REST ---------------------------------------------------

def _wait(server, name, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        meta = server.ctx.artifacts.metadata.read(name)
        if meta.get("finished") or meta.get("jobState") == "failed":
            return meta
        time.sleep(0.02)
    raise AssertionError(f"{name} did not finish")


def _history(server, name):
    return [d["loss"] for d in server.ctx.documents.find(
        name, query={"docType": "history"})]


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_rest")
    jcfg = JaxConfig()
    jcfg.store.root = str(tmp / "jax" / "store")
    jcfg.store.volume_root = str(tmp / "jax" / "volumes")
    jcfg.store.backend = "python"
    out = {
        "jax": JaxServer(jcfg),
        "port": APIServer(Config(store=StoreConfig(
            root=str(tmp / "port" / "store"),
            volume_root=str(tmp / "port" / "volumes"))), device="cpu"),
    }
    yield out
    for srv in out.values():
        srv.shutdown()


def _call(server, verb, path, body=None):
    return server.handle(verb, PREFIX + path, body or {}, {})


def _rest_drive(server):
    """Train, fail-and-PATCH (resume), PATCH a finished job (wipe),
    DELETE, and the raw-directory 406; returns what each step left."""
    x, y = _data()
    out = {}
    status, _ = _call(server, "POST", "/model/tensorflow", {
        "name": "m", "modulePath": "learningorchestra_tpu.models.mlp",
        "class": "MLPClassifier",
        "classParameters": {"hidden_layer_sizes": [4], "num_classes": 2}})
    assert status == 201
    _wait(server, "m")
    fit = {"x": x.tolist(), "y": y.tolist(), "epochs": 2, "batch_size": 8,
           "checkpoint_min_interval_s": 0}
    status, _ = _call(server, "POST", "/train/tensorflow", {
        "name": "fit1", "parentName": "m", "method": "fit",
        "methodParameters": fit})
    assert status == 201
    out["first"] = _wait(server, "fit1")["jobState"]
    ckdir = server.ctx.checkpoint_dir("fit1")
    out["path"] = ckdir.relative_to(server.ctx.volumes.root).as_posix()
    out["after_first"] = (_marker(ckdir)["step"], _steps(ckdir))
    first_losses = _history(server, "fit1")
    # A job that died after epoch 2, PATCHed back with 4 epochs:
    # resumed from its newest checkpoint, not from epoch 0.
    server.ctx.artifacts.metadata.mark_failed("fit1", "killed")
    status, _ = _call(server, "PATCH", "/train/tensorflow/fit1", {
        "methodParameters": {**fit, "epochs": 4}})
    assert status == 200
    out["resumed"] = _wait(server, "fit1")["jobState"]
    losses = _history(server, "fit1")
    out["resumed_history"] = (len(losses), losses[:2] == first_losses)
    out["after_resume"] = (_marker(ckdir)["step"], _steps(ckdir))
    # A finished job PATCHed: a fresh fit, the old tree wiped.
    status, _ = _call(server, "PATCH", "/train/tensorflow/fit1", {
        "methodParameters": {**fit, "epochs": 1}})
    out["rerun"] = _wait(server, "fit1")["jobState"]
    out["after_rerun"] = (_marker(ckdir)["step"], _steps(ckdir))
    out["raw_dir"] = _call(server, "POST", "/train/tensorflow", {
        "name": "fit2", "parentName": "m", "method": "fit",
        "methodParameters": {**fit, "checkpoint_dir": "/tmp/x"}})[0]
    out["delete"] = _call(server, "DELETE", "/train/tensorflow/fit1")[0]
    out["gone"] = not ckdir.exists()
    return out


def test_executor_checkpoints_over_rest_on_both(servers):
    outs = {side: _rest_drive(srv) for side, srv in servers.items()}
    assert outs["port"] == outs["jax"]
    assert outs["port"] == {
        "first": "finished", "path": "_checkpoints/fit1",
        "after_first": (2, ["step_1", "step_2"]),
        "resumed": "finished", "resumed_history": (4, True),
        "after_resume": (4, ["step_3", "step_4"]),
        "rerun": "finished", "after_rerun": (1, ["step_1"]),
        "raw_dir": 406, "delete": 200, "gone": True,
    }
