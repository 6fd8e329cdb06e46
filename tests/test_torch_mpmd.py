"""The port's MPMD schedule (``learningorchestra_tpu_torch/parallel/
mpmd.py``) against the JAX package's, mirroring ``tests/test_mpmd.py``,
with the JAX initial params carried in, in f32:

- the fit trajectory (loss history and final params) and predict/evaluate
  against the JAX MPMD fit;
- one program-cache entry per stage program on the first fit, every
  entry hit on a refit of the same architecture;
- one ``mpmd.stage`` span per stage and epoch;
- the partition layout, a resume that continues the uninterrupted
  trajectory, and a missing partition marker meaning a fresh start;
- restore-best weights rolling the partitioned state back;
- a kill-9 drill of a served MPMD fit: the killed server's fit resumes
  every stage from the newest common step in a fresh process;
- a streaming fit over a sharded token dataset against the JAX
  streaming fit, and predict on the bare dataset."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from learningorchestra_tpu.parallel import MeshSpec as JaxSpec
from learningorchestra_tpu.parallel import build_mesh as jax_mesh
from learningorchestra_tpu.parallel.pipeline import (
    PipelinedTransformer as JaxPipe,
)
from learningorchestra_tpu_torch.obs import tracing
from learningorchestra_tpu_torch.parallel import pipeline as pl
from learningorchestra_tpu_torch.parallel.mpmd import partition_names
from learningorchestra_tpu_torch.train import compile_cache as cc
from learningorchestra_tpu_torch.train.neural import EarlyStopping

ROOT = Path(__file__).resolve().parents[1]
MODEL = dict(vocab_size=64, hidden_dim=16, num_layers=4, num_heads=2,
             mlp_dim=16, max_len=8, num_classes=2, seed=1,
             n_microbatches=4, compute_dtype="float32", schedule="mpmd")
TOL = dict(atol=1e-4, rtol=1e-4)  # test_torch_train.py's bar


def _toy(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 64, (n, 8)).astype(np.int32)
    x[::4, 6:] = 0  # padded tails
    return x, (x.sum(axis=1) % 2).astype(np.int32)


def _mpmd(**kw):
    return pl.PipelinedTransformer(pp=2, devices=["cpu"] * 2, device="cpu",
                                   **{**MODEL, **kw})


def _jax_mpmd(**kw):
    mesh = jax_mesh(JaxSpec(pp=2), jax.devices()[:2])
    return JaxPipe(mesh=mesh, **{**MODEL, **kw})


def _jax_params(jest):
    ep, sp, hp = jax.device_get(jest.params)
    if isinstance(sp, (list, tuple)):  # the engine's partitioned layout
        sp = jax.tree_util.tree_map(lambda *ls: np.stack(ls), *sp)
    return ep, sp, hp


def _close(got, want, where=""):
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **TOL,
                                   err_msg=f"{where} "
                                   f"{jax.tree_util.keystr(path)}")


@pytest.fixture(scope="module")
def trajectories():
    """A JAX and a port MPMD fit from the same initial params (lr 2e-5:
    under adam the key bias, an exactly zero gradient, is stepped by
    rounding noise on both sides), then their predictions."""
    x, y = _toy(40)
    jest = _jax_mpmd(learning_rate=2e-5)
    jest._init_params(jnp.asarray(x[:1]))
    init = _jax_params(jest)
    jest.fit(x, y, epochs=3, batch_size=16, shuffle=False)
    pest = _mpmd(learning_rate=2e-5)
    pest.load_state_dict({"params": init})
    pest.fit(x, y, epochs=3, batch_size=16, shuffle=False)
    return x, y, jest, pest


def test_fit_trajectory_matches_jax(trajectories):
    x, y, jest, pest = trajectories
    for key in jest.history:
        np.testing.assert_allclose(pest.history[key], jest.history[key],
                                   **TOL)
    _close(pest.state_dict()["params"], _jax_params(jest), "final params")
    # The partitioned optimizer layout, one adam state per partition.
    opt = pest.state_dict()["opt_state"]
    assert isinstance(opt, tuple) and len(opt[1]) == 2
    assert int(opt[0]["count"]) == 9  # 3 epochs x 3 batches


def test_predict_and_evaluate_match_jax(trajectories):
    x, y, jest, pest = trajectories
    logits = np.concatenate(list(pest._forward_chunks(x[:5])), axis=0)
    jlogits = np.concatenate(list(jest._forward_chunks(x[:5])), axis=0)
    assert logits.shape == (5, 2)
    np.testing.assert_allclose(logits, jlogits, **TOL)
    np.testing.assert_array_equal(pest.predict(x), np.asarray(
        jest.predict(x)))
    got, want = pest.evaluate(x, y), jest.evaluate(x, y)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **TOL)


# -- per-stage program-cache entries ------------------------------------------

def test_first_fit_banks_one_entry_per_stage_program():
    """4 embed (fwd/bwd/zeros/opt) + 4 per stage + 4 head (bwd/zeros/
    finalize/opt) train programs for one shape, as the JAX engine
    banks."""
    x, y = _toy(16)
    cache = cc.get_cache()
    before = cache.stats()["misses"]
    model = _mpmd(hidden_dim=24, mlp_dim=24, n_microbatches=2)
    model.fit(x, y, epochs=1, batch_size=8, shuffle=False)
    assert cache.stats()["misses"] - before == 4 + 4 * model.pp + 4
    keys = model._mpmd._train.keys
    assert keys[("stage:fwd", 0)] != keys[("stage:fwd", 1)]
    for name, key in keys.items():
        assert cache.contains(key), name


def test_refit_of_the_same_architecture_hits_every_entry():
    x, y = _toy(16)
    _mpmd(hidden_dim=20, mlp_dim=20, n_microbatches=2).fit(
        x, y, epochs=1, batch_size=8, shuffle=False)
    cache = cc.get_cache()
    before = cache.stats()
    _mpmd(hidden_dim=20, mlp_dim=20, n_microbatches=2).fit(
        x, y, epochs=1, batch_size=8, shuffle=False)
    after = cache.stats()
    assert after["misses"] - before["misses"] == 0
    assert after["hits"] - before["hits"] == 4 + 4 * 2 + 4


def test_fit_records_one_span_per_stage():
    x, y = _toy(16)
    model = _mpmd()
    trace = tracing.new_trace("mpmd-fit")
    assert trace is not None
    with tracing.activate(trace):
        model.fit(x, y, epochs=2, batch_size=16, shuffle=False)
    spans = trace.to_doc()["spans"]
    assert sorted((s["attrs"]["epoch"], s["attrs"]["stage"])
                  for s in spans if s["name"] == "mpmd.stage") == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    epochs = [s for s in spans if s["name"] == "epoch"]
    assert len(epochs) == 2
    if "flops" in epochs[0]["attrs"]:
        assert epochs[0]["attrs"]["collectivesExcluded"] is True
        assert epochs[0]["attrs"]["flops"] > 0


# -- stage-partitioned checkpoints --------------------------------------------


def test_partition_layout_and_resume_continue_the_trajectory(tmp_path):
    x, y = _toy(32)
    ckdir = tmp_path / "ck"
    ck = dict(checkpoint_dir=str(ckdir), checkpoint_every=1,
              checkpoint_min_interval_s=0, checkpoint_async=False)
    _mpmd().fit(x, y, epochs=3, batch_size=32, shuffle=False, **ck)
    assert partition_names(2) == ["embed", "stage_00", "stage_01", "head"]
    for name in partition_names(2):
        assert (ckdir / name / "latest.json").exists(), name
    assert json.loads((ckdir / "latest.json").read_text())["step"] == 3
    resumed = _mpmd()
    resumed.fit(x, y, epochs=5, batch_size=32, shuffle=False, **ck)
    assert len(resumed.history["loss"]) == 5  # 3 restored + 2 new
    straight = _mpmd()
    straight.fit(x, y, epochs=5, batch_size=32, shuffle=False)
    np.testing.assert_allclose(resumed.history["loss"],
                               straight.history["loss"], rtol=2e-6,
                               atol=1e-7)


def test_missing_partition_marker_means_fresh_start(tmp_path):
    x, y = _toy(16)
    ckdir = tmp_path / "ck"
    _mpmd().fit(x, y, epochs=2, batch_size=16, shuffle=False,
                checkpoint_dir=str(ckdir), checkpoint_every=1,
                checkpoint_min_interval_s=0, checkpoint_async=False)
    (ckdir / "stage_01" / "latest.json").unlink()
    fresh = _mpmd()
    fresh._init_params()
    assert fresh._engine().resume_checkpoint(ckdir) is None


def test_restore_best_weights_rolls_the_partitions_back():
    """min_delta=10: epoch 0 is the only improvement, so the stop at epoch
    1 rolls the partitioned params back to a 1-epoch run's and drops the
    moments; the model then fits and predicts on."""
    x, y = _toy(32)
    model = _mpmd()
    es = EarlyStopping(monitor="loss", patience=1, min_delta=10.0,
                       restore_best_weights=True)
    model.fit(x, y, epochs=5, batch_size=32, shuffle=False, callbacks=[es])
    assert model.stop_training and es.best_epoch == 0
    assert len(model.history["loss"]) == 2
    assert model.opt_state is None
    one = _mpmd()
    one.fit(x, y, epochs=1, batch_size=32, shuffle=False)
    _close(model.state_dict()["params"], one.state_dict()["params"],
           "restored")
    model.fit(x, y, epochs=1, batch_size=32, shuffle=False)
    assert model.opt_state is not None
    assert model.predict(x[:4]).shape == (4,)


# -- the kill-9 drill ---------------------------------------------------------

_PARAMS = {"vocab_size": 32, "hidden_dim": 8, "num_layers": 2,
           "num_heads": 2, "mlp_dim": 8, "max_len": 8, "num_classes": 2,
           "n_microbatches": 2, "pp": 2, "compute_dtype": "float32",
           "schedule": "mpmd", "seed": 0}

_CHILD_SERVER = r"""
import json, os, sys
import numpy as np
from learningorchestra_tpu_torch import faults
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.services.executor import ExecutorService
from learningorchestra_tpu_torch.services.model import ModelService

ctx = ServiceContext(Config.from_env(), device="cpu")
rng = np.random.default_rng(0)
x = rng.integers(1, 32, (16, 8)).astype("int32")
y = (x.sum(1) % 2).astype("int32")
ModelService(ctx).create(
    "pm", module_path="learningorchestra_tpu.parallel.pipeline",
    class_name="PipelinedTransformer",
    class_parameters=json.loads(sys.argv[1]))
ctx.engine.wait("pm", timeout=120)
# Epochs 0-1 run free (and checkpoint); every later epoch's top waits
# 400 ms, so the kill lands while the fit runs.
faults.arm("train.epoch", "delay", delay_ms=400, after=2)
ExecutorService(ctx).create(
    "fitp", parent_name="pm", method="fit",
    method_parameters={"x": x.tolist(), "y": y.tolist(), "epochs": 6,
                       "batch_size": 16, "shuffle": False,
                       "checkpoint_every": 1,
                       "checkpoint_min_interval_s": 0,
                       "checkpoint_async": False},
    artifact_type="train/tensorflow")
print("SUBMITTED", flush=True)
sys.stdin.read()  # held until the parent kills this process
"""

_CHILD_RECOVERY = r"""
import json, time
from learningorchestra_tpu_torch.config import Config
from learningorchestra_tpu_torch.parallel.pipeline import PipelinedTransformer
from learningorchestra_tpu_torch.services.context import ServiceContext

ran = []
record = PipelinedTransformer._record_epoch_obs


def counted(self, epoch_i, epoch_s):
    ran.append(epoch_i)
    return record(self, epoch_i, epoch_s)


PipelinedTransformer._record_epoch_obs = counted
ctx = ServiceContext(Config.from_env(), device="cpu")  # recovers fitp
deadline = time.time() + 120
meta = {}
while time.time() < deadline:
    meta = ctx.artifacts.metadata.read("fitp") or {}
    if meta.get("finished") or meta.get("jobState") == "failed":
        break
    time.sleep(0.05)
print("RESULT " + json.dumps({"jobState": meta.get("jobState"),
                              "epochs": ran}), flush=True)
ctx.close()
"""


def _wait_for(cond, deadline_s, what):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _step(path: Path) -> int:
    try:
        return int(json.loads(path.read_text())["step"])
    except (OSError, ValueError, KeyError):
        return 0


def test_kill9_of_a_served_mpmd_fit_resumes_every_stage(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT),
           "LO_TPU_STORE_ROOT": str(tmp_path / "store"),
           "LO_TPU_VOLUME_ROOT": str(tmp_path / "vol"),
           "LO_TPU_CPU_RANKS": "2"}
    ckdir = tmp_path / "vol" / "_checkpoints" / "fitp"
    procs = []
    try:
        server = subprocess.Popen(
            [sys.executable, "-c", _CHILD_SERVER, json.dumps(_PARAMS)],
            env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        procs.append(server)
        _wait_for(lambda: _step(ckdir / "latest.json") >= 2
                  or server.poll() is not None, 180, "a step-2 checkpoint")
        assert server.poll() is None, server.communicate()[1][-3000:]
        server.send_signal(signal.SIGKILL)
        server.wait(timeout=30)
        assert server.returncode == -signal.SIGKILL
        step_at_kill = _step(ckdir / "latest.json")
        assert step_at_kill >= 2
        # One directory per partition, each committed at least as far.
        for name in partition_names(2):
            assert _step(ckdir / name / "latest.json") >= step_at_kill, name
        recovery = subprocess.Popen(
            [sys.executable, "-c", _CHILD_RECOVERY], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        procs.append(recovery)
        out, err = recovery.communicate(timeout=180)
        assert recovery.returncode == 0, err[-3000:]
        result = json.loads(out.split("RESULT ", 1)[1].splitlines()[0])
        assert result["jobState"] == "finished", result
        # Resumed per stage, not restarted: only the tail ran.
        assert result["epochs"] == list(range(step_at_kill, 6)), (
            result, step_at_kill)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=30)
            for stream in (proc.stdin, proc.stdout, proc.stderr):
                if stream is not None:
                    stream.close()


def test_streaming_fit_over_shards_matches_jax(tmp_path):
    """A sharded token dataset streams through the MPMD fit shard by
    shard in the JAX package's shard and in-shard orders; the loss
    history matches the JAX streaming fit from the same initial params,
    and predict on the bare dataset feeds the fit's columns."""
    from learningorchestra_tpu.store.sharded import (
        ShardedDataset as JaxSharded,
    )
    from learningorchestra_tpu.store.sharded import ShardedDatasetWriter
    from learningorchestra_tpu_torch.store.sharded import ShardedDataset

    x, y = _toy(48, seed=5)
    fields = [f"t{i}" for i in range(8)]
    writer = ShardedDatasetWriter(tmp_path / "tok", fields + ["label"],
                                  rows_per_shard=16)
    for row, label in zip(x, y):
        writer.append([int(v) for v in row] + [int(label)])
    writer.close()
    jds, pds = JaxSharded(tmp_path / "tok"), ShardedDataset(tmp_path / "tok")
    jest = _jax_mpmd(learning_rate=2e-5)
    jest._init_params(jnp.asarray(x[:1]))
    init = _jax_params(jest)
    jest.fit(jds, jds["label"], epochs=2, batch_size=8)
    pest = _mpmd(learning_rate=2e-5)
    pest.load_state_dict({"params": init})
    pest.fit(pds, pds["label"], epochs=2, batch_size=8)
    for key in jest.history:
        np.testing.assert_allclose(pest.history[key], jest.history[key],
                                   **TOL)
    assert pest._sharded_fit_cols == fields
    np.testing.assert_array_equal(pest.predict(pds),
                                  np.asarray(jest.predict(jds)))
