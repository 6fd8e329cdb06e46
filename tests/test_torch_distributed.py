"""The port's data-parallel trainer (``parallel/distributed.py``: one
process per rank, gloo on the CPU) against the JAX package's
``DistributedTrainer`` on a 2-device mesh, from the same initial
parameters (carried with ``convert.py``) and the same batch order
(``shuffle=False``), in f32.

- a world-2 fit's loss history (validation metrics included) and final
  params within 1e-4 (``test_torch_train.py``'s bar), for an even split,
  a ragged tail whose pad rows all fall on rank 1 (the masked mean must
  divide by the GLOBAL mask sum, not each rank's) and
  ``accumulate_steps=2``;
- ``tests/test_parallel.py``'s contracts, one parametrised test: a fit
  that learns (samples/s in its history), early stopping, restoring the
  best weights (equal to a world-2 fit run for best_epoch + 1 epochs;
  the moments dropped), the first epoch's loss (of the one-call
  ``distributed_fit``) equal to a single-device fit's, and the
  global-batch divisibility error;
- the mesh refuses every axis but ``dp``, ``ep`` and ``sp`` (``sp``
  accepted with its rank layout; ``ep`` is
  ``tests/test_torch_expert_parallel.py``'s), and folds spare devices
  into ``dp``; the backend follows the device list;
- a streaming world-2 fit over a sharded dataset equals the in-memory
  world-2 fit of the same rows;
- a checkpointed fit killed in its second epoch resumes to the
  uninterrupted result; a rank that raises fails ``fit`` promptly, and no
  rank outlives it.

Callbacks cross into the rank processes, so they are module-level
classes here (``test_parallel.py``'s recording closure has no
counterpart).
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu.models.mlp import MLPClassifier as JaxMLPC
from learningorchestra_tpu.parallel.distributed import (
    DistributedTrainer as JaxTrainer,
)
from learningorchestra_tpu.parallel.mesh import MeshSpec as JaxSpec
from learningorchestra_tpu.parallel.mesh import build_mesh as jax_mesh
from learningorchestra_tpu_torch import convert
from learningorchestra_tpu_torch.models.mlp import MLPClassifier
from learningorchestra_tpu_torch.parallel import (
    DistributedTrainer,
    MeshSpec,
    batch_rows,
    build_mesh,
    shard_batch,
)
from learningorchestra_tpu_torch.parallel.distributed import (
    backend_for,
    distributed_fit,
)
from learningorchestra_tpu_torch.parallel.sharding import (
    rank_coords,
    sequence_slice,
)
from learningorchestra_tpu_torch.store.sharded import (
    ShardedDataset,
    ShardedDatasetWriter,
)
from learningorchestra_tpu_torch.train.neural import EarlyStopping

TOL = dict(atol=1e-4, rtol=1e-4)
CPU2 = ["cpu", "cpu"]
KW = dict(hidden_layer_sizes=(16, 8), num_classes=3, learning_rate=1e-2,
          seed=4)


class KillAt:
    """Kill every rank at the given epoch's callback (a crash mid-fit)."""

    def __init__(self, epoch):
        self.epoch = epoch

    def __call__(self, epoch, metrics, model):
        if epoch == self.epoch:
            os._exit(9)


class RaiseOnRank:
    """Raise in one rank only; the others wait in a collective."""

    def __init__(self, rank):
        self.rank = rank

    def __call__(self, epoch, metrics, model):
        if model._dp.rank == self.rank:
            raise ValueError(f"boom on rank {self.rank}")


def _blobs(n, d=5, classes=3, seed=4):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n)
    x = rng.standard_normal((n, d)) + y[:, None] * 1.5  # float64 on purpose
    return x, y


def _toy_problem(n=256, d=8, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, classes))
    y = np.argmax(x @ w, axis=1).astype(np.int32)
    return x, y


def _port(**kw):
    est = MLPClassifier(**{**KW, **kw}, device="cpu")
    est.compute_dtype = "float32"
    return est


def _params(est):
    return {k: v.detach().clone() for k, v in est.module.named_parameters()}


def _trainer(est, devices=CPU2):
    return DistributedTrainer(est, devices=devices)


# -- against the JAX mesh trainer ---------------------------------------------

@pytest.mark.parametrize("case", [
    dict(n=64),                       # every global batch 8 + 8 real rows
    dict(n=60),                       # tail 12 real + 4 pad: 8 | 4 + 4 pad
    dict(n=64, accumulate_steps=2),   # one all-reduce per two batches
], ids=["even", "ragged_tail_on_rank1", "accumulate"])
def test_world2_fit_matches_jax_mesh(case):
    case = dict(case)
    x, y = _blobs(case.pop("n"))
    vx, vy = _blobs(20, seed=5)
    jest = JaxMLPC(**KW)
    jest.compute_dtype = "float32"
    jest._init_params(jnp.asarray(x[:1]))
    pest = _port()
    pest.load_state_dict({"params": jax.tree_util.tree_map(np.asarray,
                                                           jest.params)})
    fit = dict(epochs=2, batch_size=16, shuffle=False,
               validation_data=(vx, vy), **case)
    jt = JaxTrainer(jest, mesh=jax_mesh(JaxSpec(dp=2),
                                        devices=jax.devices()[:2]))
    jt.fit(x, y, **fit)
    pt = _trainer(pest)
    pt.fit(x, y, **fit)
    assert pt.mesh.size == 2 and pt.backend == "gloo"
    for key in ("loss", "accuracy", "val_loss", "val_accuracy"):
        np.testing.assert_allclose(pt.history[key], jt.history[key], **TOL,
                                   err_msg=key)
        np.testing.assert_allclose(pest.history[key], jest.history[key],
                                   **TOL, err_msg=key)
    assert len(pt.history["samples_per_sec"]) == 2
    want = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jest.params))
    got = jax.tree_util.tree_leaves(convert.params_to_jax(pest.module))
    for (path, u), v in zip(want, got):
        np.testing.assert_allclose(v, u, **TOL,
                                   err_msg=jax.tree_util.keystr(path))
    # Every rank launches on the CPU's plain path: no kernel counts there.
    assert [s["rank"] for s in pt.rank_stats] == [0, 1]
    assert all(len(s["step_ms"]) == 2 * -(-len(x) // 16)
               for s in pt.rank_stats)


# -- test_parallel.py's contracts ---------------------------------------------

def _learns():
    x, y = _toy_problem()
    est = _port(hidden_layer_sizes=(16,), num_classes=4, seed=1)
    trainer = _trainer(est)
    trainer.fit(x, y, epochs=30, batch_size=64)
    assert est.score(x, y) > 0.8
    assert trainer.history["samples_per_sec"]
    assert "accuracy" in trainer.history


def _early_stopping():
    x, y = _toy_problem()
    est = _port(hidden_layer_sizes=(16,), num_classes=4, seed=1,
                learning_rate=0.0)
    trainer = _trainer(est)
    trainer.fit(x, y, epochs=20, batch_size=64,
                early_stopping={"monitor": "loss", "patience": 2})
    # lr 0: epoch 0 best, epochs 1-2 do not improve -> exactly 3 run.
    assert len(trainer.history["loss"]) == 3
    assert len(est.history["loss"]) == 3
    assert trainer.stop_training


def _restore_best_weights():
    x, y = _toy_problem()
    kw = dict(hidden_layer_sizes=(16,), num_classes=4, seed=1,
              learning_rate=5.0)
    est = _port(**kw)
    cb = EarlyStopping(monitor="loss", patience=2, restore_best_weights=True)
    trainer = _trainer(est)
    trainer.fit(x, y, epochs=20, batch_size=64, callbacks=[cb])
    losses = trainer.history["loss"]
    best = int(np.argmin(losses))
    # lr 5.0 makes later epochs worse: the fit stopped past its best.
    assert best < len(losses) - 1 and len(losses) == best + 3
    assert est.opt_state is None  # the moments belong to later epochs
    ref = _port(**kw)
    _trainer(ref).fit(x, y, epochs=best + 1, batch_size=64)
    for name, p in _params(ref).items():
        np.testing.assert_allclose(_params(est)[name], p, rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    assert est.score(x, y) >= 0


def _first_epoch_matches_single_device():
    x, y = _toy_problem(n=128)
    single = _port(hidden_layer_sizes=(16,), num_classes=4, seed=3)
    single.fit(x, y, epochs=1, batch_size=32, shuffle=False)
    est = _port(hidden_layer_sizes=(16,), num_classes=4, seed=3)
    assert distributed_fit(est, x, y, devices=CPU2, epochs=1,
                           batch_size=32, shuffle=False) is est
    np.testing.assert_allclose(single.history["loss"][-1],
                               est.history["loss"][-1], rtol=1e-4)


def _global_batch_must_divide():
    x, y = _toy_problem(n=32)
    est = _port(hidden_layer_sizes=(8,), num_classes=4)
    with pytest.raises(ValueError, match="divisible"):
        _trainer(est, ["cpu"] * 8).fit(x, y, batch_size=30)


@pytest.mark.parametrize("contract", [
    _learns, _early_stopping, _restore_best_weights,
    _first_epoch_matches_single_device, _global_batch_must_divide,
], ids=lambda f: f.__name__.strip("_"))
def test_distributed_contract(contract):
    contract()


# -- mesh and backend ---------------------------------------------------------

@pytest.mark.parametrize("axis", ["fsdp", "tp"])
def test_model_axes_are_refused(axis):
    with pytest.raises(ValueError, match="only the data axis"):
        build_mesh(MeshSpec(**{axis: 2}), ["cpu"] * 4)


def test_sequence_axis_is_accepted_with_its_rank_layout():
    mesh = build_mesh(MeshSpec(sp=2), ["cpu"] * 4)
    assert mesh.size == 4 and mesh.shape["sp"] == 2 \
        and mesh.shape["dp"] == 2  # spare devices fold into dp
    # sp varies fastest: rank r is dp index r // sp, sp index r % sp
    # (and pp and ep index 0).
    assert [rank_coords(r, 2) for r in range(4)] == [
        (0, 0, 0, 0), (0, 0, 0, 1), (1, 0, 0, 0), (1, 0, 0, 1)]
    assert sequence_slice(12, 1, 2) == slice(6, 12)
    with pytest.raises(ValueError, match="power of two"):
        build_mesh(MeshSpec(sp=3), ["cpu"] * 3)
    with pytest.raises(ValueError, match="not divisible by sp=2"):
        DistributedTrainer(_port(), spec=MeshSpec(sp=2), devices=CPU2).fit(
            np.ones((4, 7), np.int32), np.zeros(4, np.int32),
            batch_size=2)


def test_mesh_folds_spare_devices_and_picks_the_backend():
    mesh = build_mesh(MeshSpec(dp=2), ["cpu"] * 8)
    assert mesh.size == 8 and mesh.shape["dp"] == 8  # as the JAX mesh
    with pytest.raises(ValueError, match="does not fit"):
        build_mesh(MeshSpec(dp=16), ["cpu"] * 8)
    rows = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(shard_batch((rows,), 1, 3)[0], rows[2:4])
    with pytest.raises(ValueError, match="divisible"):
        batch_rows(6, 0, 4)
    assert backend_for(CPU2) == "gloo"
    with pytest.raises(ValueError, match="mix"):
        backend_for(["cpu", "cuda:0"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            backend_for(["cuda:0", "cuda:1"])


# -- streaming, resume, failure -----------------------------------------------

def test_streaming_fit_equals_in_memory_fit(tmp_path):
    x, y = _blobs(64)
    writer = ShardedDatasetWriter(tmp_path / "ds", ["a", "b", "c", "d", "e",
                                                    "label"],
                                  rows_per_shard=32)
    for row, label in zip(x, y):
        writer.append([*row.tolist(), int(label)])
    writer.close()
    ds = ShardedDataset(tmp_path / "ds")
    fit = dict(epochs=2, batch_size=16, shuffle=False)
    streamed, memory = _port(), _port()
    _trainer(streamed).fit(ds, ds["label"], **fit)
    _trainer(memory).fit(x.astype(np.float32), y, **fit)
    np.testing.assert_allclose(streamed.history["loss"],
                               memory.history["loss"], rtol=1e-6)
    for name, p in _params(memory).items():
        np.testing.assert_allclose(_params(streamed)[name], p, rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    assert streamed._sharded_fit_cols == ["a", "b", "c", "d", "e"]


def test_killed_fit_resumes_to_the_uninterrupted_result(tmp_path):
    x, y = _blobs(64)
    fit = dict(epochs=3, batch_size=16, checkpoint_min_interval_s=0.0,
               checkpoint_async=False)
    whole = _port()
    _trainer(whole).fit(x, y, checkpoint_dir=str(tmp_path / "a"), **fit)
    killed = _port()
    with pytest.raises(RuntimeError, match="exited with code 9"):
        _trainer(killed).fit(x, y, checkpoint_dir=str(tmp_path / "b"),
                             callbacks=[KillAt(1)], **fit)
    resumed = _port()
    trainer = _trainer(resumed)
    trainer.fit(x, y, checkpoint_dir=str(tmp_path / "b"), **fit)
    assert len(trainer.history["loss"]) == 3  # the checkpoint's epoch + 2
    assert len(resumed.history["loss"]) == 2  # the epochs this call ran
    np.testing.assert_allclose(trainer.history["loss"],
                               whole.history["loss"], rtol=1e-6)
    for name, p in _params(whole).items():
        np.testing.assert_allclose(_params(resumed)[name], p, rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_a_raising_rank_fails_fit_and_leaves_no_child():
    x, y = _blobs(64)
    trainer = _trainer(_port())
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="boom on rank 1"):
        trainer.fit(x, y, epochs=3, batch_size=16,
                    callbacks=[RaiseOnRank(1)])
    assert time.monotonic() - t0 < 60
    assert len(trainer._procs) == 2
    assert all(p.poll() is not None for p in trainer._procs)
