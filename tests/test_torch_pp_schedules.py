"""The port's pipeline schedules (``learningorchestra_tpu_torch/parallel/
pipeline.py``) against the JAX package's on the same seeded inputs, the
JAX initial params carried in, in f32:

- ``sequential_loss`` and its gradients (cls and lm heads);
- ``gpipe_step`` / ``one_f_one_b_step`` with each rank in a thread over
  the in-memory link (``tests/torch_pp_link.py``) against JAX
  ``gpipe_loss`` (under ``jax.grad``) and ``one_f_one_b_grads`` under
  ``shard_map`` on an explicit JAX mesh: pp 2 and 4, n_micro 8 and 16,
  dp 2 x pp 2, the lm head, a masked ragged tail and pad tokens in every
  case; loss 2e-5, gradients 5e-5;
- the 1F1B in-flight bound, and the replicated leaves bit-equal on every
  rank after an optimizer step;
- the JAX errors, and ``build_mesh`` accepting ``pp``;
- two fits through real gloo rank processes (gpipe pp 2; 1f1b dp 2 x
  pp 2 with a ragged tail) against the JAX ``fit`` with ``shuffle=False``:
  loss histories and final params at ``test_torch_train.py``'s bar, and
  adam's moments (``mu``, ``nu``: what the steps' gradients were) within
  1e-5 of each leaf's largest value.

The model is vocab 64, hidden 16, 4 layers, 2 heads, max_len 8, mlp 16
(JAX ``tests/test_sparse_models_rest.py:123-126``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from learningorchestra_tpu.parallel import MeshSpec as JaxSpec
from learningorchestra_tpu.parallel import build_mesh as jax_mesh
from learningorchestra_tpu.parallel.pipeline import (
    PipelinedTransformer as JaxPipe,
)
from learningorchestra_tpu.parallel.pipeline import (
    gpipe_loss,
    one_f_one_b_grads,
)
from learningorchestra_tpu.parallel.pipeline import (
    sequential_loss as jax_sequential_loss,
)
from learningorchestra_tpu_torch import convert
from learningorchestra_tpu_torch.models.mlp import MLPClassifier
from learningorchestra_tpu_torch.parallel import pipeline as pl
from learningorchestra_tpu_torch.parallel.distributed import DistributedTrainer
from learningorchestra_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from tests.torch_pp_link import Hub, run_ranks

MODEL = dict(vocab_size=64, hidden_dim=16, num_layers=4, num_heads=2,
             mlp_dim=16, max_len=8, num_classes=2, seed=1,
             compute_dtype="float32")
LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)
FIT_TOL = dict(atol=1e-4, rtol=1e-4)  # test_torch_train.py's bar
# Adam's moments after a fit, relative to each leaf's largest value: at
# lr 2e-5 the parameters move by ~lr a step whatever the gradients are,
# so the fit's gradients are held through the moments instead.
MOMENT_TOL = 1e-5
BATCH = P(("dp", "fsdp"))


def _batch(n, head="cls", seed=0):
    """Seeded tokens with zero-padded tails on some rows, labels, and a
    mask whose last rows are padding (a ragged tail)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 64, (n, 8)).astype(np.int32)
    for r in range(0, n, 3):
        x[r, 8 - 1 - r % 4:] = 0
    x[:, 0] = np.maximum(x[:, 0], 1)
    if head == "lm":
        y = np.concatenate([x[:, 1:], np.zeros((n, 1), np.int32)], 1)
    else:
        y = (x.sum(1) % 2).astype(np.int32)
    mask = np.ones(n, np.float32)
    mask[-3:] = 0.0
    return x, y, mask


def _jax_est(pp, dp=1, **kw):
    mesh = jax_mesh(JaxSpec(dp=dp, pp=pp), jax.devices()[:dp * pp])
    return JaxPipe(mesh=mesh, **{**MODEL, **kw})


def _port(pp, dp=1, params=None, **kw):
    est = pl.PipelinedTransformer(pp=pp, devices=["cpu"] * (dp * pp),
                                  device="cpu", **{**MODEL, **kw})
    if params is not None:
        est.load_state_dict({"params": params})
    return est


def _grad_tree(module):
    return convert.to_host(convert.flax_tree(
        module, pick=lambda p: torch.zeros_like(p) if p.grad is None
        else p.grad))


def _close(got, want, tol, where=""):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert [k for k, _ in flat_g] == [k for k, _ in flat_w], where
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(w), **tol,
            err_msg=f"{where} {jax.tree_util.keystr(path)}")


# -- the oracle ---------------------------------------------------------------


@pytest.mark.parametrize("head", ["cls", "lm"])
def test_sequential_loss_and_gradients_match_jax(head):
    x, y, mask = _batch(16, head)
    jest = _jax_est(pp=2, head=head)
    jest._init_params(jnp.asarray(x[:1]))
    params = jax.device_get(jest.params)
    seq = jax_sequential_loss(jest._embed.apply, jest._stage.apply,
                              jest._head.apply, jest._loss_fn,
                              n_stages=jest.pp)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda ps: seq(*ps, x, y, mask), has_aux=True)(params)

    pest = _port(pp=2, params=params, head=head)
    pest._ensure_parts()
    parts = pest._parts
    loss, metrics = pl.sequential_loss(
        parts.embed, list(parts.stages), parts.head, pest._loss_fn,
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   **LOSS_TOL)
    got = (_grad_tree(parts.embed),
           convert.stack_trees([_grad_tree(s) for s in parts.stages]),
           _grad_tree(parts.head))
    _close(got, jax.device_get(jgrads), GRAD_TOL, "sequential")


# -- the schedules ------------------------------------------------------------

CASES = [
    ("gpipe", 2, 1, 8, "cls"),
    ("gpipe", 4, 1, 8, "cls"),
    ("gpipe", 2, 2, 8, "cls"),
    ("gpipe", 2, 1, 16, "cls"),
    ("1f1b", 2, 1, 8, "cls"),
    ("1f1b", 4, 1, 16, "cls"),
    ("1f1b", 2, 2, 8, "cls"),
    ("gpipe", 2, 1, 8, "lm"),
    ("1f1b", 4, 1, 8, "lm"),
]


def _jax_schedule(jest, schedule, x, y, mask):
    """(loss, metrics, grads) of the JAX schedule under shard_map."""
    params = jest.params
    stage_spec = jax.tree_util.tree_map(lambda _: P("pp"), params[1])
    in_specs = (P(), stage_spec, P(), BATCH, BATCH, BATCH)
    args = (jest._embed.apply, jest._stage.apply, jest._head.apply,
            jest._loss_fn)
    if schedule == "1f1b":
        fn = jax.shard_map(
            one_f_one_b_grads(*args, n_stages=jest.pp, n_micro=jest.n_micro),
            mesh=jest.mesh, in_specs=in_specs,
            out_specs=(P(), P(), (P(), stage_spec, P())))
        loss, metrics, grads = jax.jit(fn)(*params, x, y, mask)
    else:
        fn = jax.shard_map(
            gpipe_loss(*args, n_stages=jest.pp, n_micro=jest.n_micro),
            mesh=jest.mesh, in_specs=in_specs, out_specs=(P(), P()))
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda ps: fn(*ps, x, y, mask), has_aux=True))(params)
    return float(loss), jax.device_get(metrics), jax.device_get(grads)


def _port_ranks(params, schedule, pp, dp, n_micro, head, x, y, mask,
                step=False):
    """Each rank's schedule in a thread: (parts, global metrics, stats)
    per rank; with ``step``, the rank's whole optimizer step
    (``_rank_step``) instead, returning the estimator."""
    hub = Hub(dp * pp, pp)
    links = hub.links()
    names = pl.metric_names(head)

    def rank(r):
        est = _port(pp, dp, params=params, head=head, schedule=schedule,
                    n_microbatches=n_micro)
        est._rank = pl._RankRuntime(links[r], "/nonexistent", "cpu")
        est._ensure_parts()
        if step:
            est._rank_step(x, y.astype(np.int64), mask)
            return est
        link = links[r]
        rows = slice(link.dp_index * len(x) // dp,
                     (link.dp_index + 1) * len(x) // dp)
        stats = pl.StepStats("cpu")
        sums = pl.SCHEDULE_STEPS[schedule](
            est._parts, link, torch.from_numpy(x[rows]),
            torch.from_numpy(y[rows].astype(np.int64)),
            torch.from_numpy(mask[rows]), n_micro=n_micro,
            loss_fn=est._loss_fn, dtype=None, gw=float(mask.sum()),
            names=names, stats=stats)
        metrics = pl.finish_step(est._parts, link, sums)
        return est._parts, dict(zip(names, metrics)), stats

    return run_ranks(hub, rank)


@pytest.mark.parametrize("schedule,pp,dp,n_micro,head", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_schedule_matches_jax(schedule, pp, dp, n_micro, head):
    x, y, mask = _batch(2 * n_micro * dp, head, seed=pp + n_micro)
    jest = _jax_est(pp, dp, head=head, schedule=schedule,
                    n_microbatches=n_micro)
    jest._init_params(jnp.asarray(x[:1]))
    params = jax.device_get(jest.params)
    jloss, jmetrics, (jeg, jsg, jhg) = _jax_schedule(jest, schedule, x, y,
                                                     mask)
    ranks = _port_ranks(params, schedule, pp, dp, n_micro, head, x, y, mask)
    for r, (parts, metrics, _) in enumerate(ranks):
        s = r % pp
        np.testing.assert_allclose(float(metrics["loss"]), jloss,
                                   **LOSS_TOL)
        for k, v in jmetrics.items():
            np.testing.assert_allclose(float(metrics[k]), float(v),
                                       **LOSS_TOL)
        _close(_grad_tree(parts.embed), jeg, GRAD_TOL, f"rank {r} embed")
        _close(_grad_tree(parts.stage(s)), convert.slice_tree(jsg, s),
               GRAD_TOL, f"rank {r} stage {s}")
        _close(_grad_tree(parts.head), jhg, GRAD_TOL, f"rank {r} head")


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_in_flight_microbatches_are_bounded(schedule):
    """1F1B keeps at most 2*(pp-1-s)+1 microbatches in flight on stage s
    (the JAX memory contract); GPipe holds all n_micro."""
    pp, n_micro = 4, 8
    x, y, mask = _batch(2 * n_micro)
    est = _port(pp)
    est._ensure_parts()
    params = est.state_dict()["params"]
    ranks = _port_ranks(params, schedule, pp, 1, n_micro, "cls", x, y, mask)
    held = [stats.in_flight for _, _, stats in ranks]
    if schedule == "1f1b":
        assert held == [2 * (pp - 1 - s) + 1 for s in range(pp)]
    else:
        assert held == [n_micro] * pp


def test_replicated_leaves_are_bit_equal_after_a_step():
    """dp 2 x pp 2: after one optimizer step every rank holds the same
    embedding and head bits, and the two dp replicas of a stage the same
    stage bits."""
    x, y, mask = _batch(32)
    est = _port(2, 2)
    est._ensure_parts()
    params = est.state_dict()["params"]
    ranks = _port_ranks(params, "1f1b", 2, 2, 8, "cls", x, y, mask,
                        step=True)
    ref = dict(ranks[0]._parts.named_parameters())
    for est in ranks[1:]:
        for name, p in est._parts.named_parameters():
            if name.startswith("stages."):
                continue
            assert torch.equal(p, ref[name]), name
    for a, b in ((0, 2), (1, 3)):
        for (name, p), (_, q) in zip(ranks[a]._parts.named_parameters(),
                                     ranks[b]._parts.named_parameters()):
            assert torch.equal(p, q), (a, b, name)
    # The step moved them.
    assert not torch.equal(ref["embed.Embed_0.weight"], torch.from_numpy(
        params[0]["params"]["Embed_0"]["embedding"]))


# -- construction errors ------------------------------------------------------


@pytest.mark.parametrize("kwargs,match", [
    (dict(num_layers=3, pp=2), "divisible"),
    (dict(pp=2, schedule="zigzag"), "schedule"),
    (dict(pp=3), "does not divide"),
], ids=["layers", "schedule", "pp"])
def test_construction_errors_match_jax(kwargs, match):
    with pytest.raises(ValueError, match=match) as jerr:
        JaxPipe(**{**MODEL, **kwargs})
    with pytest.raises(ValueError, match=match) as perr:
        pl.PipelinedTransformer(devices=["cpu"] * 8, device="cpu",
                                **{**MODEL, **kwargs})
    assert str(perr.value) == str(jerr.value)


def test_build_mesh_accepts_pp_and_distributed_trainer_refuses_it():
    mesh = build_mesh(MeshSpec(pp=2), ["cpu"] * 4)
    assert mesh.shape["pp"] == 2 and mesh.shape["dp"] == 2
    est = MLPClassifier(hidden_layer_sizes=[4], num_classes=2, device="cpu")
    with pytest.raises(ValueError, match="does not use the pp axis"):
        DistributedTrainer(est, spec=MeshSpec(pp=2), devices=["cpu"] * 2)


# -- fits through rank processes ----------------------------------------------


@pytest.mark.parametrize("schedule,pp,dp,n", [
    ("gpipe", 2, 1, 32), ("1f1b", 2, 2, 40)], ids=["gpipe-pp2",
                                                   "1f1b-dp2-pp2"])
def test_process_fit_matches_jax_fit(schedule, pp, dp, n):
    x, y, _ = _batch(n)
    # A small rate: under adam the key bias (an exactly zero gradient) is
    # stepped by rounding noise on both sides (test_torch_train.py).
    jest = _jax_est(pp, dp, schedule=schedule, learning_rate=2e-5)
    jest._init_params(jnp.asarray(x[:1]))
    init = jax.device_get(jest.params)
    jest.fit(x, y, epochs=2, batch_size=16, shuffle=False)

    pest = _port(pp, dp, params=init, schedule=schedule,
                 learning_rate=2e-5)
    pest.fit(x, y, epochs=2, batch_size=16, shuffle=False)
    for key in jest.history:
        np.testing.assert_allclose(pest.history[key], jest.history[key],
                                   **FIT_TOL)
    state = pest.state_dict()
    _close(state["params"], jax.device_get(jest.params), FIT_TOL,
           "final params")
    adam = jax.device_get(jest.opt_state)[0]
    assert int(state["opt_state"]["count"]) == int(adam.count)
    for field in ("mu", "nu"):
        got = jax.tree_util.tree_leaves_with_path(state["opt_state"][field])
        want = jax.tree_util.tree_leaves_with_path(getattr(adam, field))
        assert [k for k, _ in got] == [k for k, _ in want], field
        for (path, g), (_, w) in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(
                np.asarray(g), w, rtol=0,
                atol=MOMENT_TOL * float(np.abs(w).max()),
                err_msg=f"{field} {jax.tree_util.keystr(path)}")
    stats = pest.rank_stats
    assert [s["stage"] for s in stats] == [r % pp for r in range(pp * dp)]
    assert all(s["backend"] == "gloo" for s in stats)
    np.testing.assert_allclose(pest.evaluate(x, y)["loss"],
                               jest.evaluate(x, y)["loss"], **FIT_TOL)
    np.testing.assert_array_equal(pest.predict(x), np.asarray(
        jest.predict(x)))
