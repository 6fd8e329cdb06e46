"""The rank program of ``tests/test_torch_expert_parallel.py``.

    python tests/torch_ep_worker.py <dir> <rank> <world>

Joins a gloo world of ``world`` CPU ranks through the ``FileStore`` in
``<dir>``, lays the port's dp x ep layout over it with ``DataParallel``
(``ep = 2``: dp 2 x ep 2 for a world of 4), then runs the cases of
``<dir>/cases.pkl`` on its rows:

- ``layer``: an ``MoEMlp`` carrying the JAX layer's weights, bound to the
  rank's expert group, forward on its dp index's rows and the backward of
  ``sum(out * cotangent)``;
- ``aux``: the same layer unbound, its auxiliary loss alone through an
  ``AuxLosses`` naming the rank's replicas, the router's gradient summed
  over the replicas;
- ``step``: one f32 SGD train step of an ``MoETransformerClassifier``
  split over the expert group (``bind_experts`` and its slice of the
  carried state), the gradients synced as a fit syncs them.

Writes ``<dir>/rank<r>.pkl``; a rank that raises writes its traceback
there instead."""

import os
import pickle
import sys
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from learningorchestra_tpu_torch import convert
from learningorchestra_tpu_torch.models.moe import MoETransformerClassifier
from learningorchestra_tpu_torch.ops import moe
from learningorchestra_tpu_torch.parallel.distributed import (
    DataParallel,
    init_process_group,
)


def layer_of(case) -> moe.MoEMlp:
    kw = case["kw"]
    layer = moe.MoEMlp(kw["num_experts"], kw["hidden_dim"], kw["mlp_dim"],
                       top_k=kw["top_k"],
                       capacity_factor=kw["capacity_factor"])
    layer.load_state_dict(convert.params_from_jax(case["variables"]))
    return layer


def run_layer(case, dp) -> dict:
    layer = layer_of(case)
    split = layer.bind_experts(dp.ep_comm)
    rows = dp.rows(case["x"].shape[0])
    x = torch.from_numpy(case["x"][rows]).requires_grad_()
    out = layer(x)
    (out * torch.from_numpy(case["cotangent"][rows])).sum().backward()
    return {"rows": (rows.start, rows.stop), "split": split,
            "offset": layer.expert_offset,
            "local_experts": layer.expert_w1.shape[0],
            "out": out.detach().numpy(), "dx": x.grad.numpy(),
            "router": layer.router.weight.grad.T.numpy(),
            "experts": {k: getattr(layer, k).grad.numpy()
                        for k in moe.EXPERT_LEAVES}}


def run_aux(case, dp) -> dict:
    layer = layer_of(case)
    rows = dp.rows(case["x"].shape[0])
    aux = moe.AuxLosses(dp.replicas)
    layer(torch.from_numpy(case["x"][rows]), aux)
    aux[0].backward()
    local: list = []
    layer(torch.from_numpy(case["x"][rows]), local)
    return {"aux": float(aux[0]), "local_aux": float(local[0]),
            "router": dp.replicas.all_reduce(
                layer.router.weight.grad).T.numpy()}


def run_step(case, dp) -> dict:
    est = MoETransformerClassifier(**case["kw"], device="cpu")
    est.compute_dtype = "float32"
    est.compile(optimizer="sgd", learning_rate=0.5)
    split = est.bind_experts(dp.ep_comm)
    est.load_state_dict(dp.local_experts({"params": case["params"]},
                                         est.module))
    est._dp = dp
    est._reset_optimizer()
    x, y = case["x"], case["y"]
    rows = dp.rows(len(x))
    mask = torch.ones(len(x))
    est._train_step(torch.from_numpy(x[rows]), torch.from_numpy(y[rows]),
                    mask[rows], est._loss_and_metrics("softmax_ce"), None,
                    mask.sum())
    return {"split": split,
            "params": {n: p.detach().numpy().copy()
                       for n, p in est.module.named_parameters()}}


def main(stage: Path, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    init_process_group(stage, rank, world, "gloo")
    dp = DataParallel(rank, world, "cpu", "gloo", stage / "cancel", ep=2)
    with open(stage / "cases.pkl", "rb") as fh:
        cases = pickle.load(fh)
    me = torch.tensor([float(rank)])
    out = {"layout": {
        "rank": rank, "dp_index": dp.dp_index, "ep_index": dp.ep_index,
        "sp_index": dp.sp_index, "dp_size": dp.dp_size,
        "ep": (dp.ep_comm.index, dp.ep_comm.size),
        "replicas": (dp.replicas.index, dp.replicas.size),
        "ep_group": dp.ep_comm.all_gather(me).tolist(),
        "dp_group": dp.replicas.all_gather(me).tolist()}}
    out["layer"] = run_layer(cases["layer"], dp)
    out["aux"] = run_aux(cases["layer"], dp)
    out["step"] = run_step(cases["step"], dp)
    dist.barrier()
    with open(stage / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)


if __name__ == "__main__":
    stage, rank = Path(sys.argv[1]), int(sys.argv[2])
    try:
        main(stage, rank, int(sys.argv[3]))
    except BaseException:  # noqa: BLE001 — the test reads the traceback
        with open(stage / f"rank{rank}.pkl", "wb") as fh:
            pickle.dump({"error": traceback.format_exc()}, fh)
    sys.stdout.flush()
    os._exit(0)
