"""The rank program of a data-parallel fit (parallel/distributed.py) and
of a pipelined one (parallel/pipeline.py, task mode ``pipeline``).

    python -m learningorchestra_tpu_torch.parallel.rank <staging dir> <rank>

The JAX package has no counterpart: there one process drives every
device of the mesh.  Here each rank joins the fit's process group through
the ``FileStore`` in its staging directory, rebuilds the estimator from
the staged artifact on its device, memory-maps the staged inputs (or
reopens the sharded dataset), runs ``fit`` or ``evaluate`` with its
:class:`DataParallel` as ``est._dp`` (on a sequence-parallel mesh a
model with ``bind_mesh`` bound to its ring for the call; on an
expert-parallel mesh a model with ``bind_experts`` split over its expert
group from its load on, holding only its experts) and leaves the
process group.  Every
rank writes its launch counters and timings; rank 0 also writes the
final state (the artifact layout), the history and the stop flag.  A
rank that raises prints the traceback and exits 1 at once (without
tearing the group down): the parent stops the others and fails the fit.
A rank dies with its parent: the kernel SIGKILLs it when the thread that
started it exits (``PR_SET_PDEATHSIG``; that thread waits on the ranks
until they end), so a fit whose server was killed cannot go on writing
the checkpoints that the server's recovery resumes from.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import pickle
import signal
import sys
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from learningorchestra_tpu_torch import convert
from learningorchestra_tpu_torch.parallel.distributed import (
    CANCEL,
    RESULT,
    TASK,
    DataParallel,
    init_process_group,
)
from learningorchestra_tpu_torch.toolkit import registry
from learningorchestra_tpu_torch.train import compile_cache
from learningorchestra_tpu_torch.train.neural import (
    TrainHistory,
    resolve_optimizer,
)

PR_SET_PDEATHSIG = 1  # <linux/prctl.h>


def load_estimator(spec: dict, device, dp: DataParallel | None = None):
    """The staged artifact rebuilt on ``device`` with the parent's loss and
    optimizer (set before the state, whose moments follow its layout).
    On an expert-parallel rank (``dp.ep_comm``) a model with
    ``bind_experts`` is split over the rank's expert group first and
    loads only its slice of the staged parameters and moments."""
    doc = spec["artifact"]
    cls = registry.resolve(doc["modulePath"], doc["class"])
    est = cls(**doc["classParameters"], device=device)
    est.compute_dtype = doc.get("compute_dtype", est.compute_dtype)
    est.loss = spec["loss"]
    est.learning_rate = spec["learning_rate"]
    est._optimizer_spec = spec["optimizer_spec"]
    est.optimizer = pickle.loads(spec["optimizer"]) \
        if spec["optimizer"] is not None \
        else resolve_optimizer(spec["optimizer_spec"], spec["learning_rate"])
    state = doc["state"]
    if dp is not None and dp.ep_comm is not None and \
            hasattr(est, "bind_experts"):
        est.bind_experts(dp.ep_comm)
        state = dp.local_experts(state, est.module)
    est.load_state_dict(state)
    est.history = TrainHistory()
    return est


def load_data(data: dict) -> dict:
    """Staged ``.npy`` files memory-mapped; sharded views reopened."""
    from learningorchestra_tpu_torch.store.sharded import ShardedDataset

    out = {}
    for key, src in data.items():
        out[key] = ShardedDataset(src["root"]).view(src["cols"]) \
            if isinstance(src, dict) else np.load(src, mmap_mode="r")
    return out


def launch_counts(device) -> dict:
    """This process's kernel launch counters."""
    from learningorchestra_tpu_torch.ops import attention, quant

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"flash_fwd": attention.launches,
            "flash_bwd_dq": attention.bwd_dq_launches,
            "flash_bwd_dkv": attention.bwd_dkv_launches,
            "quantize_rowwise": quant.quantize_launches,
            "dequantize_rowwise": quant.dequantize_launches}


def run_fit(est, dp: DataParallel, data: dict, kwargs: dict,
            trace_dir) -> dict:
    ran: list[int] = []
    validation = (data["vx"], data["vy"]) if "vx" in data else None
    profile = contextlib.nullcontext()
    if trace_dir and dp.rank == 0:
        from learningorchestra_tpu_torch.services.monitoring import profiled

        profile = profiled(trace_dir)
    callbacks = list(kwargs.pop("callbacks")) + [
        lambda epoch, metrics, model: ran.append(epoch)]
    with profile:
        est.fit(data["x"], data["y"], validation_data=validation,
                callbacks=callbacks, **kwargs)
    # A fit that stopped part way through an accumulation hands back the
    # ranks' summed gradients, as its checkpoints do; an expert-parallel
    # rank's slices are joined into the single-device layout (every rank
    # takes part).
    grads = dp.pending_grads(est.module) if est._mini_step else None
    history = {k: list(v) for k, v in est.history.items()}
    n_epochs = len(history.get("loss", ()))
    opt = est._export_opt_state(host=False, grads=grads) \
        if est.opt_state is not None else None
    return {
        "state": {
            "params": convert.to_host(dp.join_experts(
                convert.flax_tree(est.module), est.module)),
            "opt_state": convert.to_host(dp.join_experts(opt, est.module)),
            "accumulate_steps": est._accumulate_steps,
            "sharded_fit_cols": est._sharded_fit_cols,
        },
        "history": history,
        "start_epoch": n_epochs - len(ran),
        "stop_training": bool(est.stop_training),
    }


@contextlib.contextmanager
def ring_bound(est, dp: DataParallel, shard_sequence: bool):
    """A model with ``bind_mesh`` runs over the rank's ring, on its share
    of each row's tokens, for the length of the call only (the JAX
    trainer's ``_mesh_bound``)."""
    bound = shard_sequence and dp.ring is not None and \
        hasattr(est, "bind_mesh")
    if not bound:
        yield
        return
    est.bind_mesh(dp.ring)
    dp.shard_tokens = True
    try:
        yield
    finally:
        dp.shard_tokens = False
        est.bind_mesh(None)


def run_data_parallel(task: dict, stage: Path, rank: int, world: int,
                      device) -> tuple[dict, dict]:
    """This rank's part of a data-parallel ``fit`` or ``evaluate``: its
    result (rank 0's is handed back) and its stats."""
    dp = DataParallel(rank, world, device, task["backend"],
                      stage / CANCEL, mesh_key=task.get("mesh_key"),
                      sp=task.get("sp", 1), ep=task.get("ep", 1))
    est = load_estimator(task["estimator"], device, dp)
    est._dp = dp
    data = load_data(task["data"])
    kwargs = dict(task["kwargs"])
    with ring_bound(est, dp, task.get("shard_sequence", False)):
        if task["mode"] == "fit":
            out = run_fit(est, dp, data, kwargs, task["trace_dir"])
        else:
            out = {"metrics": est.evaluate(data["x"], data["y"], **kwargs)}
    return out, {**dp.stats(),
                 # What the rank holds: E/ep of each split MoE layer.
                 "param_bytes": sum(p.numel() * p.element_size()
                                    for p in est.module.parameters())}


def die_with_parent(parent: int) -> None:
    """SIGKILL this process when its parent goes; exit now if it has gone
    already (before the request was made)."""
    if sys.platform.startswith("linux"):
        libc = ctypes.CDLL(None, use_errno=True)
        if libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0) != 0:
            raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG)")
    if os.getppid() != parent:
        os._exit(1)


def main(argv: list[str]) -> int:
    stage, rank = Path(argv[0]), int(argv[1])
    with open(stage / TASK, "rb") as fh:
        task = pickle.load(fh)
    die_with_parent(task["parent"])
    world = len(task["devices"])
    device = torch.device(task["devices"][rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(task["threads"])
    init_process_group(stage, rank, world, task["backend"])
    try:
        cache_before = compile_cache.counters_snapshot()
        if task["mode"] == "pipeline":
            from learningorchestra_tpu_torch.parallel import pipeline

            out, stats = pipeline.run_rank(task, stage, rank, world, device)
        else:
            out, stats = run_data_parallel(task, stage, rank, world, device)
        stats["launches"] = launch_counts(device)
        if device.type == "cuda":
            stats["peak_memory_bytes"] = torch.cuda.max_memory_allocated(
                device)
        gathered = [None] * world
        dist.all_gather_object(gathered, stats)
        if rank == 0:
            out["rank_stats"] = gathered
            out["compile_cache"] = compile_cache.delta_since(cache_before)
            tmp = stage / f".{RESULT}.tmp"
            with open(tmp, "wb") as fh:
                pickle.dump(out, fh, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, stage / RESULT)
    except Exception:
        # Leave at once: tearing the group down would wait on the ranks
        # still blocked in a collective with this one.
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
