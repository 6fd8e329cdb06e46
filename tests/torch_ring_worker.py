"""The rank program of ``tests/test_torch_ring.py``.

    python tests/torch_ring_worker.py <dir> <rank> <world>

Joins a gloo world of ``world`` CPU ranks through the ``FileStore`` in
``<dir>``, lays the port's two sequence-parallel layouts over it with
``DataParallel`` (``sp2``: dp 2 x sp 2, two rings; ``sp4``: one ring of
4), runs every case of ``<dir>/cases.pkl`` on its rows and tokens
(forward, then the backward of ``sum(out * cotangent)``), counts the
calls of the kernel wrappers per case, then drills a hung rotation (rank
0 rotates on a ring whose peer never answers, with a 1 s timeout) and
writes ``<dir>/rank<r>.pkl``.  A rank that raises writes its traceback
there instead."""

import os
import pickle
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from learningorchestra_tpu_torch.ops import attention
from learningorchestra_tpu_torch.parallel import ring_attention as ra
from learningorchestra_tpu_torch.parallel.distributed import (
    DataParallel,
    init_process_group,
)
from learningorchestra_tpu_torch.parallel.sharding import sequence_slice

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def counting(calls):
    """Wrap the kernel wrappers the ring calls so each call counts."""
    fwd, bwd = attention.flash_attention_fwd, attention.flash_attention_bwd

    def fwd_counted(*args, **kwargs):
        calls["fwd"] += 1
        return fwd(*args, **kwargs)

    def bwd_counted(*args, **kwargs):
        calls["bwd"] += 1
        return bwd(*args, **kwargs)

    attention.flash_attention_fwd = fwd_counted
    attention.flash_attention_bwd = bwd_counted


def run_case(case, dp) -> dict:
    b, t = case["q"].shape[:2]
    rows, toks = dp.rows(b), sequence_slice(t, dp.sp_index, dp.sp)
    dtype = DTYPES[case["dtype"]]

    def local(name, grad=True):
        x = torch.from_numpy(case[name][rows, toks]).to(dtype)
        return x.requires_grad_() if grad else x

    q, k, v = local("q"), local("k"), local("v")
    km = torch.from_numpy(case["kmask"][rows, toks])
    fn = ra.ring_flash_attention if case["fn"] == "flash" \
        else ra.ring_attention
    out = fn(q, k, v, ring=dp.ring, kmask=km, causal=case["causal"])
    g = torch.from_numpy(case["cotangent"][rows, toks])
    (out.float() * g).sum().backward()
    return {"rows": (rows.start, rows.stop), "toks": (toks.start, toks.stop),
            "out": out.detach().float().numpy(),
            "dq": q.grad.float().numpy(), "dk": k.grad.float().numpy(),
            "dv": v.grad.float().numpy(), "dtype": str(out.dtype),
            "sp_index": dp.sp_index, "dp_index": dp.dp_index}


def hung_rotation(rank: int) -> dict:
    """Rank 0 rotates on a ring of ranks 0 and 1 that rank 1 never
    serves: the wait must raise after the ring's timeout."""
    group = dist.new_group([0, 1])
    if rank > 1:
        return {}
    if rank == 1:
        time.sleep(4.0)  # stays up past rank 0's timeout, then leaves
        return {}
    ring = ra.Ring(group, 0, 2, "cpu", "gloo", timeout_s=1.0)
    t0 = time.perf_counter()
    try:
        ring.rotate([torch.ones(4)])
        error = None
    except RuntimeError as exc:
        error = str(exc)
    return {"error": error, "seconds": time.perf_counter() - t0}


def main(stage: Path, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    init_process_group(stage, rank, world, "gloo")
    layouts = {"sp2": DataParallel(rank, world, "cpu", "gloo",
                                   stage / "cancel", sp=2),
               "sp4": DataParallel(rank, world, "cpu", "gloo",
                                   stage / "cancel", sp=4)}
    with open(stage / "cases.pkl", "rb") as fh:
        cases = pickle.load(fh)
    calls = {"fwd": 0, "bwd": 0}
    counting(calls)
    out = {"layouts": {name: {"rank": dp.rank, "dp_index": dp.dp_index,
                              "sp_index": dp.sp_index, "ring": dp.ring.index,
                              "ring_size": dp.ring.size}
                       for name, dp in layouts.items()}, "cases": {}}
    for key, case in cases.items():
        for name in case["layouts"]:
            calls.update(fwd=0, bwd=0)
            res = run_case(case, layouts[name])
            res["calls"] = dict(calls)
            out["cases"][(key, name)] = res
    dist.barrier()
    out["hung"] = hung_rotation(rank)
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
    # No teardown: the hung drill leaves a receive posted on rank 0.
    os._exit(0)
