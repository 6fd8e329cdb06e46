"""DistributedTrainer — data-parallel training, one process per rank —
port of ``learningorchestra_tpu/parallel/distributed.py``.

The JAX package runs one jitted step over a named mesh: the batch enters
sharded over the data axes and XLA's SPMD partitioner inserts the psum
of the gradients.  Here each rank is a process of its own
(``python -m learningorchestra_tpu_torch.parallel.rank``) holding a full
replica of the estimator on its device, and ``torch.distributed``
all-reduces the gradients:

- the parent stages the estimator (its artifact), the inputs (``.npy``
  files the ranks memory-map, or a sharded dataset's path and columns)
  and the fit's arguments in a directory of this fit's own, builds the
  CUDA kernels once, starts the ranks, watches them and hands rank 0's
  final state and history back to the estimator;
- the ranks meet through a ``FileStore`` in that directory, so no port
  or path is shared between two fits;
- each rank runs ``NeuralEstimator.fit`` itself, with a
  :class:`DataParallel` as ``est._dp``: every rank walks the same global
  batches (the single-device order, so a world of one is the
  single-device fit) and steps on rows ``[r*B/W, (r+1)*B/W)`` of each;
  its loss divides by the GLOBAL batch's mask sum, so the ranks'
  gradients sum to the global batch's masked-mean gradient even when
  the padded tail's pad rows all land on the last ranks; one flat
  gradient buffer is all-reduced per optimizer update (once per
  ``accumulate_steps`` batches); each epoch's metrics are all-reduced
  once, so every rank sees the same numbers and early stopping decides
  alike; the ranks agree on each epoch's stop and save (a MAX
  all-reduce), and only rank 0 writes checkpoints;
- with an ``sp`` axis (parallel/mesh.py: rank ``r`` is dp index
  ``r // sp``, sp index ``r % sp``) the rows of a global batch go to
  the ranks by dp index, and the sp ranks of one dp index form a ring
  (parallel/ring_attention.py): a model with ``bind_mesh`` (the
  long-context transformer) gets the ring for the length of the call and
  each rank steps on tokens ``[s*T/sp, (s+1)*T/sp)`` of its rows.  Every
  sp rank of a replica then computes the same loss (the model's pool sums
  over the ring), so each rank's loss is divided by sp and the gradients
  are summed over all ranks: the token-local parameters' partials add up
  and the head's sp equal copies count once.  The epoch metrics are
  summed over the rank's dp group (one rank per replica).  A model without
  ``bind_mesh`` sees whole rows on every sp rank, the same arithmetic;
- with an ``ep`` axis (rank ``r = (dp_index * ep + ep_index) * sp +
  sp_index``) the ep ranks of one dp index see the same rows, and a model
  with ``bind_experts`` (the MoE models) holds E/ep of each MoE layer's
  experts on each (``rank.py`` loads only its slice; ops/moe.py gathers
  the expert outputs over the rank's ep group).  The gradients are summed
  over the ranks that hold the same copy of each leaf in ONE all-reduce
  over the world: an expert slice's in its ep index's section of the
  buffer (its dp group's ranks add into it), a replicated leaf's from ep
  index 0 only (the other ep ranks of a replica hold the same gradient
  and add zeros), so every rank of a replica ends the step with
  bit-equal replicated leaves.  Checkpoints and the handed-back state
  join the slices in the single-device layout; a data-parallel MoE
  model's auxiliary loss runs over the global batch (its sums over one
  rank per replica, :attr:`DataParallel.replicas`).

The backend follows the device list: NCCL when every rank has a card of
its own, gloo when ranks share a card or run on the CPU (gloo's CUDA
gradients are staged through a pinned host buffer).  A backend that fails
to start fails the fit; nothing falls back.

The gradient sync is this module's all-reduce, not
``DistributedDataParallel``: the step runs ``functional_call`` on bf16
copies of the f32 masters, which would bypass DDP's forward hook (and its
reducer), and the flat buffer makes "one reduction per optimizer update"
explicit under gradient accumulation.
"""

from __future__ import annotations

import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from learningorchestra_tpu_torch import convert
from learningorchestra_tpu_torch.jobs.cancel import cancel_requested
from learningorchestra_tpu_torch.ops.moe import split_expert_parameters
from learningorchestra_tpu_torch.parallel.mesh import Mesh, MeshSpec, build_mesh
from learningorchestra_tpu_torch.parallel.sharding import (
    batch_rows,
    check_seq_divisible,
    rank_coords,
    sequence_slice,
)
from learningorchestra_tpu_torch.toolkit.base import as_array
from learningorchestra_tpu_torch.train import compile_cache
from learningorchestra_tpu_torch.train.neural import (
    NeuralEstimator,
    TrainHistory,
    _is_sharded,
)

#: Files of a fit's staging directory.
TASK, RESULT, CANCEL = "task.pkl", "result.pkl", "cancel"
#: A staging directory is ``<root>/lo_dist_<owner pid>_<random>``.
STAGE_PREFIX = "lo_dist_"
#: Bound on each collective: a rank stuck this long raises and exits.
COLLECTIVE_TIMEOUT_S = 600.0
_REPO = str(Path(__file__).resolve().parents[2])


def backend_for(devices) -> str:
    """``nccl`` when every rank has a card of its own, ``gloo`` when ranks
    share a card or run on the CPU.  A CUDA device list without the cards
    it names raises; a list mixing CPU and CUDA ranks is refused."""
    devices = [torch.device(d) for d in devices]
    kinds = {d.type for d in devices}
    if len(kinds) > 1:
        raise ValueError(f"ranks mix CPU and CUDA devices: {devices}")
    if kinds != {"cuda"}:
        return "gloo"
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    index = [d.index or 0 for d in devices]
    if max(index) >= count:
        raise RuntimeError(
            f"ranks on {[str(d) for d in devices]} but "
            f"{count} CUDA device(s) are visible")
    return "nccl" if len(set(index)) == len(index) else "gloo"


class GroupComm:
    """A process group of this rank with its index in it and its size:
    sums and gathers of tensors over it (new tensors on the input's
    device), staged through host copies when a gloo group carries CUDA
    tensors.  Each timed collective's start and end marks go to
    ``marks`` (``DataParallel.stats`` reads them)."""

    def __init__(self, group, index: int, size: int, device, backend: str,
                 mark=None):
        self.group, self.index, self.size = group, index, size
        self.host_staged = backend != "nccl" and \
            torch.device(device).type == "cuda"
        self._mark = mark
        self.marks: list = []

    def _timed(self, fn, t: torch.Tensor, timed: bool) -> torch.Tensor:
        start = self._mark() if timed and self._mark else None
        out = fn(t.detach().cpu() if self.host_staged else t.detach())
        out = out.to(t.device)
        if start is not None:
            self.marks.append((start, self._mark()))
        return out

    def all_reduce(self, t: torch.Tensor, timed: bool = True
                   ) -> torch.Tensor:
        """The sum of ``t`` over the group."""

        def reduce(x):
            x = x.clone()
            dist.all_reduce(x, group=self.group)
            return x

        return self._timed(reduce, t, timed)

    def all_gather(self, t: torch.Tensor, timed: bool = True
                   ) -> torch.Tensor:
        """The group's tensors of ``t``'s shape, concatenated along the
        first axis in group order."""

        def gather(x):
            parts = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(parts, x.contiguous(), group=self.group)
            return torch.cat(parts)

        return self._timed(gather, t, timed)


class DataParallel:
    """One rank's view of the process group: which rows of a global batch
    are its own (and, with ``shard_tokens``, which tokens of them), the
    sums over the ranks, the agreed stop flags, and per-step timings.
    With ``sp`` or ``ep`` > 1 every rank creates the same groups in the
    same order: one ring per (dp, ep) index (``ring``), one expert group
    per (dp, sp) index (``ep_comm``) and one dp group per (ep, sp) index
    (``dp_group``, one rank per replica; ``replicas`` sums over it when
    there are several)."""

    def __init__(self, rank: int, world: int, device, backend: str,
                 cancel_flag: Path, mesh_key=None, sp: int = 1,
                 ep: int = 1):
        self.rank, self.world = rank, world
        self.sp, self.ep, self.dp_size = sp, ep, world // (sp * ep)
        self.dp_index, _, self.ep_index, self.sp_index = rank_coords(
            rank, sp, ep)
        # Set by the rank program when the model runs over the ring.
        self.shard_tokens = False
        # The mesh's fingerprint (axis names, sizes, device list): part
        # of every program key of this rank (train/compile_cache.py).
        self.mesh_key = mesh_key
        self.device = torch.device(device)
        self.backend = backend
        # NCCL reduces device tensors; gloo's are staged on the host.
        self.comm = self.device if backend == "nccl" else torch.device("cpu")
        self.cancel_flag = cancel_flag
        self._cuda = self.device.type == "cuda"
        self._host: torch.Tensor | None = None
        self._steps: list = []
        self._syncs: list = []
        self._open = None
        self.first_step_wall: float | None = None
        self.ring = self.dp_group = self.ep_comm = self.replicas = None
        if sp > 1 or ep > 1:
            self._make_groups()
        if self.dp_size > 1:
            self.replicas = GroupComm(self.dp_group, self.dp_index,
                                      self.dp_size, self.device, backend)

    def _make_groups(self) -> None:
        from learningorchestra_tpu_torch.parallel.ring_attention import Ring

        sp, ep, timeout = self.sp, self.ep, timedelta(
            seconds=COLLECTIVE_TIMEOUT_S)
        here = (self.dp_index, self.ep_index, self.sp_index)

        def rank_of(d, e, s):
            return (d * ep + e) * sp + s

        if sp > 1:
            for d in range(self.dp_size):
                for e in range(ep):
                    group = dist.new_group(
                        [rank_of(d, e, s) for s in range(sp)],
                        timeout=timeout)
                    if (d, e) == here[:2]:
                        self.ring = Ring(group, self.sp_index, sp,
                                         self.device, self.backend,
                                         COLLECTIVE_TIMEOUT_S)
        if ep > 1:
            for d in range(self.dp_size):
                for s in range(sp):
                    group = dist.new_group(
                        [rank_of(d, e, s) for e in range(ep)],
                        timeout=timeout)
                    if (d, s) == (here[0], here[2]):
                        self.ep_comm = GroupComm(
                            group, self.ep_index, ep, self.device,
                            self.backend, mark=self._mark)
        for e in range(ep):
            for s in range(sp):
                group = dist.new_group(
                    [rank_of(d, e, s) for d in range(self.dp_size)],
                    timeout=timeout)
                if (e, s) == here[1:]:
                    self.dp_group = group

    def rows(self, batch_size: int) -> slice:
        return batch_rows(batch_size, self.dp_index, self.dp_size)

    def local_tokens(self, x, axis: int = 1):
        """This rank's tokens of a batch of token rows (axis ``axis`` the
        sequence) when it steps on a ring; anything else as it is."""
        if not self.shard_tokens or x.ndim <= axis or \
                x.dtype.is_floating_point:
            return x
        cut = sequence_slice(x.shape[axis], self.sp_index, self.sp)
        return x[(slice(None),) * axis + (cut,)]

    # -- collectives ----------------------------------------------------------

    def _reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM,
                 group=None) -> torch.Tensor:
        """All-reduce ``t`` in place over ``group`` (None: every rank),
        through a pinned host buffer when a gloo rank holds it on a
        card."""
        if t.device == self.comm:
            dist.all_reduce(t, op=op, group=group)
            return t
        if self._host is None or self._host.numel() < t.numel():
            self._host = torch.empty(t.numel(), dtype=torch.float32,
                                     pin_memory=self._cuda)
        host = self._host[:t.numel()].view(t.shape)
        host.copy_(t)
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
        return t

    def replica_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` (f32) over one rank per data-parallel replica
        (this rank's dp group): the sp ranks of a replica hold equal
        metrics, counted once."""
        return self._reduce_(t.float().clone(), group=self.dp_group)

    def agree(self, *flags) -> tuple:
        """Each flag true on every rank when it is true on any."""
        t = torch.tensor([float(bool(f)) for f in flags], device=self.comm)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return tuple(bool(v) for v in t.tolist())

    def cancel_requested(self) -> bool:
        """Rank 0 reads the cancel flag the parent relays; every rank
        gets its answer, so all of them stop at the same epoch."""
        return self.agree(self.rank == 0 and self.cancel_flag.exists())[0]

    def _sum_copies(self, module, params: list, grads: list) -> list:
        """Each gradient summed over the ranks that hold the same copy of
        its parameter, in one flat all-reduce over the world: an expert
        slice (ep > 1) in its ep index's section, a replicated leaf from
        ep index 0 alone (module docstring)."""
        split = {id(p) for p in split_expert_parameters(module)}
        chunks, spans, offset = [], [], 0
        for p, g in zip(params, grads):
            g, n = g.reshape(-1), g.numel()
            if id(p) in split:
                section = g.new_zeros(self.ep * n)
                section[self.ep_index * n:(self.ep_index + 1) * n] = g
                chunks.append(section)
                spans.append(offset + self.ep_index * n)
                offset += self.ep * n
            else:
                chunks.append(g if self.ep_index == 0 else
                              torch.zeros_like(g))
                spans.append(offset)
                offset += n
        flat = self._reduce_(torch.cat(chunks))
        return [flat[at:at + g.numel()].view_as(g)
                for at, g in zip(spans, grads)]

    def sync_grads(self, module) -> None:
        """Replace every accumulated ``.grad`` with its sum over the ranks
        holding its parameter: one flat buffer, one all-reduce."""
        params = [p for p in module.parameters() if p.grad is not None]
        t0 = self._mark()
        for p, g in zip(params, self._sum_copies(
                module, params, [p.grad for p in params])):
            p.grad.copy_(g)
        self._syncs.append((t0, self._mark()))

    def pending_grads(self, module) -> dict:
        """{parameter: its accumulated gradient summed over the ranks
        holding it}, leaving ``.grad`` as it is (a checkpoint of a fit
        stopped part way through an accumulation)."""
        params = list(module.parameters())
        return dict(zip(params, self._sum_copies(
            module, params, [torch.zeros_like(p) if p.grad is None
                             else p.grad for p in params])))

    # -- the expert slices of a state -----------------------------------------

    def local_experts(self, tree, module):
        """A single-device state tree (parameters, optimizer state) cut to
        this rank's experts of ``module``'s split layers."""
        if self.ep_comm is None or tree is None:
            return tree
        return convert.split_experts(tree, convert.expert_layers(module),
                                     self.ep_index, self.ep)

    def join_experts(self, tree, module):
        """This rank's state tree with every split expert leaf gathered
        over its ep group: the single-device layout (every rank takes
        part, leaf by leaf)."""
        if self.ep_comm is None or tree is None:
            return tree
        return convert.join_experts(
            tree, convert.expert_layers(module),
            lambda t: self.ep_comm.all_gather(torch.as_tensor(t),
                                              timed=False))

    # -- timing ---------------------------------------------------------------

    def _mark(self):
        if not self._cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def step_begin(self) -> None:
        if self.first_step_wall is None:
            self.first_step_wall = time.time()
        self._open = self._mark()

    def step_end(self) -> None:
        self._steps.append((self._open, self._mark()))

    def stats(self) -> dict:
        """Each step's milliseconds, each gradient sync's and each
        collective's of the expert exchange (CUDA events on a card, the
        host clock on the CPU)."""
        if self._cuda:
            torch.cuda.synchronize(self.device)

        def ms(a, b):
            return a.elapsed_time(b) if self._cuda else (b - a) * 1e3

        return {"rank": self.rank, "device": str(self.device),
                "backend": self.backend, "dp_index": self.dp_index,
                "ep_index": self.ep_index, "sp_index": self.sp_index,
                "step_ms": [ms(a, b) for a, b in self._steps],
                "sync_ms": [ms(a, b) for a, b in self._syncs],
                "ep_ms": [] if self.ep_comm is None else [
                    ms(a, b) for a, b in self.ep_comm.marks],
                "first_step_wall": self.first_step_wall}


def init_process_group(stage: Path, rank: int, world: int,
                       backend: str) -> None:
    """Join this fit's group through the ``FileStore`` in its staging
    directory."""
    store = dist.FileStore(str(stage / "rendezvous"), world)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))


def _default_devices() -> list[str]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "DistributedTrainer: no CUDA device is visible; pass devices= "
            "(e.g. ['cpu', 'cpu'] for ranks on the CPU)")
    return [f"cuda:{k}" for k in range(torch.cuda.device_count())]


class DistributedTrainer:
    """Data-parallel fit/evaluate over a ``NeuralEstimator``'s model.

    ``batch_size`` is the GLOBAL batch size, split across the ranks.
    ``devices`` lists one device per rank (default: every card); the
    mesh's ``dp`` times its ``ep`` times its ``sp`` is the world size.
    ``shard_sequence`` (default: on iff ``sp`` > 1) splits each token row
    over the sp ranks of its replica, for a model with ``bind_mesh``;
    off, every sp rank holds whole rows.  ``rank_stats`` holds, after a call,
    each rank's launch counters, step, gradient-sync and expert-exchange
    milliseconds, parameter bytes and seconds from its start to its first
    step.  A call ends when its ranks
    do: a hung collective raises in the ranks after
    ``COLLECTIVE_TIMEOUT_S``, and the engine's deadline or cancel reaches
    them through the relayed cancel flag.  Each call stages under
    ``stage_root`` (default: the system's temporary directory) in a
    directory named after this process, removed when the call returns;
    :func:`sweep_stages` removes those a killed process left."""

    def __init__(self, estimator: NeuralEstimator,
                 spec: MeshSpec | None = None, mesh: Mesh | None = None,
                 devices: list | None = None,
                 stage_root: str | os.PathLike | None = None,
                 shard_sequence: bool | None = None):
        self.estimator = estimator
        self.mesh = mesh if mesh is not None else build_mesh(
            spec, devices if devices is not None else _default_devices())
        if self.mesh.shape.get("pp", 1) > 1:
            # Nothing in this trainer shards over pp, so pp > 1 would
            # replicate every rank's work pp-fold with no speedup.
            raise ValueError(
                "DistributedTrainer does not use the pp axis; "
                "pipeline parallelism is parallel.pipeline."
                "PipelinedTransformer")
        sp = self.mesh.shape["sp"]
        self.shard_sequence = sp > 1 if shard_sequence is None \
            else bool(shard_sequence)
        self.backend = backend_for(self.mesh.devices)
        self.history = TrainHistory()
        self.stop_training = False
        self.rank_stats: list[dict] = []
        # Rank 0's program-cache counter delta over the last call (each
        # rank process starts with an empty cache).
        self.compile_cache: dict | None = None
        self._procs: list = []  # the last call's ranks (reaped on return)
        # Where each call stages (None: the system's temporary directory);
        # a server names a root of its own, which its boot sweeps.
        self.stage_root = stage_root

    @property
    def data_axes(self) -> int:
        return self.mesh.shape["dp"] * self.mesh.shape["fsdp"]

    def _check_seq_divisible(self, x) -> None:
        """Raise the JAX trainer's error before any rank starts when the
        sp axis cannot split the token rows."""
        if self.shard_sequence:
            check_seq_divisible(
                as_array(x.head(1)) if _is_sharded(x) else as_array(x),
                self.mesh.shape["sp"])

    # -- public surface -------------------------------------------------------

    def fit(
        self,
        x,
        y,
        epochs: int = 1,
        batch_size: int = 64,
        validation_data: tuple | None = None,
        shuffle: bool = True,
        verbose: int = 0,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 1,
        checkpoint_min_interval_s: float = 60.0,
        resume: bool = True,
        accumulate_steps: int = 1,
        checkpoint_async: bool = True,
        callbacks: list | None = None,
        early_stopping=None,
        quantize_checkpoint: bool = False,
        trace_dir: str | None = None,
        **_,
    ) -> "DistributedTrainer":
        """The single-device ``fit`` contract over the ranks: managed
        checkpoints (rank 0 writes them; every rank resumes from the same
        ``latest.json``), ``accumulate_steps``, ``early_stopping`` with
        ``restoreBestWeights`` (the moments are dropped, ``opt_state``
        None), a relayed engine cancel, and ``quantize_checkpoint`` for
        the estimator's published artifact.  Sharded ``x``/``y`` stream
        shard by shard in every rank.

        ``callbacks`` cross a process boundary: each must pickle, and runs
        in every rank as ``cb(epoch, metrics, estimator)`` with the
        metrics all-reduced first (an ``EarlyStopping`` object or the
        ``early_stopping`` spec works as on one device; a closure over
        the caller's state does not).  ``trace_dir``: rank 0 records a
        ``torch.profiler`` trace of its fit there.  The epochs run are
        appended to ``estimator.history``."""
        if batch_size % self.data_axes:
            raise ValueError(
                f"global batch_size {batch_size} not divisible by "
                f"dp*fsdp={self.data_axes}")
        self._check_seq_divisible(x)
        if validation_data is not None:
            self._check_seq_divisible(validation_data[0])
        est = self.estimator
        est._set_accumulation(accumulate_steps)
        est._quantize_persist = bool(quantize_checkpoint)
        fit_kw = dict(
            epochs=epochs, batch_size=batch_size, shuffle=shuffle,
            verbose=verbose, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            checkpoint_min_interval_s=checkpoint_min_interval_s,
            resume=resume, accumulate_steps=accumulate_steps,
            checkpoint_async=checkpoint_async,
            callbacks=list(callbacks or []), early_stopping=early_stopping)
        result = self._run("fit", x, y, validation_data, fit_kw, trace_dir)
        # Hand-back: rank 0's final state in the artifact layout; the
        # estimator keeps its own history and gains the epochs run.
        before = est.history
        est.load_state_dict(result["state"])
        est.history = before
        history, start = result["history"], result["start_epoch"]
        n_epochs = len(history.get("loss", ()))
        rows = [{k: v[i] for k, v in history.items() if len(v) > i}
                for i in range(n_epochs)]
        if start:
            self.history = TrainHistory(history)
        else:
            for row in rows:
                self.history.append(row)
        for row in rows[start:]:
            est.history.append(row)
        self.stop_training = result["stop_training"]
        return self

    def evaluate(self, x, y, batch_size: int = 128, **_) -> dict:
        """Metrics over the ranks; the batch rounds up to a multiple of
        the dp size (a throughput knob, not a semantic one)."""
        self._check_seq_divisible(x)
        return self._run("evaluate", x, y, None,
                         {"batch_size": batch_size}, None)["metrics"]

    # -- the ranks ------------------------------------------------------------

    @staticmethod
    def _stage_data(stage: Path, x, y, validation_data) -> dict:
        """Arrays as ``.npy`` files the ranks memory-map; a sharded view
        as its dataset's path and columns."""
        if _is_sharded(x):

            def view(v):
                return {"root": str(v.dataset.root),
                        "cols": v.cols[0] if v.single else list(v.cols)}

            data = {"x": view(x), "y": view(y)}
        else:
            data = {}
            for key, arr in (("x", x), ("y", y)):
                np.save(stage / f"{key}.npy", as_array(arr))
                data[key] = str(stage / f"{key}.npy")
        if validation_data is not None:
            for key, arr in zip(("vx", "vy"), validation_data):
                np.save(stage / f"{key}.npy", as_array(arr))
                data[key] = str(stage / f"{key}.npy")
        return data

    def _stage_estimator(self, x) -> dict:
        est = self.estimator
        if not est._built():
            # A module sized by its first input is built (and seeded) here,
            # so every rank starts from the same parameters.
            est._init_params(as_array(x.head(1)) if _is_sharded(x)
                             else as_array(x)[:1])
        spec = est._optimizer_spec
        try:
            optimizer = pickle.dumps(est.optimizer) if spec is None else None
        except (pickle.PicklingError, AttributeError, TypeError) as exc:
            raise ValueError(
                "the estimator's optimizer does not pickle (a schedule "
                "closure?); compile it from a name or dict spec for a "
                "distributed fit") from exc
        return {"artifact": est.to_artifact(quantize=False),
                "loss": est.loss, "learning_rate": est.learning_rate,
                "optimizer_spec": spec, "optimizer": optimizer}

    def _run(self, mode: str, x, y, validation_data, kwargs: dict,
             trace_dir) -> dict:
        """Stage, start the ranks, watch them, return rank 0's result;
        the staging directory and every rank are gone when it returns
        or raises."""
        if _is_sharded(x) or _is_sharded(y):
            from learningorchestra_tpu_torch.store import sharded as sh

            if _is_sharded(validation_data):
                raise ValueError(
                    "validation_data must be in-memory arrays, not sharded "
                    "views")
            x, y = sh.resolve_xy_views(x, y)
        devices = [str(d) for d in self.mesh.devices]
        world = len(devices)
        stage = _make_stage(self.stage_root)
        procs = self._procs = []
        try:
            task = {
                "mode": mode, "devices": devices, "backend": self.backend,
                "mesh_key": compile_cache.mesh_fingerprint(self.mesh),
                "sp": self.mesh.shape["sp"], "ep": self.mesh.shape["ep"],
                "shard_sequence": self.shard_sequence,
                "parent": os.getpid(),
                "threads": max(1, (os.cpu_count() or 1) // world),
                "estimator": self._stage_estimator(x),
                "data": self._stage_data(stage, x, y, validation_data),
                "kwargs": kwargs, "trace_dir": trace_dir,
            }
            with open(stage / TASK, "wb") as fh:
                pickle.dump(task, fh, protocol=pickle.HIGHEST_PROTOCOL)
            if self.mesh.devices[0].type == "cuda":
                # Every rank loads the libraries built here: nvcc runs once.
                from learningorchestra_tpu_torch.kernels import build

                build.build()
            t_spawn = time.time()
            procs.extend(start_ranks(stage, world))
            watch_ranks(procs, stage)
            with open(stage / RESULT, "rb") as fh:
                result = pickle.load(fh)
            self.rank_stats = result["rank_stats"]
            self.compile_cache = result.get("compile_cache")
            for stats in self.rank_stats:
                first = stats.pop("first_step_wall")
                stats["spawn_to_first_step_s"] = (
                    None if first is None else first - t_spawn)
            return result
        finally:
            stop_ranks(procs)
            shutil.rmtree(stage, ignore_errors=True)
            _live_stages.discard(str(stage))

def start_ranks(stage: Path, world: int) -> list:
    """Start the ``world`` rank processes of the fit staged in ``stage``
    (each ``python -m learningorchestra_tpu_torch.parallel.rank stage
    r``, its output in ``rank<r>.log`` / ``.err`` there).  The ranks die
    with the calling thread (PR_SET_PDEATHSIG in the rank program), which
    must wait on them (:func:`watch_ranks`)."""
    env = dict(os.environ)
    # The ranks import what this process can: the package, and the
    # modules of the callbacks they unpickle.
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(
        [_REPO] + [p for p in sys.path if p]
        + [p for p in [env.get("PYTHONPATH")] if p]))
    # One host: the ranks talk over the loopback interface.
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    procs = []
    for rank in range(world):
        with open(stage / f"rank{rank}.log", "wb") as out, \
                open(stage / f"rank{rank}.err", "wb") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "learningorchestra_tpu_torch.parallel.rank",
                 str(stage), str(rank)],
                stdout=out, stderr=err, stdin=subprocess.DEVNULL, env=env))
    return procs


def watch_ranks(procs: list, stage: Path) -> None:
    """Wait for every rank; relay the engine's cancel as a flag file;
    fail as soon as a rank dies (each dead rank's stderr tail in the
    error; the caller stops the rest)."""
    relayed = False
    while True:
        codes = [p.poll() for p in procs]
        dead = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
        if dead:
            raise RuntimeError("distributed fit failed: " + "; ".join(
                f"rank {r} exited with code {c}:\n" + (
                    stage / f"rank{r}.err").read_bytes()[-4000:].decode(
                        errors="replace") for r, c in dead))
        if all(code == 0 for code in codes):
            return
        if not relayed and cancel_requested():
            (stage / CANCEL).touch()
            relayed = True
        time.sleep(0.05)


def stop_ranks(procs: list) -> None:
    """Terminate the ranks still running and reap every one."""
    for proc in procs:
        if proc.poll() is None:
            proc.terminate()
    for proc in procs:
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


#: The staging directories of this process's fits still running.
_live_stages: set[str] = set()


def _make_stage(root) -> Path:
    """A new staging directory named after this process, under ``root``
    (None: the system's temporary directory), registered live until its
    fit returns or raises."""
    if root is not None:
        Path(root).mkdir(parents=True, exist_ok=True)
    stage = tempfile.mkdtemp(prefix=f"{STAGE_PREFIX}{os.getpid()}_",
                             dir=None if root is None else str(root))
    _live_stages.add(stage)
    return Path(stage)


def _pid_alive(pid: int) -> bool:
    """A process that exists and is not a zombie (Linux's ``/proc``)."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def sweep_stages(root) -> list[str]:
    """Remove every staging directory under ``root`` that no live fit
    owns: its owner process is gone (a SIGKILLed server never reaches
    ``_run``'s cleanup), or it is this process and none of its running
    fits staged there.  Returns the removed paths."""
    root = Path(root)
    if not root.is_dir():
        return []
    removed = []
    for entry in root.iterdir():
        owner = entry.name[len(STAGE_PREFIX):].split("_", 1)[0]
        if not (entry.is_dir() and entry.name.startswith(STAGE_PREFIX)
                and owner.isdigit()):
            continue
        pid = int(owner)
        live = (str(entry) in _live_stages if pid == os.getpid()
                else _pid_alive(pid))
        if not live:
            shutil.rmtree(entry, ignore_errors=True)
            removed.append(str(entry))
    return removed


def distributed_fit(estimator: NeuralEstimator, x, y, *,
                    mesh_spec: dict | MeshSpec | None = None,
                    devices: list | None = None,
                    **fit_kwargs) -> NeuralEstimator:
    """One-call distributed training: ``fit`` of a trainer that is then
    dropped.  The REST executor builds its own ``DistributedTrainer``
    instead, since it keeps the trainer's history and world size."""
    if isinstance(mesh_spec, dict):
        mesh_spec = MeshSpec.from_dict(mesh_spec)
    DistributedTrainer(estimator, spec=mesh_spec, devices=devices).fit(
        x, y, **fit_kwargs)
    return estimator
