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
  ``bind_mesh`` sees whole rows on every sp rank, the same arithmetic.

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

from learningorchestra_tpu_torch.jobs.cancel import cancel_requested
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


class DataParallel:
    """One rank's view of the process group, as ``est._dp`` in the rank
    process: which rows of a global batch are its own (and, with
    ``shard_tokens``, which tokens of them), the sums over the ranks, the
    agreed stop flags, and per-step timings.  With ``sp`` > 1 every rank
    creates the same groups in the same order: one ring per dp index
    (``ring``) and one dp group per sp index (``dp_group``)."""

    def __init__(self, rank: int, world: int, device, backend: str,
                 cancel_flag: Path, mesh_key=None, sp: int = 1):
        self.rank, self.world = rank, world
        self.sp, self.dp_size = sp, world // sp
        self.dp_index, self.sp_index = rank_coords(rank, sp)
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
        self.ring = self.dp_group = None
        if sp > 1:
            self._make_groups()

    def _make_groups(self) -> None:
        from learningorchestra_tpu_torch.parallel.ring_attention import Ring

        sp, timeout = self.sp, timedelta(seconds=COLLECTIVE_TIMEOUT_S)
        for d in range(self.dp_size):
            group = dist.new_group([d * sp + s for s in range(sp)],
                                   timeout=timeout)
            if d == self.dp_index:
                self.ring = Ring(group, self.sp_index, sp, self.device,
                                 self.backend, COLLECTIVE_TIMEOUT_S)
        for s in range(sp):
            group = dist.new_group(
                [d * sp + s for d in range(self.dp_size)], timeout=timeout)
            if s == self.sp_index:
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

    def _flat_sum(self, grads: list) -> torch.Tensor:
        return self._reduce_(torch.cat([g.reshape(-1) for g in grads]))

    def sync_grads(self, module) -> None:
        """Replace every accumulated ``.grad`` with its sum over the ranks:
        one flat buffer, one all-reduce."""
        params = [p for p in module.parameters() if p.grad is not None]
        t0 = self._mark()
        flat, offset = self._flat_sum([p.grad for p in params]), 0
        for p in params:
            n = p.grad.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n
        self._syncs.append((t0, self._mark()))

    def pending_grads(self, module) -> dict:
        """{parameter: its accumulated gradient summed over the ranks},
        leaving ``.grad`` as it is (a checkpoint of a fit stopped part way
        through an accumulation)."""
        params = list(module.parameters())
        flat = self._flat_sum([torch.zeros_like(p) if p.grad is None
                               else p.grad for p in params])
        out, offset = {}, 0
        for p in params:
            out[p] = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
        return out

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
        """Each step's milliseconds and each gradient sync's (CUDA events
        on a card, the host clock on the CPU)."""
        if self._cuda:
            torch.cuda.synchronize(self.device)

        def ms(a, b):
            return a.elapsed_time(b) if self._cuda else (b - a) * 1e3

        return {"rank": self.rank, "device": str(self.device),
                "backend": self.backend, "dp_index": self.dp_index,
                "sp_index": self.sp_index,
                "step_ms": [ms(a, b) for a, b in self._steps],
                "sync_ms": [ms(a, b) for a, b in self._syncs],
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
    mesh's ``dp`` times its ``sp`` is the world size.  ``shard_sequence``
    (default: on iff ``sp`` > 1) splits each token row over the sp ranks
    of its replica, for a model with ``bind_mesh``; off, every sp rank
    holds whole rows.  ``rank_stats`` holds, after a call,
    each rank's launch counters, step and gradient-sync milliseconds and
    seconds from its start to its first step.  A call ends when its ranks
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
                "sp": self.mesh.shape["sp"],
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
            env = dict(os.environ)
            # The ranks import what this process can: the package, and the
            # modules of the callbacks they unpickle.
            env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(
                [_REPO] + [p for p in sys.path if p]
                + [p for p in [env.get("PYTHONPATH")] if p]))
            # One host: the ranks talk over the loopback interface.
            env.setdefault("GLOO_SOCKET_IFNAME", "lo")
            env.setdefault("NCCL_SOCKET_IFNAME", "lo")
            t_spawn = time.time()
            # The ranks die with this thread (PR_SET_PDEATHSIG in the rank
            # program), which waits on them below.
            for rank in range(world):
                with open(stage / f"rank{rank}.log", "wb") as out, \
                        open(stage / f"rank{rank}.err", "wb") as err:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m",
                         "learningorchestra_tpu_torch.parallel.rank",
                         str(stage), str(rank)],
                        stdout=out, stderr=err, stdin=subprocess.DEVNULL,
                        env=env))
            self._watch(procs, stage)
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
            _stop(procs)
            shutil.rmtree(stage, ignore_errors=True)
            _live_stages.discard(str(stage))

    def _watch(self, procs: list, stage: Path) -> None:
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


def _stop(procs: list) -> None:
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
