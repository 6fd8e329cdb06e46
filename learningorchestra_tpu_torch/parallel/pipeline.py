"""Pipeline parallelism over the ``pp`` axis — port of
``learningorchestra_tpu/parallel/pipeline.py``.

A ``PipelinedTransformer`` splits a transformer's layers into ``pp``
stages of ``num_layers / pp`` blocks each; microbatches stream through
the stages and activations hop from stage to stage.  The JAX package
runs one SPMD program over the mesh (``shard_map``, ``ppermute``) and
gets the backward pipeline from ``jax.grad``.  Here:

- **ranks are processes.**  The ``gpipe`` and ``1f1b`` schedules run one
  process per mesh rank (the staging and rank program of
  parallel/distributed.py, task mode ``pipeline``): rank ``r`` is dp
  index ``r // pp``, stage ``r % pp`` (parallel/sharding.py), and holds
  the embedding, its own stage and the head.  A rank talks to its
  neighbours through a :class:`StageLink`: the activation hop right, the
  cotangent hop left (both posted together, as the ring does, every
  wait bounded), and the sums over its dp group and over the world;
- **the backward is written out.**  PyTorch has no autograd across
  processes, so a rank receives its stage input as a leaf that requires
  grad, runs ``torch.autograd.backward(out, cotangent)`` and sends the
  leaf's gradient left.  :func:`gpipe_step` runs every forward tick,
  then the backward ticks in reverse (the transpose ``jax.grad`` makes);
  :func:`one_f_one_b_step` interleaves them, rank s forwarding
  microbatch t - s and backwarding microbatch t - 2·pp + 2 + s at tick
  t, the last rank seeding each microbatch's cotangent in the tick its
  forward completes.  A rank keeps the autograd graphs of its in-flight
  microbatches (at most 2·(pp - 1 - s) + 1 under 1F1B, the JAX memory
  contract) instead of rematerializing them: the same numbers, with
  kernel K1 run once per layer and microbatch.  Bubble ticks run
  nothing;
- **the loss** of a microbatch is its masked rows' loss over the GLOBAL
  batch's mask mass (``softmax_ce`` of train/neural.py with ``msum``),
  so the microbatch losses of every dp replica sum to the global masked
  mean.  Stage gradients are summed over the dp group; embedding and
  head gradients (only stage 0 and the last stage have any) and the
  metrics over the world, once a step, so every rank's copies of the
  replicated leaves stay bit-equal;
- **mpmd** runs in the calling process: one stage per stage device,
  scheduled by the host (parallel/mpmd.py).

Inference (``evaluate``, ``predict``) runs the sequential forward in
512-row chunks in the calling process (f32 on the first mesh device for
the SPMD schedules; the stage devices in compute dtype for mpmd, as the
JAX package does).  ``state_dict``, ``load_state_dict`` and pickles use
the JAX layout: ``params = (embed, stages, head)``, flax trees of numpy
arrays, the stage trees stacked on a leading (pp,) axis
(convert.py: :func:`~learningorchestra_tpu_torch.convert.load_pipeline`,
:func:`~learningorchestra_tpu_torch.convert.pipeline_to_jax`).
"""

from __future__ import annotations

import itertools
import os
import pickle
import shutil
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from learningorchestra_tpu_torch import convert, faults
from learningorchestra_tpu_torch.config import get_config
from learningorchestra_tpu_torch.device import resolve_device
from learningorchestra_tpu_torch.jobs.cancel import cancel_requested
from learningorchestra_tpu_torch.models.text import (
    TransformerBlock,
    _check_tokens,
    cls_head,
    embed_tokens,
)
from learningorchestra_tpu_torch.ops.layers import Dense
from learningorchestra_tpu_torch.parallel.mesh import Mesh, MeshSpec, build_mesh
from learningorchestra_tpu_torch.parallel.sharding import batch_rows
from learningorchestra_tpu_torch.toolkit.base import as_array
from learningorchestra_tpu_torch.toolkit.registry import register
from learningorchestra_tpu_torch.train.neural import (
    NeuralEstimator,
    TrainHistory,
    _cast_params,
    _is_sharded,
    build_stop_callbacks,
    init_params,
    resolve_optimizer,
)

_MODULE = __name__
_LN_EPS = 1e-6  # flax.linen.LayerNorm's default
SCHEDULES = ("gpipe", "1f1b", "mpmd")


class _Embed(nn.Module):
    """Token + learned position embedding (``Embed_0``/``Embed_1``)."""

    def __init__(self, vocab_size: int, hidden_dim: int, max_len: int):
        super().__init__()
        self.Embed_0 = nn.Embedding(vocab_size, hidden_dim)
        self.Embed_1 = nn.Embedding(max_len, hidden_dim)

    def forward(self, tokens):
        return embed_tokens(tokens.long(), self.Embed_0, self.Embed_1)


class _Stage(nn.Module):
    """``layers_per_stage`` transformer blocks: the unit one pp rank
    owns.  Every stage has the same structure, so stage params stack."""

    def __init__(self, hidden_dim: int, num_heads: int, mlp_dim: int,
                 layers_per_stage: int, causal: bool):
        super().__init__()
        self.layers = layers_per_stage
        for i in range(layers_per_stage):
            setattr(self, f"TransformerBlock_{i}", TransformerBlock(
                hidden_dim, num_heads, mlp_dim, causal=causal))

    def forward(self, x, key_mask):
        for i in range(self.layers):
            x = getattr(self, f"TransformerBlock_{i}")(x, key_mask)
        return x


class _Head(nn.Module):
    """LayerNorm then the [CLS] head (``cls``) or a vocabulary projection
    (``lm``)."""

    def __init__(self, hidden_dim: int, out_dim: int, kind: str):
        super().__init__()
        self.kind = kind
        self.LayerNorm_0 = nn.LayerNorm(hidden_dim, eps=_LN_EPS)
        if kind == "lm":
            self.Dense_0 = Dense(hidden_dim, out_dim)
        else:
            self.Dense_0 = Dense(hidden_dim, hidden_dim)
            self.Dense_1 = Dense(hidden_dim, out_dim)

    def forward(self, h):
        h = self.LayerNorm_0(h)
        if self.kind == "lm":
            return self.Dense_0(h)
        return cls_head(h, self.Dense_0, self.Dense_1)


class _Parts(nn.Module):
    """The modules one process holds: the embedding, the stages it owns
    (``stage_ids``: every stage for the owner, one for a pipeline rank)
    and the head."""

    def __init__(self, embed: _Embed, stages: dict, head: _Head):
        super().__init__()
        self.embed = embed
        self.stage_ids = sorted(stages)
        self.stages = nn.ModuleList([stages[s] for s in self.stage_ids])
        self.head = head

    def stage(self, s: int) -> _Stage:
        return self.stages[self.stage_ids.index(s)]


def apply(module: nn.Module, dtype, *args):
    """``module`` on ``dtype`` copies of its f32 masters (None: as they
    are): the gradients reach the masters through the cast, the
    train/neural.py contract."""
    return functional_call(module, _cast_params(module, dtype), args)


def head_loss(head: nn.Module, h, y, mask, loss_fn, dtype, gw: float):
    """(loss, metrics) of one microbatch: its masked rows over the global
    mask mass ``gw``, so the microbatches' losses sum to the global
    masked mean."""
    logits = apply(head, dtype, h).float()
    return loss_fn(logits, y, mask, gw)


def sequential_loss(embed, stages, head, loss_fn, xb, yb, mb, dtype=None):
    """The pipeline's math without the pipeline — stages applied in order
    on one device: the correctness oracle."""
    km = xb != 0  # pad id 0
    h = apply(embed, dtype, xb)
    for stage in stages:
        h = apply(stage, dtype, h, km)
    logits = apply(head, dtype, h).float()
    return loss_fn(logits, yb, mb)


def metric_names(head: str) -> tuple:
    """The metrics ``softmax_ce`` reports for a head kind."""
    return ("loss", "accuracy", "perplexity") if head == "lm" \
        else ("loss", "accuracy")


# -- the per-rank schedules ---------------------------------------------------


class StepStats:
    """One rank's step timings: each step's interval, the intervals its
    stage spent computing (the rest of a step is bubble and hops) and the
    most microbatches held in flight.  CUDA events on a card, the host
    clock on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.steps: list = []
        self.busy: list = []
        self.in_flight = 0
        self._open = None

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def step_begin(self) -> None:
        self._open = self.mark()

    def step_end(self) -> None:
        self.steps.append((self._open, self.mark()))

    def hold(self, n: int) -> None:
        self.in_flight = max(self.in_flight, n)

    def summary(self) -> dict:
        if self.cuda:
            torch.cuda.synchronize()

        def ms(a, b):
            return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

        step_ms = [ms(a, b) for a, b in self.steps]
        busy_ms = sum(ms(a, b) for a, b in self.busy)
        total = sum(step_ms)
        return {"step_ms": step_ms, "busy_ms": busy_ms,
                "bubble_share": 1.0 - busy_ms / total if total else None,
                "max_in_flight": self.in_flight}


class _Busy:
    def __init__(self, stats: StepStats | None):
        self.stats = stats

    def __enter__(self):
        if self.stats is not None:
            self._a = self.stats.mark()

    def __exit__(self, *exc):
        if self.stats is not None:
            self.stats.busy.append((self._a, self.stats.mark()))


def _microbatches(t: torch.Tensor, n_micro: int) -> torch.Tensor:
    if t.shape[0] % n_micro:
        raise ValueError(
            f"batch of {t.shape[0]} rows does not split into {n_micro} "
            "microbatches")
    return t.reshape(n_micro, t.shape[0] // n_micro, *t.shape[1:])


class _Slots:
    """What a schedule step needs of a rank: its modules, its link, the
    step's inputs split into microbatches and the metric sums."""

    def __init__(self, parts: _Parts, link, xb, yb, mb, *, n_micro,
                 loss_fn, dtype, gw, names, stats):
        self.link, self.s, self.P = link, link.stage, link.n_stages
        self.first, self.last = self.s == 0, self.s == self.P - 1
        self.embed, self.head = parts.embed, parts.head
        self.stage = parts.stage(self.s)
        self.M = n_micro
        self.xm = _microbatches(xb, n_micro)
        self.ym = _microbatches(yb, n_micro)
        self.mm = _microbatches(mb, n_micro)
        self.km = self.xm != 0  # pad id 0
        self.loss_fn, self.dtype, self.gw = loss_fn, dtype, gw
        self.names, self.stats = names, stats
        self.sums = None
        width = parts.embed.Embed_0.embedding_dim
        act_dtype = dtype if dtype is not None else torch.float32
        self.act = ((self.xm.shape[1], self.xm.shape[2], width), act_dtype)
        self.inbox: dict = {}
        self.cotbox: dict = {}
        self.saved: dict = {}

    def forward(self, m: int):
        """Stage s's forward of microbatch m; returns what goes right (the
        last stage keeps its loss for the backward instead)."""
        with _Busy(self.stats):
            x_in = apply(self.embed, self.dtype, self.xm[m]) if self.first \
                else self.inbox.pop(m)
            out = apply(self.stage, self.dtype, x_in, self.km[m])
            if self.last:
                loss, metrics = head_loss(self.head, out, self.ym[m],
                                          self.mm[m], self.loss_fn,
                                          self.dtype, self.gw)
                vals = torch.stack([metrics[k].detach().float()
                                    for k in self.names])
                self.sums = vals if self.sums is None else self.sums + vals
                # The loss is the seed of this microbatch's backward.
                self.saved[m], out = (x_in, loss), None
            else:
                self.saved[m] = (x_in, out)
        if self.stats is not None:
            self.stats.hold(len(self.saved))
        return out

    def backward(self, m: int):
        """Stage s's backward of microbatch m; returns the cotangent that
        goes left (None on stage 0, whose backward reaches the
        embedding)."""
        with _Busy(self.stats):
            x_in, out = self.saved.pop(m)
            if self.last:
                torch.autograd.backward(out)
            else:
                # The cotangent in the stage's output dtype (the cast AD
                # applies on the JAX gpipe path).
                torch.autograd.backward(out, self.cotbox.pop(m).to(out.dtype))
        return None if self.first else x_in.grad

    def hop(self, *, right=None, left=None, recv_left=None,
            recv_right=None) -> None:
        """One exchange with the neighbours: the microbatch indices
        ``recv_left`` / ``recv_right`` name what arrives (None: nothing
        from that side this tick)."""
        P, s, M = self.P, self.s, self.M
        want_l = recv_left if s > 0 and recv_left is not None \
            and 0 <= recv_left < M else None
        want_r = recv_right if s < P - 1 and recv_right is not None \
            and 0 <= recv_right < M else None
        got_l, got_r = self.link.exchange(
            right=right, left=left,
            from_left=None if want_l is None else self.act,
            from_right=None if want_r is None else self.act)
        if want_l is not None:
            self.inbox[want_l] = got_l.requires_grad_()
        if want_r is not None:
            self.cotbox[want_r] = got_r

    def metrics(self) -> torch.Tensor:
        """This rank's metric sums (zeros on every rank but the last)."""
        if self.sums is None:
            return torch.zeros(len(self.names))
        return self.sums


def gpipe_step(parts: _Parts, link, xb, yb, mb, *, n_micro: int, loss_fn,
               dtype, gw: float, names: tuple, stats=None) -> torch.Tensor:
    """One rank's GPipe pass over its rows of a batch: every forward tick
    (rank s runs microbatch t - s at tick t, the JAX ``gpipe_loss``
    ticks), then the backward ticks in reverse (rank s runs microbatch
    u - (pp - 1 - s) at tick u).  Leaves the rank's gradients in
    ``.grad`` and returns its metric sums (:func:`finish_step` sums
    both)."""
    st = _Slots(parts, link, xb, yb, mb, n_micro=n_micro, loss_fn=loss_fn,
                dtype=dtype, gw=gw, names=names, stats=stats)
    P, s, M = st.P, st.s, st.M
    for t in range(M + P - 1):
        m = t - s
        out = st.forward(m) if 0 <= m < M else None
        st.hop(right=out, recv_left=t - s + 1)
    if stats is not None:
        stats.hold(M)
    for u in range(M + P - 1):
        m = u - (P - 1 - s)
        dx = st.backward(m) if 0 <= m < M else None
        st.hop(left=dx, recv_right=u - (P - 2 - s))
    return st.metrics()


def one_f_one_b_step(parts: _Parts, link, xb, yb, mb, *, n_micro: int,
                     loss_fn, dtype, gw: float, names: tuple,
                     stats=None) -> torch.Tensor:
    """One rank's 1F1B (PipeDream-flush) pass: at tick t rank s forwards
    microbatch t - s and backwards microbatch t - 2·pp + 2 + s; the last
    rank backwards a microbatch in the tick its forward completes, its
    loss the seed.  A tick's hops (the activation right, the cotangent
    left) are posted together after both slots, as the JAX schedule
    ``ppermute``s after each.  Returns the rank's metric sums."""
    st = _Slots(parts, link, xb, yb, mb, n_micro=n_micro, loss_fn=loss_fn,
                dtype=dtype, gw=gw, names=names, stats=stats)
    P, s, M = st.P, st.s, st.M
    for t in range(M + 2 * P - 2):
        m_f = t - s
        out = st.forward(m_f) if 0 <= m_f < M else None
        m_b = t - 2 * P + 2 + s
        dx = st.backward(m_b) if 0 <= m_b < M else None
        st.hop(right=out, left=dx, recv_left=t - s + 1,
               recv_right=t - 2 * P + 3 + s)
    return st.metrics()


SCHEDULE_STEPS = {"gpipe": gpipe_step, "1f1b": one_f_one_b_step}


def _grads(params: list) -> torch.Tensor:
    return torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad)
                      .reshape(-1).float() for p in params])


def _set_grads(params: list, flat: torch.Tensor) -> None:
    at = 0
    for p in params:
        n = p.numel()
        p.grad = flat[at:at + n].view_as(p).to(p.dtype).to(p.device)
        at += n


def finish_step(parts: _Parts, link, sums: torch.Tensor) -> torch.Tensor:
    """The step's gradient sums, once: the stage's over the rank's dp
    group, the embedding's and the head's with the metric sums over the
    world (each rank then holds the same replicated gradients).  Returns
    the global metrics."""
    stage = list(parts.stage(link.stage).parameters())
    if link.dp > 1:
        _set_grads(stage, link.sum_dp(_grads(stage)))
    shared = list(parts.embed.parameters()) + list(parts.head.parameters())
    flat = torch.cat([_grads(shared), sums.to(shared[0].device)])
    flat = link.sum_world(flat)
    n = flat.numel() - sums.numel()
    _set_grads(shared, flat[:n])
    return flat[n:]


# -- the transport between pipeline ranks -------------------------------------


class StageLink:
    """One pipeline rank's transport: its stage and dp index, the hops to
    its neighbours (``exchange``: the sends and receives of one tick
    posted together through ``dist.batch_isend_irecv``, never a blocking
    send before a receive) and the sums over its dp group and over the
    world.  Rank ``dp_index * pp + stage``'s neighbours are its ranks
    plus and minus one.  gloo on a card carries host copies (bf16 as its
    int16 bits); every wait is bounded by ``timeout_s``."""

    def __init__(self, rank: int, world: int, pp: int, device, backend: str,
                 timeout_s: float):
        self.rank, self.world = rank, world
        self.n_stages = pp
        self.stage, self.dp_index, self.dp = rank % pp, rank // pp, world // pp
        self.device = torch.device(device)
        self.backend = backend
        self.timeout = timedelta(seconds=timeout_s)
        self.host_staged = backend != "nccl" and self.device.type == "cuda"
        self.hop_s: list = []
        # One dp group per stage (none without data parallelism: a
        # group's creation is a rendezvous of every rank); every rank
        # creates every group, in the same order.
        self.dp_group = None
        for s in range(pp if self.dp > 1 else 0):
            group = dist.new_group([d * pp + s for d in range(self.dp)],
                                   timeout=self.timeout)
            if s == self.stage:
                self.dp_group = group

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        t = t.detach().contiguous()
        if self.host_staged:
            t = t.cpu()
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    def _buffer(self, spec) -> torch.Tensor:
        shape, dtype = spec
        wire = torch.int16 if dtype == torch.bfloat16 else dtype
        return torch.empty(shape, dtype=wire, device="cpu"
                           if self.host_staged else self.device)

    def exchange(self, right=None, left=None, from_left=None,
                 from_right=None) -> tuple:
        """Send ``right`` / ``left`` (tensors or None) and receive from
        the left / right neighbour (a (shape, dtype) or None); returns
        (from left, from right) on this rank's device."""
        ops, recvs, sends = [], [], []
        for spec, peer in ((from_left, self.rank - 1),
                           (from_right, self.rank + 1)):
            buf = None if spec is None else self._buffer(spec)
            recvs.append((buf, None if spec is None else spec[1]))
            if buf is not None:
                ops.append(dist.P2POp(dist.irecv, buf, peer=peer))
        for t, peer in ((right, self.rank + 1), (left, self.rank - 1)):
            if t is not None:
                sends.append(self._wire(t))
                ops.append(dist.P2POp(dist.isend, sends[-1], peer=peer))
        if not ops:
            return None, None
        t0 = time.perf_counter()
        for work in dist.batch_isend_irecv(ops):
            if self.backend == "nccl":
                work.wait()
            elif not work.wait(self.timeout):
                raise RuntimeError(
                    f"pipeline hop on rank {self.rank} did not finish "
                    f"within {self.timeout}")
        self.hop_s.append(time.perf_counter() - t0)
        out = []
        for buf, dtype in recvs:
            if buf is not None and dtype == torch.bfloat16:
                buf = buf.view(torch.bfloat16)
            out.append(None if buf is None else buf.to(self.device))
        return tuple(out)

    def _reduce(self, t: torch.Tensor, group=None, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
        out = t.detach().cpu().clone() if self.host_staged \
            else t.detach().clone()
        dist.all_reduce(out, op=op, group=group)
        return out.to(t.device)

    def sum_dp(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, self.dp_group)

    def sum_world(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t)

    def agree(self, flag: bool) -> bool:
        """True on every rank when it is true on any."""
        t = torch.tensor([float(bool(flag))], device="cpu"
                         if self.device.type == "cpu" or self.host_staged
                         else self.device)
        return bool(self._reduce(t, op=dist.ReduceOp.MAX).item())

    def barrier(self) -> None:
        self.agree(False)


class _RankRuntime:
    """A pipeline rank's side of ``PipelinedTransformer``: its link, the
    staging directory (part files for the gathered state, the relayed
    cancel flag) and its step timings."""

    def __init__(self, link: StageLink, stage_dir: Path, device):
        self.link = link
        self.stage_dir = Path(stage_dir)
        self.device = torch.device(device)
        self.stats = StepStats(device)
        self.first_step_wall: float | None = None
        self._gathers = itertools.count()

    def cancel_requested(self) -> bool:
        from learningorchestra_tpu_torch.parallel.distributed import CANCEL

        return self.link.agree(self.link.rank == 0
                               and (self.stage_dir / CANCEL).exists())

    def gather(self, part) -> list | None:
        """Every stage's ``part`` (from the ranks of dp index 0), in stage
        order, on rank 0; None elsewhere.  Through files in the staging
        directory: a stage of BERT-base with its moments is hundreds of
        megabytes, more than a gloo object collective should carry."""
        link = self.link
        serial = next(self._gathers)
        path = self.stage_dir / f"part_{serial}_{link.stage}.pkl"
        if link.dp_index == 0:
            tmp = path.with_suffix(".tmp")
            with open(tmp, "wb") as fh:
                pickle.dump(part, fh, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)
        link.barrier()
        if link.rank != 0:
            return None
        parts = []
        for s in range(link.n_stages):
            p = self.stage_dir / f"part_{serial}_{s}.pkl"
            with open(p, "rb") as fh:
                parts.append(pickle.load(fh))
            p.unlink()
        return parts


# -- optimizer state in the optax layout --------------------------------------


def _opt_export(opt, spec, module: nn.Module, count: int) -> dict:
    """``module``'s share of ``opt`` as optax lays it out: ``count`` and
    each slot (adam: ``mu``, ``nu``) as a flax tree of numpy arrays."""
    out = {"count": np.asarray(count, np.int32)}
    for field, key in spec.slots.items():
        out[field] = convert.to_host(convert.flax_tree(
            module, pick=lambda p, key=key: opt.state.get(p, {}).get(
                key, torch.zeros_like(p))))
    return out


def _opt_import(opt, spec, pairs: list, count: int) -> None:
    """Load optax-layout slots into ``opt``: ``pairs`` is a list of
    (module, {field: flax tree}) for modules whose parameters ``opt``
    holds."""
    params = [p for g in opt.param_groups for p in g["params"]]
    index = {id(p): i for i, p in enumerate(params)}
    per: dict = {}
    for module, trees in pairs:
        named = dict(module.named_parameters())
        for field, key in spec.slots.items():
            if field not in trees:
                continue
            for name, t in convert.params_from_jax(trees[field]).items():
                p = named[name]
                per.setdefault(index[id(p)], {})[key] = t.to(p)
    step = torch.tensor(float(count))
    for st in per.values():
        st["step"] = step.clone()
    saved = opt.state_dict()
    saved["state"] = per
    opt.load_state_dict(saved)


def _opt_count(tree) -> int:
    return int(np.asarray(tree["count"]))


def _named3(t3) -> dict:
    """A (embed, stages, head) triple as a dict (checkpoint files hold
    nested dicts)."""
    return dict(zip(("embed", "stages", "head"), t3))


def _triple(d: dict) -> tuple:
    return d["embed"], d["stages"], d["head"]


# -- the estimator ------------------------------------------------------------


def _default_devices(device) -> list[str]:
    if device.type == "cpu":
        return ["cpu"] * max(1, int(get_config().dist.cpu_ranks))
    return [f"cuda:{k}" for k in range(torch.cuda.device_count())]


@register(_MODULE)
class PipelinedTransformer:
    """Transformer classifier/LM trained pipeline-parallel over ``pp``.

    fit/evaluate/predict mirror the NeuralEstimator surface so the
    executor drives it by reflection.  ``num_layers`` must divide evenly
    into ``pp`` stages.  The mesh is dp x pp over ``devices`` (default:
    every card, or ``LO_TPU_CPU_RANKS`` CPU ranks when ``device`` is the
    CPU); a card named several times holds several ranks.  A job of the
    REST services lays it over the cards it leased
    (:meth:`bind_devices`)."""

    # The executor gives ``fit`` a managed checkpoint directory.
    supports_managed_checkpoints = True
    # The model spans a mesh: a service job leases every card for it and
    # binds them (:meth:`bind_devices`).
    spans_mesh = True

    def __init__(
        self,
        vocab_size: int = 20000,
        hidden_dim: int = 128,
        num_layers: int = 4,
        num_heads: int = 4,
        mlp_dim: int | None = None,
        max_len: int = 256,
        num_classes: int = 2,
        head: str = "cls",  # 'cls' | 'lm'
        n_microbatches: int | None = None,
        learning_rate: float = 1e-3,
        seed: int = 0,
        mesh: Mesh | None = None,
        pp: int | None = None,
        compute_dtype: str = "bfloat16",
        schedule: str | None = None,  # 'gpipe' | '1f1b' | 'mpmd'
        devices: list | None = None,
        device=None,
    ):
        self.vocab_size = vocab_size
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.mlp_dim = mlp_dim or hidden_dim * 4
        self.max_len = max_len
        self.num_classes = num_classes
        self.head = head
        self.learning_rate = learning_rate
        self.seed = seed
        self.compute_dtype = compute_dtype
        # The caller's device (a service context's): without one, the
        # first named device's kind, else the card.
        self.device = resolve_device(
            device if device is not None
            else str(torch.device(devices[0])) if devices else "cuda")
        mpmd_cfg = get_config().mpmd
        if schedule is None:
            # The deployment default (LO_TPU_MPMD_SCHEDULE).
            schedule = mpmd_cfg.schedule or "gpipe"
        if schedule not in SCHEDULES:
            raise ValueError(
                "schedule must be 'gpipe', '1f1b' or 'mpmd', "
                f"got {schedule!r}")
        self.schedule = schedule
        if n_microbatches is None and mpmd_cfg.n_micro > 0:
            n_microbatches = mpmd_cfg.n_micro
        if mesh is None:
            devices = list(devices) if devices is not None \
                else _default_devices(self.device)
            n = len(devices)
            if pp is not None:
                # Explicit pp: honour it or fail loudly.
                stages = pp
                if n % stages:
                    raise ValueError(
                        f"pp={stages} does not divide {n} devices")
            else:
                stages = min(n, num_layers)
                while num_layers % stages or n % stages:
                    stages -= 1
            mesh = build_mesh(MeshSpec(dp=n // stages, pp=stages), devices)
        self.mesh = mesh
        self.pp = mesh.shape["pp"]
        if num_layers % self.pp:
            raise ValueError(
                f"num_layers={num_layers} not divisible by pp={self.pp}")
        self.n_micro = n_microbatches or 2 * self.pp
        self.optimizer = resolve_optimizer("adam", learning_rate)
        self._optimizer_spec = {"name": "adam"}
        self._loss_fn = NeuralEstimator._loss_and_metrics("softmax_ce")
        self.history = TrainHistory()
        self.stop_training = False
        self.rank_stats: list[dict] = []
        # Where a process-per-rank fit stages (None: the system's
        # temporary directory); a server names its own.
        self.stage_root = None
        self._parts: _Parts | None = None
        self._params_host = None  # JAX-layout params not yet placed
        self._opt_host = None  # optax-layout optimizer state, host
        self.opt_state = None  # live optimizer(s) of the placed parts
        self._updates = 0
        self._mpmd = None
        self._rank: _RankRuntime | None = None

    # -- construction ---------------------------------------------------------

    def _new_module(self, part: str) -> nn.Module:
        if part == "embed":
            return _Embed(self.vocab_size, self.hidden_dim, self.max_len)
        if part == "head":
            return _Head(self.hidden_dim, self.vocab_size
                         if self.head == "lm" else self.num_classes,
                         self.head)
        return _Stage(self.hidden_dim, self.num_heads, self.mlp_dim,
                      self.num_layers // self.pp, causal=self.head == "lm")

    def _build_parts(self, stage_ids, device_of) -> _Parts:
        """The modules for ``stage_ids`` from the host params, or seeded
        (the same seed gives the same weights on every device); ``device_of``
        maps "embed", "head" and a stage index to a device."""
        embed = self._new_module("embed")
        stages = {s: self._new_module("stage") for s in stage_ids}
        head = self._new_module("head")
        if self._params_host is not None:
            convert.load_pipeline(self._params_host, embed, stages, head)
        else:
            init_params(embed, 3 * self.seed)
            init_params(head, 3 * self.seed + 2)
            for s, stage in stages.items():
                init_params(stage, 1000 * (3 * self.seed + 1) + s)
        embed.to(device_of("embed")).eval()
        head.to(device_of("head")).eval()
        for s, stage in stages.items():
            stage.to(device_of(s)).eval()
        return _Parts(embed, stages, head)

    def _ensure_parts(self) -> None:
        """Place the state where this process uses it: a rank its stage,
        the mpmd engine each stage on its stage device, the owner of an
        SPMD schedule everything on the first mesh device."""
        if self._parts is not None:
            return
        if self._rank is not None:
            s = self._rank.link.stage
            dev = self._rank.device
            self._parts = self._build_parts([s], lambda _: dev)
            self._params_host = None
            self._reset_rank_optimizer(self._opt_host)
            self._opt_host = None
        elif self.schedule == "mpmd":
            self._engine().ensure_placed()
        else:
            dev = self.mesh.devices[0]
            self._parts = self._build_parts(range(self.pp), lambda _: dev)
            self._params_host = None

    def _init_params(self, x0=None) -> None:
        """Seeded parameters on first use (the JAX ``_init_params``)."""
        self._ensure_parts()

    @property
    def params(self) -> dict:
        """The live parameters by name (a callback's view; the optimizer
        updates them in place)."""
        self._ensure_parts()
        return dict(self._parts.named_parameters())

    @params.setter
    def params(self, values: dict) -> None:
        with torch.no_grad():
            for name, p in self._parts.named_parameters():
                p.copy_(values[name])

    def _engine(self):
        """The MPMD host dispatcher (parallel/mpmd.py), built lazily."""
        if self._mpmd is None:
            from learningorchestra_tpu_torch.parallel.mpmd import MPMDEngine

            self._mpmd = MPMDEngine(self)
        return self._mpmd

    def bind_devices(self, devices: list) -> None:
        """Lay the mesh over ``devices`` (a service job's leased cards or
        CPU ranks); the state moves there at its next use.  ``pp`` stays:
        a device count it does not divide is refused."""
        mesh = build_mesh(MeshSpec(pp=self.pp), list(devices))
        if self._parts is not None or self._mpmd is not None:
            state = self.state_dict()
            self._params_host, self._opt_host = state["params"], \
                state["opt_state"]
            self._parts = self._mpmd = None
            self.opt_state = None
        self.mesh = mesh

    def to(self, device) -> "PipelinedTransformer":
        """The volumes' load hook: a pickle made on another kind of device
        lays its mesh over this one, rank for rank."""
        self.device = resolve_device(device)
        if self.mesh.devices[0].type != self.device.type:
            self.bind_devices([str(self.device)] * self.mesh.size)
        return self

    # -- a rank's optimizer ---------------------------------------------------

    def _reset_rank_optimizer(self, opt_host=None) -> None:
        """The rank's one optimizer over its embedding, stage and head;
        moments from ``opt_host`` (the stacked layout) or fresh."""
        parts = self._parts
        self.opt_state = self.optimizer.build(parts.parameters())
        self._updates = 0
        if opt_host is None or isinstance(opt_host, tuple):
            return  # none, or a partitioned (mpmd) state: fresh moments
        s = self._rank.link.stage
        self._updates = _opt_count(opt_host)
        fields = [f for f in opt_host if f != "count"]
        _opt_import(self.opt_state, self.optimizer, [
            (parts.embed, {f: opt_host[f][0] for f in fields}),
            (parts.stage(s), {f: convert.slice_tree(opt_host[f][1], s)
                              for f in fields}),
            (parts.head, {f: opt_host[f][2] for f in fields})],
            self._updates)

    def _rank_step(self, xb, yb, mask):
        """One optimizer step of a pipeline rank over one global batch:
        its dp rows through the schedule, the sums, the update."""
        r = self._rank
        link = r.link
        if self.opt_state is None:  # restore-best dropped the moments
            self._reset_rank_optimizer()
        if r.first_step_wall is None:
            r.first_step_wall = time.time()
        r.stats.step_begin()
        rows = batch_rows(len(xb), link.dp_index, link.dp)
        gw = max(float(mask.sum()), 1e-9)
        dev = r.device
        xt = torch.from_numpy(np.ascontiguousarray(xb[rows])).to(dev)
        yt = torch.from_numpy(np.ascontiguousarray(yb[rows])).to(dev)
        mt = torch.from_numpy(np.ascontiguousarray(mask[rows])).to(dev)
        names = metric_names(self.head)
        sums = SCHEDULE_STEPS[self.schedule](
            self._parts, link, xt, yt, mt, n_micro=self.n_micro,
            loss_fn=self._loss_fn, dtype=self._dtype(), gw=gw,
            names=names, stats=r.stats)
        metrics = finish_step(self._parts, link, sums)
        lr = self.optimizer.lr(self._updates)
        for group in self.opt_state.param_groups:
            group["lr"] = lr
        self.opt_state.step()
        self._parts.zero_grad(set_to_none=True)
        self._updates += 1
        r.stats.step_end()
        return dict(zip(names, metrics)), float(mask.sum())

    def _dtype(self):
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else None

    # -- the fit loop ---------------------------------------------------------

    def _batch_pass(self, xs, ys, order, batch_size):
        """The optimizer steps over ``order`` in ``batch_size`` slices
        (tail batch padded and masked); returns each batch's metrics and
        real-row weight."""
        metrics_list, weights = [], []
        self._epoch_batches = getattr(self, "_epoch_batches", 0)
        for lo in range(0, len(order), batch_size):
            idx = order[lo: lo + batch_size]
            if len(idx) < batch_size:
                pad = batch_size - len(idx)
                idx = np.concatenate([idx, idx[:1].repeat(pad)])
                mask = np.concatenate([np.ones(batch_size - pad, np.float32),
                                       np.zeros(pad, np.float32)])
            else:
                mask = np.ones(batch_size, np.float32)
            xb = np.asarray(xs[idx])
            yb = np.asarray(ys[idx]).astype(np.int64)
            if self.schedule == "mpmd":
                m, w = self._engine().train_batch(xb, yb, mask)
            else:
                m, w = self._rank_step(xb, yb, mask)
            metrics_list.append(m)
            weights.append(w)
            self._epoch_batches += 1
        return metrics_list, weights

    @staticmethod
    def _weighted_update(totals, metrics_list, weights):
        """One host transfer of the batches' metrics, mask-weighted (a
        padded tail batch must not count like a full one); returns the
        weight added."""
        if not metrics_list:
            return 0.0
        keys = list(metrics_list[0])
        stacked = torch.stack([torch.stack([torch.as_tensor(m[k]).float()
                                            .cpu() for k in keys])
                               for m in metrics_list]).tolist()
        for row, w in zip(stacked, weights):
            for k, v in zip(keys, row):
                totals[k] = totals.get(k, 0.0) + float(v) * w
        return sum(weights)

    @staticmethod
    def _finish_row(totals, wsum):
        row = {k: v / max(wsum, 1e-9) for k, v in totals.items()}
        if "perplexity" in row:  # raw CE until post-mean exp
            row["perplexity"] = float(np.exp(row["perplexity"]))
        return row

    def _batch_quantum(self) -> int:
        """Smallest legal global batch: n_micro microbatches, times the dp
        replication for the SPMD schedules (mpmd ignores dp)."""
        if self.schedule == "mpmd":
            return self.n_micro
        return self.n_micro * (self.mesh.shape["dp"] * self.mesh.shape["fsdp"])

    def _checkpoint_state(self) -> dict:
        """The stacked checkpoint state (nested dicts), gathered to rank 0
        on a pipeline rank (None on the others)."""
        state = self.state_dict()
        if state is None:
            return None
        opt = state["opt_state"]
        return {"params": _named3(state["params"]),
                "opt_state": None if opt is None else {
                    k: (v if k == "count" else _named3(v))
                    for k, v in opt.items()}}

    def _ckpt_resume(self, checkpoint_dir) -> int:
        """Resume from ``checkpoint_dir`` if it holds a checkpoint; returns
        the epoch to continue from (0 = fresh).  mpmd resumes every stage
        partition from its newest common step; the SPMD schedules restore
        the stacked state (every rank the same file)."""
        if self.schedule == "mpmd":
            loaded = self._engine().resume_checkpoint(checkpoint_dir)
            if loaded is None:
                return 0
            step, past_history = loaded
            self.history = TrainHistory(past_history)
            return step
        from learningorchestra_tpu_torch.train import checkpoint as ckpt

        def restore(state):
            opt = state.get("opt_state")
            self._params_host = _triple(state["params"])
            self._opt_host = None if opt is None else {
                k: (v if k == "count" else _triple(v))
                for k, v in opt.items()}
            self._parts = None
            self._ensure_parts()

        loaded = ckpt.resume_or_none(checkpoint_dir, restore)
        if loaded is None:
            return 0
        step, past_history = loaded
        self.history = TrainHistory(past_history)
        return step

    def _ckpt_save(self, checkpoint_dir, step: int, *, async_save: bool
                   ) -> None:
        if self.schedule == "mpmd":
            self._engine().save_checkpoint(
                checkpoint_dir, step, dict(self.history),
                async_save=async_save)
            return
        from learningorchestra_tpu_torch.train import checkpoint as ckpt

        if self.opt_state is None:
            # restore-best dropped the moments: checkpoint the restored
            # params with FRESH moments (the train/neural.py contract).
            self._reset_rank_optimizer()
        state = self._checkpoint_state()
        if state is not None:  # rank 0 writes
            ckpt.save(checkpoint_dir, step, state,
                      history=dict(self.history), async_save=async_save)

    def _ckpt_finalize(self, checkpoint_dir) -> None:
        from learningorchestra_tpu_torch.train import checkpoint as ckpt

        if self.schedule == "mpmd":
            self._engine().finalize_checkpoints(checkpoint_dir)
        ckpt.finalize_async(checkpoint_dir)

    def _record_epoch_obs(self, epoch_i: int, epoch_s: float) -> None:
        """The epoch's trace span; mpmd adds one ``mpmd.stage`` span per
        stage (host dispatch seconds) and books the epoch against the
        job's device time with the per-stage programs' FLOPs."""
        from learningorchestra_tpu_torch.obs import tracing

        attrs: dict = {}
        if self.schedule == "mpmd" and self._mpmd is not None:
            engine = self._mpmd
            n_batches = getattr(self, "_epoch_batches", 0)
            engine.attribute_epoch(epoch_s, n_batches)
            attrs = engine.epoch_cost_attrs(epoch_s, n_batches)
            for s, secs in enumerate(engine.pop_stage_seconds()):
                tracing.record_span("mpmd.stage", secs, stage=s,
                                    epoch=epoch_i)
        tracing.record_span("epoch", epoch_s, epoch=epoch_i, **attrs)

    def _cancelled(self) -> bool:
        if self._rank is not None:
            return self._rank.cancel_requested()
        return cancel_requested()

    def _agree_stop(self) -> None:
        if self._rank is not None:
            self.stop_training = self._rank.link.agree(self.stop_training)

    def fit(self, x, y, epochs: int = 1, batch_size: int = 32,
            shuffle: bool = True, verbose: int = 0,
            checkpoint_dir: str | None = None,
            checkpoint_every: int = 1,
            checkpoint_min_interval_s: float = 60.0,
            resume: bool = True, checkpoint_async: bool = True,
            callbacks: list | None = None, early_stopping=None, **_):
        """The ``NeuralEstimator.fit`` contract: managed checkpoints with
        resume (the stacked state; mpmd one directory per partition),
        callbacks and early stopping, and sharded datasets streamed shard
        by shard.  The SPMD schedules run in one process per mesh rank,
        each running this loop on its stage (callbacks must pickle: they
        run in every rank, with the global metrics)."""
        if self.schedule != "mpmd" and self._rank is None:
            return self._fit_ranks(x, y, dict(
                epochs=epochs, batch_size=batch_size, shuffle=shuffle,
                verbose=verbose, checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every,
                checkpoint_min_interval_s=checkpoint_min_interval_s,
                resume=resume, checkpoint_async=checkpoint_async,
                callbacks=list(callbacks or []),
                early_stopping=early_stopping))
        callbacks = build_stop_callbacks(self, callbacks, early_stopping)
        if _is_sharded(x) or _is_sharded(y):
            return self._fit_streaming(
                x, y, epochs=epochs, batch_size=batch_size, shuffle=shuffle,
                verbose=verbose, checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every,
                checkpoint_min_interval_s=checkpoint_min_interval_s,
                resume=resume, checkpoint_async=checkpoint_async,
                callbacks=callbacks)
        x = as_array(x)
        y = as_array(y).astype(np.int64)
        _check_tokens(x, self.vocab_size, self.max_len)
        # The global batch splits into n_micro microbatches over dp;
        # round it DOWN to a legal multiple (never below one quantum).
        quantum = self._batch_quantum()
        batch_size = max(quantum, (batch_size // quantum) * quantum)
        self._ensure_parts()
        start_epoch = 0
        if checkpoint_dir and resume:
            start_epoch = self._ckpt_resume(checkpoint_dir)
        rng = np.random.default_rng(self.seed)
        n = len(x)
        if shuffle:
            # Burn the completed epochs' draws: a resumed run shuffles as
            # the original would at this epoch.
            for _ in range(start_epoch):
                rng.permutation(n)

        def epoch_rows(epoch_i):
            order = rng.permutation(n) if shuffle else np.arange(n)
            totals: dict = {}
            wsum = self._weighted_update(
                totals, *self._batch_pass(x, y, order, batch_size))
            return self._finish_row(totals, wsum)

        return self._epochs(epoch_rows, start_epoch, epochs, verbose,
                            callbacks, checkpoint_dir, checkpoint_every,
                            checkpoint_min_interval_s, checkpoint_async)

    def _epochs(self, epoch_rows, start_epoch, epochs, verbose, callbacks,
                checkpoint_dir, checkpoint_every, checkpoint_min_interval_s,
                checkpoint_async):
        """The epoch loop both fit paths share."""
        from learningorchestra_tpu_torch.train import checkpoint as ckpt_mod

        last_save = time.monotonic()
        try:
            for epoch_i in range(start_epoch, epochs):
                if self._cancelled():
                    # Engine-side cancellation: wind down like an early
                    # stop.
                    self.stop_training = True
                    break
                faults.hit("train.epoch")
                t0 = time.perf_counter()
                self._epoch_batches = 0
                epoch_row = epoch_rows(epoch_i)
                self.history.append(epoch_row)
                self._record_epoch_obs(epoch_i, time.perf_counter() - t0)
                if verbose:
                    print(f"pipeline epoch: {self.history['loss'][-1]:.4f}",
                          flush=True)
                for cb in callbacks or []:
                    if callable(cb):
                        cb(epoch_i, epoch_row, self)
                self._agree_stop()
                if checkpoint_dir and ckpt_mod.should_save(
                        epoch_i, epochs, checkpoint_every,
                        checkpoint_min_interval_s, last_save,
                        stopped=self.stop_training):
                    self._ckpt_save(checkpoint_dir, epoch_i + 1,
                                    async_save=checkpoint_async)
                    last_save = time.monotonic()
                if self.stop_training:
                    break
        finally:
            if checkpoint_dir:
                # The last async save is durable when fit returns.
                self._ckpt_finalize(checkpoint_dir)
        return self

    def _fit_streaming(self, x, y, *, epochs, batch_size, shuffle, verbose,
                       checkpoint_dir, checkpoint_every,
                       checkpoint_min_interval_s, resume, checkpoint_async,
                       callbacks=None) -> "PipelinedTransformer":
        """Shard-streaming pipelined fit: the same steps fed shard by
        shard, the next shard loading on an IO thread — token datasets
        bigger than host RAM train through the pipeline unchanged.  The
        shard and in-shard orders are the JAX package's."""
        import concurrent.futures

        from learningorchestra_tpu_torch.store import sharded as sh

        x, y = sh.resolve_xy_views(x, y)
        self._sharded_fit_cols = list(x.cols)
        ds = x.dataset
        quantum = self._batch_quantum()
        batch_size = max(quantum, (batch_size // quantum) * quantum)
        self._ensure_parts()
        start_epoch = 0
        if checkpoint_dir and resume:
            start_epoch = self._ckpt_resume(checkpoint_dir)

        def load(k: int):
            return (np.asarray(x.load_shard(k)),
                    np.asarray(y.load_shard(k)).astype(np.int64))

        with concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="shard-io") as io:

            def epoch_rows(epoch_i):
                order = (np.random.default_rng([self.seed, 3, epoch_i])
                         .permutation(ds.n_shards)
                         if shuffle else np.arange(ds.n_shards))
                totals: dict = {}
                wsum = 0.0
                nxt = io.submit(load, int(order[0]))
                for pos, k in enumerate(order):
                    xs, ys = nxt.result()
                    if pos + 1 < len(order):
                        nxt = io.submit(load, int(order[pos + 1]))
                    inner = (np.random.default_rng(
                        [self.seed, 7 + epoch_i, pos]).permutation(len(xs))
                        if shuffle else np.arange(len(xs)))
                    wsum += self._weighted_update(
                        totals, *self._batch_pass(xs, ys, inner, batch_size))
                return self._finish_row(totals, wsum)

            return self._epochs(epoch_rows, start_epoch, epochs, verbose,
                                callbacks, checkpoint_dir, checkpoint_every,
                                checkpoint_min_interval_s, checkpoint_async)

    # -- one process per rank -------------------------------------------------

    def _class_params(self) -> dict:
        return {"vocab_size": self.vocab_size, "hidden_dim": self.hidden_dim,
                "num_layers": self.num_layers, "num_heads": self.num_heads,
                "mlp_dim": self.mlp_dim, "max_len": self.max_len,
                "num_classes": self.num_classes, "head": self.head,
                "n_microbatches": self.n_micro,
                "learning_rate": self.learning_rate, "seed": self.seed,
                "pp": self.pp, "compute_dtype": self.compute_dtype,
                "schedule": self.schedule}

    def _fit_ranks(self, x, y, kwargs: dict) -> "PipelinedTransformer":
        """Stage the state, the inputs and the fit's arguments, run one
        process per mesh rank (parallel/rank.py, task mode ``pipeline``),
        and take rank 0's gathered state, history and stop flag back.
        The staging directory and every rank are gone when it returns or
        raises."""
        from learningorchestra_tpu_torch.parallel import distributed as dd

        if _is_sharded(x) or _is_sharded(y):
            from learningorchestra_tpu_torch.store import sharded as sh

            x, y = sh.resolve_xy_views(x, y)
        else:
            x = as_array(x)
            _check_tokens(x, self.vocab_size, self.max_len)
        if self._parts is None and self._params_host is None:
            self._ensure_parts()  # the seeded init the ranks start from
        devices = [str(d) for d in self.mesh.devices]
        world = len(devices)
        stage = dd._make_stage(self.stage_root)
        procs: list = []
        try:
            task = {
                "mode": "pipeline", "devices": devices,
                "backend": dd.backend_for(devices),
                "parent": os.getpid(),
                "threads": max(1, (os.cpu_count() or 1) // world),
                "estimator": {"class_params": self._class_params(),
                              "state": self.state_dict()},
                "data": dd.DistributedTrainer._stage_data(stage, x, y, None),
                "kwargs": kwargs,
            }
            with open(stage / dd.TASK, "wb") as fh:
                pickle.dump(task, fh, protocol=pickle.HIGHEST_PROTOCOL)
            if self.mesh.devices[0].type == "cuda":
                # Every rank loads the libraries built here.
                from learningorchestra_tpu_torch.kernels import build

                build.build()
            t_spawn = time.time()
            procs.extend(dd.start_ranks(stage, world))
            dd.watch_ranks(procs, stage)
            with open(stage / dd.RESULT, "rb") as fh:
                result = pickle.load(fh)
        finally:
            dd.stop_ranks(procs)
            shutil.rmtree(stage, ignore_errors=True)
            dd._live_stages.discard(str(stage))
        self.rank_stats = result["rank_stats"]
        for stats in self.rank_stats:
            first = stats.pop("first_step_wall")
            stats["spawn_to_first_step_s"] = (
                None if first is None else first - t_spawn)
            # Where a rank's start goes: to its process group, its links,
            # its placed stage (seconds from the spawn).
            stats["startup_s"] = {
                key[:-5]: stats.pop(key) - t_spawn for key in (
                    "group_wall", "link_wall", "placed_wall")}
        self.load_state_dict(result["state"])
        self.stop_training = result["stop_training"]
        if result.get("sharded_fit_cols"):
            self._sharded_fit_cols = result["sharded_fit_cols"]
        return self

    # -- inference ------------------------------------------------------------

    _CHUNK = 512  # inference batch: one fixed shape

    def _forward_chunks(self, x: np.ndarray):
        """Sequential forward in fixed-size chunks (inference needs no
        microbatch schedule); the ragged last chunk pads with id 0."""
        for lo in range(0, len(x), self._CHUNK):
            chunk = x[lo: lo + self._CHUNK]
            n = len(chunk)
            if n < self._CHUNK:
                chunk = np.pad(chunk, ((0, self._CHUNK - n), (0, 0)))
            if self.schedule == "mpmd":
                logits = self._engine().forward_logits(chunk)
            else:
                logits = self._sequential_logits(chunk)
            # The chunk's host transfer:
            # lo-check: disable=jit-host-sync
            yield logits[:n].float().cpu().numpy()

    def _sequential_logits(self, chunk: np.ndarray) -> torch.Tensor:
        self._ensure_parts()
        parts = self._parts
        dev = self.mesh.devices[0]
        with torch.inference_mode():
            xb = torch.from_numpy(np.ascontiguousarray(chunk)).to(dev)
            km = xb != 0
            h = parts.embed(xb)
            for stage in parts.stages:
                h = stage(h, km)
            return parts.head(h)

    def _require_params(self, what: str) -> None:
        if self._parts is None and self._params_host is None:
            raise RuntimeError(f"{what} before fit")

    def evaluate(self, x, y, **_) -> dict:
        if _is_sharded(x) or _is_sharded(y):
            from learningorchestra_tpu_torch.store import sharded as sh

            x, y = sh.resolve_xy_views(x, y)
            acc = sh.WeightedMetrics()
            for k in range(x.dataset.n_shards):
                acc.add(self.evaluate(x.load_shard(k), y.load_shard(k)),
                        x.dataset.shard_rows[k])
            return acc.result()
        x = as_array(x)
        y = as_array(y).astype(np.int64)
        self._require_params("evaluate")
        _check_tokens(x, self.vocab_size, self.max_len)
        sums: dict = {}
        total = 0
        for lo, logits in zip(range(0, len(x), self._CHUNK),
                              self._forward_chunks(x)):
            yb = torch.from_numpy(y[lo: lo + len(logits)])
            _, metrics = self._loss_fn(torch.from_numpy(logits), yb,
                                       torch.ones(len(logits)))
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v) * len(logits)
            total += len(logits)
        out = {k: v / max(total, 1) for k, v in sums.items()}
        if "perplexity" in out:  # raw CE until post-mean exp
            out["perplexity"] = float(np.exp(out["perplexity"]))
        return out

    def predict(self, x, **_):
        if _is_sharded(x):
            from learningorchestra_tpu_torch.store import sharded as sh

            if isinstance(x, sh.ShardedDataset):
                cols = getattr(self, "_sharded_fit_cols", None)
                view = x.view(cols) if cols and all(
                    c in x.fields for c in cols) else x.view(x.fields)
            else:
                view = x
            return np.concatenate([
                self.predict(view.load_shard(k))
                for k in range(view.dataset.n_shards)], axis=0)
        x = as_array(x)
        self._require_params("predict")
        _check_tokens(x, self.vocab_size, self.max_len)
        out = np.concatenate(list(self._forward_chunks(x)), axis=0)
        if self.head == "cls":
            return np.argmax(out, -1)
        return out

    # -- persistence ----------------------------------------------------------

    def state_dict(self) -> dict | None:
        """``{"params": (embed, stages stacked, head), "opt_state",
        "history"}`` on the host.  The optimizer state is optax's adam
        state for the stacked tree (``count``, ``mu``, ``nu``, each slot
        the same triple) for the SPMD schedules, and one such state per
        partition, ``(embed, (stage_0, ...), head)``, for mpmd.  On a
        pipeline rank the stages are gathered to rank 0 (None
        elsewhere)."""
        history = {k: list(v) for k, v in self.history.items()}
        if self._rank is not None and self._parts is not None:
            return self._gathered_state(history)
        if self.schedule == "mpmd" and self._mpmd is not None \
                and self._mpmd.placed:
            params, opt = self._mpmd.host_state()
        elif self._parts is not None:
            params = convert.pipeline_to_jax(
                self._parts.embed, list(self._parts.stages),
                self._parts.head)
            opt = self._opt_host
        else:
            params, opt = self._params_host, self._opt_host
        return {"params": params, "opt_state": opt, "history": history}

    def _gathered_state(self, history: dict) -> dict | None:
        parts, s = self._parts, self._rank.link.stage
        stage = parts.stage(s)
        opt = self.opt_state
        spec = self.optimizer
        mine = {"params": convert.params_to_jax(stage),
                "opt": None if opt is None else _opt_export(
                    opt, spec, stage, self._updates)}
        every = self._rank.gather(mine)
        if every is None:
            return None
        params = (convert.params_to_jax(parts.embed),
                  convert.stack_trees([p["params"] for p in every]),
                  convert.params_to_jax(parts.head))
        opt_state = None
        if opt is not None:
            emb = _opt_export(opt, spec, parts.embed, self._updates)
            hd = _opt_export(opt, spec, parts.head, self._updates)
            opt_state = {"count": emb["count"]}
            for field in spec.slots:
                opt_state[field] = (
                    emb[field],
                    convert.stack_trees([p["opt"][field] for p in every]),
                    hd[field])
        return {"params": params, "opt_state": opt_state,
                "history": history}

    def load_state_dict(self, state: dict) -> None:
        self._params_host = state["params"]
        self._opt_host = state.get("opt_state")
        self.history = TrainHistory(state.get("history") or {})
        self._parts = None
        self.opt_state = None
        self._mpmd = None  # host state: the engine re-places on next use

    def __getstate__(self):
        """Pickles (the model service persists instances) hold the host
        state and the mesh's shape and device names, no modules, engine
        or rank runtime."""
        d = dict(self.__dict__)
        state = self.state_dict() if self._rank is None else None
        if state is not None:
            d["_params_host"], d["_opt_host"] = state["params"], \
                state["opt_state"]
        d["_parts"] = d["_mpmd"] = d["_rank"] = None
        d["opt_state"] = None
        d.pop("_loss_fn")  # a closure: rebuilt on load
        d["mesh"] = None
        d["_mesh_layout"] = (dict(self.mesh.shape),
                             [str(dev) for dev in self.mesh.devices])
        d["device"] = str(self.device)
        return d

    def __setstate__(self, d):
        shape, devices = d.pop("_mesh_layout")
        self.__dict__.update(d)
        self._loss_fn = NeuralEstimator._loss_and_metrics("softmax_ce")
        self.device = torch.device(d["device"])
        self.mesh = build_mesh(MeshSpec.from_dict(shape), devices)


def run_rank(task: dict, stage_dir: Path, rank: int, world: int, device
             ) -> tuple[dict, dict]:
    """A pipeline rank (parallel/rank.py, task mode ``pipeline``): the
    estimator rebuilt from the staged state, bound to its link, through
    ``fit``; its stats, and on rank 0 the gathered state and history."""
    from learningorchestra_tpu_torch.parallel.distributed import (
        COLLECTIVE_TIMEOUT_S,
    )
    from learningorchestra_tpu_torch.parallel.rank import load_data

    marks = {"group_wall": time.time()}  # the process group is up
    spec = task["estimator"]
    est = PipelinedTransformer(**spec["class_params"],
                               devices=task["devices"], device=device)
    link = StageLink(rank, world, est.pp, device, task["backend"],
                     COLLECTIVE_TIMEOUT_S)
    marks["link_wall"] = time.time()
    est._rank = _RankRuntime(link, stage_dir, device)
    est.load_state_dict(spec["state"])
    est._ensure_parts()
    marks["placed_wall"] = time.time()
    data = load_data(task["data"])
    kwargs = dict(task["kwargs"])
    est.fit(data["x"], data["y"], **kwargs)
    state = est.state_dict()
    stats = {"rank": rank, "stage": link.stage, "dp_index": link.dp_index,
             "device": str(device), "backend": task["backend"],
             **est._rank.stats.summary(),
             "hop_ms": [s * 1e3 for s in link.hop_s],
             "param_bytes": sum(p.numel() * p.element_size()
                                for p in est._parts.parameters()),
             "first_step_wall": est._rank.first_step_wall, **marks}
    out = {}
    if rank == 0:
        out = {"state": state, "stop_training": bool(est.stop_training),
               "sharded_fit_cols": getattr(est, "_sharded_fit_cols", None)}
    return out, stats
