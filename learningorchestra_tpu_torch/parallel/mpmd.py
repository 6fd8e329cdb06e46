"""MPMD pipeline dispatch: every stage is a program of its own — port of
``learningorchestra_tpu/parallel/mpmd.py``.

The ``mpmd`` schedule of ``PipelinedTransformer`` runs in the calling
process: stage s lives on stage device s (the mesh's pp axis at dp index
0; a card named several times holds several stages), and a host loop
dispatches the 1F1B schedule over per-stage programs, the activations
and cotangents hopping between devices by ``Tensor.to``.  Eager CUDA
launches are asynchronous and each device runs its stream in order, so
the host's enqueue order is the schedule.

- **Per-stage programs.**  Each embed/stage/head program goes through
  the process-wide program cache (train/compile_cache.py) under its own
  key — the module's fingerprint, the part (a stage's index included)
  and the microbatch shape — so N stages give N entries per kind, shared
  by every job of the same architecture.  A program is a module-level
  function taking the module as an argument (``_embed_fwd``,
  ``_stage_bwd``, ...).
- **Stage-partitioned state.**  Parameters and optimizer states live per
  partition on its stage device: the embedding on the first, stage s on
  device s, the head on the last; one optimizer per partition (adam is
  per leaf, so P + 2 optimizers step exactly as one over the stacked
  tree).  Checkpoints write one directory per partition (``embed``,
  ``stage_00``, ..., ``head``) and then one top-level marker; a resume
  restores every partition from the newest step all of them hold.

The math is the SPMD 1F1B schedule's (parallel/pipeline.py): each
microbatch's loss over the global mask mass, a stage input received as a
leaf that requires grad, the backward of a stage written out with
``torch.autograd.backward(out, cotangent)`` on the autograd graph kept
from its forward, one optimizer update per batch.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from learningorchestra_tpu_torch import convert
from learningorchestra_tpu_torch.parallel import pipeline as pl

__all__ = ["MPMDEngine", "stage_devices", "partition_names"]


def stage_devices(mesh, n_stages: int) -> list:
    """One device per pipeline stage: the ``pp`` axis of the mesh at dp
    index 0 (ranks are laid out ``dp_index * pp + stage``).  mpmd ignores
    the dp axis: scale the batch through bigger microbatches."""
    return [mesh.devices[s] for s in range(n_stages)]


def partition_names(n_stages: int) -> list[str]:
    """Checkpoint sub-directory names, in pipeline order."""
    return (["embed"] + [f"stage_{s:02d}" for s in range(n_stages)]
            + ["head"])


# -- the programs (each takes its module as an argument) ----------------------


def _embed_fwd(embed, tok, dtype):
    return pl.apply(embed, dtype, tok)


def _embed_bwd(embed, emb, dh):
    torch.autograd.backward(emb, dh.to(emb.dtype))


def _stage_fwd(stage, x, km, dtype):
    return pl.apply(stage, dtype, x, km)


def _stage_bwd(stage, x, out, cot):
    """The stage's backward on the graph its forward kept; returns the
    gradient of its input (what goes left)."""
    torch.autograd.backward(out, cot.to(out.dtype))
    return x.grad


def _head_fwd(head, h, dtype):
    return pl.apply(head, dtype, h)


def _head_bwd(head, h, y, m, gw, loss_fn, dtype, names):
    """Head + loss + their backward: the cotangent of the last stage's
    output and the microbatch's metric sums."""
    loss, metrics = pl.head_loss(head, h, y, m, loss_fn, dtype, gw)
    loss.backward()
    return h.grad, torch.stack([metrics[k].detach().float() for k in names])


def _zeros(module):
    module.zero_grad(set_to_none=True)


def _opt_step(module, opt, lr):
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()


def _finalize(sums, names):
    return dict(zip(names, sums))


class _ProgramSet:
    """The cached program handles one shape uses, and their keys."""

    def __init__(self, sig):
        self.sig = sig
        self.fns: dict = {}
        self.keys: dict = {}


class MPMDEngine:
    """Host-side MPMD dispatcher bound to one ``PipelinedTransformer``: it
    places the owner's state (``owner._parts``, ``owner.opt_state``) on
    the stage devices and runs the schedule; programs live in the
    process-wide cache.  Dropped on pickle, rebuilt on first use."""

    def __init__(self, owner):
        self.o = owner
        self.pp = int(owner.pp)
        self.devices = stage_devices(owner.mesh, self.pp)
        self.placed = False
        self._train: _ProgramSet | None = None
        self._fwd: _ProgramSet | None = None
        self._stage_s = [0.0] * self.pp
        self._batch_cost = None

    # -- placement ------------------------------------------------------------

    def _device_of(self, part):
        if part == "embed":
            return self.devices[0]
        if part == "head":
            return self.devices[-1]
        return self.devices[part]

    def ensure_placed(self) -> None:
        """Build the owner's modules on the stage devices: from a stacked
        host state (split per stage), or seeded.  A partitioned host
        optimizer state (this engine's layout) loads per partition; a
        stacked one cannot be split into per-partition adam counts, so the
        moments start fresh (the restore-best contract: moments belong to
        the run that makes them).  Re-entry is a flag check."""
        if self.placed:
            return
        o = self.o
        if o._parts is None:
            o._parts = o._build_parts(range(self.pp), self._device_of)
        else:
            o._parts.embed.to(self.devices[0])
            o._parts.head.to(self.devices[-1])
            for s in range(self.pp):
                o._parts.stage(s).to(self.devices[s])
        o._params_host = None
        opt = o._opt_host
        o._opt_host = None
        self._init_opt()
        if isinstance(opt, tuple):
            for i, ((_, module, _), state, live) in enumerate(zip(
                    self._parts(), (opt[0], *opt[1], opt[2]),
                    self._opts())):
                self._counts[i] = _opt_import_one(live, o.optimizer, module,
                                                  state)
        self.placed = True

    def _init_opt(self) -> None:
        """One optimizer per partition, fresh moments."""
        o = self.o
        parts = o._parts
        o.opt_state = (
            o.optimizer.build(parts.embed.parameters()),
            [o.optimizer.build(parts.stage(s).parameters())
             for s in range(self.pp)],
            o.optimizer.build(parts.head.parameters()))
        self._counts = [0] * (self.pp + 2)

    def _opts(self) -> list:
        oe, osp, oh = self.o.opt_state
        return [oe, *osp, oh]

    def _parts(self):
        """(name, module, device) per partition, in pipeline order —
        matches :func:`partition_names`."""
        parts = self.o._parts
        yield "embed", parts.embed, self.devices[0]
        for s in range(self.pp):
            yield f"stage_{s:02d}", parts.stage(s), self.devices[s]
        yield "head", parts.head, self.devices[-1]

    def host_state(self) -> tuple:
        """(params in the JAX layout, the partitioned optimizer state:
        ``(embed, (stage_0, ...), head)`` optax adam states) on the
        host."""
        o = self.o
        parts = o._parts
        params = convert.pipeline_to_jax(
            parts.embed, [parts.stage(s) for s in range(self.pp)],
            parts.head)
        if o.opt_state is None:
            return params, None
        states = [pl._opt_export(opt, o.optimizer, module, count)
                  for (_, module, _), opt, count in zip(
                      self._parts(), self._opts(), self._counts)]
        return params, (states[0], tuple(states[1:-1]), states[-1])

    # -- programs -------------------------------------------------------------

    def _cached(self, pset, name, kind, *, module, shapes, fn,
                with_opt=False):
        """One program through the process-wide cache; the key carries the
        part (``kind`` holds a stage's index), so N stages give N
        entries."""
        from learningorchestra_tpu_torch.train import compile_cache as cc

        o = self.o
        key = cc.program_key(
            f"mpmd:{kind}", module=cc.module_fingerprint(module),
            optimizer=cc.optimizer_fingerprint(o) if with_opt else None,
            loss="softmax_ce", dtype=o.compute_dtype, shapes=shapes)
        label = f"mpmd:{type(o).__name__}:{kind}"
        prog = cc.get_cache().get_or_build(
            key, lambda: cc.Program(fn, key, label), label=label)
        pset.fns[name] = prog
        pset.keys[name] = key
        return prog

    def _prepare_train(self, mb_sz: int, seq_len: int, y_shape) -> _ProgramSet:
        sig = (mb_sz, seq_len, tuple(y_shape), self.o.compute_dtype)
        if self._train is not None and self._train.sig == sig:
            return self._train
        parts = self.o._parts
        pset = _ProgramSet(sig)
        mb = (mb_sz, seq_len)
        for kind, fn, opt in (("fwd", _embed_fwd, False),
                              ("bwd", _embed_bwd, False),
                              ("zeros", _zeros, False),
                              ("opt", _opt_step, True)):
            self._cached(pset, f"embed:{kind}", f"embed:{kind}",
                         module=parts.embed, shapes=mb, fn=fn, with_opt=opt)
        for s in range(self.pp):
            for kind, fn, opt in (("fwd", _stage_fwd, False),
                                  ("bwd", _stage_bwd, False),
                                  ("zeros", _zeros, False),
                                  ("opt", _opt_step, True)):
                self._cached(pset, (f"stage:{kind}", s),
                             f"stage:{kind}:s{s}", module=parts.stage(s),
                             shapes=mb, fn=fn, with_opt=opt)
        for kind, fn, opt in (("bwd", _head_bwd, False),
                              ("zeros", _zeros, False),
                              ("finalize", _finalize, False),
                              ("opt", _opt_step, True)):
            self._cached(pset, f"head:{kind}", f"head:{kind}",
                         module=parts.head, shapes=mb, fn=fn, with_opt=opt)
        self._train = pset
        self._batch_cost = None
        return pset

    # -- the 1F1B host schedule -----------------------------------------------

    def train_batch(self, xb: np.ndarray, yb: np.ndarray, mask: np.ndarray):
        """One optimizer step over one global batch, scheduled 1F1B
        across the stage devices: at tick t stage s forwards microbatch
        t - s, and (last stage first) backwards microbatch
        t - 2·pp + 2 + s.  Returns the batch's metrics (tensors) and its
        real-row weight."""
        o = self.o
        self.ensure_placed()
        if o.opt_state is None:  # restore-best dropped the moments
            self._init_opt()
        P, M = self.pp, int(o.n_micro)
        B = xb.shape[0]
        if B % M:
            raise ValueError(
                f"batch of {B} rows does not split into {M} microbatches")
        mb_sz = B // M
        fns = self._prepare_train(mb_sz, xb.shape[1], yb.shape[1:]).fns
        devs = self.devices
        parts = o._parts
        dtype = o._dtype()
        names = pl.metric_names(o.head)
        clock = time.perf_counter
        gw = max(float(mask.sum()), 1e-9)

        xm = torch.from_numpy(np.ascontiguousarray(xb)).reshape(
            M, mb_sz, -1)
        ym = torch.from_numpy(np.ascontiguousarray(yb)).reshape(
            M, mb_sz, *yb.shape[1:])
        mm = torch.from_numpy(np.ascontiguousarray(mask)).reshape(M, mb_sz)
        tok = xm.to(devs[0])
        km = [(xm != 0).to(devs[s]) for s in range(P)]
        y_d, w_d = ym.to(devs[-1]), mm.to(devs[-1])

        fns["embed:zeros"](parts.embed)
        for s in range(P):
            fns[("stage:zeros", s)](parts.stage(s))
        fns["head:zeros"](parts.head)
        sums = torch.zeros(len(names), device=devs[-1])
        saved = [dict() for _ in range(P)]  # (input, output) per microbatch
        inbox = [dict() for _ in range(P)]  # activations arriving
        cotbox = [dict() for _ in range(P)]  # cotangents arriving
        seeds: dict = {}
        stage_s = self._stage_s
        for t in range(M + 2 * P - 2):
            # ---- forward slots: stage s runs microbatch t - s ----
            for s in range(P):
                m = t - s
                if not 0 <= m < M:
                    continue
                t0 = clock()
                if s == 0:
                    emb = fns["embed:fwd"](parts.embed, tok[m], dtype)
                    x_in = emb.detach().requires_grad_()
                    saved[0][("emb", m)] = emb
                else:
                    x_in = inbox[s].pop(m)
                out = fns[("stage:fwd", s)](parts.stage(s), x_in, km[s][m],
                                            dtype)
                saved[s][m] = (x_in, out)
                if s + 1 < P:
                    inbox[s + 1][m] = out.detach().to(
                        devs[s + 1]).requires_grad_()
                else:
                    # 1F1B: the head + loss backward seeds microbatch m's
                    # cotangent the tick its forward completes.
                    h = out.detach().to(devs[-1]).requires_grad_()
                    seeds[m], part = fns["head:bwd"](
                        parts.head, h, y_d[m], w_d[m], gw, o._loss_fn,
                        dtype, names)
                    sums = sums + part
                stage_s[s] += clock() - t0
            # ---- backward slots: stage s runs microbatch
            # t - 2P + 2 + s (last stage first: its seed is fresh) ----
            for s in range(P - 1, -1, -1):
                m = t - 2 * P + 2 + s
                if not 0 <= m < M:
                    continue
                t0 = clock()
                cot = seeds.pop(m) if s == P - 1 else cotbox[s].pop(m)
                x_in, out = saved[s].pop(m)
                dx = fns[("stage:bwd", s)](parts.stage(s), x_in, out, cot)
                if s > 0:
                    cotbox[s - 1][m] = dx.to(devs[s - 1])
                else:
                    fns["embed:bwd"](parts.embed, saved[0].pop(("emb", m)),
                                     dx)
                stage_s[s] += clock() - t0

        progs = ([fns["embed:opt"]] + [fns[("stage:opt", s)]
                                       for s in range(P)] + [fns["head:opt"]])
        for i, ((_, module, _), prog, opt) in enumerate(zip(
                self._parts(), progs, self._opts())):
            t0 = clock()
            prog(module, opt, o.optimizer.lr(self._counts[i]))
            self._counts[i] += 1
            # The embedding's update books to stage 0, the head's to the
            # last stage.
            stage_s[min(max(i - 1, 0), P - 1)] += clock() - t0
        metrics = fns["head:finalize"](sums, names)
        return metrics, float(mask.sum())

    # -- inference ------------------------------------------------------------

    def forward_logits(self, chunk: np.ndarray) -> torch.Tensor:
        """The sequential forward across the stage devices in the compute
        dtype: tokens to stage 0, activations hop stage to stage, logits
        on the last device."""
        o = self.o
        self.ensure_placed()
        sig = ("fwd", chunk.shape, o.compute_dtype)
        parts = o._parts
        if self._fwd is None or self._fwd.sig != sig:
            pset = _ProgramSet(sig)
            self._cached(pset, "embed:fwd", "embed:fwd", module=parts.embed,
                         shapes=chunk.shape, fn=_embed_fwd)
            for s in range(self.pp):
                self._cached(pset, ("stage:fwd", s), f"stage:fwd:s{s}",
                             module=parts.stage(s), shapes=chunk.shape,
                             fn=_stage_fwd)
            self._cached(pset, "head:fwd", "head:fwd", module=parts.head,
                         shapes=chunk.shape, fn=_head_fwd)
            self._fwd = pset
        fns = self._fwd.fns
        dtype = o._dtype()
        devs = self.devices
        with torch.inference_mode():
            tok = torch.from_numpy(np.ascontiguousarray(chunk))
            h = fns["embed:fwd"](parts.embed, tok.to(devs[0]), dtype)
            for s in range(self.pp):
                h = fns[("stage:fwd", s)](parts.stage(s), h.to(devs[s]),
                                          (tok != 0).to(devs[s]), dtype)
            return fns["head:fwd"](parts.head, h.to(devs[-1]), dtype)

    # -- observability --------------------------------------------------------

    def pop_stage_seconds(self) -> list[float]:
        """Per-stage host dispatch seconds since the last call (the owner
        records them as ``mpmd.stage`` spans once per epoch)."""
        out = list(self._stage_s)
        self._stage_s = [0.0] * self.pp
        return out

    def _cost(self):
        """One ProgramCost for a whole batch: the per-microbatch programs'
        FLOPs times n_micro plus the once-per-batch programs' (each
        analyzed at its first call).  No program holds a collective, so
        the count is collective-free."""
        from learningorchestra_tpu_torch.obs import costs as obs_costs

        pset = self._train
        if self._batch_cost is not None or pset is None \
                or not obs_costs.enabled():
            return self._batch_cost
        M = int(self.o.n_micro)
        per_micro = ["embed:fwd", "embed:bwd", "head:bwd"] + [
            (k, s) for s in range(self.pp)
            for k in ("stage:fwd", "stage:bwd")]
        per_batch = ["embed:opt", "head:opt", "head:finalize"] + [
            ("stage:opt", s) for s in range(self.pp)]
        ledger = obs_costs.get_ledger()
        flops = nbytes = 0.0
        analyzed = False
        for name, mult in [(n, M) for n in per_micro] + [
                (n, 1) for n in per_batch]:
            cost = ledger.get(pset.keys[name])
            if cost is None or not cost.analyzed:
                continue
            analyzed = True
            flops += (cost.flops or 0.0) * mult
            nbytes += (cost.bytes_accessed or 0.0) * mult
        if analyzed:
            self._batch_cost = obs_costs.ProgramCost(
                key=f"mpmd:batch:{pset.keys['head:bwd'][:12]}",
                label=f"mpmd:{type(self.o).__name__}:batch",
                flops=flops or None, bytes_accessed=nbytes or None,
                analyzed=True, collectives_excluded=True)
        return self._batch_cost

    def attribute_epoch(self, epoch_s: float, n_batches: int) -> None:
        """One epoch's interval into the job's device-time entry with the
        aggregate per-stage FLOPs (collectives excluded)."""
        from learningorchestra_tpu_torch.obs import costs as obs_costs

        cost = self._cost()
        if cost is None or not obs_costs.enabled():
            return
        try:
            obs_costs.attribute(epoch_s, cost=dataclasses.replace(
                cost, flops=(cost.flops or 0.0) * n_batches or None,
                bytes_accessed=(cost.bytes_accessed or 0.0) * n_batches
                or None))
        except Exception:  # noqa: BLE001 — accounting never fails a fit
            pass

    def epoch_cost_attrs(self, epoch_s: float, n_batches: int) -> dict:
        """flops/MFU annotations of the epoch's trace span."""
        from learningorchestra_tpu_torch.obs import costs as obs_costs

        cost = self._cost()
        if cost is None or cost.flops is None:
            return {}
        flops = cost.flops * n_batches
        attrs = {"flops": flops, "collectivesExcluded": True}
        try:
            util = obs_costs.mfu(flops, epoch_s,
                                 peak_flops=obs_costs.peak_flops())
        except Exception:  # noqa: BLE001
            util = None
        if util is not None:
            attrs["mfu"] = util
        return attrs

    # -- stage-partitioned checkpoints ----------------------------------------

    def _partition_states(self) -> list:
        o = self.o
        if o.opt_state is None:  # restore-best dropped the moments
            self._init_opt()
        return [{"params": convert.params_to_jax(module),
                 "opt_state": pl._opt_export(opt, o.optimizer, module,
                                             count)}
                for (_, module, _), opt, count in zip(
                    self._parts(), self._opts(), self._counts)]

    def save_checkpoint(self, directory, step: int, history: dict,
                        *, async_save: bool = True) -> None:
        """One directory per partition, then ONE top-level marker: the
        marker publishes only after every partition committed, so a
        resuming fit never sees a torn multi-stage checkpoint."""
        from learningorchestra_tpu_torch.train import checkpoint as ckpt

        self.ensure_placed()
        d = Path(directory)
        for name, state in zip(partition_names(self.pp),
                               self._partition_states()):
            ckpt.save(d / name, step, state, history=None,
                      async_save=async_save)
        if async_save:
            for name in partition_names(self.pp):
                ckpt.finalize_async(d / name)
        ckpt.publish_marker(d, step, history)

    def resume_checkpoint(self, directory):
        """Restore every partition from the newest COMMON step (each
        partition directory has its own marker; a kill between partition
        saves resumes from the last step every stage completed).  Returns
        ``(step, history)`` or None."""
        from learningorchestra_tpu_torch.train import checkpoint as ckpt

        self.ensure_placed()
        d = Path(directory)
        steps = []
        for name in partition_names(self.pp):
            try:
                steps.append(int(json.loads(
                    (d / name / "latest.json").read_text())["step"]))
            except (OSError, ValueError, KeyError, TypeError):
                return None
        step = min(steps)
        states = []
        for (name, _, _) in self._parts():
            state = ckpt.load_step(d / name, step, device="cpu")
            if state is None:
                # The common step was pruned in one partition.
                return None
            states.append(state)
        o = self.o
        self._init_opt()
        with torch.no_grad():
            for (_, module, _), state, opt, i in zip(
                    self._parts(), states, self._opts(), range(self.pp + 2)):
                module.load_state_dict(convert.params_from_jax(
                    state["params"]))
                self._counts[i] = _opt_import_one(opt, o.optimizer, module,
                                                  state["opt_state"])
        history: dict = {}
        try:
            marker = json.loads((d / "latest.json").read_text())
            if int(marker.get("step", -1)) == step:
                history = marker.get("history") or {}
        except (OSError, ValueError):
            history = {}
        return step, history

    def finalize_checkpoints(self, directory) -> None:
        from learningorchestra_tpu_torch.train import checkpoint as ckpt

        d = Path(directory)
        for name in partition_names(self.pp):
            ckpt.finalize_async(d / name)


def _opt_import_one(opt, spec, module, state) -> int:
    """One partition's optax-layout state into its optimizer; returns its
    count."""
    count = pl._opt_count(state)
    pl._opt_import(opt, spec, [(module, {k: v for k, v in state.items()
                                         if k != "count"})], count)
    return count
