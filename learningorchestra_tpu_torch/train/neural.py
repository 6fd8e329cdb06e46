"""NeuralEstimator — port of ``learningorchestra_tpu/train/neural.py``:
keras-``fit`` semantics over a PyTorch train loop.

Parameters live on the estimator's device from construction (seeded from
a ``torch.Generator`` on the CPU, so one seed gives the same weights on
every device; modules that size themselves from the first input, like the
MLP, are built and seeded at the first ``fit``).  Training follows the JAX
package's policies:

- **mixed precision as the reference does it**: the optimizer holds f32
  master weights; each step casts them to bf16 *inside* the differentiated
  objective (``torch.func.functional_call`` on a dict of bf16 copies), so
  the gradients arrive in f32 on the masters.  Every op then computes in
  bf16 as flax's promoted modules do; ``torch.autocast`` would keep
  LayerNorm, softmax and the residual adds in f32 instead.  Evaluation
  applies the same cast; ``predict`` stays f32;
- **the device epoch** (``_device_epoch_raw``): the dataset is uploaded
  once, each epoch permutes on the device from a generator seeded by
  (seed, epoch), pads the tail by cycling the order (mask 0 rows), runs
  the batches and makes one host transfer of the metrics; epoch metrics
  are the mean of the per-batch metrics;
- **optimizers** are the optax names with optax's defaults
  (:func:`resolve_optimizer`): adam, adamw, sgd and adagrad on
  ``torch.optim``; rmsprop, lamb, lion, novograd and radam written after
  optax's update rules, per parameter (= per flax leaf); schedules are
  plain functions of the update count, optax's convention (step 0 is the
  first update); ``accumulate_steps`` has ``optax.MultiSteps`` semantics.

``predict`` pads its ragged tail to a power-of-two bucket as the JAX
estimator does; ``state_dict``/``load_state_dict`` keep the JAX package's
artifact layout: the flax-shaped numpy tree (with ``QuantizedLeaf``s where
``quantize_pytree`` puts them) and the optimizer state as plain dicts in
the optax layout.  ``fit(checkpoint_dir=...)`` saves that state every N
epochs through ``train/checkpoint.py`` and resumes from the newest
committed step.

Sharded datasets (``store/sharded.py``) stream: ``fit`` runs one device
epoch per shard, the next shard loading and uploading on a side stream
meanwhile; ``evaluate`` weights each shard's metrics by its rows;
``predict`` on a bare dataset feeds the columns the streaming fit
trained on (``sharded_fit_cols`` in the artifact state).  The shard order
is the JAX package's (numpy, seeded by (seed, 3, epoch)); the in-shard
order comes from a ``torch.Generator``, since the port cannot draw
threefry's bits.

An artifact is a plain dict (:meth:`NeuralEstimator.to_artifact`) naming
its class through the registry; :func:`load_artifact` rebuilds it on any
device.

Programs resolve through the process-wide program cache
(train/compile_cache.py) under the JAX package's kinds: ``epoch_fns`` (the
evaluate program), ``device_epoch`` keyed by (n, batch size, shuffle) for
the in-memory fit and by each distinct shard length for the streaming
fit, and ``apply`` per rows bucket for predict.  Each program takes the
estimator (or module) as an argument, so two estimators of one
architecture share it.  A program's first call is counted for FLOPs
(obs/costs.py), and each in-memory epoch's device interval (CUDA events
on the card, the host clock on the CPU) is attributed to the job.  The
programs stay eager: the optimizer's host-side learning rate and counts
and the autograd kernels make capturing a training step a design of its
own.

Each epoch starts at the ``train.epoch`` fault point (faults/plane.py; a
``preempt`` schedule there is how a drill preempts a fit mid-way, and the
engine's retry resumes its checkpoint) and ends as an ``epoch`` span of
the job's trace (obs/tracing.py), both on the host clock alone.
"""

from __future__ import annotations

import logging
import math
import re
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from learningorchestra_tpu_torch import convert, faults
from learningorchestra_tpu_torch.device import resolve_device
from learningorchestra_tpu_torch.jobs.cancel import cancel_requested
from learningorchestra_tpu_torch.obs import costs, tracing
from learningorchestra_tpu_torch.ops.layers import (
    MultiHeadSelfAttention,
    has_separate_qkv,
    migrate_separate_qkv,
)
from learningorchestra_tpu_torch.ops.moe import AuxLosses
from learningorchestra_tpu_torch.ops.quant import (
    dequantize_pytree,
    has_quantized_leaves,
    quantize_pytree,
)
from learningorchestra_tpu_torch.serve.bucketing import bucket_for, pad_rows
from learningorchestra_tpu_torch.toolkit import registry
from learningorchestra_tpu_torch.toolkit.base import Estimator, as_array
from learningorchestra_tpu_torch.train import aot_store
from learningorchestra_tpu_torch.train import checkpoint as ckpt
from learningorchestra_tpu_torch.train import compile_cache as cc

_log = logging.getLogger("learningorchestra_tpu_torch.train")


def init_params(module: nn.Module, seed: int) -> None:
    """Seeded init in module order, flax's defaults in distribution:
    Linear and conv weights N(0, 1/fan_in) (lecun scale; a conv's fan in
    is kh*kw*cin/groups), an LSTM cell's recurrent kernels orthogonal,
    embeddings N(0, 1/features), zero biases, unit norm scales."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                if getattr(mod, "init", "lecun") == "orthogonal":
                    nn.init.orthogonal_(mod.weight, generator=gen)
                else:
                    mod.weight.copy_(torch.randn(
                        mod.weight.shape, generator=gen
                    ) / math.sqrt(mod.weight[0].numel()))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.copy_(torch.randn(
                    mod.weight.shape, generator=gen
                ) / math.sqrt(mod.embedding_dim))
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif hasattr(mod, "init_leaves"):
                # Raw parameters of the module's own (an MoE layer's
                # expert leaves) seed themselves.
                mod.init_leaves(gen)


# -- learning-rate schedules and optimizers ----------------------------------


def _spec_get(spec: dict, snake: str, default=None, *, required=False):
    """Read a spec key in snake_case OR camelCase — REST bodies use
    camelCase (vocabSize, maxLen) while Python callers write snake."""
    camel = re.sub(r"_(\w)", lambda m: m.group(1).upper(), snake)
    for key in (snake, camel):
        if key in spec:
            return spec[key]
    if required:
        raise ValueError(f"learning-rate schedule needs {snake!r}")
    return default


def _linear(init_value, end_value, transition_steps):
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count):
        frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def _cosine(init_value, decay_steps, alpha=0.0):
    if not decay_steps > 0:
        raise ValueError(
            "The cosine_decay_schedule requires positive decay_steps, got "
            f"decay_steps={decay_steps}."
        )

    def schedule(count):
        count = min(count, decay_steps)
        decay = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * decay + alpha)

    return schedule


def _warmup_cosine(init_value, peak_value, warmup_steps, decay_steps,
                   end_value=0.0):
    warm = _linear(init_value, peak_value, warmup_steps)
    cool = _cosine(peak_value, decay_steps - warmup_steps,
                   0.0 if peak_value == 0.0 else end_value / peak_value)
    return lambda count: warm(count) if count < warmup_steps else \
        cool(count - warmup_steps)


def _exponential(init_value, transition_steps, decay_rate, staircase=False):
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: init_value

    def schedule(count):
        p = count / transition_steps
        if staircase:
            p = math.floor(p)
        return init_value if count <= 0 else init_value * decay_rate ** p

    return schedule


def _piecewise(init_value, boundaries_and_scales):
    if any(scale < 0.0 for scale in boundaries_and_scales.values()):
        raise ValueError(
            "`piecewise_constant_schedule` expects non-negative scale factors"
        )

    def schedule(count):
        v = init_value
        for threshold, scale in sorted(boundaries_and_scales.items()):
            if count >= threshold:
                v *= scale
        return v

    return schedule


def resolve_learning_rate(lr):
    """A float passes through; a dict becomes a schedule, a plain function
    of the optimizer's update count (optax's convention: step 0 is the
    first update) with optax's formulas:

        {"schedule": "warmup_cosine", "peakValue": 3e-4,
         "warmupSteps": 500, "decaySteps": 10000}

    Kinds: constant, warmup_cosine, cosine, exponential, piecewise.
    """
    if not isinstance(lr, dict):
        return float(lr)
    kind = str(lr.get("schedule", "")).lower()
    if kind in ("warmup_cosine", "warmupcosine"):
        return _warmup_cosine(
            float(_spec_get(lr, "init_value", 0.0)),
            float(_spec_get(lr, "peak_value", required=True)),
            int(_spec_get(lr, "warmup_steps", required=True)),
            int(_spec_get(lr, "decay_steps", required=True)),
            float(_spec_get(lr, "end_value", 0.0)),
        )
    if kind == "cosine":
        return _cosine(
            float(_spec_get(lr, "init_value", required=True)),
            int(_spec_get(lr, "decay_steps", required=True)),
            float(_spec_get(lr, "alpha", 0.0)),
        )
    if kind == "exponential":
        return _exponential(
            float(_spec_get(lr, "init_value", required=True)),
            int(_spec_get(lr, "transition_steps", required=True)),
            float(_spec_get(lr, "decay_rate", required=True)),
            bool(_spec_get(lr, "staircase", False)),
        )
    if kind == "piecewise":
        # JSON object keys are strings; the schedule wants {int step: scale}.
        raw = _spec_get(lr, "boundaries_and_scales", required=True)
        return _piecewise(
            float(_spec_get(lr, "init_value", required=True)),
            {int(k): float(v) for k, v in dict(raw).items()},
        )
    if kind == "constant":
        return float(_spec_get(lr, "value", required=True))
    raise ValueError(
        f"unknown learning-rate schedule {lr.get('schedule')!r}; "
        "expected warmup_cosine | cosine | exponential | piecewise | "
        "constant"
    )


class _RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop``: nu = decay*nu + (1-decay)*g^2, update
    -lr * g / sqrt(nu + eps), then an optional momentum trace of the
    scaled updates.  ``torch.optim.RMSprop`` adds eps outside the root,
    which moves early steps by percents when nu starts at 0."""

    def __init__(self, params, lr, decay=0.9, eps=1e-8, initial_scale=0.0,
                 momentum=None, nesterov=False):
        super().__init__(params, dict(
            lr=lr, decay=decay, eps=eps, initial_scale=initial_scale,
            momentum=momentum, nesterov=nesterov,
        ))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["nu"] = torch.full_like(p, group["initial_scale"])
                    if group["momentum"]:
                        st["trace"] = torch.zeros_like(p)
                g = p.grad
                nu = st["nu"]
                nu.mul_(group["decay"]).addcmul_(g, g,
                                                 value=1 - group["decay"])
                upd = g / torch.sqrt(nu + group["eps"]) * -group["lr"]
                if group["momentum"]:
                    trace = st["trace"]
                    trace.mul_(group["momentum"]).add_(upd)
                    upd = upd + group["momentum"] * trace \
                        if group["nesterov"] else trace
                p.add_(upd)


def _adam(params, lr, b1=0.9, b2=0.999, eps=1e-8):
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps)


def _adamw(params, lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4):
    # optax adds wd*p to the update before the lr scale; torch decays p by
    # lr*wd first: the same step.  Default 1e-4 is optax's (torch: 1e-2).
    return torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


def _sgd(params, lr, momentum=None, nesterov=False):
    return torch.optim.SGD(params, lr=lr, momentum=momentum or 0.0,
                           nesterov=nesterov)


def _adagrad(params, lr, initial_accumulator_value=0.1, eps=1e-7):
    # optax's defaults (torch: 0 and 1e-10).  optax takes the root of
    # (sum + eps), torch adds eps after the root: with the 0.1 start the
    # two differ by under 1e-6 relative.
    return torch.optim.Adagrad(
        params, lr=lr, initial_accumulator_value=initial_accumulator_value,
        eps=eps,
    )


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _decay_pow(decay: float, count: int) -> torch.Tensor:
    """``decay**count`` as optax gets it from XLA: the f32 power of the
    f32 decay, rounded once (torch's f32 ``pow`` is an ulp off at some
    counts, and radam's ro magnifies an ulp of it ~2,000 times)."""
    return _f32(float(_f32(decay)) ** count)


def _bias_correction(decay: float, count: int) -> float:
    """optax's ``1 - decay**count``, in f32 as optax computes it (the
    f64 value differs by 1e-5 relative at decay 0.999)."""
    return float(1 - _decay_pow(decay, count))


class _OptaxStep(torch.optim.Optimizer):
    """Base of the optimizers written after optax's update rules: each
    parameter's slots live in its state under optax's field names, and
    ``step`` counts updates (optax's ``count``) as a float tensor, as
    ``torch.optim`` keeps it.  ``_update(group, p, g, st, count)``
    returns the update; the step adds ``-lr * update``."""

    slots: tuple = ()

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if "step" not in st:
                    st["step"] = torch.tensor(0.0)
                    for slot in self.slots:
                        st[slot] = torch.zeros_like(p)
                st["step"] += 1
                upd = self._update(group, p, p.grad, st, int(st["step"]))
                p.add_(upd, alpha=-group["lr"])


def _adam_moments(g, st, b1: float, b2: float) -> None:
    st["mu"].mul_(b1).add_(g, alpha=1 - b1)
    st["nu"].mul_(b2).addcmul_(g, g, value=1 - b2)


class _Lamb(_OptaxStep):
    """``optax.lamb``: Adam's direction (eps outside the root) plus
    ``weight_decay * p``, scaled by the trust ratio ||p|| / ||update|| of
    each parameter (1 where either norm is 0)."""

    slots = ("mu", "nu")

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0,
                 weight_decay=0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      eps_root=eps_root,
                                      weight_decay=weight_decay))

    def _update(self, group, p, g, st, count):
        b1, b2 = group["b1"], group["b2"]
        _adam_moments(g, st, b1, b2)
        mu_hat = st["mu"] / _bias_correction(b1, count)
        nu_hat = st["nu"] / _bias_correction(b2, count)
        upd = mu_hat / (torch.sqrt(nu_hat + group["eps_root"]) +
                        group["eps"])
        if group["weight_decay"]:
            upd = upd + group["weight_decay"] * p
        p_norm = torch.linalg.vector_norm(p)
        u_norm = torch.linalg.vector_norm(upd)
        ratio = torch.where((p_norm == 0) | (u_norm == 0),
                            torch.ones_like(p_norm), p_norm / u_norm)
        return upd * ratio


class _Lion(_OptaxStep):
    """``optax.lion``: sign((1-b1) g + b1 mu) + weight_decay * p, then
    mu <- b2 mu + (1-b2) g."""

    slots = ("mu",)

    def __init__(self, params, lr, b1=0.9, b2=0.99, weight_decay=1e-3):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2,
                                      weight_decay=weight_decay))

    def _update(self, group, p, g, st, count):
        b1, b2 = group["b1"], group["b2"]
        mu = st["mu"]
        upd = torch.sign((1.0 - b1) * g + b1 * mu)
        mu.mul_(b2).add_(g, alpha=1 - b2)
        return upd + group["weight_decay"] * p


class _Novograd(_OptaxStep):
    """``optax.novograd``: nu is ONE scalar per parameter, the EMA of
    ||g||^2 (its first value ||g||^2 itself); mu <- b1 mu + g / (sqrt(nu)
    + eps) + weight_decay * p (its first value without the b1 mu term).
    The parameter is the flax leaf, so the LSTM's gates are separate."""

    slots = ("mu",)

    def __init__(self, params, lr, b1=0.9, b2=0.25, eps=1e-6, eps_root=0.0,
                 weight_decay=0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      eps_root=eps_root,
                                      weight_decay=weight_decay))

    def _update(self, group, p, g, st, count):
        sq = torch.linalg.vector_norm(g) ** 2
        if count == 1:
            st["nu"] = sq
        else:
            st["nu"] = (1 - group["b2"]) * sq + group["b2"] * st["nu"]
        upd = g / (torch.sqrt(st["nu"] + group["eps_root"]) + group["eps"])
        if group["weight_decay"]:
            upd = upd + group["weight_decay"] * p
        mu = st["mu"]
        if count == 1:
            mu.copy_(upd)
        else:
            mu.mul_(group["b1"]).add_(upd)
        return mu


class _RAdam(_OptaxStep):
    """``optax.radam``: Adam's moments; while the variance's tractability
    ro is below ``threshold`` the update is the bias-corrected mu alone,
    after that r * mu_hat / (sqrt(nu_hat) + eps).  ro and r are computed
    in f32 in optax's order: ro cancels two numbers near 2/(1-b2), so its
    f64 value is a different number."""

    slots = ("mu", "nu")

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                 threshold=5.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      eps_root=eps_root,
                                      threshold=threshold))

    @staticmethod
    def _rectifier(b2: float, count: int):
        """(ro, r) of update ``count``, as f32 scalars on the host."""
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = _decay_pow(b2, count)
        ro = ro_inf - (2 * count) * b2t / (1 - b2t)
        r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                       / (((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
        return float(ro), float(r)

    def _update(self, group, p, g, st, count):
        b1, b2 = group["b1"], group["b2"]
        _adam_moments(g, st, b1, b2)
        mu_hat = st["mu"] / _bias_correction(b1, count)
        ro, r = self._rectifier(b2, count)
        if ro < group["threshold"]:
            return mu_hat
        nu_hat = st["nu"] / _bias_correction(b2, count)
        return r * mu_hat / (torch.sqrt(nu_hat + group["eps_root"]) +
                             group["eps"])


# name -> (factory, {optax state field: torch state key})
_OPTIMIZERS = {
    "adam": (_adam, {"mu": "exp_avg", "nu": "exp_avg_sq"}),
    "adamw": (_adamw, {"mu": "exp_avg", "nu": "exp_avg_sq"}),
    "sgd": (_sgd, {"trace": "momentum_buffer"}),
    "rmsprop": (_RMSprop, {"nu": "nu", "trace": "trace"}),
    "adagrad": (_adagrad, {"sum_of_squares": "sum"}),
    "lamb": (_Lamb, {"mu": "mu", "nu": "nu"}),
    "lion": (_Lion, {"mu": "mu"}),
    "novograd": (_Novograd, {"mu": "mu", "nu": "nu"}),
    "radam": (_RAdam, {"mu": "mu", "nu": "nu"}),
}


class OptimizerSpec:
    """A resolved optimizer: a ``torch.optim`` factory with optax's
    defaults, its kwargs, and the learning rate (a float or a schedule)."""

    def __init__(self, name: str, learning_rate, **kwargs):
        self.name = name
        self.factory, self.slots = _OPTIMIZERS[name]
        self.learning_rate = learning_rate
        self.kwargs = kwargs

    def lr(self, count: int) -> float:
        """The learning rate of update number ``count`` (from 0)."""
        lr = self.learning_rate
        return float(lr(count) if callable(lr) else lr)

    def build(self, params) -> torch.optim.Optimizer:
        return self.factory(params, self.lr(0), **self.kwargs)

    def __repr__(self) -> str:
        return f"OptimizerSpec({self.name!r}, {self.kwargs})"


def resolve_optimizer(optimizer, learning_rate=1e-3) -> OptimizerSpec:
    """Turn a REST-expressible optimizer spec into an :class:`OptimizerSpec`.

    ``optimizer`` may be: None (adam at ``learning_rate``), an
    ``OptimizerSpec`` (passed through), a name string ("sgd"), or a dict
    ``{"name": "adamw", "learningRate": ..., "weightDecay": 1e-2}`` —
    extra keys forward to the factory (snake or camelCase) under optax's
    names and defaults; the learning rate itself may be a schedule spec
    (:func:`resolve_learning_rate`).
    """
    if optimizer is None:
        return OptimizerSpec("adam", resolve_learning_rate(learning_rate))
    if isinstance(optimizer, OptimizerSpec):
        return optimizer
    if isinstance(optimizer, str):
        optimizer = {"name": optimizer}
    if not isinstance(optimizer, dict):
        raise TypeError(
            f"optimizer must be a name, a dict spec or an OptimizerSpec, got "
            f"{type(optimizer).__name__}"
        )
    spec = dict(optimizer)
    name = str(spec.pop("name", "") or "").lower()
    if name not in _OPTIMIZERS:
        raise ValueError(
            f"unknown optimizer {name!r}; expected one of "
            f"{sorted(_OPTIMIZERS)}"
        )
    lr = None
    for key in ("learning_rate", "learningRate"):
        if key in spec:
            lr = spec.pop(key)
    if lr is None:
        lr = learning_rate
    kwargs = {
        re.sub(r"([A-Z])", lambda m: "_" + m.group(1).lower(), k): v
        for k, v in spec.items()
    }
    out = OptimizerSpec(name, resolve_learning_rate(lr), **kwargs)
    out.build([torch.zeros(1, requires_grad=True)])  # reject bad kwargs now
    return out


# -- fit plumbing --------------------------------------------------------------


class TrainHistory(dict):
    """keras-History-shaped: {"loss": [...], "accuracy": [...], ...}."""

    def append(self, metrics: dict) -> None:
        for key, val in metrics.items():
            self.setdefault(key, []).append(float(val))


def build_stop_callbacks(owner, callbacks, early_stopping) -> list:
    """Normalize the callback list, fold in an ``early_stopping`` spec,
    reset reused EarlyStopping instances, clear ``owner.stop_training``."""
    owner.stop_training = False
    cbs = list(callbacks or [])
    # False is the natural JSON off-toggle mirroring True.
    if early_stopping is not None and early_stopping is not False:
        cbs.append(EarlyStopping.from_spec(early_stopping))
    for cb in cbs:
        if isinstance(cb, EarlyStopping):
            cb.reset()
    return cbs


def snapshot_params(params: dict) -> dict:
    """Device-side copy of a parameter dict for best-weights rollback."""
    return {k: v.detach().clone() for k, v in params.items()}


class EarlyStopping:
    """Keras-parity early stopping, usable as a fit callback or (as a
    JSON dict via the REST train surface) the ``early_stopping`` fit
    parameter.

    ``monitor=None`` picks ``val_loss`` when validation runs, else
    ``loss``.  ``mode="auto"`` minimizes unless the metric name looks
    like accuracy/F1.  ``restore_best_weights=True`` snapshots the best
    epoch's params (a device-side copy: the live tensors are updated in
    place by the optimizer)."""

    def __init__(self, monitor: str | None = None, patience: int = 0,
                 min_delta: float = 0.0, mode: str = "auto",
                 restore_best_weights: bool = False, baseline=None):
        if mode not in ("auto", "min", "max"):
            raise ValueError(f"mode must be auto|min|max, got {mode!r}")
        self.monitor = monitor
        self.patience = int(patience)
        self.min_delta = abs(float(min_delta))
        self.mode = mode
        self.restore_best_weights = bool(restore_best_weights)
        self.baseline = baseline
        self.reset()

    def reset(self) -> None:
        """Clear per-run state, so a reused instance carries nothing from a
        previous fit."""
        self.best = None
        self.best_params = None
        self.best_epoch = None
        self.wait = 0
        self._warned_missing = False

    @classmethod
    def from_spec(cls, spec) -> "EarlyStopping":
        """Build from a REST-JSON dict (snake_case or camelCase)."""
        if isinstance(spec, cls):
            return spec
        if spec is True:
            return cls()
        spec = dict(spec)
        kw = {}
        for snake in ("monitor", "patience", "min_delta", "mode",
                      "restore_best_weights", "baseline"):
            val = _spec_get(spec, snake)
            if val is not None:
                kw[snake] = val
        return cls(**kw)

    def _resolve(self, metrics: dict) -> tuple[str, bool]:
        name = self.monitor or (
            "val_loss" if "val_loss" in metrics else "loss"
        )
        if self.mode != "auto":
            minimize = self.mode == "min"
        else:
            minimize = not any(
                tag in name for tag in ("acc", "f1", "auc", "precision",
                                        "recall")
            )
        return name, minimize

    def __call__(self, epoch: int, metrics: dict, model) -> None:
        name, minimize = self._resolve(metrics)
        if name not in metrics:
            if not self._warned_missing:
                self._warned_missing = True
                _log.warning(
                    "EarlyStopping monitor %r not in metrics %s — "
                    "early stopping is inactive this fit",
                    name, sorted(metrics),
                )
            return
        value = float(metrics[name])
        if self.best is None and self.baseline is not None:
            # keras semantics: with a baseline, the first "best" to beat
            # is the baseline itself, not the first epoch's value.
            self.best = float(self.baseline)
        improved = (
            self.best is None
            or (value < self.best - self.min_delta if minimize
                else value > self.best + self.min_delta)
        )
        if improved:
            self.best, self.best_epoch, self.wait = value, epoch, 0
            if self.restore_best_weights:
                self.best_params = snapshot_params(model.params)
        else:
            self.wait += 1
        # keras parity: patience=N stops after N consecutive
        # non-improving epochs (patience=0 → the first one).
        if self.wait >= max(1, self.patience):
            model.stop_training = True
            if self.restore_best_weights and self.best_params is not None:
                model.params = self.best_params
                model.opt_state = None  # moments belong to later epochs


def _batch_data(x: np.ndarray, y: np.ndarray, batch_size: int, rng):
    """Shuffle + pad to a whole number of batches; returns (xb, yb, mask)
    with shapes (n_batches, bs, ...).  Padding rows carry mask 0 so metrics
    and gradients ignore them."""
    n = x.shape[0]
    if n == 0:
        raise ValueError("cannot batch an empty dataset")
    perm = rng.permutation(n)
    n_batches = max(1, -(-n // batch_size))
    pad = n_batches * batch_size - n
    # np.resize cycles perm, so pad may exceed n (tiny datasets).
    idx = np.concatenate([perm, np.resize(perm, pad)]) if pad else perm
    mask = np.ones(n_batches * batch_size, np.float32)
    if pad:
        mask[n:] = 0.0
    xb = x[idx].reshape(n_batches, batch_size, *x.shape[1:])
    yb = y[idx].reshape(n_batches, batch_size, *y.shape[1:])
    mb = mask.reshape(n_batches, batch_size)
    return xb, yb, mb


class _NoShuffle:
    """Identity 'rng' for deterministic batching."""

    def permutation(self, n: int):
        return np.arange(n)


def _is_sharded(obj) -> bool:
    """A sharded dataset or view (both expose ``load_shard``), or a tuple
    holding one."""
    if isinstance(obj, tuple):
        return any(_is_sharded(o) for o in obj)
    return hasattr(obj, "load_shard")


def _sharded():
    """``store/sharded.py``, imported at first use: the store package
    imports this module."""
    from learningorchestra_tpu_torch.store import sharded

    return sharded


class _ShardStream:
    """Streams the shards of an x/y view pair to the device, shard k+1's
    disk read and host-to-device copy overlapping shard k's compute.

    An IO thread loads a shard's ``.npz``, narrows x as ``as_array`` does
    (token ids stay integer) and casts y to the loss's dtype.  On the card
    it copies both into pinned host memory, starts non-blocking copies on
    a side stream and records an event; it waits for that event itself,
    so a pinned buffer is freed only once its copy is done.  The compute
    stream waits on the event and the tensors are recorded on it
    (``record_stream``), so the allocator reuses their memory only after
    the compute that reads them.  At most two shards are resident: the
    one computing and the one loading.  ``stats["shard_wait_s"]`` holds,
    per pass, the seconds the compute side waited for its shards."""

    def __init__(self, x, y, y_dtype, device):
        self.x, self.y, self.y_dtype = x, y, y_dtype
        self.dataset = x.dataset
        self.device = device
        self._io = ThreadPoolExecutor(max_workers=1,
                                      thread_name_prefix="shard-io")
        self._side = torch.cuda.Stream(device) \
            if device.type == "cuda" else None
        self.stats: dict = {"shard_wait_s": []}

    def _load(self, k: int):
        xs = np.ascontiguousarray(as_array(self.x.load_shard(k)))
        ys = np.ascontiguousarray(self.y.load_shard(k).astype(self.y_dtype))
        if self._side is None:
            return (torch.from_numpy(xs).to(self.device),
                    torch.from_numpy(ys).to(self.device), None)
        with torch.cuda.device(self.device), torch.cuda.stream(self._side):
            xd = torch.from_numpy(xs).pin_memory().to(self.device,
                                                      non_blocking=True)
            yd = torch.from_numpy(ys).pin_memory().to(self.device,
                                                      non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._side)
        done.synchronize()
        return xd, yd, done

    def shards(self, order):
        """Yield ``(position, shard, x, y)`` in ``order``, the next shard
        loading meanwhile."""
        wait = 0.0
        nxt = self._io.submit(self._load, int(order[0]))
        for pos, k in enumerate(order):
            t0 = time.perf_counter()
            xd, yd, done = nxt.result()
            wait += time.perf_counter() - t0
            if done is not None:
                compute = torch.cuda.current_stream(self.device)
                compute.wait_event(done)
                xd.record_stream(compute)
                yd.record_stream(compute)
            if pos + 1 < len(order):
                nxt = self._io.submit(self._load, int(order[pos + 1]))
            yield pos, int(k), xd, yd
            del xd, yd
        self.stats["shard_wait_s"].append(wait)

    def close(self) -> None:
        self._io.shutdown(wait=True)


def _cast_params(module: nn.Module, dtype) -> dict:
    """The module's parameters by name, f32 ones cast to ``dtype`` (None:
    as they are).  The MoE router keeps full-precision weights, as the
    JAX package's ``_param_cast_for`` exempts it."""
    out = {}
    for name, p in module.named_parameters():
        if dtype is not None and p.dtype == torch.float32 and \
                "router" not in name.lower():
            p = p.to(dtype)
        out[name] = p
    return out


def _cast_input(xb: torch.Tensor, dtype) -> torch.Tensor:
    return xb.to(dtype) if dtype is not None and xb.is_floating_point() \
        else xb


def _finalize_metrics(per_batch: list[dict], dp=None) -> dict:
    """Batch-mean the per-step metrics with ONE host transfer, then
    'perplexity' (raw per-token CE) becomes exp(mean CE).  Under data
    parallelism (``dp``, parallel/distributed.py) each rank's metrics are
    its rows' share of the global batch's masked mean, so one all-reduce
    sum of the whole epoch's metrics over one rank per replica gives every
    rank the global ones."""
    keys = list(per_batch[0])
    stacked = torch.stack([torch.stack([m[k] for k in keys])
                           for m in per_batch]).float()
    if dp is not None:
        stacked = dp.replica_sum(stacked)
    # The epoch's one host transfer, its metrics:
    # lo-check: disable=jit-host-sync
    out = dict(zip(keys, stacked.mean(0).cpu().tolist()))
    if "perplexity" in out:
        out["perplexity"] = math.exp(out["perplexity"])
    return out


def _cached_program(kind: str, est, loss_kind, *, shapes=None, mesh=None,
                    donate=None, fn, analyze: bool = True) -> cc.Program:
    """Fetch (or build once) the program ``fn`` through the process-wide
    program cache, keyed by the estimator's architecture, optimizer, loss
    and compute dtype plus what the program is specialised to.  A rank of
    a data-parallel fit keys on its mesh too (axis names, sizes, the
    device list).  ``fn`` takes the estimator (or module) as an argument,
    so the program never closes over one estimator's weights."""
    if mesh is None and est._dp is not None:
        mesh = est._dp.mesh_key
    key = cc.program_key(
        kind,
        module=cc.module_fingerprint(est.module),
        optimizer=cc.optimizer_fingerprint(est),
        loss=loss_kind,
        dtype=est.compute_dtype,
        shapes=shapes,
        mesh=mesh,
        donate=donate,
    )
    label = f"{kind}:{type(est.module).__name__}"
    return cc.get_cache().get_or_build(
        key, lambda: cc.Program(fn, key, label, analyze=analyze),
        label=label)


@aot_store.program_function
def _device_epoch_program(est, xs, ys, loss_fn, dtype, batch_size: int,
                          shuffle: bool, key: int) -> dict:
    """The ``device_epoch`` program: one epoch over a device-resident
    dataset (:meth:`NeuralEstimator._device_epoch`)."""
    return est._device_epoch(xs, ys, loss_fn, dtype, batch_size, shuffle,
                             key)


@aot_store.program_function
def _evaluate_program(est, x, y, batch_size: int, loss_kind) -> dict:
    """The ``epoch_fns`` program: metrics over padded batches
    (:meth:`NeuralEstimator._evaluate_batches`)."""
    return est._evaluate_batches(x, y, batch_size, loss_kind)


@aot_store.program_function
def _apply_program(module: nn.Module, x: np.ndarray) -> np.ndarray:
    """The ``apply`` program: one f32 forward of a host batch on the
    module's device, in one transfer; host f32 outputs."""
    device = next(module.parameters()).device
    with torch.inference_mode():
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(device)
        # The program's host output, in one transfer:
        # lo-check: disable=jit-host-sync
        return module(xt).float().cpu().numpy()


def apply_program(module: nn.Module, rows: int, *,
                  label: str | None = None) -> cc.Program:
    """The cached ``apply`` program of ``module``'s architecture for a
    ``rows``-row bucket (``compile_cache.apply_program_key``): predict and
    serving share it, and the cache's misses count buckets."""
    key = cc.apply_program_key(module, rows=rows)
    label = label or f"apply:{type(module).__name__}:b{rows}"
    return cc.get_cache().get_or_build(
        key, lambda: cc.Program(_apply_program, key, label), label=label)


class NeuralEstimator(Estimator):
    """Wraps a ``nn.Module`` with fit/evaluate/predict/save/load."""

    # The executor gives ``fit`` a managed checkpoint directory (and
    # resume semantics) for any estimator that declares this.
    supports_managed_checkpoints = True
    # In a rank process of a data-parallel fit, the rank's
    # ``parallel.distributed.DataParallel``; None everywhere else.
    _dp = None

    def __init__(self, module: nn.Module, *, loss: str = "auto",
                 optimizer: Any = None, learning_rate: float = 1e-3,
                 seed: int = 0, compute_dtype: str = "bfloat16",
                 device="cuda"):
        self.device = resolve_device(device)
        self.module = module
        self.loss = loss  # auto | softmax_ce | sigmoid_ce | mse
        self.learning_rate = learning_rate
        self.seed = seed
        self.compute_dtype = compute_dtype
        self.optimizer = resolve_optimizer(optimizer, learning_rate)
        # The declarative spec (name/dict/None=adam), so a later
        # compile(learning_rate=...) can rebuild the SAME optimizer kind.
        self._optimizer_spec = (
            optimizer if isinstance(optimizer, (str, dict))
            else ({"name": "adam"} if optimizer is None else None)
        )
        self.opt_state: torch.optim.Optimizer | None = None
        self._updates = 0  # optimizer updates made (optax's count)
        self._mini_step = 0  # batches accumulated towards the next update
        self._accumulate_steps = 1
        self.stop_training = False  # callbacks may set True mid-fit
        self.history = TrainHistory()
        # The feature columns of the last streaming fit, and its shard
        # waits (``_ShardStream.stats``).
        self._sharded_fit_cols: list[str] | None = None
        self.stream_stats: dict | None = None
        self._invalidate_programs()
        init_params(module, seed)
        module.to(self.device).eval()

    # -- parameters -------------------------------------------------------------

    @property
    def params(self) -> dict:
        """The live parameters by name (the optimizer updates them)."""
        return dict(self.module.named_parameters())

    @params.setter
    def params(self, values: dict) -> None:
        with torch.no_grad():
            for name, p in self.module.named_parameters():
                p.copy_(values[name])

    def _init_params(self, x0: np.ndarray) -> None:
        """Hook for modules that size themselves from the first input
        (flax's ``module.init``); parameters of fixed-size modules exist
        from construction."""

    def _invalidate_programs(self) -> None:
        """Drop this estimator's references to its cached programs; the
        next fit, evaluate or predict resolves them again through the
        cache (a hit when nothing that keys them changed)."""
        self._eval_fn = None
        self._eval_loss_kind = None
        self._device_epoch_prog = None
        self._device_epoch_key = None
        self._apply_fns: dict = {}

    def _reset_optimizer(self) -> None:
        """Fresh optimizer state (moments from zero, count 0, no pending
        accumulated gradients)."""
        self.module.zero_grad(set_to_none=True)
        self.opt_state = self.optimizer.build(self.module.parameters())
        self._updates = 0
        self._mini_step = 0

    # -- keras-compile parity -------------------------------------------------

    def compile(self, optimizer=None, loss: str | None = None,
                learning_rate=None, **kw) -> None:
        """Reconfigure optimizer/loss.  ``optimizer`` accepts an
        ``OptimizerSpec``, a name string, or a REST-JSON dict spec
        (:func:`resolve_optimizer`); ``learning_rate`` (or camelCase
        ``learningRate``) alone rebuilds the current optimizer kind at
        the new rate/schedule."""
        if learning_rate is None:
            learning_rate = kw.pop("learningRate", None)
        if optimizer is None and learning_rate is not None:
            spec = self._optimizer_spec
            if spec is None:
                raise ValueError(
                    "current optimizer is an OptimizerSpec whose rate is "
                    "baked in; pass optimizer= explicitly to change it"
                )
            optimizer = spec
        if optimizer is not None:
            if learning_rate is not None and not isinstance(
                optimizer, (str, dict)
            ):
                raise ValueError(
                    "learning_rate is ignored for OptimizerSpec objects — "
                    "bake the rate into the object, or pass a name/dict "
                    "spec"
                )
            self.optimizer = resolve_optimizer(
                optimizer, learning_rate if learning_rate is not None
                else self.learning_rate,
            )
            self._optimizer_spec = (
                optimizer if isinstance(optimizer, (str, dict)) else None
            )
            if learning_rate is not None:
                self.learning_rate = learning_rate
            # A fresh optimizer voids accumulation and any state built for
            # the old one.
            self._accumulate_steps = 1
            if self.opt_state is not None:
                self._reset_optimizer()
        if loss is not None:
            self.loss = loss
        self._invalidate_programs()

    def _set_accumulation(self, accumulate_steps: int) -> None:
        """``optax.MultiSteps(every_k_schedule=accumulate_steps)``: the
        mean gradient over k batches, one update every k-th batch.  The
        inner optimizer's moments survive a change; pending accumulated
        gradients do not."""
        if accumulate_steps < 1:
            raise ValueError(
                f"accumulate_steps must be >= 1, got {accumulate_steps}"
            )
        if accumulate_steps != self._accumulate_steps:
            self._accumulate_steps = accumulate_steps
            self._mini_step = 0
            self.module.zero_grad(set_to_none=True)
            # Accumulation is part of the programs' optimizer key.
            self._invalidate_programs()

    # -- loss -----------------------------------------------------------------

    def _resolve_loss(self, y: np.ndarray) -> str:
        if self.loss != "auto":
            return self.loss
        if np.issubdtype(y.dtype, np.floating):
            return "mse"
        return "softmax_ce"

    @staticmethod
    def _loss_and_metrics(loss_kind: str) -> Callable:
        """(f32 logits, labels, per-row mask[, msum]) -> (loss, metrics): a
        masked mean over ``msum``, by default max(mask.sum(), 1), as the
        JAX package's losses.  A data-parallel rank passes the global
        batch's ``msum``, so its loss is its rows' share of the global
        batch's mean and the ranks' gradients sum to the global one."""

        def fn(logits, y, mask, msum=None):
            if msum is None:
                msum = torch.clamp_min(mask.sum(), 1.0)
            if loss_kind == "softmax_ce":
                y = y.long()
                # optax.softmax_cross_entropy_with_integer_labels
                per = torch.logsumexp(logits, -1) - logits.gather(
                    -1, y[..., None])[..., 0]
                correct = (logits.argmax(-1) == y).float()
                seq_out = per.dim() == 2
                if seq_out:
                    # Sequence outputs (B, T, V): average over non-pad
                    # target tokens (pad id 0); the per-sample mask
                    # applies unchanged.
                    tok = (y != 0).float()
                    denom = torch.clamp_min(tok.sum(-1), 1.0)
                    per = (per * tok).sum(-1) / denom
                    correct = (correct * tok).sum(-1) / denom
                loss = (per * mask).sum() / msum
                acc = (correct * mask).sum() / msum
                metrics = {"loss": loss, "accuracy": acc}
                if seq_out:
                    # Raw per-token CE; exponentiated after the mean
                    # (_finalize_metrics).
                    metrics["perplexity"] = loss
                return loss, metrics
            if loss_kind == "sigmoid_ce":
                z = logits[..., 0]
                yf = y.float()
                # optax.sigmoid_binary_cross_entropy
                per = -yf * nn.functional.logsigmoid(z) - \
                    (1 - yf) * nn.functional.logsigmoid(-z)
                loss = (per * mask).sum() / msum
                acc = (((z > 0) == (yf > 0)).float() * mask).sum() / msum
                return loss, {"loss": loss, "accuracy": acc}
            # mse
            pred = logits if logits.dim() == y.dim() else logits[..., 0]
            per = ((pred - y) ** 2).mean(dim=tuple(range(1, pred.dim()))) \
                if pred.dim() > 1 else (pred - y) ** 2
            loss = (per * mask).sum() / msum
            return loss, {"loss": loss}

        return fn

    def _compute_dtype(self):
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else None

    def _build_step(self, loss_kind: str) -> None:
        """Resolve the evaluate program under the JAX ``epoch_fns`` key
        (once per loss kind, as the JAX estimator builds its (step,
        evaluate) pair)."""
        if self._eval_fn is None or self._eval_loss_kind != loss_kind:
            self._eval_fn = _cached_program(
                "epoch_fns", self, loss_kind, donate=False,
                fn=_evaluate_program, analyze=False)
            self._eval_loss_kind = loss_kind

    # -- train step / epoch ---------------------------------------------------

    def _train_step(self, xb, yb, mb, loss_fn, dtype, msum=None) -> dict:
        """Forward + backward on bf16 copies of the f32 masters; every
        ``accumulate_steps``-th call applies one optimizer update with the
        mean gradient.  Returns detached metric tensors (no host sync).
        A data-parallel rank normalises by the global batch's ``msum`` and
        sums the ranks' gradients once per update; on a sequence-parallel
        mesh it steps on its tokens of the rows and divides its loss by sp
        (each sp rank of a replica computes the replica's loss); an MoE
        model's auxiliary loss is the global batch's (``ops/moe.py``)."""
        dp = self._dp
        # A module whose forward takes ``aux_losses`` (the MoE models)
        # appends its auxiliary losses to the list; their sum joins the
        # objective, not the metrics (the JAX package's _apply_with_aux).
        # A data-parallel rank's list names its replicas, so the terms
        # are the global batch's.
        aux = AuxLosses(None if dp is None else dp.replicas) \
            if getattr(self.module, "takes_aux_losses", False) else None
        if dp is not None:
            dp.step_begin()
            xb = dp.local_tokens(xb)
        logits = functional_call(
            self.module, _cast_params(self.module, dtype),
            (_cast_input(xb, dtype),),
            {} if aux is None else {"aux_losses": aux},
        ).float()
        loss, metrics = loss_fn(logits, yb, mb, msum)
        if aux:
            loss = loss + sum(aux)
        if dp is not None and dp.sp > 1:
            loss = loss / dp.sp
        loss.backward()
        self._mini_step += 1
        k = self._accumulate_steps
        if self._mini_step == k:
            if dp is not None:
                dp.sync_grads(self.module)
            if k > 1:
                for p in self.module.parameters():
                    if p.grad is not None:
                        p.grad.div_(k)
            lr = self.optimizer.lr(self._updates)
            for group in self.opt_state.param_groups:
                group["lr"] = lr
            self.opt_state.step()
            self.module.zero_grad(set_to_none=True)
            self._updates += 1
            self._mini_step = 0
        if dp is not None:
            dp.step_end()
        return {name: v.detach() for name, v in metrics.items()}

    def _device_epoch(self, xs, ys, loss_fn, dtype, batch_size: int,
                      shuffle: bool, key: int) -> dict:
        """One epoch over a device-resident dataset: permute on the device
        (a generator seeded by the estimator's seed and ``key``), pad the
        tail by cycling the order (mask 0), run the batches, one host
        transfer of the mean per-batch metrics.  A data-parallel rank
        walks the same global batches and steps on its slice of each
        (``self._dp.rows``)."""
        dp = self._dp
        n = xs.shape[0]
        if shuffle:
            gen = torch.Generator(device=xs.device).manual_seed(
                int(self.seed) * 1_000_003 + key)
            order = torch.randperm(n, generator=gen, device=xs.device)
        else:
            order = torch.arange(n, device=xs.device)
        n_batches = max(1, -(-n // batch_size))
        pad = n_batches * batch_size - n
        idx = torch.cat([order, order.repeat(-(-pad // n))[:pad]]) \
            if pad else order
        mask = torch.ones(n_batches * batch_size, device=xs.device)
        mask[n:] = 0.0
        per_batch = []
        for i in range(n_batches):
            sl = slice(i * batch_size, (i + 1) * batch_size)
            rows, m, msum = idx[sl], mask[sl], None
            if dp is not None:
                msum = torch.clamp_min(m.sum(), 1.0)
                part = dp.rows(batch_size)
                rows, m = rows[part], m[part]
            per_batch.append(self._train_step(
                xs[rows], ys[rows], m, loss_fn, dtype, msum))
            if i == 0:
                # Every batch has the first one's shapes: a FLOP count of
                # this call stops here and scales (obs/costs.py).
                costs.repeats(n_batches)
        return _finalize_metrics(per_batch, dp)

    def _streaming_epoch(self, stream: "_ShardStream", loss_fn, dtype,
                         batch_size: int, shuffle: bool, epoch: int,
                         program_for) -> dict:
        """One epoch over a sharded dataset: the shards in a host order
        seeded by (seed, 3, epoch), the JAX package's; each shard one
        device epoch (its tail padded like the in-memory tail), its
        in-shard order seeded by ``epoch * n_shards + position``; the
        metrics weighted by each shard's rows."""
        n_shards = stream.dataset.n_shards
        order = (np.random.default_rng([self.seed, 3, epoch]).permutation(
            n_shards) if shuffle else np.arange(n_shards))
        acc = _sharded().WeightedMetrics()
        for pos, k, xs, ys in stream.shards(order):
            rows = stream.dataset.shard_rows[k]
            # A shard shorter than a batch is one batch; a data-parallel
            # one rounds it up to a multiple of the dp size.
            bs = min(batch_size, rows if self._dp is None
                     else -(-rows // self._dp.dp_size) * self._dp.dp_size)
            acc.add(program_for(rows, bs)(
                self, xs, ys, loss_fn, dtype, bs, shuffle,
                epoch * n_shards + pos), rows)
        return acc.result()

    # -- keras-fit surface ----------------------------------------------------

    def fit(
        self,
        x,
        y,
        epochs: int = 1,
        batch_size: int = 32,
        validation_split: float = 0.0,
        validation_data: tuple | None = None,
        shuffle: bool = True,
        verbose: int = 0,
        callbacks: list | None = None,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 1,
        checkpoint_min_interval_s: float = 60.0,
        resume: bool = True,
        accumulate_steps: int = 1,
        quantize_checkpoint: bool = False,
        checkpoint_async: bool = True,
        early_stopping: dict | EarlyStopping | None = None,
        **_,
    ) -> "NeuralEstimator":
        """keras-fit surface: ``validation_split`` / ``validation_data``
        (``val_*`` metrics), ``shuffle``, ``callbacks`` (``cb(epoch,
        metrics, model)``), ``early_stopping`` (an :class:`EarlyStopping`
        or its REST-JSON dict spec), ``accumulate_steps`` (MultiSteps).
        ``quantize_checkpoint=True`` marks the estimator so its saved
        artifact stores parameters int8 with optimizer state dropped; the
        live model keeps full precision.

        Sharded ``x``/``y`` (views of one sharded dataset; ``x`` may be
        the bare dataset, which resolves to every column but ``y``'s)
        stream: each epoch walks the shards in a fresh order, shard k+1
        loading from disk and copying to the device while the device
        runs shard k (:class:`_ShardStream`).  ``validation_split`` is
        refused there; ``validation_data`` must be in-memory arrays.

        Managed checkpoints: with ``checkpoint_dir`` set, (params,
        opt_state) are saved every ``checkpoint_every`` epochs, at most
        once per ``checkpoint_min_interval_s`` (the final epoch, or an
        early stop, always saves), asynchronously unless
        ``checkpoint_async=False``; with ``resume`` a fit starts from the
        newest committed step, with its history, and walks the batches
        an uninterrupted fit walks from there (each epoch's order is
        seeded by its index).

        In a rank process of a data-parallel fit
        (parallel/distributed.py), ``self._dp`` holds the rank's view of
        the process group: every rank walks the same global batches and
        steps on its rows of each, the ranks agree on each epoch's stop
        (early stopping, a relayed cancel) and save, only rank 0 writes
        checkpoints, and each epoch's metrics gain ``samples_per_sec``."""
        dp = self._dp
        self._quantize_persist = bool(quantize_checkpoint)
        callbacks = build_stop_callbacks(self, callbacks, early_stopping)
        self._set_accumulation(accumulate_steps)
        stream = None
        if _is_sharded(x) or _is_sharded(y):
            if validation_split:
                raise ValueError(
                    "validation_split is unsupported for sharded datasets; "
                    "pass validation_data=(x, y) arrays")
            if _is_sharded(validation_data):
                raise ValueError(
                    "validation_data must be in-memory arrays, not sharded "
                    "views (validation sets are small by construction)")
            x, y = _sharded().resolve_xy_views(x, y)
            # A later predict on the bare dataset feeds these columns,
            # not the label.
            self._sharded_fit_cols = list(x.cols)
            loss_kind = self._resolve_loss(np.asarray(y.head(256)))
            x0 = as_array(x.head(1))
        else:
            x = as_array(x)
            y_arr = as_array(y)
            y_arr = y_arr.reshape(-1) \
                if y_arr.ndim == 2 and y_arr.shape[1] == 1 else y_arr
            loss_kind = self._resolve_loss(y_arr)
            y_arr = y_arr.astype(np.int32 if loss_kind == "softmax_ce"
                                 else np.float32)
            if validation_data is None and validation_split > 0:
                n_val = int(len(x) * validation_split)
                # Tiny datasets: never let the split empty the train set.
                if 0 < n_val < len(x):
                    x, x_val = x[:-n_val], x[-n_val:]
                    y_arr, y_val = y_arr[:-n_val], y_arr[-n_val:]
                    validation_data = (x_val, y_val)
            if len(x) == 0:
                raise ValueError("cannot batch an empty dataset")
            x0 = x[:1]
        self._init_params(x0)
        if self.opt_state is None:
            self._reset_optimizer()
        self._build_step(loss_kind)
        start_epoch = 0
        if checkpoint_dir and resume:
            loaded = ckpt.resume_or_none(
                checkpoint_dir, self._restore_checkpoint, device=self.device)
            if loaded is not None:
                start_epoch, past_history = loaded
                self.history = TrainHistory(past_history)

        loss_fn = self._loss_and_metrics(loss_kind)
        dtype = self._compute_dtype()
        if _is_sharded(x):
            stream = _ShardStream(
                x, y, np.int32 if loss_kind == "softmax_ce" else np.float32,
                self.device)
            self.stream_stats = stream.stats

            n_samples = stream.dataset.n_rows
            # One program per distinct shard length: the full shards
            # share one, the tail adds a second.
            progs: dict = {}

            def program_for(rows, bs):
                if rows not in progs:
                    progs[rows] = _cached_program(
                        "device_epoch", self, loss_kind,
                        shapes=(rows, bs, bool(shuffle)),
                        fn=_device_epoch_program)
                return progs[rows]

            attributed = None

            def run_epoch(epoch_i):
                return self._streaming_epoch(stream, loss_fn, dtype,
                                             batch_size, bool(shuffle),
                                             epoch_i, program_for)
        else:
            # Upload the dataset once; each epoch shuffles/batches on
            # the device.
            xs = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            ys = torch.from_numpy(np.ascontiguousarray(y_arr)).to(
                self.device)

            n_samples = -(-len(x) // batch_size) * batch_size
            epoch_key = (len(x), batch_size, bool(shuffle), loss_kind)
            if self._device_epoch_key != epoch_key:
                self._device_epoch_prog = _cached_program(
                    "device_epoch", self, loss_kind,
                    shapes=(len(x), batch_size, bool(shuffle)),
                    fn=_device_epoch_program)
                self._device_epoch_key = epoch_key
            # Each epoch's device interval goes to the job's device-time
            # ledger with the program's FLOPs (as the JAX in-memory fit
            # attributes; its streaming fit does not).
            attributed = self._device_epoch_prog

            def run_epoch(epoch_i):
                return attributed(self, xs, ys, loss_fn, dtype, batch_size,
                                  bool(shuffle), epoch_i)

        self.module.train()
        last_save = time.monotonic()
        try:
            for epoch_i in range(start_epoch, epochs):
                if (cancel_requested() if dp is None
                        else dp.cancel_requested()):
                    # Engine-side cancellation (deadline watchdog, bounded
                    # shutdown drain, REST cancel): wind down exactly like
                    # an early stop, params and history at the last
                    # completed epoch.
                    self.stop_training = True
                    break
                t0 = time.perf_counter()
                # Chaos probe per epoch, on the host before the epoch's
                # work: an armed ``preempt`` schedule models a preemption
                # mid-fit, after some checkpoints committed, so the
                # engine's retry -> checkpoint resume runs end to end.
                faults.hit("train.epoch")
                interval = costs.Interval(self.device) \
                    if attributed is not None and costs.enabled() else None
                metrics = run_epoch(epoch_i)
                metrics["epoch_time"] = time.perf_counter() - t0
                if interval is not None:
                    costs.attribute(interval.stop().seconds(),
                                    cost=attributed.cost())
                if dp is not None:
                    metrics["samples_per_sec"] = \
                        n_samples / metrics["epoch_time"]
                if validation_data is not None:
                    vx, vy = validation_data
                    vy = as_array(vy)
                    # Only flatten single-column matrices — sequence
                    # targets (B, T) keep their shape.
                    if vy.ndim == 2 and vy.shape[1] == 1:
                        vy = vy.reshape(-1)
                    vmetrics = self._evaluate_arrays(
                        as_array(vx), vy, batch_size, loss_kind)
                    metrics.update(
                        {f"val_{k}": v for k, v in vmetrics.items()})
                self.history.append(metrics)
                # One span per epoch (train step + validation), from host
                # clocks only: the metrics' transfer above already waited
                # for the device.
                if stream is None:
                    tracing.record_span("epoch", time.perf_counter() - t0,
                                        epoch=epoch_i)
                else:
                    tracing.record_span("epoch", time.perf_counter() - t0,
                                        epoch=epoch_i, streaming=True)
                if verbose:
                    _log.info("epoch %d/%d: %s", epoch_i + 1, epochs,
                              metrics)
                # Callbacks run before the save decision, so an early stop
                # counts as the final epoch.
                for cb in callbacks:
                    if callable(cb):
                        cb(epoch_i, metrics, self)
                save = bool(checkpoint_dir) and ckpt.should_save(
                    epoch_i, epochs, checkpoint_every,
                    checkpoint_min_interval_s, last_save,
                    stopped=self.stop_training)
                if dp is not None:
                    # One decision for every rank, or one breaks out of
                    # the loop while the others wait in an all-reduce.
                    self.stop_training, save = dp.agree(
                        self.stop_training, save)
                if save:
                    state = self._checkpoint_state()
                    if dp is None or dp.rank == 0:
                        # save() copies the history's lists: a marker it
                        # publishes later holds this epoch's history.
                        ckpt.save(checkpoint_dir, epoch_i + 1, state,
                                  history=self.history,
                                  async_save=checkpoint_async)
                    last_save = time.monotonic()
                if self.stop_training:
                    if verbose:
                        _log.info("early stop after epoch %d", epoch_i + 1)
                    break
        finally:
            self.module.eval()
            if stream is not None:
                stream.close()
            if checkpoint_dir:
                # The last save is committed when fit returns (or raises).
                ckpt.finalize_async(checkpoint_dir)
        return self

    def _checkpoint_state(self) -> dict:
        """{params, opt_state} in the artifact layout, as live tensors
        (``checkpoint.save`` snapshots them).  Moments that a restore-best
        early stop dropped are saved fresh, as optax's ``init`` gives
        them, so a resume does not replay pre-restore moments.  A
        data-parallel rank's accumulated gradients are summed over the
        ranks first, and its expert slices joined (every rank takes
        part)."""
        dp = self._dp
        grads = dp.pending_grads(self.module) \
            if dp is not None and self._mini_step else None
        opt = self._export_opt_state(host=False, grads=grads) \
            if self.opt_state is not None else self._fresh_opt_state()
        state = {"params": convert.flax_tree(self.module), "opt_state": opt}
        # An expert-parallel rank's slices, joined: the single-device
        # layout.
        return state if dp is None else dp.join_experts(state, self.module)

    def _fresh_opt_state(self) -> dict:
        """A never-stepped optimizer's exported state: count 0, no slot
        written yet (zero moments), and no accumulated gradient."""
        state = {"count": np.asarray(0, np.int32)}
        if self._accumulate_steps == 1:
            return state
        zero = np.asarray(0, np.int32)
        return {"mini_step": zero, "gradient_step": zero,
                "inner_opt_state": state,
                "acc_grads": convert.flax_tree(
                    self.module, pick=torch.zeros_like)}

    def _restore_checkpoint(self, state: dict) -> None:
        """Resume from a checkpoint's state, its tensors on this device (an
        expert-parallel rank's cut to its experts)."""
        if self._dp is not None:
            state = self._dp.local_experts(state, self.module)
        opt = state["opt_state"]
        if ("inner_opt_state" in opt) != (self._accumulate_steps > 1):
            raise ValueError(
                f"checkpoint accumulates over "
                f"{'several' if 'inner_opt_state' in opt else 'one'} "
                f"batch(es); this fit over {self._accumulate_steps}")
        self.module.load_state_dict(
            convert.params_from_jax(state["params"]))
        self._import_opt_state(opt)

    # -- evaluation / inference -------------------------------------------------

    def _evaluate_arrays(self, x, y, batch_size, loss_kind) -> dict:
        """Metrics over padded batches, through the cached evaluate
        program."""
        self._build_step(loss_kind)
        return self._eval_fn(self, x, y, batch_size, loss_kind)

    def _evaluate_batches(self, x, y, batch_size, loss_kind) -> dict:
        """Metrics over padded batches of ``batch_size`` rows; a
        data-parallel rank computes its rows of each global batch and the
        ranks' shares are summed."""
        dp = self._dp
        y = y.astype(np.int32 if loss_kind == "softmax_ce" else np.float32)
        xb, yb, mb = _batch_data(x, y, batch_size, _NoShuffle())
        msums = [None] * len(mb)
        if dp is not None:
            msums = [torch.tensor(max(float(m.sum()), 1.0)) for m in mb]
            part = dp.rows(batch_size)
            xb, yb, mb = xb[:, part], yb[:, part], mb[:, part]
        xb, yb, mb = (torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device) for a in (xb, yb, mb))
        if dp is not None:
            xb = dp.local_tokens(xb, axis=2)
        loss_fn = self._loss_and_metrics(loss_kind)
        dtype = self._compute_dtype()
        with torch.inference_mode():
            # Same numerics (and tensor-core rate) as training.
            params = _cast_params(self.module, dtype)
            per_batch = [
                loss_fn(functional_call(
                    self.module, params, (_cast_input(xb[i], dtype),)
                ).float(), yb[i], mb[i],
                    None if msums[i] is None else msums[i].to(self.device)
                )[1]
                for i in range(xb.shape[0])
            ]
        return _finalize_metrics(per_batch, dp)

    def evaluate(self, x, y, batch_size: int = 128, **_) -> dict:
        if self._dp is not None:
            # A data-parallel rank rounds up to a global batch the
            # replicas can split: the batch size is a throughput knob here.
            world = self._dp.dp_size
            batch_size = -(-max(1, batch_size) // world) * world
        if _is_sharded(x) or _is_sharded(y):
            return self._evaluate_streaming(x, y, batch_size)
        x = as_array(x)
        y = as_array(y)
        # Only flatten a single-column matrix; multi-output regression
        # targets (n, k>1) must keep their shape.
        if y.ndim == 2 and y.shape[1] == 1:
            y = y.reshape(-1)
        if not self._built():
            raise RuntimeError("evaluate() before fit()")
        return self._evaluate_arrays(x, y, batch_size, self._resolve_loss(y))

    def _evaluate_streaming(self, x, y, batch_size: int) -> dict:
        """Shard by shard (``fit``'s x/y resolution); the metrics weighted
        by each shard's rows, perplexity averaged in the log domain."""
        sharded = _sharded()
        x, y = sharded.resolve_xy_views(x, y)
        if not self._built():
            raise RuntimeError("evaluate() before fit()")
        loss_kind = self._resolve_loss(np.asarray(y.head(256)))
        ds = x.dataset
        acc = sharded.WeightedMetrics()
        for k in range(ds.n_shards):
            acc.add(self._evaluate_arrays(
                as_array(x.load_shard(k)), y.load_shard(k), batch_size,
                loss_kind), ds.shard_rows[k])
        return acc.result()

    def _built(self) -> bool:
        return next(self.module.parameters(), None) is not None

    def check_input(self, x: np.ndarray) -> None:
        """Raise ValueError for input the module cannot take (validated on
        the host: a bad index on the card would fault the device)."""

    def apply(self, x: np.ndarray, module=None) -> np.ndarray:
        """One f32 forward over a host batch; returns host f32 outputs.
        ``module``: a placed copy of this estimator's module to run
        instead (a fleet replica's on another card); the batch goes from
        the host to its card in one transfer."""
        return _apply_program(self.module if module is None else module, x)

    def _apply_for(self, rows: int) -> cc.Program:
        """The cached ``apply`` program for a ``rows``-row bucket,
        memoized on the estimator (:func:`apply_program`)."""
        prog = self._apply_fns.get(rows)
        if prog is None:
            prog = self._apply_fns[rows] = apply_program(self.module, rows)
        return prog

    def predict(self, x, batch_size: int = 512, **_):
        if _is_sharded(x):
            return self._predict_streaming(x, batch_size)
        x = as_array(x)
        self.check_input(x)
        if not self._built():
            raise RuntimeError("predict() before fit()")
        outs = []
        for i in range(0, len(x), batch_size):
            xb = x[i:i + batch_size]
            k = xb.shape[0]
            # The ragged final slice pads up to its power-of-two bucket
            # (capped at batch_size) and the pad rows are sliced off: the
            # same discipline as the serving path.
            bucket = bucket_for(k, batch_size)
            outs.append(self._apply_for(bucket)(
                self.module, pad_rows(xb, bucket))[:k])
        return np.concatenate(outs, axis=0)

    def _predict_streaming(self, x, batch_size: int) -> np.ndarray:
        """Shard by shard, the outputs stitched in order on the host.  A
        bare dataset feeds the columns the streaming fit trained on (they
        exclude the label), else all of them."""
        if isinstance(x, _sharded().ShardedDataset):
            cols = self._sharded_fit_cols
            # The list form keeps a one-column fit's (rows, 1) matrix.
            x = x.view(cols if cols and all(c in x.fields for c in cols)
                       else x.fields)
        return np.concatenate([
            self.predict(x.load_shard(k), batch_size)
            for k in range(x.dataset.n_shards)], axis=0)

    def predict_classes(self, x, batch_size: int = 512):
        return np.argmax(self.predict(x, batch_size), axis=-1)

    def score(self, x, y) -> float:
        return float(self.evaluate(x, y).get("accuracy", 0.0))

    # -- persistence ----------------------------------------------------------

    def _export_opt_state(self, *, host: bool = True, grads=None):
        """The optimizer state as optax lays it out, numpy leaves in the
        flax tree shape (live tensors with ``host=False``): ``count`` plus the optimizer's slots (adam, adamw,
        lamb, radam: ``mu``/``nu``; sgd: ``trace``; rmsprop: ``nu``;
        adagrad: ``sum_of_squares``; lion: ``mu``; novograd: ``mu`` and a
        scalar ``nu`` per leaf), wrapped as ``MultiStepsState`` fields when
        gradients accumulate (``grads``, {parameter: gradient}, stands in
        for the parameters' own accumulated ``.grad``)."""
        opt = self.opt_state
        if opt is None:
            return None

        def slot(key):
            return lambda p: opt.state.get(p, {}).get(key, torch.zeros_like(p))

        def acc(p):
            g = p.grad if grads is None else grads.get(p)
            return torch.zeros_like(p) if g is None \
                else g / max(self._mini_step, 1)

        to_host = convert.to_host if host else (lambda tree: tree)
        state = {"count": np.asarray(self._updates, np.int32)}
        for field, key in self.optimizer.slots.items():
            if any(key in st for st in opt.state.values()):
                state[field] = to_host(
                    convert.flax_tree(self.module, pick=slot(key)))
        if self._accumulate_steps == 1:
            return state
        return {
            "mini_step": np.asarray(self._mini_step, np.int32),
            "gradient_step": np.asarray(self._updates, np.int32),
            "inner_opt_state": state,
            "acc_grads": to_host(convert.flax_tree(self.module, pick=acc)),
        }

    def _import_opt_state(self, state) -> None:
        self._reset_optimizer()
        if state is None:
            return
        if "inner_opt_state" in state:
            self._mini_step = int(state["mini_step"])
            grads = convert.params_from_jax(state["acc_grads"])
            for name, p in self.module.named_parameters():
                p.grad = grads[name].to(p) * self._mini_step \
                    if self._mini_step else None
            state = state["inner_opt_state"]
        self._updates = int(state["count"])
        index = {name: i for i, (name, _) in
                 enumerate(self.module.named_parameters())}
        per_param: dict[int, dict] = {i: {} for i in index.values()}
        for field, key in self.optimizer.slots.items():
            if field not in state:
                continue
            for name, t in convert.params_from_jax(state[field]).items():
                per_param[index[name]][key] = t
        step = torch.tensor(float(self._updates))
        for st in per_param.values():
            if st:
                st["step"] = step.clone()
        saved = self.opt_state.state_dict()
        saved["state"] = {i: st for i, st in per_param.items() if st}
        self.opt_state.load_state_dict(saved)

    def state_dict(self, *, quantize: bool = False) -> dict:
        """The JAX package's artifact state: ``params`` is the flax tree of
        numpy arrays; ``quantize=True`` stores large tensors int8 (the
        quantize kernel runs on the estimator's device) and drops the
        optimizer state — a serving binary."""
        tree = convert.flax_tree(self.module)
        if quantize:
            tree = quantize_pytree(tree)
        return {
            "params": convert.to_host(tree),
            "opt_state": None if quantize else self._export_opt_state(),
            # Copies: a later fit must not grow a saved artifact's lists.
            "history": {k: list(v) for k, v in self.history.items()},
            "accumulate_steps": self._accumulate_steps,
            # Survives persistence, or a loaded model's predict on the
            # bare dataset would feed it the label column.
            "sharded_fit_cols": self._sharded_fit_cols,
        }

    def load_state_dict(self, state: dict) -> None:
        params = state["params"]
        if has_quantized_leaves(params):
            params = dequantize_pytree(params, device=self.device)
        if has_separate_qkv(params) and not any(
            isinstance(m, MultiHeadSelfAttention) and not m.fused_qkv
            for m in self.module.modules()
        ):
            # Legacy separate-projection artifact meeting the fused
            # default: block-stack into the qkv layout.
            params = migrate_separate_qkv(params)
        self.module.load_state_dict(convert.params_from_jax(params))
        self._set_accumulation(state.get("accumulate_steps", 1))
        # A quantized artifact drops the moments: the next fit starts
        # them from zero.
        if state.get("opt_state") is not None:
            self._import_opt_state(state["opt_state"])
        else:
            self.opt_state = None
        self.history = TrainHistory(state.get("history") or {})
        cols = state.get("sharded_fit_cols")
        if cols:
            self._sharded_fit_cols = list(cols)

    def to_artifact(self, *, quantize: bool | None = None) -> dict:
        """A picklable artifact: class name, constructor kwargs (minus the
        device), the compute dtype and :meth:`state_dict`, which is None
        for a module sized by its first input that has not seen one yet.
        ``quantize`` defaults to what the last fit's
        ``quantize_checkpoint`` asked for."""
        if quantize is None:
            quantize = getattr(self, "_quantize_persist", False)
        params = self.get_params()
        params.pop("device", None)
        return {
            "modulePath": type(self).__module__,
            "class": type(self).__name__,
            "classParameters": params,
            "compute_dtype": self.compute_dtype,
            "state": self.state_dict(quantize=quantize)
            if self._built() else None,
        }


class SizedModule(nn.Module):
    """A module sized by its first input, as flax infers shapes: no
    parameters until :meth:`build`, whose keyword arguments come from an
    input (:meth:`dims_of_input`) or from a flax tree made for one
    (:meth:`dims_of_tree`)."""

    built = False

    def build(self, **dims) -> None:
        raise NotImplementedError

    @staticmethod
    def dims_of_input(x0) -> dict:
        raise NotImplementedError

    @staticmethod
    def dims_of_tree(params: dict) -> dict:
        raise NotImplementedError

    def _check_built(self) -> None:
        if not self.built:
            raise RuntimeError(
                f"{type(self).__name__} is sized by its first input: fit() "
                "or load a state first")


class SizedEstimator(NeuralEstimator):
    """Estimator over a :class:`SizedModule`: built and seeded at the
    first ``fit`` from the input's shape, or from a loaded state."""

    def _build(self, dims: dict) -> None:
        self.module.build(**dims)
        init_params(self.module, self.seed)
        self.module.to(self.device)

    def _init_params(self, x0: np.ndarray) -> None:
        if not self.module.built:
            self._build(self.module.dims_of_input(x0))

    def load_state_dict(self, state: dict) -> None:
        if not self.module.built:
            self._build(self.module.dims_of_tree(state["params"]["params"]))
        super().load_state_dict(state)


_ARTIFACT_KEYS = frozenset({"modulePath", "class", "classParameters",
                            "state"})


def is_artifact(obj) -> bool:
    """Whether ``obj`` is a :meth:`NeuralEstimator.to_artifact` dict."""
    return isinstance(obj, dict) and _ARTIFACT_KEYS <= set(obj)


def load_artifact(doc: dict, *, device="cuda") -> NeuralEstimator:
    """Rebuild an estimator from :meth:`NeuralEstimator.to_artifact` on
    ``device`` (int8 leaves dequantize there).  An unbuilt sized module's
    artifact (``state`` None) comes back unbuilt."""
    cls = registry.resolve(doc["modulePath"], doc["class"])
    est = cls(**doc["classParameters"], device=device)
    est.compute_dtype = doc.get("compute_dtype", est.compute_dtype)
    if doc["state"] is not None:
        est.load_state_dict(doc["state"])
    return est
