"""Mixture-of-experts feed-forward layer — port of
``learningorchestra_tpu/ops/moe.py``: a GShard/Switch-style top-k routed
expert FFN with a static per-expert capacity.

- **Static shapes.**  The capacity ``C`` comes from the static shapes
  alone, so the dispatch and combine tensors are always (B, T, E, C) and
  the step holds no host sync and no shape that depends on the data (a
  decode step with a router is captured as a CUDA graph,
  ``serve/decode/pages.py``).  Tokens over capacity are dropped: their
  combine weight is zero and the block's residual carries them.
- **Dispatch and combine as einsums.**  Routing is two batched matmuls
  around the experts' two, all four in the model dtype; the JAX package
  computes them outside any Pallas kernel, and so does the port (no
  hand-written kernel replaces them).
- **Router in f32.**  The router's logits, softmax and top-k run in f32
  on f32 weights whatever the compute dtype: the bf16 cast of the fit
  loop skips parameters named ``router`` (``train/neural.py::
  _cast_params``).  On the card its f32 matmul must not run as TF32, or
  near-tied top-k choices flip; the port leaves
  ``torch.backends.cuda.matmul.allow_tf32`` at PyTorch's default, False,
  and sets it nowhere.

The load-balancing auxiliary loss (Switch eq. 4 over first choices plus
the router z-loss) is the counterpart of the JAX layer's
``sow("losses", ...)``: the forward appends it to ``aux_losses`` when the
caller passes a list, and computes nothing otherwise.  Only the fit
loop's train step passes one (``train/neural.py::_train_step``), so
evaluation, predict and the decode step, a captured one included, never
compute it and no module state holds it.  A rank of a data-parallel fit
passes an :class:`AuxLosses` naming its replicas: the means then run over
the GLOBAL batch, as the JAX layer's over its sharded batch.

Expert parallelism (the ``ep`` mesh axis): a layer bound to its rank's
expert group (:meth:`MoEMlp.bind_experts`) holds and computes only E/ep
whole experts.  The ep ranks of one replica see the same rows (the JAX
batch is not sharded over ``ep``), so routing runs in full on each; the
sum over experts becomes a collective: the local (E/ep, B, C, H) expert
outputs are all-gathered forward (:class:`_GatherExperts`, whose backward
takes this rank's slice) and the dispatched input's gradient, partial
over the local experts, is summed over the group backward
(:class:`_SumBackward`).  Every other gradient upstream of the layer is
then whole and equal on each ep rank.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from learningorchestra_tpu_torch.ops.layers import Dense

#: The expert leaves, carried between the flax tree and the module by
#: name with their layout unchanged (``convert.py``).
EXPERT_LEAVES = ("expert_w1", "expert_b1", "expert_w2", "expert_b2")


class AuxLosses(list):
    """The list a forward appends its auxiliary losses to.  ``replicas``
    (None on one device) is a data-parallel rank's group of replicas: an
    object with ``size`` and ``all_reduce(t)``, the sum of ``t`` over one
    rank per replica (``parallel/distributed.py::GroupComm``)."""

    def __init__(self, replicas=None):
        super().__init__()
        self.replicas = replicas


class _SumOverReplicas(torch.autograd.Function):
    """The sum over the replicas forward, the identity backward: each rank
    adds the global term to its loss and the gradients are summed over
    the replicas afterwards, so a summing backward would count it dp
    times."""

    @staticmethod
    def forward(ctx, t, replicas):
        return replicas.all_reduce(t)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumBackward(torch.autograd.Function):
    """The identity forward, the sum over the expert group backward (the
    Megatron ``f``): the dispatched input's gradient from this rank's
    experts only, completed by the other ranks'."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce(grad.contiguous()), None


class _GatherExperts(torch.autograd.Function):
    """Every rank's (E/ep, ...) expert outputs, concatenated in ep order
    along the expert axis; backward, this rank's slice of the whole (and
    on every ep rank equal) gradient."""

    @staticmethod
    def forward(ctx, h, group):
        ctx.index, ctx.per = group.index, h.shape[0]
        return group.all_gather(h.contiguous())

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.index * ctx.per
        return grad[lo:lo + ctx.per], None


def capacity(num_experts: int, top_k: int, tokens: int,
             capacity_factor: float) -> int:
    """Slots per expert per routing group (a batch row), the JAX layer's
    arithmetic to the float: every token admitted if routing were
    balanced, times headroom, at least 1 and at most ``tokens * k``."""
    k = min(top_k, num_experts)
    cap = max(1, int(-(-(k * tokens * capacity_factor) // num_experts)))
    return min(cap, tokens * k)


def _one_hot(idx, n: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over ``n`` classes; an index outside
    [0, n) gives a zero row, as ``jax.nn.one_hot`` does (a token past its
    expert's capacity)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.float32)


def route(logits, top_k: int, cap: int):
    """(dispatch, combine, first-choice one-hot, router probabilities)
    of f32 router logits (B, T, E) for a per-expert capacity ``cap``.

    Each of the k rounds takes the argmax of what is left (the first
    index on ties, in both frameworks), masks it out, and places each
    token in its expert's buffer after the tokens before it in the row and
    after every earlier round's tokens (a cumsum in f32, exact on these
    integers).  The selected gates are renormalised to sum to 1 BEFORE the
    capacity drops (GShard: a drop loses mass, the survivors are not
    re-weighted)."""
    b, t, e = logits.shape
    k = min(top_k, e)
    probs = torch.softmax(logits, dim=-1)
    remaining = probs
    assigned = logits.new_zeros((b, e))  # slots used so far, per expert
    slot_oh, slot_gate, slot_pos = [], [], []
    for _ in range(k):
        oh = _one_hot(remaining.argmax(-1), e)  # (B, T, E)
        slot_gate.append((remaining * oh).sum(-1))  # (B, T)
        remaining = remaining * (1.0 - oh)
        pos = torch.cumsum(oh, dim=1) - oh + assigned[:, None, :]
        slot_pos.append((pos * oh).sum(-1).to(torch.int64))  # (B, T)
        slot_oh.append(oh)
        assigned = assigned + oh.sum(dim=1)
    denom = sum(slot_gate) + 1e-9
    dispatch = logits.new_zeros((b, t, e, cap))
    combine = logits.new_zeros((b, t, e, cap))
    for oh, gate, pos in zip(slot_oh, slot_gate, slot_pos):
        keep = (pos < cap).to(torch.float32)  # (B, T)
        sel = oh[..., None] * _one_hot(pos, cap)[:, :, None, :] * \
            keep[..., None, None]
        dispatch = dispatch + sel
        combine = combine + (gate / denom)[..., None, None] * sel
    return dispatch, combine, slot_oh[0], probs


def aux_loss(logits, probs, first_choice, *, aux_loss_weight: float,
             router_z_weight: float, replicas=None):
    """Switch's load-balancing loss over first choices plus the router
    z-loss, in f32: ``e * sum(frac * prob) * aux_loss_weight +
    mean(logsumexp(logits)**2) * router_z_weight``.  With ``replicas``
    (an :class:`AuxLosses`' group) the three means are over the global
    batch: this rank's sums, summed over the replicas in one all-reduce
    with an identity backward, over the global B*T; padded rows count, as
    in the JAX layer."""
    e = logits.shape[-1]
    lse2 = torch.logsumexp(logits, dim=-1) ** 2
    if replicas is None:
        frac = first_choice.mean(dim=(0, 1))  # dispatch fraction / expert
        prob = probs.mean(dim=(0, 1))  # mean router probability / expert
        zmean = torch.mean(lse2)
    else:
        n = logits.shape[0] * logits.shape[1] * replicas.size
        sums = _SumOverReplicas.apply(torch.cat([
            first_choice.sum(dim=(0, 1)), probs.sum(dim=(0, 1)),
            lse2.sum()[None]]), replicas) / n
        frac, prob, zmean = sums[:e], sums[e:2 * e], sums[2 * e]
    aux = e * torch.sum(frac * prob) * aux_loss_weight
    return aux + zmean * router_z_weight


class MoEMlp(nn.Module):
    """Top-k routed expert FFN, a drop-in for a transformer block's dense
    MLP: (B, T, H) -> (B, T, H).  With one expert and top-1 it is the
    plain tanh-gelu FFN of the expert's weights (combine weight 1)."""

    def __init__(self, num_experts: int, hidden_dim: int, mlp_dim: int, *,
                 top_k: int = 2, capacity_factor: float = 1.5,
                 aux_loss_weight: float = 1e-2,
                 router_z_weight: float = 1e-3):
        super().__init__()
        e, h, m = num_experts, hidden_dim, mlp_dim
        # The routing configuration is read by the program cache's
        # fingerprint (train/compile_cache.py::_config_attrs): two layers
        # that differ only in top_k or capacity_factor route differently.
        self.num_experts = e
        self.hidden_dim = h
        self.mlp_dim = m
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        self.router_z_weight = router_z_weight
        self.expert_w1 = nn.Parameter(torch.empty(e, h, m))
        self.expert_b1 = nn.Parameter(torch.zeros(e, m))
        self.expert_w2 = nn.Parameter(torch.empty(e, m, h))
        self.expert_b2 = nn.Parameter(torch.zeros(e, h))
        self.router = Dense(h, e, bias=False)
        # Expert parallelism: the rank's expert group (None: every expert
        # here), the axis size and the first expert this layer holds (the
        # two ints are part of the program cache's fingerprint).
        self._ep_group = None
        self.ep = 1
        self.expert_offset = 0

    @property
    def ep_group(self):
        return self._ep_group

    def bind_experts(self, group) -> bool:
        """Hold and compute only ``group.index``'s E/ep experts of the
        ``group.size`` ranks of an expert group (``GroupComm``), their
        values cut from the layer's: the parameters are replaced, so bind
        before an optimizer is built.  A layer whose E does not divide by
        ep stays whole (the JAX rule replicates it); returns whether it
        was split."""
        # Imported here: the parallel package imports this module.
        from learningorchestra_tpu_torch.parallel.sharding import (
            expert_slice,
            splits_experts,
        )

        ep = group.size
        if not splits_experts("expert_w1", self.expert_w1.shape, ep):
            return False
        cut = expert_slice(self.num_experts, group.index, ep)
        for key in EXPERT_LEAVES:
            setattr(self, key, nn.Parameter(
                getattr(self, key).detach()[cut].clone()))
        self._ep_group, self.ep, self.expert_offset = group, ep, cut.start
        return True

    @torch.no_grad()
    def init_leaves(self, gen: torch.Generator) -> None:
        """Seeded init of the expert leaves (``train/neural.py::
        init_params``): N(0, 1/fan_in) per expert, the input axis's fan in
        (flax's lecun_normal with the expert axis as a batch axis), zero
        biases."""
        for w in (self.expert_w1, self.expert_w2):
            w.copy_(torch.randn(w.shape, generator=gen) /
                    math.sqrt(w.shape[1]))
        self.expert_b1.zero_()
        self.expert_b2.zero_()

    def forward(self, x, aux_losses: list | None = None):
        cap = capacity(self.num_experts, self.top_k, x.shape[1],
                       self.capacity_factor)
        logits = F.linear(x.to(torch.float32),
                          self.router.weight.to(torch.float32))  # (B, T, E)
        dispatch, combine, first, probs = route(logits, self.top_k, cap)
        if aux_losses is not None:
            aux_losses.append(aux_loss(
                logits, probs, first, aux_loss_weight=self.aux_loss_weight,
                router_z_weight=self.router_z_weight,
                replicas=getattr(aux_losses, "replicas", None)))
        dt = x.dtype
        group = self._ep_group
        if group is not None:
            lo = self.expert_offset
            dispatch = dispatch[:, :, lo:lo + self.expert_w1.shape[0]]
            x = _SumBackward.apply(x, group)
        xe = torch.einsum("btec,bth->ebch", dispatch.to(dt), x)
        h1 = torch.einsum("ebch,ehm->ebcm", xe, self.expert_w1.to(dt))
        h1 = F.gelu(h1 + self.expert_b1.to(dt)[:, None, None, :],
                    approximate="tanh")  # flax nn.gelu is the tanh form
        h2 = torch.einsum("ebcm,emh->ebch", h1, self.expert_w2.to(dt))
        h2 = h2 + self.expert_b2.to(dt)[:, None, None, :]
        if group is not None:
            h2 = _GatherExperts.apply(h2, group)
        return torch.einsum("btec,ebch->bth", combine.to(dt), h2)


def split_expert_parameters(module: nn.Module) -> list:
    """The expert parameters of ``module``'s MoE layers split over an
    expert group: each rank holds a different slice of them."""
    return [getattr(mod, key) for mod in module.modules()
            if isinstance(mod, MoEMlp) and mod.ep_group is not None
            for key in EXPERT_LEAVES]
