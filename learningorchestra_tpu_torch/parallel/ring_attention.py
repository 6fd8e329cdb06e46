"""Ring attention over the ``sp`` axis — port of
``learningorchestra_tpu/parallel/ring_attention.py``.

The sequence axis is split over the ranks of one sequence-parallel ring
(:class:`Ring`, one process per rank, parallel/distributed.py): each rank
holds its query block resident and the key/value blocks travel the ring,
one hop per step, so the result is exact attention over the whole
sequence without any rank holding the (T, T) scores.  Where the JAX
package rotates with ``lax.ppermute`` inside ``shard_map``, a rank here
posts a receive from the previous rank and a send to the next one
together (``dist.batch_isend_irecv``) and waits for both: at ``sp = 2``
the previous and the next rank are the same peer, and a blocking send
before the receive would deadlock.  NCCL carries device tensors between
ranks on cards of their own; gloo (ranks sharing a card, or on the CPU)
carries them through host copies, as ``DataParallel`` stages its
all-reduce.  Every wait is bounded by the fit's ``COLLECTIVE_TIMEOUT_S``.

- :func:`ring_attention`: the online-softmax ring in plain PyTorch, a
  block of f32 scores per step; its backward runs through
  :class:`_Rotate`, a rotation whose backward rotates the other way.
- :func:`ring_flash_attention`: kernel K1 (``flash_attention_fwd``) once
  per step, the partial outputs merged by their LSE
  (:func:`_merge_partials`); the backward is written out
  (:class:`_RingFlash`): the reverse ring of the JAX
  ``_ring_flash_core_bwd``, K2 and K3 once per step with the MERGED
  output's LSE and delta, dQ accumulating at home while the dK/dV
  partials travel with their key/value block and arrive home after the
  full circuit.  A causal ring runs the diagonal step causal and skips
  the blocks of later ranks (no launch).  The kernels mask their own
  ragged tails, so no local length is padded (the JAX ``_ring_blocks``
  has no counterpart).
- :func:`reference_attention`: unsharded exact attention, the oracle.
- :class:`RingSelfAttention`: the long-context model's attention layer.

Inputs of the ring functions are THIS rank's blocks, (B, T/sp, H, D),
with the key mask (B, T/sp); the rank's place on the ring gives their
global positions.  The two JAX rings differ on a query row with no valid
key: the flash ring gives 0 (the kernels' rule), the online ring and
:func:`reference_attention` the mean of V; each port follows its JAX
function.
"""

from __future__ import annotations

from datetime import timedelta

import torch
import torch.distributed as dist
from torch import nn

from learningorchestra_tpu_torch.ops import attention
from learningorchestra_tpu_torch.ops.layers import Dense

NEG_INF = -1e30
_MERGE_EMPTY = -1e30  # merge-domain lse for "no keys seen yet"


class Ring:
    """One rank's place on its sequence-parallel ring: the ring's process
    group, this rank's index on it (``index``, which block of the sequence
    it holds) and its size.  ``host_staged``: a gloo ring of CUDA tensors
    sends host copies."""

    def __init__(self, group, index: int, size: int, device,
                 backend: str, timeout_s: float):
        self.group, self.index, self.size = group, index, size
        self.device = torch.device(device)
        self.backend = backend
        self.timeout = timedelta(seconds=timeout_s)
        self.host_staged = backend != "nccl" and self.device.type == "cuda"

    def start_rotate(self, tensors, reverse: bool = False) -> "_Transfer":
        """Post the hop of ``tensors`` to the next rank (the previous one
        with ``reverse``) and the receive of the other side's, together;
        ``.wait()`` returns the received tensors on this rank's device."""
        n = self.size
        dst = (self.index + (-1 if reverse else 1)) % n
        src = (self.index + (1 if reverse else -1)) % n
        sends = [t.detach().contiguous() for t in tensors]
        if self.host_staged:
            sends = [t.cpu() for t in sends]
        recvs = [torch.empty_like(t) for t in sends]
        ops = [dist.P2POp(dist.irecv, r, group=self.group, group_peer=src)
               for r in recvs]
        ops += [dist.P2POp(dist.isend, s, group=self.group, group_peer=dst)
                for s in sends]
        return _Transfer(self, dist.batch_isend_irecv(ops), sends, recvs)

    def rotate(self, tensors, reverse: bool = False) -> list:
        return self.start_rotate(tensors, reverse).wait()

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ring's ranks (a new tensor on ``t``'s
        device)."""
        out = t.detach().clone()
        if self.host_staged:
            host = out.cpu()
            dist.all_reduce(host, group=self.group)
            return host.to(t.device)
        dist.all_reduce(out, group=self.group)
        return out


class _Transfer:
    """A posted rotation; ``wait`` bounds every request by the ring's
    timeout (gloo) and moves host-staged tensors back to the device."""

    def __init__(self, ring: Ring, works, sends, recvs):
        self.ring, self.works = ring, works
        self.sends, self.recvs = sends, recvs  # alive until the wait

    def wait(self) -> list:
        ring = self.ring
        for work in self.works:
            if ring.backend == "nccl":
                work.wait()
            elif not work.wait(ring.timeout):
                raise RuntimeError(
                    f"ring rotation on rank {ring.index} of {ring.size} "
                    f"did not finish within {ring.timeout}")
        if ring.host_staged:
            return [r.to(ring.device, non_blocking=True) for r in self.recvs]
        return self.recvs


class _Rotate(torch.autograd.Function):
    """A differentiable hop: forward to the next rank, the gradient back
    to the previous one."""

    @staticmethod
    def forward(ctx, ring, *tensors):
        ctx.ring = ring
        return tuple(ring.rotate(tensors))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.ring.rotate(grads, reverse=True))


class _RingSum(torch.autograd.Function):
    """The sum over the ring in forward; in backward the sum of the
    incoming gradients, so each rank's partial receives every rank's
    share of the loss (parallel/distributed.py divides each rank's loss
    by sp)."""

    @staticmethod
    def forward(ctx, ring, t):
        ctx.ring = ring
        return ring.all_reduce(t)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.ring.all_reduce(g)


def ring_sum(t: torch.Tensor, ring: Ring) -> torch.Tensor:
    """Differentiable sum of ``t`` over the ring's ranks."""
    return _RingSum.apply(ring, t)


# -- the online-softmax ring ----------------------------------------------------


def _block_attend(q, k, kmask, bias):
    """Scores (B, H, Tq, Tk) of one (query block, key block) pair: the
    bias added, then masked keys set to NEG_INF (the JAX order)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if bias is not None:
        s = s + bias[None, None]
    if kmask is not None:
        s = torch.where(kmask[:, None, None, :], s, NEG_INF)
    return s


def _online_update(o, m, l, s, v):
    """Fold one block of scores into the running softmax accumulators."""
    m_new = torch.maximum(m, s.amax(-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * corr + p.sum(-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o * corr[..., None].transpose(1, 2) + pv, m_new, l_new


def ring_attention(q, k, v, *, ring: Ring, kmask=None,
                   causal: bool = False):
    """Exact attention of this rank's query block (B, T_loc, H, D) over
    the whole ring's keys: the online-softmax ring of the JAX package, in
    f32.  ``kmask`` (B, T_loc) marks this rank's valid keys."""
    n, me = ring.size, ring.index
    b, t, h, d = q.shape
    o = torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, t), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    q32 = q.float()
    kb, vb = k, v
    km = None if kmask is None else kmask.bool()
    pos = torch.arange(t, device=q.device)
    for step in range(n):
        src = (me - step) % n
        bias = None
        if causal:
            bias = torch.where((me * t + pos)[:, None] >= (src * t + pos)[None],
                               0.0, NEG_INF)
        s = _block_attend(q32, kb.float(), km, bias)
        o, m, l = _online_update(o, m, l, s, vb.float())
        if step < n - 1:
            kb, vb = _Rotate.apply(ring, kb, vb)
            if km is not None:
                km = ring.rotate([km])[0]
    l = torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]
    return (o / l).to(q.dtype)


# -- the flash ring ---------------------------------------------------------------


def _kernel_lse_to_merge(lse):
    """Kernel sentinel (+1e30 for fully-masked rows) -> merge domain."""
    return torch.where(lse > 1e29, _MERGE_EMPTY, lse)


def _merge_partials(o_c, lse_c, o_b, lse_b):
    """Fold one block's normalized output into the running result: the
    exact combination re-weights by exp(lse - m), an empty side weighing
    0."""
    m = torch.maximum(lse_c, lse_b)
    wc = torch.where(lse_c > _MERGE_EMPTY / 2, torch.exp(lse_c - m), 0.0)
    wb = torch.where(lse_b > _MERGE_EMPTY / 2, torch.exp(lse_b - m), 0.0)
    denom = wc + wb
    safe = torch.where(denom > 0.0, denom, 1.0)
    o = (o_c * wc + o_b * wb) / safe
    lse = torch.where(denom > 0.0, m + torch.log(safe), _MERGE_EMPTY)
    return o, lse


def _step_branch(causal: bool, me: int, src: int) -> int:
    """0 = full block, 1 = diagonal (causal within), 2 = skip (future)."""
    if not causal:
        return 0
    return 1 if src == me else (0 if src < me else 2)


def _ring_flash_fwd(q, k, v, km, ring: Ring, causal: bool):
    """K1 per step, merged; returns (O like q, LSE (B, H, T, 1) in the
    kernel's sentinel domain for the backward)."""
    n, me = ring.size, ring.index
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full(q.shape[:3] + (1,), _MERGE_EMPTY, dtype=torch.float32,
                     device=q.device)
    kb, vb, kmb = k, v, km
    for step in range(n):
        branch = _step_branch(causal, me, (me - step) % n)
        pending = ring.start_rotate((kb, vb, kmb)) if step < n - 1 else None
        if branch != 2:
            ob, lseb = attention.flash_attention_fwd(
                q, kb, vb, kmb, causal=branch == 1)
            o, lse = _merge_partials(o, lse, ob.float(),
                                     _kernel_lse_to_merge(lseb))
        if pending is not None:
            kb, vb, kmb = pending.wait()
    return o.to(q.dtype), torch.where(lse <= _MERGE_EMPTY / 2, 1e30, lse)


class _RingFlash(torch.autograd.Function):
    """``_ring_flash_core`` and its custom_vjp: the forward ring of K1, the
    backward the reverse ring of K2 + K3 with the merged LSE and delta =
    rowsum(dO * O).  q, k, v are (B, H, T_loc, D); the key mask gets no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, km, ring, causal):
        out, lse = _ring_flash_fwd(q, k, v, km, ring, causal)
        ctx.save_for_backward(q, k, v, km, out, lse)
        ctx.ring, ctx.causal = ring, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, km, out, lse = ctx.saved_tensors
        ring, causal = ctx.ring, ctx.causal
        n, me = ring.size, ring.index
        do32 = g.float()
        delta = (do32 * out.float()).sum(-1, keepdim=True)
        do = do32.to(q.dtype).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkb = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvb = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        kb, vb, kmb = k, v, km
        for step in range(n):
            branch = _step_branch(causal, me, (me - step) % n)
            pending = ring.start_rotate((kb, vb, kmb)) \
                if step < n - 1 else None
            if branch != 2:
                dqs, dks, dvs = attention.flash_attention_bwd(
                    q, kb, vb, kmb, do, lse, delta, causal=branch == 1)
                dq += dqs.float()
                dkb += dks.float()
                dvb += dvs.float()
            if pending is not None:
                kb, vb, kmb = pending.wait()
            # The dK/dV partials travel WITH their block; after the full
            # circuit each block's gradient is home.
            dkb, dvb = ring.rotate((dkb, dvb))
        return (dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype),
                None, None, None)


def ring_flash_attention(q, k, v, *, ring: Ring, kmask=None,
                         causal: bool = False):
    """:func:`ring_attention`'s contract with kernel K1 per step (K2/K3
    in the backward): per-rank memory O(T_loc · D), the block products in
    the storage dtype.  On CPU tensors the kernels' plain versions run
    (tests)."""
    b, t = q.shape[:2]
    km = torch.ones((b, t), dtype=torch.float32, device=q.device) \
        if kmask is None else kmask.to(torch.float32).contiguous()
    out = _RingFlash.apply(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), km, ring, causal)
    return out.transpose(1, 2)


def reference_attention(q, k, v, kmask=None, causal: bool = False):
    """Unsharded exact attention on (B, T, H, D) — the correctness oracle
    (a row with no valid key gets the mean of V, as in the JAX package)."""
    s = _block_attend(q.float(), k.float(), None if kmask is None
                      else kmask.bool(), None)
    if causal:
        t = q.shape[1]
        pos = torch.arange(t, device=q.device)
        s = s + torch.where(pos[:, None] >= pos[None], 0.0, NEG_INF)[None, None]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


# -- the layer ------------------------------------------------------------------


class RingBound(nn.Module):
    """A module that runs over a :class:`Ring` once one is bound
    (``bind_ring``).  ``sp``, the bound ring's size, is configuration the
    program cache's module fingerprint reads; the ring itself is runtime
    state and never pickled."""

    sp = 1
    _ring: Ring | None = None

    def bind_ring(self, ring: Ring | None) -> None:
        """Bind ``ring`` in this module and every ``RingBound`` below it;
        None unbinds, leaving the configuration of a module never bound."""
        for mod in self.modules():
            if not isinstance(mod, RingBound):
                continue
            if ring is None:
                mod.__dict__.pop("_ring", None)
                mod.__dict__.pop("sp", None)
            else:
                mod._ring, mod.sp = ring, ring.size

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_ring", None)
        state.pop("sp", None)
        return state


class RingSelfAttention(RingBound):
    """Self-attention whose QKV projection is the JAX layer's
    ``DenseGeneral((3, H, D))`` (``qkv``) and output ``Dense`` (``out``).
    Bound to a ring of more than one rank it runs ring attention: the
    flash ring on CUDA tensors, the online-softmax ring on CPU tensors
    (the JAX layer's TPU / elsewhere choice).  Unbound
    it runs :func:`~learningorchestra_tpu_torch.ops.attention.flash_attention`
    over the whole sequence (K1, and K2/K3 in the backward, on a card)."""

    def __init__(self, num_heads: int, hidden_dim: int, *,
                 causal: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = hidden_dim // num_heads
        self.causal = causal
        self.qkv = Dense(hidden_dim, (3, num_heads, self.head_dim))
        self.out = Dense(hidden_dim, hidden_dim)

    def forward(self, x, kmask=None):
        b, t, hidden = x.shape
        q, k, v = self.qkv(x).view(
            b, t, 3, self.num_heads, self.head_dim).unbind(2)
        ring = self._ring
        if ring is not None and ring.size > 1:
            attend = (ring_flash_attention if q.device.type == "cuda"
                      else ring_attention)
            o = attend(q, k, v, ring=ring, kmask=kmask, causal=self.causal)
        else:
            o = attention.flash_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                kmask, causal=self.causal).transpose(1, 2)
        return self.out(o.reshape(b, t, hidden))
