"""Batch placement over the data axis and the expert rule — port of the
batch half and of the expert leaves of
``learningorchestra_tpu/parallel/sharding.py``.

In the JAX package a batch enters sharded over ``("dp", "fsdp")``: device
r of a world of W holds rows ``[r*B/W, (r+1)*B/W)`` of each global batch
of B rows (``batch_sharding`` / ``shard_batch``).  Here the same rule
picks the rows each rank process feeds its replica, by the rank's dp
index; with an ``sp`` axis the ranks of one replica split each row's
tokens the same way (the JAX ``P(("dp", "fsdp"), "sp")`` token sharding).
The batch is not sharded over ``ep``: the ep ranks of one replica see the
same rows.  Of the parameter rules (``leaf_spec``) the expert one is
ported: a 2-D or 3-D leaf whose name holds ``expert`` and whose leading
(expert) dimension divides by ``ep`` is split into E/ep whole experts per
ep index (:func:`expert_slice`); a leaf that does not divide stays whole
on every rank, the JAX fall-through that replicates it.  The
``fsdp``/``tp`` rules wait for ROADMAP A.9 part 3.  A pipeline stage
(``pp``, parallel/pipeline.py) takes the rows of its dp index and holds
its own slice of the layers.
"""

from __future__ import annotations


def batch_rows(batch_size: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s rows of a global batch of ``batch_size`` rows."""
    if batch_size % world:
        raise ValueError(
            f"global batch_size {batch_size} not divisible by "
            f"dp*fsdp={world}")
    per = batch_size // world
    return slice(rank * per, (rank + 1) * per)


def shard_batch(arrays: tuple, rank: int, world: int) -> tuple:
    """Rank ``rank``'s slice of each array's leading (batch) axis."""
    return tuple(a[batch_rows(a.shape[0], rank, world)] for a in arrays)


def rank_coords(rank: int, sp: int, ep: int = 1, pp: int = 1
                ) -> tuple[int, int, int, int]:
    """(dp, pp, ep, sp) indices of ``rank``, the JAX mesh's axis order
    with ``sp`` fastest: ``rank = ((dp * pp + pp_index) * ep + ep_index)
    * sp + sp_index``."""
    return (rank // (sp * ep * pp), (rank // (sp * ep)) % pp,
            (rank // sp) % ep, rank % sp)


def splits_experts(name: str, shape, ep: int) -> bool:
    """The JAX ``leaf_spec``'s expert rule: a 2-D (experts, features) or
    3-D (experts, in, out) leaf named ``expert`` whose leading dimension
    divides by ``ep`` > 1 is sharded over ``ep``."""
    return ep > 1 and len(shape) in (2, 3) and "expert" in name.lower() \
        and shape[0] % ep == 0


def expert_slice(num_experts: int, ep_index: int, ep: int) -> slice:
    """Experts ``[i*E/ep, (i+1)*E/ep)`` of ep index i."""
    per = num_experts // ep
    return slice(ep_index * per, (ep_index + 1) * per)


def check_seq_divisible(x, sp: int) -> None:
    """The JAX trainer's error for a token matrix whose sequence length
    the sp axis cannot split."""
    if sp > 1 and x.ndim > 1 and x.dtype.kind in "iu" and x.shape[1] % sp:
        raise ValueError(
            f"sequence length {x.shape[1]} not divisible by sp={sp}")


def sequence_slice(t: int, sp_index: int, sp: int) -> slice:
    """Tokens ``[s*T/sp, (s+1)*T/sp)`` of a row of ``t`` for sp index s."""
    if t % sp:
        raise ValueError(f"sequence length {t} not divisible by sp={sp}")
    per = t // sp
    return slice(sp_index * per, (sp_index + 1) * per)
