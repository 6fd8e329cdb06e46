"""Batch placement over the data axis — port of the batch half of
``learningorchestra_tpu/parallel/sharding.py``.

In the JAX package a batch enters sharded over ``("dp", "fsdp")``: device
r of a world of W holds rows ``[r*B/W, (r+1)*B/W)`` of each global batch
of B rows (``batch_sharding`` / ``shard_batch``).  Here the same rule
picks the rows each rank process feeds its replica.  The parameter rules
(``leaf_spec``, ``param_shardings``) shard leaves over ``fsdp``/``tp`` and
wait for ROADMAP A.9 part 2.
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
