"""Data-, expert- and sequence-parallel execution — port of the data,
expert and sequence axes of ``learningorchestra_tpu/parallel/``.

- ``mesh``: the six named axes and ``MeshSpec``; ``build_mesh`` lays a
  spec over devices (only ``dp``, ``ep`` and ``sp`` may exceed 1 here);
- ``sharding``: which rows of a global batch, and which tokens of them,
  each rank takes, and which experts of an MoE layer;
- ``distributed``: ``DistributedTrainer``, one process per rank on
  ``torch.distributed`` (``rank.py`` is the rank program);
- ``ring_attention``: attention over the ``sp`` ring of ranks.

Pipeline and MPMD stages, the multi-host coordinator and launch, and the
parameter sharding rules (``fsdp``/``tp``) are ROADMAP A.9 part 2.
"""

from learningorchestra_tpu_torch.parallel.distributed import (  # noqa: F401
    DistributedTrainer,
    distributed_fit,
)
from learningorchestra_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshSpec,
    build_mesh,
    default_spec,
)
from learningorchestra_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_rows,
    shard_batch,
)
