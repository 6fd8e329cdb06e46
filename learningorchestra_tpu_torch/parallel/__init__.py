"""Data-, pipeline-, expert- and sequence-parallel execution — port of
the data, pipeline, expert and sequence axes of
``learningorchestra_tpu/parallel/``.

- ``mesh``: the six named axes and ``MeshSpec``; ``build_mesh`` lays a
  spec over devices (``fsdp`` and ``tp`` stay 1 here);
- ``sharding``: which rows of a global batch, and which tokens of them,
  each rank takes, and which experts of an MoE layer;
- ``distributed``: ``DistributedTrainer``, one process per rank on
  ``torch.distributed`` (``rank.py`` is the rank program);
- ``ring_attention``: attention over the ``sp`` ring of ranks;
- ``pipeline``: ``PipelinedTransformer``, layer stages over ``pp`` under
  the GPipe and 1F1B schedules (one process per rank) or ``mpmd`` (one
  program per stage, dispatched by the calling process: ``mpmd``).

The multi-host coordinator and launch, and the parameter sharding rules
(``fsdp``/``tp``) are ROADMAP A.9 part 3.
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
from learningorchestra_tpu_torch.parallel.pipeline import (  # noqa: F401
    PipelinedTransformer,
)
from learningorchestra_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_rows,
    shard_batch,
)
