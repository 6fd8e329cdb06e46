"""Fleet serving — the multi-replica data plane over leased cards — port
of ``learningorchestra_tpu/serve/fleet``.

A served model's module serves from N replicas, each holding a card
lease, a MicroBatcher and its placement; traffic spreads by
power-of-two-choices on live batcher queue depth, and a metrics-driven
control loop turns sustained saturation into replicas instead of 429s.

- :mod:`router` — ``P2CRouter``: seeded power-of-two-choices candidate
  ranking;
- :mod:`replicaset` — ``Replica``/``ReplicaSet``: per-replica card lease
  + batcher + placement, drain-before-unload scale-down;
- :mod:`autoscaler` — ``Autoscaler``: the control loop over queue depth,
  p99, sheds and traffic;
- :mod:`manager` — ``FleetManager``: per-model sets + bounds + the
  lazily started autoscaler thread.

Knobs: ``config.FleetConfig`` (``LO_TPU_FLEET_*``); REST: ``GET|POST|
DELETE /serve/<model>/replicas`` and ``GET /serve/fleet``.
"""

from learningorchestra_tpu_torch.serve.fleet.autoscaler import Autoscaler
from learningorchestra_tpu_torch.serve.fleet.manager import FleetManager
from learningorchestra_tpu_torch.serve.fleet.replicaset import (
    Replica,
    ReplicaSet,
)
from learningorchestra_tpu_torch.serve.fleet.router import P2CRouter

__all__ = [
    "Autoscaler",
    "FleetManager",
    "P2CRouter",
    "Replica",
    "ReplicaSet",
]
