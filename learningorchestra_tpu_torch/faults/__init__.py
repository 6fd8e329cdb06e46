"""Fault-injection plane (chaos layer) — port of
``learningorchestra_tpu/faults/``; see plane.py.

Subsystems call ``faults.hit("<point>")`` on their hot paths; seeded
schedules armed via ``LO_TPU_FAULT_*`` (``FaultsConfig.specs``) or the
``/faults`` REST surface decide whether that hit preempts, errors, or
delays.  Disabled (the default) it is one truthiness check.
"""

from learningorchestra_tpu_torch.faults.plane import (
    ENV_PREFIX,
    MODES,
    POINTS,
    FaultInjected,
    FaultSchedule,
    arm,
    disarm,
    disarm_all,
    hit,
    load_env,
    parse_spec,
    points,
    register_point,
    reset,
    status,
    triggers,
)

__all__ = [
    "ENV_PREFIX",
    "MODES",
    "POINTS",
    "FaultInjected",
    "FaultSchedule",
    "arm",
    "disarm",
    "disarm_all",
    "hit",
    "load_env",
    "parse_spec",
    "points",
    "register_point",
    "reset",
    "status",
    "triggers",
]
