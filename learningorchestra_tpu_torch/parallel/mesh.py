"""Named device meshes — port of ``learningorchestra_tpu/parallel/mesh.py``.

The six axes of the JAX package exist here too, so a request's ``mesh``
body means the same on both packages.  Four are ported: ``dp`` (a rank
is one process holding a replica of the model; gradients are all-reduced
over the ranks, parallel/distributed.py), ``ep`` (the ranks of one
data-parallel replica see the same rows and each holds and computes
E/ep of every MoE layer's experts, ops/moe.py), ``sp`` (the ranks of
one replica split each row's sequence and run ring attention,
parallel/ring_attention.py) and ``pp`` (each rank of a data-parallel
replica holds one stage of a ``PipelinedTransformer``'s layers,
parallel/pipeline.py).  Ranks follow the JAX axis order (dp, fsdp, pp,
ep, tp, sp), innermost last: rank ``r`` is
``((dp_index * pp + pp_index) * ep + ep_index) * sp + sp_index``.
``fsdp`` shards parameters and ``tp`` shards the model's work in the JAX
package; replicating them here would be a different memory contract, so
a spec with either above 1 is refused (ROADMAP A.9 part 3).  ``ep`` and
``sp`` together are refused too: no model of the zoo is both routed and
ring-bound (ROADMAP C).
"""

from __future__ import annotations

import dataclasses

import torch

AXES = ("dp", "fsdp", "pp", "ep", "tp", "sp")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. Total size must divide the device count."""

    dp: int = 1
    fsdp: int = 1
    pp: int = 1
    ep: int = 1
    tp: int = 1
    sp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.fsdp * self.pp * self.ep * self.tp * self.sp

    def axis_sizes(self) -> dict[str, int]:
        return {a: getattr(self, a) for a in AXES}

    @staticmethod
    def from_dict(d: dict) -> "MeshSpec":
        return MeshSpec(**{a: int(d.get(a, 1)) for a in AXES})


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices laid out by a spec: one ``torch.device`` per rank, in rank
    order, and the axis sizes (``fsdp`` and ``tp`` are 1)."""

    devices: tuple
    shape: dict

    @property
    def size(self) -> int:
        return len(self.devices)


def default_spec(n_devices: int) -> MeshSpec:
    """Pure data parallelism over every device."""
    return MeshSpec(dp=n_devices)


def validate_spec(spec: MeshSpec) -> None:
    for axis in AXES:
        size = getattr(spec, axis)
        if size < 1 or size != int(size):
            raise ValueError(f"mesh axis {axis} must be a positive int")
    if spec.sp > 1 and spec.sp & (spec.sp - 1):
        raise ValueError("sp axis should be a power of two")
    refused = {a: getattr(spec, a) for a in ("fsdp", "tp")
               if getattr(spec, a) > 1}
    if refused:
        raise ValueError(
            f"mesh axes {refused} are not ported to the PyTorch package: "
            "only the data axis dp, the pipeline axis pp, the expert axis "
            "ep and the sequence axis sp are (fsdp/tp: ROADMAP A.9 part 3)")
    if spec.ep > 1 and spec.sp > 1:
        raise ValueError(
            f"mesh axes ep={spec.ep} and sp={spec.sp} together are not "
            "ported to the PyTorch package: an expert-parallel replica "
            "holds whole rows (ROADMAP C)")


def build_mesh(spec: MeshSpec | None = None, devices: list | None = None
               ) -> Mesh:
    """Lay ``spec`` over ``devices`` (each a ``torch.device`` or its name;
    one rank per entry, so a card named twice holds two ranks).  The
    spec's size must divide the device count; spare devices fold into
    ``dp``, as in the JAX package, so ``{"dp": 2}`` over 8 devices is a
    world of 8, ``{"sp": 2}`` over 4 devices is dp 2 x sp 2 and
    ``{"ep": 2}`` over 4 devices is dp 2 x ep 2 and ``{"pp": 2}`` over 4
    devices dp 2 x pp 2."""
    if devices is None:
        devices = [f"cuda:{k}" for k in range(torch.cuda.device_count())]
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("build_mesh needs at least one device")
    spec = spec or default_spec(len(devs))
    validate_spec(spec)
    if spec.size > len(devs) or len(devs) % spec.size:
        raise ValueError(
            f"mesh spec {spec} (size {spec.size}) does not fit "
            f"{len(devs)} devices")
    spec = dataclasses.replace(spec, dp=spec.dp * (len(devs) // spec.size))
    return Mesh(devs, spec.axis_sizes())
