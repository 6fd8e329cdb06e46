"""Artifact persistence of the port — port of
``learningorchestra_tpu/store/``: the embedded WAL document store (the
system of record), metadata and lineage, and the volumes that hold each
artifact's binary.

Each named artifact is a collection whose document ``_id=0`` is its
metadata record (``finished`` flag, ``jobState``, lineage via
``parentName``), with result rows and execution records at ``_id >= 1``.
"""

from learningorchestra_tpu_torch.store.artifacts import (
    ArtifactStore,
    DuplicateArtifact,
    LineageError,
    Metadata,
)
from learningorchestra_tpu_torch.store.document_store import DocumentStore
from learningorchestra_tpu_torch.store.volumes import VolumeStorage


def open_document_store(root, durable_writes: bool = False,
                        backend: str = "auto") -> DocumentStore:
    """Open the system of record at ``root``.

    ``backend`` is ``"python"`` or ``"auto"`` (both the embedded WAL
    store).  ``"native"`` names the JAX package's C++ store, which the
    port does not carry; a directory either package wrote opens here,
    since both share one WAL format."""
    if backend == "native":
        raise ValueError(
            "store backend 'native' is the JAX package's C++ store "
            "(liblodstore), which is not ported; use 'python' or 'auto'"
        )
    if backend not in ("auto", "python"):
        raise ValueError(f"unknown store backend: {backend!r}")
    return DocumentStore(root, durable_writes=durable_writes)


__all__ = [
    "ArtifactStore",
    "DocumentStore",
    "DuplicateArtifact",
    "LineageError",
    "Metadata",
    "VolumeStorage",
    "open_document_store",
]
