"""Artifact persistence of the port — port of
``learningorchestra_tpu/store/``: the embedded WAL document store (the
system of record), metadata and lineage, and the volumes that hold each
artifact's binary.

The system of record is the C++ store (native/__init__.py) where its
library builds, else the Python one (``open_document_store``).  Each
named artifact is a collection whose document ``_id=0`` is its
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
from learningorchestra_tpu_torch import native  # noqa: E402 — needs the above


def open_document_store(root, durable_writes: bool = False,
                        backend: str = "auto"):
    """Open the system of record at ``root``.

    ``backend``: ``"native"`` (the C++ store, native/__init__.py; raises
    with g++'s output when its library cannot be built), ``"python"``
    (the embedded WAL store) or ``"auto"`` — native when the library
    builds, else python, with the build error logged.  Both backends
    share one WAL format with each other and with the JAX package, so a
    directory any of them wrote opens under the others."""
    if backend not in ("auto", "native", "python"):
        raise ValueError(f"unknown store backend: {backend!r}")
    if backend in ("auto", "native"):
        try:
            return native.NativeDocumentStore(root,
                                              durable_writes=durable_writes)
        except (native.NativeBuildError, OSError) as exc:
            if backend == "native":
                raise
            from learningorchestra_tpu_torch.log import get_logger

            get_logger("store").error(
                "native store unavailable, opening the python store: %s",
                exc)
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
