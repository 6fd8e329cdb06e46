"""Volume-backed binary artifact storage — port of
``learningorchestra_tpu/store/volumes.py``.

A host directory tree keyed by service type (the reference's six named
volumes).  Objects are stored with the standard library's ``pickle`` (the
JAX package uses ``dill``).  Only pickled objects are ported: the port's artifacts are
plain dicts of numpy arrays (``NeuralEstimator.to_artifact``), so neither
``save_pytree`` nor the raw-stream and delete helpers have a caller yet.
Only bytes this program wrote should be read back: unpickling runs code.
"""

from __future__ import annotations

import os
import pickle
import re
from pathlib import Path
from typing import Any

# Binary names come from REST request JSON and become file names — no
# separators, no traversal.
_NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]*$")


def _validate_name(name: str) -> str:
    if not _NAME_RE.match(name or "") or ".." in name:
        raise ValueError(f"invalid artifact name: {name!r}")
    return name


VOLUME_KEYS = (
    "datasets",
    "models",
    "binaries",
    "transform",
    "explore",
    "code_executions",
)


def volume_key_for_type(artifact_type: str) -> str:
    """Map an artifact type like ``train/pytorch`` to its volume."""
    head = artifact_type.split("/", 1)[0]
    return {
        "dataset": "datasets",
        "model": "models",
        "train": "binaries",
        "tune": "binaries",
        "evaluate": "binaries",
        "predict": "binaries",
        "builder": "binaries",
        "transform": "transform",
        "explore": "explore",
        "function": "code_executions",
    }.get(head, "binaries")


class VolumeStorage:
    def __init__(self, root: str | Path):
        self.root = Path(root).expanduser()
        for key in VOLUME_KEYS:
            (self.root / key).mkdir(parents=True, exist_ok=True)

    def path_for(self, artifact_type: str, name: str) -> Path:
        return self.root / volume_key_for_type(artifact_type) / _validate_name(
            name
        )

    # -- pickled objects -------------------------------------------------------

    def save_object(self, artifact_type: str, name: str, obj: Any) -> Path:
        return self._dump_atomic(self.path_for(artifact_type, name), obj)

    @staticmethod
    def _dump_atomic(path: Path, obj: Any) -> Path:
        """tmp + rename publish: a rewrite while a reader loads never
        exposes a torn file."""
        path.parent.mkdir(parents=True, exist_ok=True)
        # Leading '.' never collides with an artifact: _NAME_RE requires
        # names to start with an alphanumeric.
        tmp = path.with_name("." + path.name + ".tmp")
        with open(tmp, "wb") as fh:
            pickle.dump(obj, fh, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
        return path

    def read_object(self, artifact_type: str, name: str) -> Any:
        path = self.path_for(artifact_type, name)
        with open(path, "rb") as fh:
            return pickle.load(fh)
