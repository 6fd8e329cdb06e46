"""Volume-backed binary artifact storage — port of
``learningorchestra_tpu/store/volumes.py``.

A host directory tree keyed by service type (the reference's six named
volumes).  Objects are stored with the standard library's ``pickle`` (the
JAX package uses ``dill``).

Estimators are stored as artifacts, not as pickled modules: the JAX
package dills the estimator object, whose ``__getstate__`` moves the
params to the host (int8 when the fit asked for ``quantize_checkpoint``);
the port stores :meth:`NeuralEstimator.to_artifact` dicts of numpy arrays
(:meth:`VolumeStorage.save_estimator`, which runs the quantize kernel
there) and rebuilds them on a device (:meth:`load_estimator`, which runs
the dequantize kernel).  A classical estimator (``TensorEstimator``) is
pickled as it is, its tensors on the CPU, and any other result (an
evaluate dict, predict arrays, a transform's tensors) with its tensors
moved to the CPU: an artifact made on the card loads where there is
none, and :meth:`load_estimator` places it on the caller's device.  Only
bytes this program wrote should be read back: unpickling runs code.

Unpickling never imports the JAX package: a pickle that names one of
its classes loads as the port's own class where the port has one (the
BPE tokenizer a JAX server's text transform stored) and fails with a
clear error otherwise.  Raw bytes (generic ingest, explore PNGs) go
through :meth:`VolumeStorage.save_stream` and :meth:`read_bytes`.
"""

from __future__ import annotations

import io
import os
import pickle
import re
import shutil
from pathlib import Path
from typing import Any

from learningorchestra_tpu_torch.toolkit.base import (
    TensorEstimator,
    map_tensors,
)
from learningorchestra_tpu_torch.train.neural import (
    NeuralEstimator,
    is_artifact,
    load_artifact,
)

# Binary names come from REST request JSON and become file names — no
# separators, no traversal.
_NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]*$")


def _validate_name(name: str) -> str:
    if not _NAME_RE.match(name or "") or ".." in name:
        raise ValueError(f"invalid artifact name: {name!r}")
    return name


#: Classes of the JAX package whose pickles load as the port's own.
_PORTED_CLASSES = {
    ("learningorchestra_tpu.text.bpe", "BpeTokenizer"):
        ("learningorchestra_tpu_torch.text.bpe", "BpeTokenizer"),
}


class _PortUnpickler(pickle.Unpickler):
    """``pickle.Unpickler`` that maps the JAX package's ported classes to
    the port's and refuses its other classes instead of importing them."""

    def find_class(self, module: str, name: str):
        if module.split(".", 1)[0] == "learningorchestra_tpu":
            target = _PORTED_CLASSES.get((module, name))
            if target is None:
                raise pickle.UnpicklingError(
                    f"{module}.{name} is a class of the JAX package, which "
                    "the PyTorch package does not import")
            module, name = target
        return super().find_class(module, name)


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
        """Pickle ``obj`` with every tensor in it on the CPU."""
        return self._dump_atomic(self.path_for(artifact_type, name),
                                 map_tensors(obj, lambda t: t.detach().cpu()))

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
            return _PortUnpickler(fh).load()

    # -- estimators as artifacts ---------------------------------------------

    def save_estimator(self, artifact_type: str, name: str,
                       estimator: NeuralEstimator | TensorEstimator) -> Path:
        """Persist a neural estimator as ``estimator.to_artifact()``: int8
        parameters (one grouped quantize launch) when its last fit asked
        for ``quantize_checkpoint``, else f32 with the optimizer state;
        anything else (a classical estimator, a mesh model, a transform's
        output) as :meth:`save_object` pickles it."""
        if isinstance(estimator, NeuralEstimator):
            estimator = estimator.to_artifact()
        return self.save_object(artifact_type, name, estimator)

    def load_estimator(self, artifact_type: str, name: str, *, device):
        """The stored object placed on ``device``: an estimator artifact
        rebuilt there (int8 leaves dequantize in one grouped launch), a
        classical estimator's state and any other object's tensors
        moved there."""
        obj = self.read_object(artifact_type, name)
        if is_artifact(obj):
            return load_artifact(obj, device=device)
        if callable(getattr(obj, "to", None)):
            # A tensor estimator, or a mesh model (a pipelined transformer)
            # pickled with its f32 state on the host, places itself.
            return obj.to(device)
        return map_tensors(obj, lambda t: t.to(device))

    # -- raw bytes ------------------------------------------------------------

    def save_stream(self, artifact_type: str, name: str,
                    stream: io.BufferedIOBase,
                    chunk_size: int = 1 << 20) -> Path:
        """Copy a byte stream onto the volume in chunks."""
        path = self.path_for(artifact_type, name)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as fh:
            shutil.copyfileobj(stream, fh, chunk_size)
        return path

    def read_bytes(self, artifact_type: str, name: str) -> bytes:
        return self.path_for(artifact_type, name).read_bytes()

    # -- lifecycle ------------------------------------------------------------

    def exists(self, artifact_type: str, name: str) -> bool:
        return self.path_for(artifact_type, name).exists()

    def delete(self, artifact_type: str, name: str) -> bool:
        path = self.path_for(artifact_type, name)
        if path.is_dir():
            shutil.rmtree(path)
            return True
        if path.exists():
            path.unlink()
            return True
        return False

    def delete_everywhere(self, name: str) -> bool:
        """Remove a named binary from whichever volume holds it."""
        _validate_name(name)
        hit = False
        for key in VOLUME_KEYS:
            path = self.root / key / name
            if path.is_dir():
                shutil.rmtree(path)
                hit = True
            elif path.exists():
                path.unlink()
                hit = True
        return hit
