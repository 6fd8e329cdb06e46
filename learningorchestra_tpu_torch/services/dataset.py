"""Dataset service: CSV, tensor and generic ingest and the universal GET
path — port of the Python paths of
``learningorchestra_tpu/services/dataset.py``.

- ``POST /dataset/csv`` streams a CSV (a ``file://`` URL or a local
  path) into the store, one document per row, in batched inserts, on a
  job thread; headers are cleaned (non-alphanumeric -> underscore) and
  values type-inferred exactly as the JAX package does, so both packages
  store the same documents.  With ``shardRows`` the rows stream into
  columnar ``.npz`` shards on the volume instead (store/sharded.py), the
  first ``PREVIEW_ROWS`` also as documents;
- ``POST /dataset/tensor`` shards a memory-mapped ``.npy`` of N-D
  features and a ``.npy`` of labels, chunk by chunk;
- ``POST /dataset/generic`` copies a file onto the datasets volume.

HTTP sources answer 406 (the card's machine has no network and no
``requests``); the JAX package's native CSV engine is not ported
(ROADMAP A.11), so a sharded CSV takes its Python path.
"""

from __future__ import annotations

import csv
import math
import re

import numpy as np

from learningorchestra_tpu_torch.services.context import (
    ServiceContext,
    ValidationError,
)
from learningorchestra_tpu_torch.store.sharded import (
    ShardedDatasetWriter,
    ShardedTensorWriter,
)

_HEADER_CLEAN_RE = re.compile(r"[^0-9a-zA-Z_]+")
_INT_RE = re.compile(r"[+-]?[0-9]+")

CSV_TYPE = "dataset/csv"
GENERIC_TYPE = "dataset/generic"
TENSOR_TYPE = "dataset/tensor"


def _clean_header(header: list[str]) -> list[str]:
    out = []
    for i, h in enumerate(header):
        h = _HEADER_CLEAN_RE.sub("_", h.strip()).strip("_")
        out.append(h or f"col{i}")
    return out


def _infer(value: str):
    """Type inference matching the JAX package's (and its native CSV
    engine's) exactly: stricter than Python's int()/float() — no '_'
    separators, no inf/nan spellings, no hex; ints beyond int64 degrade
    to float; a blank cell is None."""
    v = value.strip()
    if v == "":
        return None
    if _INT_RE.fullmatch(v):
        iv = int(v)
        if -(2 ** 63) <= iv < 2 ** 63:
            return iv
        return float(v)
    if any(c in "_xX" for c in v):
        return value
    try:
        f = float(v)
    except ValueError:
        return value
    if math.isnan(f) or math.isinf(f):
        return value
    return f


def _local_path(url: str, what: str = "CSV") -> str:
    if url.startswith(("http://", "https://")):
        raise ValidationError(
            f"HTTP {what} sources are not ported to the PyTorch package; "
            "pass a file:// URL or a local path"
        )
    return url[len("file://"):] if url.startswith("file://") else url


class DatasetService:
    BATCH = 2000  # rows per insert_many
    PREVIEW_ROWS = 100  # GET page cap = a sharded dataset's preview size
    TENSOR_CHUNK_ROWS = 1024  # rows moved per mmap slice during ingest

    def __init__(self, ctx: ServiceContext):
        self.ctx = ctx

    # -- CSV ------------------------------------------------------------------

    def create_csv(self, name: str, url: str, *, infer_types: bool = True,
                   shard_rows: int | None = None) -> dict:
        """Async ingest: the metadata appears at once (finished=False),
        rows stream in on a job thread.  ``shard_rows`` switches to
        sharded ingest (:meth:`_ingest_sharded`)."""
        self.ctx.require_new_name(name)
        path = _local_path(url)
        meta = self.ctx.artifacts.metadata.create(
            name, CSV_TYPE, extra={"url": url}
        )

        def ingest():
            if shard_rows:
                return self._ingest_sharded(name, path, url, int(shard_rows),
                                            infer_types)
            n_rows = 0
            fields: list[str] = []
            # newline="": quoted fields keep their line breaks.
            with open(path, "r", encoding="utf-8", errors="replace",
                      newline="") as fh:
                batch: list[dict] = []
                for row in csv.reader(fh):
                    if not fields:
                        fields = _clean_header(row)
                        continue
                    if not row:
                        continue
                    batch.append({
                        fields[i]: (_infer(v) if infer_types else v)
                        for i, v in enumerate(row[: len(fields)])
                    })
                    if len(batch) >= self.BATCH:
                        n_rows += self.ctx.documents.insert_many(name, batch)
                        batch = []
                if batch:
                    n_rows += self.ctx.documents.insert_many(name, batch)
            return {"fields": fields, "rows": n_rows}

        self.ctx.engine.submit(
            name,
            ingest,
            description=f"csv ingest from {url}",
            on_success=lambda r: r,
            job_class="dataset",
        )
        return meta

    def _ingest_sharded(self, name: str, path: str, url: str,
                        shard_rows: int, infer_types: bool) -> dict:
        """Stream CSV rows into columnar volume shards: peak host memory
        is O(shard_rows x columns) whatever the file size.  The first
        ``PREVIEW_ROWS`` rows also land in the store so GET pages work;
        columns must be numeric (a blank cell is NaN)."""
        root = self.ctx.volumes.path_for(CSV_TYPE, name)
        writer = None
        preview: list[dict] = []
        fields: list[str] = []
        n_rows = 0
        with open(path, "r", encoding="utf-8", errors="replace",
                  newline="") as fh:
            for row in csv.reader(fh):
                if not fields:
                    fields = _clean_header(row)
                    writer = ShardedDatasetWriter(
                        root, fields, rows_per_shard=shard_rows)
                    continue
                if not row:
                    continue
                vals = [_infer(v) if infer_types else v
                        for v in row[: len(fields)]]
                vals += [None] * (len(fields) - len(vals))
                writer.append([float("nan") if v is None else v
                               for v in vals])
                if len(preview) < self.PREVIEW_ROWS:
                    preview.append(dict(zip(fields, vals)))
                n_rows += 1
        if writer is None:
            raise ValueError(f"CSV at {url} has no header row")
        manifest = writer.close()
        if preview:
            self.ctx.documents.insert_many(name, preview)
        return {
            "fields": fields,
            "rows": n_rows,
            "sharded": True,
            "shards": len(manifest["shard_rows"]),
            "shardRows": shard_rows,
            "previewRows": len(preview),
        }

    # -- tensor (N-D, image-shaped) -------------------------------------------

    def create_tensor(self, name: str, url: str, *, labels_url: str,
                      shard_rows: int = 4096) -> dict:
        """Sharded ingest of N-D features: ``url``/``labels_url`` point at
        ``.npy`` arrays, memory-mapped and copied chunk by chunk, so host
        memory stays O(chunk) whatever the file size.  The artifact trains
        like a sharded CSV: ``x="$name"`` (or ``"$name.x"``),
        ``y="$name.label"``."""
        self.ctx.require_new_name(name)
        if int(shard_rows) <= 0:
            raise ValueError("shardRows must be a positive integer")
        feats_path = _local_path(url, ".npy")
        labels_path = _local_path(labels_url, ".npy")
        meta = self.ctx.artifacts.metadata.create(
            name, TENSOR_TYPE,
            extra={"url": url, "labelsUrl": labels_url},
        )

        def ingest():
            feats = np.load(feats_path, mmap_mode="r")
            labels = np.load(labels_path, mmap_mode="r")
            if feats.ndim < 2:
                raise ValueError(
                    f"features must be (rows, ...), got {feats.shape}")
            if labels.shape[0] != feats.shape[0] or labels.ndim != 1:
                raise ValueError(
                    f"labels must be ({feats.shape[0]},), got "
                    f"{labels.shape}")
            writer = ShardedTensorWriter(
                self.ctx.volumes.path_for(TENSOR_TYPE, name),
                {"x": feats.shape[1:], "label": ()},
                rows_per_shard=int(shard_rows),
            )
            n = feats.shape[0]
            step = self.TENSOR_CHUNK_ROWS
            for i in range(0, n, step):
                writer.append_rows({
                    "x": np.asarray(feats[i:i + step]),
                    "label": np.asarray(labels[i:i + step]),
                })
            manifest = writer.close()
            return {
                "fields": ["x", "label"],
                "rows": n,
                "sharded": True,
                "shards": len(manifest["shard_rows"]),
                "shardRows": int(shard_rows),
                "featureShape": list(feats.shape[1:]),
            }

        self.ctx.engine.submit(
            name,
            ingest,
            description=f"tensor ingest from {url}",
            on_success=lambda r: r,
            job_class="dataset",
        )
        return meta

    # -- generic binary -------------------------------------------------------

    def create_generic(self, name: str, url: str) -> dict:
        """Copy a file onto the datasets volume in chunks."""
        self.ctx.require_new_name(name)
        src = _local_path(url, "generic")
        meta = self.ctx.artifacts.metadata.create(
            name, GENERIC_TYPE, extra={"url": url}
        )

        def ingest():
            with open(src, "rb") as fh:
                path = self.ctx.volumes.save_stream(GENERIC_TYPE, name, fh)
            return {"sizeBytes": path.stat().st_size}

        self.ctx.engine.submit(
            name,
            ingest,
            description=f"generic ingest from {url}",
            on_success=lambda r: r,
            job_class="dataset",
        )
        return meta

    # -- read / list / delete -------------------------------------------------

    def read_page(self, name: str, query: dict | None = None, skip: int = 0,
                  limit: int = 20) -> list[dict]:
        self.ctx.require_existing(name)
        cap = self.ctx.config.api.page_limit_max
        return self.ctx.artifacts.read_page(
            name, query=query, skip=skip, limit=min(limit, cap)
        )

    def list_metadata(self, type_prefix: str = "") -> list[dict]:
        return self.ctx.artifacts.list_by_type(type_prefix)

    def delete(self, name: str) -> None:
        self.ctx.delete_artifact(name)
