"""Dataset service: CSV ingest and the universal GET path — port of the
Python CSV path of ``learningorchestra_tpu/services/dataset.py``.

``POST /dataset/csv`` streams a CSV (a ``file://`` URL or a local path)
into the store, one document per row, in batched inserts, on a job
thread; headers are cleaned (non-alphanumeric -> underscore) and values
type-inferred exactly as the JAX package does, so both packages store the
same documents.  Sharded ingest (ROADMAP A.5), tensor and generic ingest
and HTTP sources (the card's machine has no network and no ``requests``)
are not ported.
"""

from __future__ import annotations

import csv
import math
import re

from learningorchestra_tpu_torch.services.context import (
    ServiceContext,
    ValidationError,
)

_HEADER_CLEAN_RE = re.compile(r"[^0-9a-zA-Z_]+")
_INT_RE = re.compile(r"[+-]?[0-9]+")

CSV_TYPE = "dataset/csv"


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


def _local_path(url: str) -> str:
    if url.startswith(("http://", "https://")):
        raise ValidationError(
            "HTTP CSV sources are not ported to the PyTorch package; "
            "pass a file:// URL or a local path"
        )
    return url[len("file://"):] if url.startswith("file://") else url


class DatasetService:
    BATCH = 2000  # rows per insert_many

    def __init__(self, ctx: ServiceContext):
        self.ctx = ctx

    def create_csv(self, name: str, url: str, *,
                   infer_types: bool = True) -> dict:
        """Async ingest: the metadata appears at once (finished=False),
        rows stream in on a job thread."""
        self.ctx.require_new_name(name)
        path = _local_path(url)
        meta = self.ctx.artifacts.metadata.create(
            name, CSV_TYPE, extra={"url": url}
        )

        def ingest():
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
