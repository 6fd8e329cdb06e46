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

A source is an ``http(s)://`` URL, a ``file://`` URL or a local path.
HTTP sources stream through the standard library's ``urllib.request``
(60 s timeout) where the JAX package uses ``requests``; a non-2xx answer
fails the job with ``requests``' ``raise_for_status`` wording
(:class:`HTTPError`).  A ``.npy`` source is downloaded to the datasets
volume first (``npycache_<hash>``), so it can be memory-mapped.

Where the native engine builds (native/__init__.py), CSV ingest runs
through it as in the JAX package: an in-memory ingest parses the whole
file in C++ and inserts the JSONL straight into the native store
(:meth:`DatasetService._ingest_native`), and a sharded one feeds raw
byte chunks to the C++ numeric parser, which returns packed float64
blocks for the shard writer (:meth:`DatasetService.
_ingest_sharded_native`).  Without the library, or for a file too big to
buffer, the Python paths run, with the same documents and shards.
"""

from __future__ import annotations

import contextlib
import csv
import hashlib
import io
import json
import math
import os
import re
import urllib.error
import urllib.request

import numpy as np

from learningorchestra_tpu_torch.log import get_logger
from learningorchestra_tpu_torch.services.context import ServiceContext
from learningorchestra_tpu_torch.store.sharded import (
    ShardedDatasetWriter,
    ShardedTensorWriter,
)

logger = get_logger("dataset")

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


FETCH_TIMEOUT_S = 60


class HTTPError(OSError):
    """A non-2xx answer from an HTTP source."""


def is_http(url: str) -> bool:
    return url.startswith(("http://", "https://"))


def _local_path(url: str) -> str:
    return url[len("file://"):] if url.startswith("file://") else url


@contextlib.contextmanager
def open_url(url: str):
    """An HTTP source's body as a binary stream; a non-2xx answer raises
    :class:`HTTPError` worded as ``requests``' ``raise_for_status``."""
    try:
        resp = urllib.request.urlopen(url, timeout=FETCH_TIMEOUT_S)
    except urllib.error.HTTPError as exc:
        kind = "Client" if exc.code < 500 else "Server"
        exc.close()
        raise HTTPError(
            f"{exc.code} {kind} Error: {exc.reason} for url: {url}"
        ) from None
    with resp:
        yield resp


@contextlib.contextmanager
def _open_bytes(url: str):
    """A CSV source as an iterator of byte chunks (the native numeric
    parser reads raw bytes)."""
    if is_http(url):
        with open_url(url) as resp:
            yield iter(lambda: resp.read(1 << 20), b"")
    else:
        with open(_local_path(url), "rb") as fh:
            yield iter(lambda: fh.read(1 << 22), b"")


def _native():
    """The native engine's module when its library builds, else None
    (the reason is logged: the Python path then runs)."""
    from learningorchestra_tpu_torch import native

    try:
        native.load_library()
    except (native.NativeBuildError, OSError) as exc:
        logger.warning("native CSV engine unavailable (%s); the Python "
                       "ingest path runs", exc)
        return None
    return native


@contextlib.contextmanager
def _open_text(url: str):
    """A CSV source as text lines (``newline=""``: quoted fields keep
    their line breaks)."""
    if is_http(url):
        with open_url(url) as resp:
            yield io.TextIOWrapper(resp, encoding="utf-8", errors="replace",
                                   newline="")
    else:
        with open(_local_path(url), "r", encoding="utf-8", errors="replace",
                  newline="") as fh:
            yield fh


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
        meta = self.ctx.artifacts.metadata.create(
            name, CSV_TYPE, extra={"url": url}
        )

        def ingest():
            if shard_rows:
                return self._ingest_sharded(name, url, int(shard_rows),
                                            infer_types)
            native = self._ingest_native(name, url, infer_types)
            if native is not None:
                return native
            n_rows = 0
            fields: list[str] = []
            with _open_text(url) as fh:
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

    #: Above this size the whole-buffer native path would hold ~2.5x the
    #: file resident (download + JSONL + store copy); stream instead.
    NATIVE_MAX_BYTES = 256 * 1024 * 1024

    def _ingest_native(self, name: str, url: str, infer_types: bool):
        """The JAX package's fully native ingest: C++ CSV parse, then the
        JSONL straight into the native store (no per-row Python objects).
        Returns None before touching the store when the engine is not
        built here, the file is too big to buffer or the parse fails, and
        the streaming Python path takes over."""
        native = _native()
        if native is None:
            return None
        try:
            if is_http(url):
                chunks, total = [], 0
                with open_url(url) as resp:
                    declared = int(resp.headers.get("content-length") or 0)
                    if declared > self.NATIVE_MAX_BYTES:
                        return None
                    for chunk in iter(lambda: resp.read(1 << 20), b""):
                        total += len(chunk)
                        if total > self.NATIVE_MAX_BYTES:
                            return None  # too big to buffer: stream
                        chunks.append(chunk)
                data = b"".join(chunks)
            else:
                path = _local_path(url)
                if os.path.getsize(path) > self.NATIVE_MAX_BYTES:
                    return None
                with open(path, "rb") as fh:
                    data = fh.read()
            # Valid UTF-8, as the streaming path's errors="replace" reads
            # it: the store holds JSON text.
            try:
                data.decode("utf-8")
            except UnicodeDecodeError:
                data = data.decode("utf-8", errors="replace").encode("utf-8")
            fields, jsonl = native.csv_parse(data, infer_types)
        except Exception as exc:  # noqa: BLE001 — nothing inserted yet,
            # so the streaming path may still ingest it.
            logger.warning("native CSV ingest of %r fell back: %r", url, exc)
            return None
        if hasattr(self.ctx.documents, "insert_jsonl"):
            n = self.ctx.documents.insert_jsonl(name, jsonl)
        else:
            n = self.ctx.documents.insert_many(
                name, (json.loads(ln) for ln in jsonl.splitlines() if ln))
        return {"fields": fields, "rows": n}

    def _ingest_sharded(self, name: str, url: str, shard_rows: int,
                        infer_types: bool) -> dict:
        """Stream CSV rows into columnar volume shards: peak host memory
        is O(shard_rows x columns) whatever the file size.  The first
        ``PREVIEW_ROWS`` rows also land in the store so GET pages work;
        columns must be numeric (a blank cell is NaN).  With type
        inference on and the native engine built, the C++ parser does
        it (:meth:`_ingest_sharded_native`)."""
        root = self.ctx.volumes.path_for(CSV_TYPE, name)
        if infer_types:
            native_result = self._ingest_sharded_native(name, root, url,
                                                        shard_rows)
            if native_result is not None:
                return native_result
        writer = None
        preview: list[dict] = []
        fields: list[str] = []
        n_rows = 0
        with _open_text(url) as fh:
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

    _NATIVE_CHUNK = 4 << 20  # bytes fed to the native parser per call

    def _ingest_sharded_native(self, name: str, root, url: str,
                               shard_rows: int) -> dict | None:
        """The JAX package's native sharded ingest: raw bytes -> C++
        quote-aware CSV records -> packed float64 blocks -> columnar
        shards, no per-row or per-cell Python objects.  None when the
        engine is not built here (the row path runs).  Parity with the row
        path: short rows pad NaN, empty cells are NaN, a column with a
        non-empty unparseable cell fails the job, and dtypes follow the
        text's format (the parser counts float-formatted cells per
        column, so "5.0" stays float32 as ``_infer`` keeps it)."""
        native = _native()
        if native is None:
            return None
        writer = None
        fields: list[str] = []
        bad = ffmt = None
        n_rows = 0
        head_bytes = b""  # the first bytes, for the text preview
        buf = b""
        with _open_bytes(url) as chunks:
            final = False
            while True:
                if not final:
                    piece = next(chunks, None)
                    if piece is None:
                        final = True
                    else:
                        buf += piece
                        if len(head_bytes) < (1 << 18):
                            # From the pieces in stream order (buf
                            # shrinks as records are consumed).
                            head_bytes += piece[:(1 << 18) - len(head_bytes)]
                if not fields:
                    nl = buf.find(b"\n")
                    if nl < 0:
                        if not final:
                            continue
                        if not buf.strip():
                            raise ValueError(
                                f"CSV at {url} has no header row")
                        nl = len(buf)
                    header_line = buf[:nl].lstrip(b"\xef\xbb\xbf").decode(
                        "utf-8", "replace").rstrip("\r")
                    fields = _clean_header(next(csv.reader([header_line])))
                    writer = ShardedDatasetWriter(
                        root, fields, rows_per_shard=shard_rows)
                    bad = np.zeros(len(fields), np.int64)
                    ffmt = np.zeros(len(fields), np.int64)
                    buf = buf[nl + 1:]
                while len(buf) >= self._NATIVE_CHUNK or (final and buf):
                    block, consumed = native.csv_numeric_chunk(
                        buf, len(fields), is_final=final, bad_counts=bad,
                        float_counts=ffmt)
                    if consumed == 0:
                        break  # one record longer than the buffer
                    if len(block):
                        writer.append_block(block,
                                            float_format_cols=ffmt > 0)
                        n_rows += len(block)
                    buf = buf[consumed:]
                if final and not buf:
                    break
        if writer is None:
            raise ValueError(f"CSV at {url} has no header row")
        for i, count in enumerate(bad):
            if count:
                raise ValueError(
                    f"column {fields[i]!r} is not numeric ({int(count)} "
                    "unparseable cell(s)); cast or project it away before "
                    "sharded ingest")
        manifest = writer.close()
        # The preview from the head bytes, typed as the row path types it.
        preview: list[dict] = []
        head_text = head_bytes.decode("utf-8", "replace")
        head_lines = head_text.splitlines()
        if len(head_bytes) >= (1 << 18) and not head_text.endswith("\n"):
            head_lines = head_lines[:-1]  # the cap may cut a record
        for row in csv.reader(head_lines[1:]):
            if len(preview) >= min(self.PREVIEW_ROWS, n_rows):
                break
            if not row:
                continue
            vals = [_infer(v) for v in row[: len(fields)]]
            vals += [None] * (len(fields) - len(vals))
            preview.append(dict(zip(fields, vals)))
        if preview:
            self.ctx.documents.insert_many(name, preview)
        return {
            "fields": fields,
            "rows": n_rows,
            "sharded": True,
            "shards": len(manifest["shard_rows"]),
            "shardRows": shard_rows,
            "previewRows": len(preview),
            "engine": "native",
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
        meta = self.ctx.artifacts.metadata.create(
            name, TENSOR_TYPE,
            extra={"url": url, "labelsUrl": labels_url},
        )

        def ingest():
            feats = np.load(self._local_npy(url), mmap_mode="r")
            labels = np.load(self._local_npy(labels_url), mmap_mode="r")
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

    def _local_npy(self, url: str) -> str:
        """A local path for a ``.npy`` source: an HTTP one is downloaded
        (streamed) to the datasets volume first, so it can be
        memory-mapped."""
        if not is_http(url):
            return _local_path(url)
        cache = "npycache_" + hashlib.sha1(url.encode()).hexdigest()[:16]
        with open_url(url) as resp:
            return str(self.ctx.volumes.save_stream(GENERIC_TYPE, cache,
                                                    resp))

    # -- generic binary -------------------------------------------------------

    def create_generic(self, name: str, url: str) -> dict:
        """Copy a file or an HTTP body onto the datasets volume in
        chunks."""
        self.ctx.require_new_name(name)
        meta = self.ctx.artifacts.metadata.create(
            name, GENERIC_TYPE, extra={"url": url}
        )

        def ingest():
            with (open_url(url) if is_http(url)
                  else open(_local_path(url), "rb")) as fh:
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
