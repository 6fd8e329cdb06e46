"""Sharded (beyond-host-RAM) dataset artifacts — port of
``learningorchestra_tpu/store/sharded.py``.

Ingest writes fixed-size columnar shards (one ``.npz`` per shard, one
array per column) plus a JSON manifest; the streaming fit reads shard
k+1 from disk while the card computes on shard k, so peak host memory
is O(shard), not O(dataset).  The on-disk format is the JAX package's,
byte for byte in layout (``np.savez``, int64 narrowed to int32 and
float64 to float32), so each package reads the other's shards.  The
readers return numpy; the fit moves the arrays to the device.

Layout::

    <root>/manifest.json                 fields, dtypes, shard row counts
    <root>/shard_00000.npz               {field: ndarray(rows_k,)}
    ...

Shuffle model: shard ORDER is reshuffled every epoch on the host, row
order WITHIN a shard on the device; sample-granular global shuffling
would re-read the whole dataset per epoch.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

MANIFEST = "manifest.json"
_SHARD_FMT = "shard_{:05d}.npz"

# int64 CSV values narrow to int32 and float64 to float32 (the JAX
# package's shard dtypes, so both packages read each other's shards).
_NARROW = {"int64": "int32", "float64": "float32"}


def _narrow(dtype: np.dtype) -> str:
    name = np.dtype(dtype).name
    return _NARROW.get(name, name)


def _int32_safe(arr: np.ndarray) -> bool:
    """True when every value fits int32 exactly (INT32_MIN included).
    One policy for every ingest path: the shards' dtypes depend on it."""
    return bool(
        arr.size == 0
        or (np.all(arr >= -(2**31)) and np.all(arr < 2**31))
    )


def _publish_shard(root: Path, k: int, cols: dict) -> None:
    """Write shard ``k`` atomically: a crashed ingest must not leave a
    torn ``.npz`` that a later open would read."""
    tmp = root / (_SHARD_FMT.format(k) + ".tmp")
    with open(tmp, "wb") as fh:
        np.savez(fh, **cols)
    os.replace(tmp, root / _SHARD_FMT.format(k))


def _publish_manifest(root: Path, manifest: dict) -> dict:
    """The dataset exists for readers once its manifest lands."""
    tmp = root / (MANIFEST + ".tmp")
    tmp.write_text(json.dumps(manifest))
    os.replace(tmp, root / MANIFEST)
    return manifest


class ShardedDatasetWriter:
    """Streaming writer: buffer rows (:meth:`append`) or float64 blocks
    from the native CSV parser (:meth:`append_block`), flush one ``.npz``
    per shard.

    Columns may change integer/float character between shards (a column
    integral for the first million rows then fractional); the manifest
    records the PROMOTED dtype and readers cast each shard on load, so
    every shard a consumer sees is uniformly typed.
    """

    def __init__(self, root: str | Path, fields: list[str], *,
                 rows_per_shard: int = 65536):
        if rows_per_shard <= 0:
            raise ValueError("rows_per_shard must be positive")
        if not fields:
            raise ValueError("sharded dataset needs a non-empty header")
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.fields = list(fields)
        self.rows_per_shard = rows_per_shard
        self._buf: list[list] = []
        self._blocks: list[np.ndarray] = []
        self._block_rows = 0
        self._shard_rows: list[int] = []
        self._dtypes: dict[str, np.dtype] = {}
        # Per-field "saw float-formatted text" flags of block mode: the
        # native parser reports them, so both paths type columns by text.
        self._float_format = np.zeros(len(self.fields), bool)
        self._closed = False

    def append(self, row: list) -> None:
        """One row of numeric values in field order (shorter rows are an
        error — silent column misalignment corrupts training data)."""
        if len(row) != len(self.fields):
            raise ValueError(
                f"row has {len(row)} values, header has "
                f"{len(self.fields)} fields"
            )
        if self._blocks:
            raise RuntimeError("append after append_block: pick one")
        self._buf.append(row)
        if len(self._buf) >= self.rows_per_shard:
            self._flush()

    def append_block(self, block, float_format_cols=None) -> None:
        """Append a ``(n, n_fields)`` float64 array (the native CSV
        parser's output).  ``float_format_cols`` marks columns whose text
        was float-formatted somewhere ("5.0", "1e3"): they stay float32
        even when every value is integral, as the row path's ``_infer``
        keeps them.  Row and block modes do not mix on one writer."""
        if self._buf:
            raise RuntimeError("append_block after append: pick one")
        block = np.asarray(block, np.float64)
        if block.ndim != 2 or block.shape[1] != len(self.fields):
            raise ValueError(
                f"block shape {block.shape} != (n, {len(self.fields)})")
        if float_format_cols is not None:
            self._float_format |= np.asarray(float_format_cols, bool)
        self._blocks.append(block)
        self._block_rows += len(block)
        while self._block_rows >= self.rows_per_shard:
            self._flush_block(self.rows_per_shard)

    def _take_block_rows(self, n: int) -> np.ndarray:
        """Pop exactly ``n`` rows off the block queue."""
        out, need = [], n
        while need > 0:
            head = self._blocks[0]
            if len(head) <= need:
                out.append(head)
                need -= len(head)
                self._blocks.pop(0)
            else:
                out.append(head[:need])
                self._blocks[0] = head[need:]
                need = 0
        self._block_rows -= n
        return out[0] if len(out) == 1 else np.concatenate(out, axis=0)

    def _flush_block(self, n: int) -> None:
        if n <= 0:
            return
        rows = self._take_block_rows(n)
        cols = {}
        for i, field in enumerate(self.fields):
            arr = rows[:, i]
            # The row path's inference: int32 only when no cell was
            # float-formatted and the values are integral, finite and
            # int32-safe.
            if (not self._float_format[i]) and np.all(np.isfinite(arr)) \
                    and np.all(arr == np.floor(arr)) and _int32_safe(arr):
                arr = arr.astype(np.int32)
            else:
                arr = arr.astype(np.float32)
            cols[field] = arr
            prev = self._dtypes.get(field)
            self._dtypes[field] = arr.dtype if prev is None else np.dtype(
                _narrow(np.promote_types(prev, arr.dtype)))
        _publish_shard(self.root, len(self._shard_rows), cols)
        self._shard_rows.append(n)

    def _flush(self) -> None:
        if not self._buf:
            return
        cols = {}
        for i, field in enumerate(self.fields):
            try:
                arr = np.asarray([r[i] for r in self._buf])
            except (ValueError, TypeError) as exc:
                raise ValueError(
                    f"column {field!r} is not numeric: {exc}"
                ) from exc
            if not np.issubdtype(arr.dtype, np.number):
                raise ValueError(
                    f"column {field!r} is not numeric "
                    f"(dtype {arr.dtype}); cast or project it away "
                    "before sharded ingest"
                )
            if np.issubdtype(arr.dtype, np.integer) and not _int32_safe(
                arr
            ):
                # int64 values beyond int32 must not wrap silently on
                # the narrowing cast; degrade to float32.
                arr = arr.astype(np.float32)
            else:
                arr = arr.astype(_narrow(arr.dtype))
            cols[field] = arr
            prev = self._dtypes.get(field)
            if prev is None:
                self._dtypes[field] = arr.dtype
            else:
                # Re-narrow after promotion: int32+float32 promotes to
                # float64 under numpy's rules, but shards stay 32-bit.
                self._dtypes[field] = np.dtype(
                    _narrow(np.promote_types(prev, arr.dtype))
                )
        _publish_shard(self.root, len(self._shard_rows), cols)
        self._shard_rows.append(len(self._buf))
        self._buf = []

    def close(self) -> dict:
        """Flush the tail shard and publish the manifest (the artifact
        does not exist as a dataset until the manifest lands)."""
        if self._closed:
            raise RuntimeError("writer already closed")
        self._flush()
        self._flush_block(self._block_rows)
        self._closed = True
        manifest = {
            "fields": self.fields,
            "dtypes": {
                f: np.dtype(self._dtypes.get(f, np.float32)).name
                for f in self.fields
            },
            "shard_rows": self._shard_rows,
            "rows": int(sum(self._shard_rows)),
            "rows_per_shard": self.rows_per_shard,
        }
        return _publish_manifest(self.root, manifest)


class ShardedTensorWriter:
    """Streaming writer for N-D (tensor) columns — the image-dataset
    shape (BASELINE config 5: ResNet/ImageNet), where a row's features
    are a (H, W, C) block, not scalars.  Chunks of rows arrive as
    arrays ({column: (k, *feature_shape)}) and flush into the same
    shard/manifest layout the scalar writer produces, so every reader
    (views, streaming fit, replica of the volume) works unchanged.
    """

    def __init__(self, root: str | Path, column_shapes: dict, *,
                 rows_per_shard: int = 4096):
        if rows_per_shard <= 0:
            raise ValueError("rows_per_shard must be positive")
        if not column_shapes:
            raise ValueError("tensor dataset needs columns")
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.fields = list(column_shapes)
        self.column_shapes = {
            f: tuple(s) for f, s in column_shapes.items()
        }
        self.rows_per_shard = rows_per_shard
        self._buf: dict[str, list] = {f: [] for f in self.fields}
        self._buffered = 0
        self._shard_rows: list[int] = []
        self._dtypes: dict[str, np.dtype] = {}
        self._closed = False

    def append_rows(self, chunk: dict) -> None:
        """A chunk of rows per column: {field: (k, *field_shape)}.
        All columns must bring the same k."""
        sizes = set()
        for field in self.fields:
            arr = np.asarray(chunk[field])
            want = self.column_shapes[field]
            if tuple(arr.shape[1:]) != want:
                raise ValueError(
                    f"column {field!r} rows have shape "
                    f"{arr.shape[1:]}, dataset declares {want}"
                )
            if not np.issubdtype(arr.dtype, np.number):
                raise ValueError(f"column {field!r} is not numeric")
            sizes.add(arr.shape[0])
        if len(sizes) != 1:
            raise ValueError(f"columns brought differing row counts: "
                             f"{sorted(sizes)}")
        k = sizes.pop()
        # Convert ONCE per chunk (astype only copies on a real dtype
        # change), not per shard-boundary crossing.
        converted = {}
        for field in self.fields:
            arr = np.asarray(chunk[field])
            want = np.dtype(_narrow(arr.dtype))
            converted[field] = arr.astype(want, copy=False)
        off = 0
        while off < k:
            room = self.rows_per_shard - self._buffered
            take = min(room, k - off)
            for field in self.fields:
                self._buf[field].append(
                    converted[field][off:off + take]
                )
            self._buffered += take
            off += take
            if self._buffered >= self.rows_per_shard:
                self._flush()

    def _flush(self) -> None:
        if not self._buffered:
            return
        cols = {}
        for field in self.fields:
            arr = np.concatenate(self._buf[field], axis=0)
            cols[field] = arr
            prev = self._dtypes.get(field)
            self._dtypes[field] = arr.dtype if prev is None else \
                np.dtype(_narrow(np.promote_types(prev, arr.dtype)))
            self._buf[field] = []
        _publish_shard(self.root, len(self._shard_rows), cols)
        self._shard_rows.append(self._buffered)
        self._buffered = 0

    def close(self) -> dict:
        if self._closed:
            raise RuntimeError("writer already closed")
        self._flush()
        self._closed = True
        manifest = {
            "fields": self.fields,
            "dtypes": {
                f: np.dtype(self._dtypes.get(f, np.float32)).name
                for f in self.fields
            },
            "column_shapes": {
                f: list(s) for f, s in self.column_shapes.items()
            },
            "shard_rows": self._shard_rows,
            "rows": int(sum(self._shard_rows)),
            "rows_per_shard": self.rows_per_shard,
        }
        return _publish_manifest(self.root, manifest)


class ShardedDataset:
    """Read handle over a sharded dataset directory — lazy: holds the
    manifest only; shards load one at a time via :meth:`load_shard`."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        path = self.root / MANIFEST
        if not path.exists():
            raise FileNotFoundError(
                f"no sharded-dataset manifest at {path} (ingest "
                "unfinished or crashed before publish)"
            )
        m = json.loads(path.read_text())
        self.fields: list[str] = list(m["fields"])
        self.dtypes = {f: np.dtype(d) for f, d in m["dtypes"].items()}
        self.shard_rows: list[int] = [int(r) for r in m["shard_rows"]]
        self.n_rows: int = int(m["rows"])
        self.rows_per_shard: int = int(m["rows_per_shard"])
        # Tensor datasets (ShardedTensorWriter) record per-column row
        # shapes; scalar datasets predate the key and default to ().
        self.column_shapes: dict[str, tuple] = {
            f: tuple(s)
            for f, s in (m.get("column_shapes") or {}).items()
        }

    # -- handle surface -------------------------------------------------------

    @property
    def n_shards(self) -> int:
        return len(self.shard_rows)

    def __len__(self) -> int:
        return self.n_rows

    def __getitem__(self, key):
        """``$dataset.column`` DSL indexing → a single-column view;
        a list of names → a feature-matrix view."""
        return self.view(key)

    def view(self, cols) -> "ShardedView":
        return ShardedView(self, cols)

    def feature_view(self, exclude) -> "ShardedView":
        """All columns except ``exclude`` — the ``fit(x=$big,
        y=$big.label)`` convention resolves x to this."""
        drop = {exclude} if isinstance(exclude, str) else set(exclude)
        keep = [f for f in self.fields if f not in drop]
        if not keep:
            raise ValueError("feature view excludes every column")
        return ShardedView(self, keep)

    def load_shard(self, k: int, cols: list[str] | None = None) -> dict:
        """Columns of shard ``k`` as host arrays, cast to the manifest
        dtypes (shards written before a column promoted may be narrower
        on disk)."""
        with np.load(self.root / _SHARD_FMT.format(k)) as z:
            out = {}
            for f in (cols or self.fields):
                arr = z[f]
                want = self.dtypes[f]
                out[f] = arr.astype(want) if arr.dtype != want else arr
            return out


class ShardedView:
    """Lazy column selection over a :class:`ShardedDataset`.

    A string selects ONE column — scalar columns yield (rows,), tensor
    columns (ShardedTensorWriter) yield (rows, *feature_shape).  A
    list selects a feature matrix (rows, n_cols) stacked in the given
    order, promoted to a common dtype; a one-element list over a
    tensor column collapses to that column (``feature_view`` on a
    tensor dataset resolves to its x block).  Mixing tensor columns
    into a multi-column matrix is an error — there is no meaningful
    stacking axis.
    """

    def __init__(self, dataset: ShardedDataset, cols):
        self.dataset = dataset
        single = isinstance(cols, str)
        names = [cols] if single else list(cols)
        missing = [c for c in names if c not in dataset.fields]
        if missing:
            raise KeyError(
                f"no such column(s) {missing} in sharded dataset "
                f"(fields: {dataset.fields})"
            )
        nd = [c for c in names if dataset.column_shapes.get(c)]
        if not single and len(names) == 1 and nd:
            # A one-element list over a TENSOR column collapses to the
            # column itself (feature_view on a tensor dataset).  A
            # one-element list over a scalar column stays a (rows, 1)
            # matrix — the shape the in-memory DataFrame path feeds
            # single-feature models.
            single = True
        elif nd and not single:
            raise ValueError(
                f"tensor column(s) {nd} cannot stack into a feature "
                "matrix; select one column"
            )
        self.single = single
        self.cols = names

    def __len__(self) -> int:
        return self.dataset.n_rows

    @property
    def dtype(self) -> np.dtype:
        dts = [self.dataset.dtypes[c] for c in self.cols]
        out = dts[0]
        for d in dts[1:]:
            out = np.promote_types(out, d)
        return out

    @property
    def shape(self) -> tuple:
        n = self.dataset.n_rows
        if self.single:
            row = self.dataset.column_shapes.get(self.cols[0], ())
            return (n, *row)
        return (n, len(self.cols))

    def load_shard(self, k: int) -> np.ndarray:
        cols = self.dataset.load_shard(k, self.cols)
        if self.single:
            return cols[self.cols[0]]
        dtype = self.dtype
        return np.stack(
            [cols[c].astype(dtype) for c in self.cols], axis=1
        )

    def head(self, n: int = 1) -> np.ndarray:
        """First ``n`` rows (for parameter init / loss resolution)
        without loading more than the first shard."""
        return self.load_shard(0)[:n]


def same_dataset(a, b) -> bool:
    """True when two views stream from the same dataset directory —
    the x/y alignment precondition for streaming fit."""
    da = a.dataset if isinstance(a, ShardedView) else a
    db = b.dataset if isinstance(b, ShardedView) else b
    return isinstance(da, ShardedDataset) and \
        isinstance(db, ShardedDataset) and da.root == db.root


def resolve_xy_views(x, y):
    """Normalize/validate the (x, y) pair every streaming surface
    accepts: y must be one column; a bare-dataset x resolves to all
    columns except y's (the ``fit(x="$big", y="$big.label")`` request
    shape); both must stream from ONE dataset (shard alignment).
    Returns ``(x_view, y_view)``."""
    if isinstance(y, ShardedDataset) or not (
        isinstance(y, ShardedView) and y.single
    ):
        raise ValueError(
            "y must select one column of the sharded dataset "
            "(request shape: \"y\": \"$name.label\")"
        )
    if isinstance(x, ShardedDataset):
        x = x.feature_view(y.cols[0])
    if not isinstance(x, ShardedView):
        raise ValueError(
            "x must be a sharded view when y is one (both sides "
            "stream shard-aligned from the same dataset)"
        )
    if not same_dataset(x, y):
        raise ValueError(
            "x and y stream from different sharded datasets; "
            "shard alignment requires one source"
        )
    return x, y


class WeightedMetrics:
    """Row-weighted metric accumulation across shards.

    Perplexity is averaged in LOG domain (a shard's ppl is exp of its
    mean CE, so mean-of-logs + exp-at-the-end reproduces the global
    exp-after-mean; averaging exps would Jensen-bias upward) — shared
    by every streaming loop so the convention can't drift.
    """

    def __init__(self):
        self._totals: dict[str, float] = {}
        self._weight = 0.0

    def add(self, metrics: dict, rows: float) -> None:
        for key, val in metrics.items():
            val = float(val)
            if key == "perplexity":
                val = float(np.log(val))
            self._totals[key] = self._totals.get(key, 0.0) + val * rows
        self._weight += rows

    def result(self) -> dict:
        out = {k: v / self._weight for k, v in self._totals.items()}
        if "perplexity" in out:
            out["perplexity"] = float(np.exp(out["perplexity"]))
        return out
