"""ctypes binding of the native (C++) document store and CSV engine —
port of ``learningorchestra_tpu/native/__init__.py``.

``liblodstore`` is the native document store + CSV ingest engine: the
system-of-record role MongoDB plays in the reference deployment.  Its WAL
format is byte-compatible with the Python ``DocumentStore``, so either
backend (and either package) opens the other's store directory.

The port keeps its own copy of the source, ``csrc/docstore.cpp``, and
:func:`ensure_built` compiles it with g++ at first use into the
git-ignored ``build/torch_native/`` at the repository root, the name
hashing the source and the flags (like ``kernels/build.py``), so an
edited source never loads a stale library.  The compiler writes to a
temporary file that is then renamed into place, so processes building at
once never load a torn library.  A failed build raises
:class:`NativeBuildError` with g++'s output; nothing falls back here
(``store.open_document_store`` decides what ``"auto"`` does with it).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
from pathlib import Path
from typing import Any, Iterable

from learningorchestra_tpu_torch import faults
from learningorchestra_tpu_torch.concurrency_rt import make_lock
from learningorchestra_tpu_torch.store.document_store import (
    DuplicateKey,
    NoSuchCollection,
    _match,
)

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "docstore.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / \
    "torch_native"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")

_build_lock = make_lock("native._build_lock")
_lib: ctypes.CDLL | None = None


class NativeBuildError(RuntimeError):
    """g++ is missing or refused ``csrc/docstore.cpp``."""


def compiler() -> str:
    """The C++ compiler: ``$CXX``, else ``g++`` on PATH."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise NativeBuildError(
            "g++ not found (set CXX or put g++ on PATH); the native store "
            "is built from learningorchestra_tpu_torch/csrc/docstore.cpp "
            "at first use")
    return cxx


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update("\0".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"liblodstore-{h.hexdigest()[:16]}.so"


def ensure_built() -> Path:
    """Build the library if missing and return its path; raises
    :class:`NativeBuildError` with the compiler's output on failure."""
    with _build_lock:
        out = library_path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = [compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as exc:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(
                f"native store build failed: {' '.join(cmd)}: {exc!r}"
            ) from exc
        log = proc.stdout.decode(errors="replace")
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(
                f"native store build failed (exit {proc.returncode}): "
                f"{' '.join(cmd)}\n{log}")
        # Atomic publish: another process loads the whole library or none.
        os.replace(tmp, out)
        return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_char_p = ctypes.c_char_p
    i64 = ctypes.c_int64
    ll = ctypes.c_longlong
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_ll = ctypes.POINTER(ctypes.c_longlong)
    # Returned buffers are malloc'd char*; keep them as void* so ctypes
    # doesn't copy-and-lose the pointer we must pass to lods_free.
    buf_t = ctypes.c_void_p

    lib.lods_last_error.restype = c_char_p
    lib.lods_free.argtypes = [buf_t]
    lib.lods_open.argtypes = [c_char_p, ctypes.c_int]
    lib.lods_open.restype = i64
    lib.lods_close.argtypes = [i64]
    lib.lods_has_collection.argtypes = [i64, c_char_p]
    lib.lods_list_collections.argtypes = [i64, p_i64]
    lib.lods_list_collections.restype = buf_t
    lib.lods_insert_many.argtypes = [i64, c_char_p, c_char_p, i64, p_ll]
    lib.lods_insert_many.restype = i64
    lib.lods_insert_at.argtypes = [i64, c_char_p, c_char_p, ll, ctypes.c_int]
    lib.lods_update.argtypes = [i64, c_char_p, ll, c_char_p]
    lib.lods_delete.argtypes = [i64, c_char_p, ll]
    lib.lods_find_one.argtypes = [i64, c_char_p, ll, p_i64]
    lib.lods_find_one.restype = buf_t
    lib.lods_scan.argtypes = [i64, c_char_p, i64, i64, p_i64]
    lib.lods_scan.restype = buf_t
    lib.lods_count.argtypes = [i64, c_char_p]
    lib.lods_count.restype = i64
    lib.lods_next_id.argtypes = [i64, c_char_p]
    lib.lods_next_id.restype = ll
    lib.lods_value_counts.argtypes = [i64, c_char_p, c_char_p, p_i64]
    lib.lods_value_counts.restype = buf_t
    lib.lods_drop.argtypes = [i64, c_char_p]
    lib.lods_compact.argtypes = [i64, c_char_p]
    lib.lods_csv_parse.argtypes = [c_char_p, i64, ctypes.c_int, p_i64]
    lib.lods_csv_parse.restype = buf_t
    lib.lods_csv_numeric_chunk.argtypes = [
        c_char_p, i64, ctypes.c_int, i64,
        ctypes.POINTER(ctypes.c_double), i64, p_i64, p_i64, p_i64,
    ]
    lib.lods_csv_numeric_chunk.restype = i64
    lib.lods_project.argtypes = [i64, c_char_p, c_char_p, c_char_p]
    lib.lods_project.restype = i64
    return lib


def load_library() -> ctypes.CDLL:
    """The bound library, built on first use (raises
    :class:`NativeBuildError` when it cannot be built)."""
    global _lib
    if _lib is not None:
        return _lib
    path = ensure_built()
    with _build_lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(path)))
    return _lib


def native_available() -> bool:
    """True when the library builds and loads here."""
    try:
        load_library()
    except (NativeBuildError, OSError):
        return False
    return True


def _raise_native(lib: ctypes.CDLL):
    msg = lib.lods_last_error().decode()
    if "invalid collection name" in msg:
        raise ValueError(msg)  # match DocumentStore._validate_name
    raise RuntimeError(msg)


def _take(lib: ctypes.CDLL, ptr: int, length: int) -> bytes:
    """Copy a returned buffer and free the native allocation."""
    if not ptr:
        return b""
    try:
        return ctypes.string_at(ptr, length)
    finally:
        lib.lods_free(ptr)


def _dumps(doc: dict) -> bytes:
    d = {k: v for k, v in doc.items() if k != "_id"}
    return json.dumps(d, default=str).encode()


def csv_numeric_chunk(data: bytes, ncols: int, *, is_final: bool,
                      bad_counts, float_counts=None,
                      max_rows: int | None = None):
    """Numeric CSV records → ((rows, ncols) float64 array, consumed).

    Only complete newline-terminated records are consumed unless
    ``is_final``; feed ``data[consumed:]`` + the next read back in.
    ``bad_counts`` is a caller-owned int64 array of length ``ncols``
    accumulating non-empty-unparseable cell counts across chunks (the
    "column is not numeric" contract check happens at close).
    ``float_counts`` (same shape, optional) accumulates FLOAT-FORMATTED
    cell counts — "5.0"/"1e3"/int64-overflow — so the sharded writer
    can type columns by text format exactly like the Python row path's
    ``_infer`` (a column is int only if every cell is int-formatted)."""
    import numpy as np

    lib = load_library()
    if max_rows is None:
        # A minimal record is ncols-1 commas + a newline = ncols bytes
        # (all-empty cells), so bytes/ncols bounds the row count —
        # far below a byte-per-row worst-case buffer.
        max_rows = len(data) // max(1, ncols) + 2
    out = np.empty((max_rows, ncols), np.float64)
    consumed = ctypes.c_int64()
    rows = lib.lods_csv_numeric_chunk(
        data, len(data), 1 if is_final else 0, ncols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        max_rows,
        bad_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        (float_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
         if float_counts is not None else None),
        ctypes.byref(consumed),
    )
    if rows < 0:
        _raise_native(lib)
    if rows < max_rows:
        # A view would pin the whole worst-case allocation (~8x the
        # chunk bytes) in the caller's block queue until shard flush.
        return out[:rows].copy(), consumed.value
    return out, consumed.value


def csv_parse(data: bytes, infer_types: bool = True):
    """CSV bytes → (fields, jsonl doc lines) via the native parser."""
    lib = load_library()
    out_len = ctypes.c_int64()
    ptr = lib.lods_csv_parse(
        data, len(data), 1 if infer_types else 0, ctypes.byref(out_len)
    )
    if not ptr:
        raise ValueError(lib.lods_last_error().decode())
    payload = _take(lib, ptr, out_len.value)
    head, _, rest = payload.partition(b"\n")
    return json.loads(head), rest


class NativeDocumentStore:
    """Drop-in replacement for ``DocumentStore`` backed by liblodstore.

    Documents live in native memory as raw JSON; Python materialises them
    only on read.  Query filtering beyond id-ordered paging reuses the
    Python ``_match`` operator set over a native scan.  It has no
    ``refresh`` (the cross-process coherence primitive), so the
    multi-engine control plane refuses it.
    """

    def __init__(self, root: str | Path, durable_writes: bool = False):
        self._lib = load_library()
        self.root = Path(root).expanduser()
        self.root.mkdir(parents=True, exist_ok=True)
        self._h = self._lib.lods_open(
            str(self.root).encode(), 1 if durable_writes else 0
        )
        if self._h < 0:
            _raise_native(self._lib)
        self._closed = False

    # -- collection lifecycle ----------------------------------------------

    def collection_exists(self, name: str) -> bool:
        return self._lib.lods_has_collection(self._h, name.encode()) == 1

    def list_collections(self) -> list[str]:
        n = ctypes.c_int64()
        ptr = self._lib.lods_list_collections(self._h, ctypes.byref(n))
        data = _take(self._lib, ptr, n.value)
        return [ln for ln in data.decode().splitlines() if ln]

    def drop(self, name: str) -> bool:
        return self._lib.lods_drop(self._h, name.encode()) == 1

    # -- writes -------------------------------------------------------------
    # Every write entry point carries the same chaos probe as the
    # Python backend's WAL append (document_store.py _append): an
    # armed ``store.wal_write`` schedule must fire no matter which
    # backend the deployment resolved — a probe that exists on only
    # one backend would fake a green drill on the other.

    def insert_one(self, name: str, doc: dict, _id: int | None = None) -> int:
        faults.hit("store.wal_write")
        if _id is None:
            first = ctypes.c_longlong()
            payload = _dumps(doc) + b"\n"
            n = self._lib.lods_insert_many(
                self._h, name.encode(), payload, len(payload),
                ctypes.byref(first),
            )
            if n < 0:
                _raise_native(self._lib)
            return int(first.value)
        rc = self._lib.lods_insert_at(
            self._h, name.encode(), _dumps(doc), _id, 0
        )
        if rc < 0:
            _raise_native(self._lib)
        return _id

    def insert_unique(self, name: str, doc: dict, _id: int) -> int:
        faults.hit("store.wal_write")
        rc = self._lib.lods_insert_at(
            self._h, name.encode(), _dumps(doc), _id, 1
        )
        if rc == -2:
            raise DuplicateKey(f"{name}[{_id}]")
        if rc < 0:
            _raise_native(self._lib)
        return _id

    def insert_many(self, name: str, docs: Iterable[dict]) -> int:
        payload = b"\n".join(_dumps(d) for d in docs)
        if not payload:
            return 0
        return self.insert_jsonl(name, payload + b"\n")

    def insert_jsonl(self, name: str, jsonl: bytes) -> int:
        """Fast path: pre-serialized JSONL docs (no ``_id`` fields) go
        straight into the native engine — paired with ``csv_parse`` this
        makes CSV ingest bypass Python object materialisation."""
        faults.hit("store.wal_write")
        first = ctypes.c_longlong()
        n = self._lib.lods_insert_many(
            self._h, name.encode(), jsonl, len(jsonl), ctypes.byref(first)
        )
        if n < 0:
            _raise_native(self._lib)
        return int(n)

    def update_one(self, name: str, _id: int, fields: dict) -> bool:
        faults.hit("store.wal_write")
        rc = self._lib.lods_update(
            self._h, name.encode(), _id, _dumps(fields)
        )
        if rc < 0:
            raise NoSuchCollection(name)
        return rc == 1

    def delete_one(self, name: str, _id: int) -> bool:
        faults.hit("store.wal_write")
        rc = self._lib.lods_delete(self._h, name.encode(), _id)
        if rc < 0:
            raise NoSuchCollection(name)
        return rc == 1

    # -- reads --------------------------------------------------------------

    def _scan(self, name: str, skip: int = 0, limit: int = -1) -> list[dict]:
        n = ctypes.c_int64()
        ptr = self._lib.lods_scan(
            self._h, name.encode(), skip, limit, ctypes.byref(n)
        )
        if not ptr and not self.collection_exists(name):
            raise NoSuchCollection(name)
        data = _take(self._lib, ptr, n.value)
        return [json.loads(ln) for ln in data.splitlines() if ln]

    def find(
        self,
        name: str,
        query: dict | None = None,
        sort_key: str = "_id",
        skip: int = 0,
        limit: int | None = None,
    ) -> list[dict]:
        if not query and sort_key == "_id":
            return self._scan(name, skip, -1 if limit is None else limit)
        docs = [d for d in self._scan(name) if _match(d, query)]
        if sort_key != "_id":
            docs.sort(
                key=lambda d: (d.get(sort_key) is None, d.get(sort_key))
            )
        if skip:
            docs = docs[skip:]
        if limit is not None:
            docs = docs[:limit]
        return docs

    def find_one(self, name: str, _id: int) -> dict | None:
        n = ctypes.c_int64()
        ptr = self._lib.lods_find_one(
            self._h, name.encode(), _id, ctypes.byref(n)
        )
        if not ptr:
            return None
        return json.loads(_take(self._lib, ptr, n.value))

    def count(self, name: str, query: dict | None = None) -> int:
        if query is None:
            n = self._lib.lods_count(self._h, name.encode())
            if n < 0:
                raise NoSuchCollection(name)
            return int(n)
        return sum(1 for d in self._scan(name) if _match(d, query))

    def aggregate_counts(
        self, name: str, field: str, exclude_ids: tuple = (0,)
    ) -> dict[Any, int]:
        if tuple(exclude_ids) != (0,):
            counts: dict[Any, int] = {}
            for doc in self._scan(name):
                if doc.get("_id") in exclude_ids \
                        or doc.get("docType") == "execution":
                    continue
                val = doc.get(field)
                if isinstance(val, (list, dict)):
                    val = json.dumps(val, default=str)
                counts[val] = counts.get(val, 0) + 1
            return counts
        n = ctypes.c_int64()
        ptr = self._lib.lods_value_counts(
            self._h, name.encode(), field.encode(), ctypes.byref(n)
        )
        if not ptr and not self.collection_exists(name):
            raise NoSuchCollection(name)
        data = _take(self._lib, ptr, n.value)
        counts = {}
        for ln in data.splitlines():
            if not ln:
                continue
            rec = json.loads(ln)
            key = rec["k"]
            if isinstance(key, (list, dict)):
                key = json.dumps(key, default=str)
            counts[key] = counts.get(key, 0) + rec["n"]
        return counts

    def project(self, src: str, dst: str, fields: list[str]) -> int:
        """Native column projection src → dst (data rows only); returns
        rows written.  The Spark-projection replacement (SURVEY §2.3)."""
        n = self._lib.lods_project(
            self._h, src.encode(), dst.encode(),
            "\n".join(fields).encode(),
        )
        if n < 0:
            _raise_native(self._lib)
        return int(n)

    # -- maintenance --------------------------------------------------------

    def compact(self, name: str) -> None:
        if self._lib.lods_compact(self._h, name.encode()) < 0:
            raise NoSuchCollection(name)

    def close(self) -> None:
        if not self._closed:
            self._lib.lods_close(self._h)
            self._closed = True
