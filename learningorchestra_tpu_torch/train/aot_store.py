"""Durable program store — the hot set survives the process — port of
``learningorchestra_tpu/train/aot_store.py``.

The process-wide program cache (train/compile_cache.py) dies with the
process, so a restart re-pays what a program's first use costs: the FLOP
analysis of its first call (obs/costs.py) and, for a decode step, the CUDA
graph each of its page pools captures.  The JAX store persists serialized
XLA executables; PyTorch has no serialized form of an eager program or a
CUDA graph, so a blob here holds what a restart would otherwise redo:

- the program's identity: its function as (module, qualname), resolved
  ONLY against a closed table of the port's program functions
  (:func:`program_function` registers one; a blob can name nothing else
  and can make the loader import nothing but :data:`_PROGRAM_MODULES`);
- its ``analyze`` flag and its ``ProgramCost`` record (obs/costs.py), so
  the restored program's first call skips the FLOP counter;
- for a decode step, the architecture key and the (S, Tk) cell, so a
  served decoder of that architecture captures the cell's graph before
  its first stream (serve/decode/engine.py).

The payload is JSON, never pickle: loading a file from disk runs no code.

Blob format (one file per program, ``<key>.aotx``)::

    LOAOT1\\n
    {json header: version, key, label, deviceSig, torch, code, sha256,
     bytes}\\n
    <json payload>

Safety contract (the JAX store's): a stale or corrupt blob degrades to a
live build, never a crash.  Every load validates the magic, the format
version, the key, the device signature
(``train/compile_cache.py::_device_signature``), the torch version (the
FLOPs come from torch's own formulas), the port's code signature (a hash
of the package's Python sources: the program bodies, the models' forwards
and the kernels' FLOP notes decide a stored record, and a restored record
is never re-analyzed) and a payload checksum, and resolves
the function in the table; any failure counts ``loadErrors``, deletes the
blob and returns None.  A ``manifest.json`` beside the blobs records the
hot set (key, label, hits, bytes) ordered by heat; the boot pre-warm
(services/context.py) walks it hottest first, each restore a
``prewarm`` span of a ``boot.prewarm`` trace.  Every write passes the
``cache.aot_store`` fault point and every read ``cache.aot_load``
(faults/plane.py): an injected failure degrades exactly as a bad disk
would, to a counted error and a live build.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import os
import threading
import time
from typing import Any, Callable

from learningorchestra_tpu_torch import faults
from learningorchestra_tpu_torch.concurrency_rt import make_lock
from learningorchestra_tpu_torch.log import get_logger, kv

__all__ = [
    "AOTExecutableStore",
    "StoredProgram",
    "configure",
    "enabled",
    "get_store",
    "offer_program",
    "program_function",
    "reset_store",
    "restored_cells",
    "stats_snapshot",
]

logger = get_logger("aot_store")

_MAGIC = b"LOAOT1\n"
_FORMAT_VERSION = 1
_MANIFEST = "manifest.json"

#: The only modules a blob may name a program function of: resolving one
#: imports its module, so the list bounds what a file on disk can load.
_PROGRAM_MODULES = (
    "learningorchestra_tpu_torch.train.neural",
    "learningorchestra_tpu_torch.models.text",
)
#: (module, qualname) -> function: the closed table.
_TABLE: dict[tuple[str, str], Callable] = {}


def program_function(fn: Callable) -> Callable:
    """Register ``fn`` (a module-level program function of one of
    :data:`_PROGRAM_MODULES`) in the closed table; returns it unchanged."""
    _TABLE[(fn.__module__, fn.__qualname__)] = fn
    return fn


def _identity(fn) -> tuple[str, str] | None:
    """``fn``'s (module, qualname) when the table holds it, else None."""
    ident = (getattr(fn, "__module__", None), getattr(fn, "__qualname__",
                                                      None))
    return ident if _TABLE.get(ident) is fn else None


def _resolve(ident) -> Callable:
    if not (isinstance(ident, list) and len(ident) == 2
            and all(isinstance(p, str) for p in ident)):
        raise ValueError(f"bad function identity {ident!r}")
    module, qualname = ident
    if module not in _PROGRAM_MODULES:
        raise ValueError(f"{module!r} holds no program functions")
    importlib.import_module(module)
    fn = _TABLE.get((module, qualname))
    if fn is None:
        raise ValueError(f"{module}.{qualname} is not a program function")
    return fn


def _device_signature() -> list:
    """``compile_cache._device_signature()`` as the header holds it: JSON
    (a device's capability tuple reads back as a list)."""
    from learningorchestra_tpu_torch.train import compile_cache

    return json.loads(json.dumps(compile_cache._device_signature()))


def _torch_version() -> str:
    import torch

    return str(torch.__version__)


_code_sig: str | None = None


def _code_signature() -> str:
    """sha256 over the port package's Python sources (relative path and
    bytes, in path order), computed once per process: any change to the
    port's code makes every stored record a mismatch."""
    global _code_sig
    if _code_sig is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        digest = hashlib.sha256()
        for dirpath, dirnames, names in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            for name in sorted(n for n in names if n.endswith(".py")):
                path = os.path.join(dirpath, name)
                digest.update(os.path.relpath(path, root).encode() + b"\0")
                with open(path, "rb") as fh:
                    digest.update(fh.read())
        _code_sig = digest.hexdigest()
    return _code_sig


@dataclasses.dataclass
class StoredProgram:
    """A validated blob: ``kind`` "program" (``fn``, ``analyze``,
    ``cost``: the ProgramCost fields or None) or "decode_step" (``arch``,
    ``cell``: (S, Tk))."""

    kind: str
    label: str | None = None
    fn: Callable | None = None
    analyze: bool = True
    cost: dict | None = None
    arch: str | None = None
    cell: tuple | None = None


def _materialize(payload: Any, label) -> StoredProgram:
    """A payload as a :class:`StoredProgram`; raises on anything else."""
    if not isinstance(payload, dict):
        raise ValueError("payload is not an object")
    kind = payload.get("kind")
    cost = payload.get("cost")
    if cost is not None and not isinstance(cost, dict):
        raise ValueError("bad cost record")
    if kind == "program":
        return StoredProgram("program", label, fn=_resolve(payload.get("fn")),
                             analyze=bool(payload.get("analyze", True)),
                             cost=cost)
    if kind == "decode_step":
        cell = payload.get("cell")
        if not (isinstance(payload.get("arch"), str)
                and isinstance(cell, list) and len(cell) == 2
                and all(isinstance(c, int) and c > 0 for c in cell)):
            raise ValueError("bad decode-step cell")
        return StoredProgram("decode_step", label, arch=payload["arch"],
                             cell=(cell[0], cell[1]))
    raise ValueError(f"unknown payload kind {kind!r}")


class AOTExecutableStore:
    """On-disk store of program blobs + hot-set manifest.

    All mutation happens under one lock; blob and manifest writes are
    atomic (tmp + rename) so a crash mid-store leaves the previous state,
    never a torn file.  Loading is deliberately paranoid (the module
    docstring's safety contract)."""

    def __init__(self, root: str, *, max_entries: int = 64,
                 max_bytes: int = 1 << 30):
        self.root = os.path.expanduser(root)
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)
        self._lock = make_lock("AOTExecutableStore._lock")
        # key -> {"label", "hits", "bytes", "storedAt"}
        self._manifest: dict[str, dict] = {}
        # Counters (process lifetime; stats() snapshots them).
        self.hits = 0
        self.misses = 0
        self.load_errors = 0
        self.stores = 0
        self.store_errors = 0
        self.evictions = 0
        self.call_fallbacks = 0
        # Offers refused because their key names process-local state (an
        # opaque serial, an object address): never persisted.
        self.skipped = 0
        os.makedirs(self.root, exist_ok=True)
        self._read_manifest()

    # -- paths / persistence -------------------------------------------------

    def _blob_path(self, key: str) -> str:
        # Keys are sha256 hexdigests (compile_cache.fingerprint).
        return os.path.join(self.root, f"{key}.aotx")

    def _read_manifest(self) -> None:
        path = os.path.join(self.root, _MANIFEST)
        try:
            with open(path, encoding="utf-8") as fh:
                raw = json.load(fh)
            entries = raw.get("entries", {})
            if isinstance(entries, dict):
                self._manifest = {
                    str(k): dict(v) for k, v in entries.items()
                    if isinstance(v, dict)
                }
        except FileNotFoundError:
            return
        except Exception as exc:  # noqa: BLE001 — a torn manifest must
            # not fail boot; the blobs re-register as they are re-offered.
            logger.warning(kv(event="aot_manifest_unreadable", path=path,
                              error=repr(exc)))
            self._manifest = {}

    def _write_manifest_locked(self) -> None:
        path = os.path.join(self.root, _MANIFEST)
        tmp = f"{path}.tmp.{os.getpid()}"
        doc = {"version": _FORMAT_VERSION, "entries": self._manifest}
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(doc, fh)
            os.replace(tmp, path)
        except OSError as exc:
            logger.warning(kv(event="aot_manifest_write_failed",
                              error=repr(exc)))
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _drop_locked(self, key: str, *, evicted: bool = False) -> None:
        self._manifest.pop(key, None)
        if evicted:
            self.evictions += 1
        try:
            os.unlink(self._blob_path(key))
        except OSError:
            pass

    def _prune_locked(self, keep: str | None = None) -> None:
        """Bound the store to max_entries/max_bytes, evicting the coldest
        (fewest hits, oldest) blobs first; ``keep``, the key just stored,
        is never evicted."""
        def total() -> int:
            return sum(int(rec.get("bytes", 0) or 0)
                       for rec in self._manifest.values())

        while self._manifest and (
            len(self._manifest) > self.max_entries
            or total() > self.max_bytes
        ):
            victims = sorted(
                (k for k in self._manifest if k != keep),
                key=lambda k: (
                    int(self._manifest[k].get("hits", 0) or 0),
                    float(self._manifest[k].get("storedAt", 0.0) or 0.0),
                ),
            )
            if not victims:
                break
            self._drop_locked(victims[0], evicted=True)

    # -- store / load --------------------------------------------------------

    def offer(self, key: str, payload: Any, *,
              label: str | None = None) -> bool:
        """Persist one program's JSON ``payload``.  Best effort: any
        failure counts ``storeErrors`` and the build it rides proceeds
        untouched.  Re-offering a stored key refreshes its label/bytes and
        bumps its heat."""
        try:
            faults.hit("cache.aot_store")
            blob = json.dumps(payload, sort_keys=True).encode("utf-8")
            header = {
                "version": _FORMAT_VERSION,
                "key": key,
                "label": label,
                "deviceSig": _device_signature(),
                "torch": _torch_version(),
                "code": _code_signature(),
                "sha256": hashlib.sha256(blob).hexdigest(),
                "bytes": len(blob),
            }
            path = self._blob_path(key)
            tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "wb") as fh:
                fh.write(_MAGIC)
                fh.write(json.dumps(header).encode("utf-8"))
                fh.write(b"\n")
                fh.write(blob)
            os.replace(tmp, path)
        except Exception as exc:  # noqa: BLE001 — never fail the build
            with self._lock:
                self.store_errors += 1
            logger.warning(kv(event="aot_store_failed", key=key[:12],
                              label=label or "", error=repr(exc)))
            return False
        with self._lock:
            rec = self._manifest.get(key)
            if rec is None:
                rec = self._manifest[key] = {"hits": 0}
            rec["label"] = label
            rec["bytes"] = len(blob)
            rec["storedAt"] = time.time()
            rec["hits"] = int(rec.get("hits", 0) or 0) + 1
            self.stores += 1
            self._prune_locked(keep=key)
            self._write_manifest_locked()
        return True

    def load(self, key: str) -> StoredProgram | None:
        """The validated blob of ``key`` as a :class:`StoredProgram`;
        ``None`` on a miss OR any validation/decode failure (the caller
        builds live: a bad blob must never fail a request).  A corrupt or
        mismatched blob is deleted so the error pays once."""
        with self._lock:
            known = key in self._manifest
        path = self._blob_path(key)
        try:
            faults.hit("cache.aot_load")
            with open(path, "rb") as fh:
                if fh.read(len(_MAGIC)) != _MAGIC:
                    raise ValueError("bad magic")
                header = json.loads(fh.readline().decode("utf-8"))
                blob = fh.read()
            if header.get("version") != _FORMAT_VERSION:
                raise ValueError(
                    f"format version {header.get('version')!r} != "
                    f"{_FORMAT_VERSION}")
            if header.get("key") != key:
                raise ValueError("header key mismatch")
            if header.get("deviceSig") != _device_signature():
                raise ValueError("device signature mismatch")
            if header.get("torch") != _torch_version():
                raise ValueError(
                    f"written under torch {header.get('torch')!r}")
            if header.get("code") != _code_signature():
                raise ValueError("written by another version of the port")
            if hashlib.sha256(blob).hexdigest() != header.get("sha256"):
                raise ValueError("payload checksum mismatch")
            stored = _materialize(json.loads(blob.decode("utf-8")),
                                  header.get("label"))
        except FileNotFoundError:
            with self._lock:
                self.misses += 1
                if known:
                    # Blob vanished under the manifest (operator rm,
                    # partial copy): forget it.
                    self._manifest.pop(key, None)
                    self._write_manifest_locked()
            return None
        except Exception as exc:  # noqa: BLE001 — corruption/mismatch
            with self._lock:
                self.load_errors += 1
                self._drop_locked(key)
                self._write_manifest_locked()
            logger.warning(kv(event="aot_load_failed", key=key[:12],
                              error=repr(exc)))
            return None
        with self._lock:
            self.hits += 1
            rec = self._manifest.get(key)
            if rec is None:
                # Blob present without a manifest row (torn manifest at a
                # previous crash): re-register it.
                rec = self._manifest[key] = {
                    "label": header.get("label"),
                    "bytes": len(blob),
                    "storedAt": time.time(),
                    "hits": 0,
                }
            rec["hits"] = int(rec.get("hits", 0) or 0) + 1
            self._write_manifest_locked()
        return stored

    def note_call_fallback(self) -> None:
        """A restored program raised at CALL time (counted, then raised
        as a live program's failure would: train/compile_cache.py)."""
        with self._lock:
            self.call_fallbacks += 1

    def note_skipped(self) -> None:
        with self._lock:
            self.skipped += 1

    # -- introspection -------------------------------------------------------

    def contains(self, key: str) -> bool:
        with self._lock:
            return key in self._manifest

    def manifest_entries(self) -> list[dict]:
        """Hot set, hottest first: the boot pre-warm's work list."""
        with self._lock:
            entries = [{"key": key, **rec}
                       for key, rec in self._manifest.items()]
        entries.sort(key=lambda rec: int(rec.get("hits", 0) or 0),
                     reverse=True)
        return entries

    def stats(self) -> dict:
        with self._lock:
            persisted_bytes = sum(int(rec.get("bytes", 0) or 0)
                                  for rec in self._manifest.values())
            return {
                "enabled": True,
                "dir": self.root,
                "persistedEntries": len(self._manifest),
                "persistedBytes": persisted_bytes,
                "maxEntries": self.max_entries,
                "maxBytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "loadErrors": self.load_errors,
                "stores": self.stores,
                "storeErrors": self.store_errors,
                "evictions": self.evictions,
                "callFallbacks": self.call_fallbacks,
                "entries_detail": [
                    {
                        "key": key[:12],
                        "label": rec.get("label"),
                        "hits": int(rec.get("hits", 0) or 0),
                        "bytes": int(rec.get("bytes", 0) or 0),
                    }
                    for key, rec in self._manifest.items()
                ],
            }


# -- offering -----------------------------------------------------------------

#: ProgramCost fields a blob leaves out: identity, and this process's own
#: build counters and times.
_NOT_STORED = frozenset(("key", "label", "created_at", "builds", "built_s",
                         "analyzed"))


def offer_program(key: str, label: str | None, *, fn=None,
                  analyze: bool = True, cost=None, arch: str | None = None,
                  cell: tuple | None = None) -> bool:
    """Offer one program to the store (off: one config read): a program
    function of the closed table (``fn``, ``analyze``, ``cost``: a
    ProgramCost or None) or a decode step (``arch``, ``cell``).  A key
    that names process-local state (``compile_cache.persistable``) or a
    function outside the table is counted as skipped, never stored.
    Never raises."""
    try:
        store = get_store()
        if store is None:
            return False
        from learningorchestra_tpu_torch.train import compile_cache

        ident = _identity(fn) if arch is None else None
        if not compile_cache.persistable(key) or (
                arch is None and ident is None):
            store.note_skipped()
            return False
        if arch is not None:
            payload = {"kind": "decode_step", "arch": arch,
                       "cell": [int(c) for c in cell], "cost": None}
        else:
            record = None
            if cost is not None:
                # What the analysis measured; the build counters and
                # times are this process's own.
                record = {k: v for k, v in dataclasses.asdict(cost).items()
                          if k not in _NOT_STORED}
            payload = {"kind": "program", "fn": list(ident),
                       "analyze": bool(analyze), "cost": record}
        return store.offer(key, payload, label=label)
    except Exception:  # noqa: BLE001 — persistence never fails a build
        return False


# -- restored decode cells ----------------------------------------------------

_cells: dict[str, set] = {}
_cells_lock = make_lock("aot_store._cells_lock")


def note_restored_cell(arch: str, cell: tuple) -> None:
    """A decode-step blob of architecture ``arch`` was restored."""
    with _cells_lock:
        _cells.setdefault(arch, set()).add(tuple(cell))


def restored_cells(arch: str | None = None):
    """The (S, Tk) cells restored for ``arch``, sorted; with no ``arch``,
    whether any cell was restored at all."""
    with _cells_lock:
        if arch is None:
            return bool(_cells)
        return sorted(_cells.get(arch, ()))


# -- process-wide singleton ---------------------------------------------------

_store: AOTExecutableStore | None = None
_store_lock = make_lock("aot_store._store_lock")
_config_override = None


def _cfg():
    if _config_override is not None:
        return _config_override
    from learningorchestra_tpu_torch.config import get_config

    return get_config().aot


def configure(cfg) -> None:
    """Serve the store from ``cfg`` (a server's ``AotConfig``) instead of
    the process config; a store sized from other settings is dropped."""
    global _config_override, _store
    with _store_lock:
        _config_override = cfg
        if _store is not None and (
                _store.root != os.path.expanduser(cfg.dir)
                or _store.max_entries != cfg.max_entries
                or _store.max_bytes != cfg.max_bytes):
            _store = None


def enabled() -> bool:
    """Off by default (LO_TPU_AOT_ENABLED): durability is an explicit
    deployment opt-in, as in the JAX package."""
    try:
        cfg = _cfg()
    except Exception:  # noqa: BLE001 — a config error must not turn
        return False  # every program-cache miss into a crash
    return bool(cfg.enabled) and cfg.max_entries > 0


def get_store() -> AOTExecutableStore | None:
    """The process-wide store, or None when disabled.  An explicitly
    installed store (``reset_store`` with overrides: tests) is served
    regardless of config."""
    global _store
    with _store_lock:
        if _store is not None:
            return _store
    if not enabled():
        return None
    with _store_lock:
        if _store is None:
            cfg = _cfg()
            try:
                _store = AOTExecutableStore(
                    cfg.dir, max_entries=cfg.max_entries,
                    max_bytes=cfg.max_bytes)
            except OSError as exc:
                logger.warning(kv(event="aot_store_unavailable",
                                  dir=cfg.dir, error=repr(exc)))
                return None
        return _store


def reset_store(**overrides) -> AOTExecutableStore | None:
    """Replace the singleton (tests; config swap).  With ``overrides``
    (root/max_entries/max_bytes) builds an explicit store regardless of
    config; a bare call drops it, the config override and the restored
    decode cells, for a lazy rebuild from the process config."""
    global _store, _config_override
    with _store_lock:
        if overrides:
            _store = AOTExecutableStore(**overrides)
            return _store
        _store = None
        _config_override = None
    with _cells_lock:
        _cells.clear()
    return get_store()


def stats_snapshot() -> dict:
    """The ``aot`` block of ``GET /monitoring/<tool>/compileCache``: the
    live counters, or zeros when disabled (the JAX disabled shape)."""
    store = get_store()
    if store is None:
        return {
            "enabled": False,
            "persistedEntries": 0,
            "persistedBytes": 0,
            "hits": 0,
            "misses": 0,
            "loadErrors": 0,
            "stores": 0,
            "storeErrors": 0,
            "evictions": 0,
            "callFallbacks": 0,
        }
    return store.stats()
