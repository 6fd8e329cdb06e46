"""Managed in-loop training checkpoints — port of
``learningorchestra_tpu/train/checkpoint.py`` on ``torch.save`` where the
JAX package uses orbax.

A fit given a checkpoint directory saves ``{"params", "opt_state"}``
every N epochs, and an interrupted fit (a killed process recovered from
the job journal, or a failed job PATCHed back) resumes from the newest
committed step instead of epoch 0.  The state is the layout
:meth:`NeuralEstimator.state_dict` already uses: the flax parameter tree
and the optimizer state in optax's field names (``count``, ``mu``,
``nu``, ...; ``MultiStepsState`` fields when gradients accumulate), so
a JAX checkpoint's restored numpy tree sits beside the port's name for
name.  The pickle holds CPU tensors only, and a load maps them onto the
caller's device.

Layout under ``<dir>``::

    step_<n>/state.pt   the state at the end of epoch n
    latest.json         {"step": n, "history": {...}}

``latest.json`` is replaced atomically (``.tmp`` + ``os.replace``) only
after ``step_<n>/`` is renamed into place, so a save killed part way
leaves the previous step discoverable: the marker is the commit point.
Steps older than ``KEEP`` are pruned at each publish.  The commit point
survives the death of the process; surviving a power loss is left to
the file system, as for the store's default (``durable_writes`` off).

Async saves (``async_save=True``, the fit default): each directory has
one writer thread and at most one save in flight.  ``save`` takes a
snapshot first, on the device (a clone enqueued on the current stream,
so the next epoch's in-place updates queue behind it) or on the host for
CPU tensors, and returns; the writer copies the snapshot to the host on
a side stream and pickles it.  The marker of a save publishes at the
next save to the same directory or at :func:`finalize_async` (which fit
calls on exit; an ``atexit`` hook covers the rest), exactly as the JAX
package's orbax slot does.  A writer's error is raised there too, so a
checkpoint that fails to write fails the fit.

The JAX package gates saves to its primary process behind a barrier.
In the port's data-parallel fit (parallel/distributed.py) only rank 0
saves, and every rank resumes from the marker before any rank saves, so
no barrier is needed.
"""

from __future__ import annotations

import atexit
import collections
import json
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

KEEP = 2  # retained checkpoints; older ones are pruned after each publish
STATE_FILE = "state.pt"

#: The last saves' costs (newest last), one dict each: ``step``,
#: ``snapshot_s`` (the fit loop's wait for the snapshot), ``wait_s`` (its
#: wait for the previous save's writer), ``write_s`` (the writer's host
#: copy and pickle), ``bytes`` (of ``state.pt``) and ``async``.
recent_saves: collections.deque = collections.deque(maxlen=64)


def _publish(directory: Path, step: int, history: dict | None) -> None:
    """Commit point: name the newest fully written step, then prune the
    steps older than ``KEEP``."""
    marker = {"step": step, "history": history or {}}
    tmp = directory / "latest.json.tmp"
    tmp.write_text(json.dumps(marker))
    os.replace(tmp, directory / "latest.json")
    for old in sorted(directory.glob("step_*")):
        try:
            n = int(old.name.split("_", 1)[1])
        except ValueError:
            continue
        if n <= step - KEEP:
            shutil.rmtree(old, ignore_errors=True)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _host_copy(leaf):
    """A CPU tensor that owns its memory (numpy leaves become tensors);
    Python scalars and None pass."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, np.ndarray | np.generic):
        return torch.from_numpy(np.array(leaf, copy=True))
    return leaf


def _snapshot_leaf(leaf):
    """A copy the caller's next in-place update cannot reach: on the card
    a clone on the device, enqueued on the current stream ahead of the
    next epoch's kernels; elsewhere a host copy."""
    if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
        return leaf.detach().clone(memory_format=torch.contiguous_format)
    return _host_copy(leaf)


def _write_step(directory: Path, step: int, host_state) -> tuple[Path, int]:
    """Write ``step_<step>/`` through a ``.tmp`` directory renamed into
    place; returns (path, bytes)."""
    path = directory / f"step_{step}"
    tmp = directory / f"step_{step}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    torch.save(host_state, tmp / STATE_FILE)
    size = (tmp / STATE_FILE).stat().st_size
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path, size


class _AsyncSlot:
    """One directory's writer: at most one save in flight."""

    def __init__(self):
        self.lock = threading.Lock()
        self.thread: threading.Thread | None = None
        self.pending = None  # (step, history, stats) awaiting publish
        self.error: BaseException | None = None


_SLOTS: dict[str, _AsyncSlot] = {}
_SLOTS_LOCK = threading.Lock()


def _slot(directory: Path) -> _AsyncSlot:
    key = str(directory)
    with _SLOTS_LOCK:
        if not _SLOTS:
            # A process must never exit with a written but unpublished
            # checkpoint (the marker is the commit point).
            atexit.register(finalize_async)
        return _SLOTS.setdefault(key, _AsyncSlot())


def _finish_locked(directory: Path, slot: _AsyncSlot) -> None:
    """Join the in-flight writer and publish its marker; re-raise its
    error (the save is then not published)."""
    if slot.thread is not None:
        slot.thread.join()
        slot.thread = None
    if slot.pending is None:
        return
    step, history, stats = slot.pending
    slot.pending = None
    if slot.error is not None:
        error, slot.error = slot.error, None
        raise RuntimeError(
            f"checkpoint step {step} under {directory} failed to write"
        ) from error
    _publish(directory, step, history)
    recent_saves.append(stats)


def _writer(slot: _AsyncSlot, directory: Path, step: int, snap, ready,
            stats: dict) -> None:
    try:
        t0 = time.perf_counter()
        if ready is not None:
            # The device-to-host copy runs on a side stream, after the
            # snapshot's clones and beside the next epoch's kernels.
            event, device = ready
            side = torch.cuda.Stream(device=device)
            side.wait_event(event)
            with torch.cuda.stream(side):
                snap = _map(snap, _host_copy)
        _, stats["bytes"] = _write_step(directory, step, snap)
        stats["write_s"] = time.perf_counter() - t0
    except Exception as exc:  # noqa: BLE001 — handed to the fit loop,
        # which raises it at the next save or finalize.
        slot.error = exc


def finalize_async(directory: str | Path | None = None) -> None:
    """Block until in-flight async saves are written and publish their
    markers, for one directory or (``None``) all of them.  Fit calls it
    on exit, so the last checkpoint is committed when fit returns."""
    if directory is not None:
        keys = [str(Path(directory))]
    else:
        with _SLOTS_LOCK:
            keys = list(_SLOTS)
    for key in keys:
        with _SLOTS_LOCK:
            slot = _SLOTS.get(key)
        if slot is not None:
            with slot.lock:
                _finish_locked(Path(key), slot)


def save(directory: str | Path, step: int, state: dict,
         history: dict | None = None, *, async_save: bool = False) -> Path:
    """Persist ``state`` (a nested dict of tensors, numpy arrays and
    scalars) as step ``step``; returns the step path.

    Sync: written and published before it returns.  ``async_save=True``
    returns once the snapshot is taken; the marker publishes at the next
    save or at :func:`finalize_async` (a crash before then resumes from
    the previous step, the same fallback as a crash mid sync save)."""
    directory = Path(directory)
    # The marker publishes later: it must hold the history as it is now,
    # not the caller's lists after later epochs appended to them.
    history = {k: list(v) for k, v in (history or {}).items()}
    stats = {"dir": str(directory), "step": step, "async": async_save}
    if not async_save:
        # A pending async save publishes first: its stale marker must
        # never land over this one's.
        finalize_async(directory)
        t0 = time.perf_counter()
        directory.mkdir(parents=True, exist_ok=True)
        snap = _map(state, _host_copy)
        path, stats["bytes"] = _write_step(directory, step, snap)
        stats.update(snapshot_s=0.0, wait_s=0.0,
                     write_s=time.perf_counter() - t0)
        _publish(directory, step, history)
        recent_saves.append(stats)
        return path
    slot = _slot(directory)
    with slot.lock:
        t0 = time.perf_counter()
        _finish_locked(directory, slot)
        t1 = time.perf_counter()
        directory.mkdir(parents=True, exist_ok=True)
        snap = _map(state, _snapshot_leaf)
        ready = None
        device = next((t.device for t in _leaves(snap)
                       if isinstance(t, torch.Tensor) and t.is_cuda), None)
        if device is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            ready = (event, device)
        stats.update(wait_s=t1 - t0, snapshot_s=time.perf_counter() - t1)
        slot.pending = (step, history, stats)
        slot.thread = threading.Thread(
            target=_writer, args=(slot, directory, step, snap, ready, stats),
            name=f"lo-ckpt-{directory.name}", daemon=True)
        slot.thread.start()
    return directory / f"step_{step}"


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _read_marker(directory: Path):
    try:
        marker = json.loads((directory / "latest.json").read_text())
        return int(marker["step"]), marker.get("history") or {}
    except (OSError, ValueError, KeyError, TypeError):
        return None


def load_step(directory: str | Path, step: int, *, device="cpu"):
    """One step's state with its tensors on ``device``, or None when that
    step is absent."""
    directory = Path(directory)
    finalize_async(directory)
    path = directory / f"step_{step}" / STATE_FILE
    if not path.exists():
        return None
    return torch.load(path, map_location=device, weights_only=True)


def load_latest(directory: str | Path, *, device="cpu"):
    """The newest committed checkpoint as (state, step, history), or
    None.  In-flight saves to the directory publish first, so a reader
    in this process sees the newest step."""
    directory = Path(directory)
    finalize_async(directory)
    marker = _read_marker(directory)
    if marker is None:
        return None
    step, history = marker
    state = load_step(directory, step, device=device)
    if state is None:
        return None
    return state, step, history


def publish_marker(directory: str | Path, step: int,
                   history: dict | None = None) -> None:
    """The commit-point writer for a fit that persists its state in its
    own sub-layout (the JAX package's pipelined fit writes one directory
    per stage): the same atomic ``latest.json``, after every part has
    committed."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    _publish(directory, step, history)


def resume_or_none(directory, restore, *, device="cpu"):
    """Load the newest checkpoint and hand its state to ``restore``;
    returns (step, history), or None without a checkpoint.  A state that
    does not fit the current configuration is reported as such."""
    loaded = load_latest(directory, device=device)
    if loaded is None:
        return None
    state, step, history = loaded
    try:
        restore(state)
    except (ValueError, TypeError, KeyError, RuntimeError) as exc:
        raise ValueError(
            "checkpoint resume failed: the saved state does not match "
            "the current configuration (model, optimizer, or "
            "accumulate_steps changed since the checkpoint was "
            "written). Re-run with resume=False or the original "
            "settings."
        ) from exc
    return step, history


def should_save(epoch_i: int, epochs: int, every: int,
                min_interval_s: float, last_save: float,
                *, stopped: bool = False) -> bool:
    """One save policy for every fit loop: every ``every`` epochs
    (``every <= 0`` disables checkpointing, the final save included),
    at most once per ``min_interval_s``; the final epoch always saves
    when checkpointing is on, and ``stopped=True`` (an early stop) counts
    as final."""
    if every <= 0:
        return False
    return (
        epoch_i + 1 == epochs
        or stopped
        or ((epoch_i + 1) % every == 0
            and time.monotonic() - last_save >= min_interval_s)
    )
