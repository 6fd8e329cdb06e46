"""Build the CUDA sources under ``csrc/`` with nvcc at first use and bind
them through ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own into ``build/torch_kernels/<name>-<hash>.so`` at the repository root
(a git-ignored directory); the hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited kernel or header never loads
a stale library.  Independent sources build in parallel, one nvcc process
each.  A failed build raises with nvcc's output: nothing falls back to a
plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / \
    "torch_kernels"
SOURCES = ("flash_fwd", "flash_bwd", "quant")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: nvcc's output (ptxas registers / shared memory / spills) per source,
#: from the build that made its library (kept beside it as ``.log``).
build_log: dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
        "and PATH); the port's CUDA kernels are built from csrc/ at "
        "first use"
    )


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every source in ``names`` whose library is missing, all
    nvcc processes at once; returns wall seconds per source (0.0 when it
    was already built)."""
    todo = [n for n in names if not library_path(n).exists()]
    secs = {n: 0.0 for n in names}
    for name in names:
        log = library_path(name).with_suffix(".log")
        if name not in todo and log.exists():
            build_log[name] = log.read_text()
    if not todo:
        return secs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )))
    failed = []
    for name, out, tmp, t0, proc in procs:
        log = proc.communicate()[0].decode(errors="replace")
        secs[name] = time.perf_counter() - t0
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            # Atomic publish: a concurrent process never loads a torn .so
            # (the log goes first, so a published library has its log).
            tmp_log = tmp.with_suffix(".log")
            tmp_log.write_text(log)
            os.replace(tmp_log, out.with_suffix(".log"))
            os.replace(tmp, out)
    if failed:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build((name,))
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


def check(status: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(
            f"{what}: CUDA launch failed with cudaError_t {status}"
        )
