"""The port stands alone: neither learningorchestra_tpu_torch/ nor
chip_smoke.py imports JAX, flax, optax, dill, pandas, requests,
matplotlib or the JAX package (the card's machine has none of them),
checked statically and at import time."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "learningorchestra_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "dill", "orbax", "pandas",
             "requests", "matplotlib", "learningorchestra_tpu"}


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
            node.func, "attr", getattr(node.func, "id", None)
        ) in ("import_module", "__import__") and node.args and isinstance(
            node.args[0], ast.Constant
        ):
            yield str(node.args[0].value).split(".")[0]


def test_sources_exist():
    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    assert "learningorchestra_tpu_torch/ops/attention.py" in names
    assert "chip_smoke.py" in names
    # The text pipeline and beyond-RAM datasets' own copies.
    for module in ("text/bpe.py", "store/sharded.py", "services/explore.py",
                   "services/function.py", "services/png.py",
                   # Data parallelism, the distributed services and the
                   # monitoring sessions' own copies.
                   "parallel/mesh.py", "parallel/sharding.py",
                   "parallel/distributed.py", "parallel/rank.py",
                   "services/distributed_exec.py", "services/monitoring.py",
                   "services/tfevents.py",
                   # The streaming decode engine's own copies.
                   "serve/decode/__init__.py", "serve/decode/engine.py",
                   "serve/decode/pages.py", "serve/decode/streams.py",
                   # The fleet tier's own copies.
                   "serve/fleet/__init__.py", "serve/fleet/router.py",
                   "serve/fleet/replicaset.py", "serve/fleet/autoscaler.py",
                   "serve/fleet/manager.py",
                   # The program cache and the cost plane's own copies.
                   "obs/__init__.py", "obs/costs.py",
                   "train/compile_cache.py",
                   # The durable program store and the live profiler.
                   "train/aot_store.py", "obs/profiling.py",
                   # The operations plane.
                   "obs/metrics.py", "obs/tracing.py", "obs/rollup.py",
                   "obs/slo.py", "obs/flight.py", "obs/bundle.py",
                   "faults/__init__.py", "faults/plane.py",
                   # The mixture-of-experts layer and models.
                   "ops/moe.py", "models/moe.py",
                   # Ring attention and the long-context model.
                   "parallel/ring_attention.py", "models/longcontext.py"):
        assert f"learningorchestra_tpu_torch/{module}" in names
    assert (PORT / "csrc" / "flash_fwd.cu").is_file()
    assert (PORT / "csrc" / "flash_bwd.cu").is_file()
    assert (PORT / "csrc" / "quant.cu").is_file()


@pytest.mark.parametrize(
    "path", _sources(), ids=lambda p: p.relative_to(ROOT).as_posix()
)
def test_no_forbidden_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.name} imports {bad}"


def test_import_pulls_in_no_jax():
    modules = sorted(
        "learningorchestra_tpu_torch." + ".".join(
            p.relative_to(PORT).with_suffix("").parts
        ).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import sys\n"
        f"for m in {modules!r}:\n"
        "    __import__(m.rstrip('.'))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'pandas', 'requests', "
        "'matplotlib', 'learningorchestra_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
