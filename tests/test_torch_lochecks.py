"""The port's static-analysis suite (``learningorchestra_tpu_torch/analysis/``)
against the JAX package's (``learningorchestra_tpu/analysis/``), and the
port's zero-findings gate:

- ``run_checks`` over the port's package with the whole-program pass
  finds no unsuppressed error, and each inline suppression in the port
  says why on the comment line above it
  (``tests/test_lochecks.py::test_package_is_clean`` for the port);
- each copied analyzer (concurrency, cancellation, the whole-program lock
  graph, the program lints on jit bodies) gives the same rules, paths and
  lines as its JAX original on the same sources: golden fixtures of every
  rule and the port's own package;
- the retargeted host-sync rule fires on ``.item()`` inside a program
  function and the methods the port's programs run, not outside one, and
  an inline suppression silences it;
- the cancellation rule's scope holds the port's rank program.
"""

import ast
import textwrap
from pathlib import Path

import pytest

from learningorchestra_tpu.analysis import cancellation as jax_cancellation
from learningorchestra_tpu.analysis import concurrency as jax_concurrency
from learningorchestra_tpu.analysis import jaxlint as jax_lint
from learningorchestra_tpu.analysis import runner as jax_runner
from learningorchestra_tpu.analysis import wholeprogram as jax_wholeprogram
from learningorchestra_tpu_torch.analysis import ERROR, RULES, run_checks
from learningorchestra_tpu_torch.analysis import cancellation, concurrency
from learningorchestra_tpu_torch.analysis import jaxlint, wholeprogram
from learningorchestra_tpu_torch.analysis.findings import Suppressions

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "learningorchestra_tpu_torch"

#: One module per rule family, each with findings.
FIXTURES = {
    "locks.py": """
        import threading

        class C:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()
                self.count = 0

            def one(self):
                with self._a:
                    with self._b:
                        self.count += 1

            def two(self):
                with self._b:
                    with self._a:
                        pass

            def again(self):
                with self._a:
                    with self._a:
                        pass

            def bare(self):
                self.count = 0

            def start(self):
                threading.Thread(target=self.bare).start()
    """,
    "jitted.py": """
        import jax
        import numpy as np

        TABLE = {}

        @jax.jit
        def step(x):
            y = x * 2
            if y.shape[0] > 1:
                y = y + TABLE["k"]
            return float(y.sum()), y.item(), np.asarray(y)

        def outside(x):
            return x.item()
    """,
    "jobs/worker.py": """
        def body(queue):
            while True:
                queue.get()

        def fit(data):
            for epoch in range(10):
                data.step()
    """,
    "a.py": """
        import threading
        from pkg.b import B

        class A:
            def __init__(self):
                self._lock = threading.Lock()
                self.other = B()

            def one(self):
                with self._lock:
                    self.other.poke()

            def ping(self):
                with self._lock:
                    pass
    """,
    "b.py": """
        import threading
        import time

        class B:
            def __init__(self):
                self._lock = threading.Lock()
                self.friend = None

            def wire(self):
                from pkg.a import A
                self.friend = A()

            def poke(self):
                with self._lock:
                    time.sleep(1)

            def two(self):
                with self._lock:
                    self.friend.ping()
    """,
}


def _write(tmp_path, files) -> Path:
    root = tmp_path / "pkg"
    for rel, src in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    return root


def _trees(root: Path) -> dict:
    return {str(p): (ast.parse(p.read_text()), p.read_text())
            for p in sorted(root.rglob("*.py"))
            if "__pycache__" not in p.parts}


def _keys(findings) -> list:
    return sorted((f.file, f.line, f.rule, f.severity) for f in findings)


def _keys_of(f):
    return (f.file, f.line, f.rule, f.message)


# -- the gate -----------------------------------------------------------------


def test_port_package_is_clean_and_every_suppression_says_why():
    report = run_checks(PKG, whole_program=True)
    assert report.parse_errors == []
    assert report.errors == [], "\n".join(f.render() for f in report.errors)
    assert report.files_scanned > 90
    for finding in report.suppressed:
        lines = Path(finding.file).read_text().splitlines()
        sup = Suppressions("\n".join(lines))
        assert finding.rule not in sup.file_wide, finding.render()
        # The directive stands on the line above the finding, and the
        # comment line above the directive gives the reason.
        directive = lines[finding.line - 2].strip()
        reason = lines[finding.line - 3].strip()
        assert directive.startswith("# lo-check: disable="), finding.render()
        assert reason.startswith("#") and "lo-check" not in reason \
            and len(reason.split()) >= 4, finding.render()


# -- the copies against their JAX originals ----------------------------------


def _per_module(analyze_port, analyze_jax, root):
    port, jax = [], []
    for path, (tree, text) in _trees(root).items():
        port += analyze_port(path, tree, text)
        jax += analyze_jax(path, tree, text)
    return port, jax


FAMILIES = {
    "concurrency": (
        lambda p, t, x: concurrency.analyze_concurrency(p, t),
        lambda p, t, x: jax_concurrency.analyze_concurrency(p, t)),
    "cancellation": (cancellation.analyze_cancellation,
                     jax_cancellation.analyze_cancellation),
    "jit_lints": (lambda p, t, x: jaxlint.analyze_jax(p, t),
                  lambda p, t, x: jax_lint.analyze_jax(p, t)),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_copied_analyzer_matches_jax_on_the_fixtures(tmp_path, family):
    root = _write(tmp_path, FIXTURES)
    port, jax = _per_module(*FAMILIES[family], root)
    assert port, family  # the fixtures exercise every family
    assert _keys(port) == _keys(jax)
    assert sorted(map(_keys_of, port)) == sorted(map(_keys_of, jax))


def test_whole_program_pass_matches_jax_on_the_fixtures_and_the_port(
        tmp_path):
    root = _write(tmp_path, FIXTURES)
    for where in (root, PKG):
        trees = {p: t for p, (t, _) in _trees(where).items()}
        port, graph = wholeprogram.analyze_wholeprogram(where, trees)
        jax, jax_graph = jax_wholeprogram.analyze_wholeprogram(where, trees)
        assert sorted(map(_keys_of, port)) == sorted(map(_keys_of, jax))
        assert sorted(graph.edges) == sorted(jax_graph.edges)
        if where == root:
            assert {f.rule for f in port} == {"lock-order-global",
                                              "blocking-call-under-lock"}


def test_port_rules_are_the_jax_rules_it_runs(tmp_path):
    for rule, (severity, _) in RULES.items():
        assert jax_runner.RULES[rule][0] == severity, rule
    root = _write(tmp_path, FIXTURES)
    report = run_checks(root, whole_program=True)
    assert {f.rule for f in report.findings} <= set(RULES)
    assert {f.rule for f in report.findings} >= {
        "lock-order", "lock-self-deadlock", "unlocked-shared-write",
        "jit-host-sync", "jit-mutable-global", "jit-shape-branch",
        "loop-no-cancel-check", "lock-order-global",
        "blocking-call-under-lock"}


def test_copied_analyzers_match_jax_on_the_port_package():
    port, jax = [], []
    for path, (tree, text) in _trees(PKG).items():
        port += concurrency.analyze_concurrency(path, tree)
        jax += jax_concurrency.analyze_concurrency(path, tree)
        port += cancellation.analyze_cancellation(path, tree, text)
        jax += jax_cancellation.analyze_cancellation(path, tree, text)
    assert _keys(port) == _keys(jax)


# -- the retargeted host-sync rule --------------------------------------------

PROGRAMS = {
    "train/programs.py": """
        import torch
        from pkg.train import aot_store

        def helper(t):
            return t.cpu()

        @aot_store.program_function
        def program(est, x, seed: int):
            torch.manual_seed(int(seed))
            y = est.module(x)
            z = helper(y)
            torch.cuda.synchronize()
            return y.sum().item(), float(z.mean())

        @aot_store.program_function
        def quiet(est, x):
            # The program's one host transfer, its result:
            # lo-check: disable=jit-host-sync
            return est.module(x).numpy()

        def host_side(x):
            return x.sum().item()
    """,
    "ops/moe.py": """
        def route(logits, top_k: int, cap: int):
            return logits.argmax(-1).tolist(), int(cap)

        def aux_loss(logits):
            return logits.mean().item()
    """,
    "serve/decode/pages.py": """
        class DecodeStepProgram:
            def __init__(self, nslots):
                self.nslots = int(nslots)

            def __call__(self, module, pool):
                return module(pool).item()
    """,
}


def test_host_sync_fires_inside_program_functions_only(tmp_path):
    root = _write(tmp_path, PROGRAMS)
    report = run_checks(root)
    got = sorted((Path(f.file).relative_to(root).as_posix(), f.line,
                  f.message.split()[0])
                 for f in report.findings)
    assert {f.rule for f in report.findings} == {"jit-host-sync"}
    assert all(f.severity == ERROR for f in report.findings)
    assert got == sorted([
        # helper() runs inside program(): its .cpu() counts there.
        ("train/programs.py", 6, ".cpu()"),
        ("train/programs.py", 13, "torch.cuda.synchronize"),
        ("train/programs.py", 14, ".item()"),
        ("train/programs.py", 14, "float()"),
        ("ops/moe.py", 3, ".tolist()"),
        ("serve/decode/pages.py", 7, ".item()"),
    ])
    # int() of a host argument, the host-side function, the aux loss
    # (not a program method) and the program object's constructor: none.
    # The suppressed transfer is reported as suppressed.
    assert [(Path(f.file).name, f.line) for f in report.suppressed] == [
        ("programs.py", 20)]


def test_cancellation_scope_holds_the_rank_program(tmp_path):
    root = _write(tmp_path, {"parallel/rank.py": """
        def serve(queue):
            while True:
                queue.get()
    """})
    port, jax = _per_module(cancellation.analyze_cancellation,
                            jax_cancellation.analyze_cancellation, root)
    assert [f.rule for f in port] == ["loop-no-cancel-check"]
    assert jax == []
