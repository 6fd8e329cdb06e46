"""Cross-artifact drift gates — port of
``learningorchestra_tpu/analysis/drift.py``.

The orchestration contract — ``LO_TPU_*`` env knobs, REST routes,
Prometheus family names, armable fault points — lives in five places at
once: the code that reads it, ``config.py``, the README, and both deploy
manifests.  These gates make the convention mechanical.  Over the port
(:meth:`DriftPaths.for_repo`) they read the port's ``config.py``,
``api/server.py``, ``client.py`` and ``faults/plane.py``, the README's
port section alone, ``tests/test_torch_*.py``, ``chip_smoke.py`` and the
port's manifests under ``deploy/torch/``.  A knob only the port reads may
be named in the README by its config field (``dist.cpu_ranks``): the JAX
package's gate reads the whole README and refuses a knob it does not
read.

Rules (all error severity):

``knob-missing-config``    knob referenced in code but absent from
                           ``config.py`` (the canonical index —
                           direct-read knobs belong in its
                           ``DIRECT_ENV_KNOBS`` registry)
``knob-missing-compose``   knob absent from deploy/docker-compose.yml
``knob-missing-k8s``       knob absent from deploy/k8s.yaml
``knob-missing-readme``    knob absent from the README knob tables
``knob-unknown``           knob present in a manifest/README but
                           referenced nowhere in code (stale entry)
``fault-point-unknown``    ``LO_TPU_FAULT_<X>`` / ``faults.hit("x")``
                           names a point faults/plane.py never
                           registers
``route-missing-client``   a REST route with no client.py binding
``route-gate-missing``     the every-route-metered test gate is gone
                           (``DriftPaths.route_gate``)
``metric-unregistered``    a ``lo_*`` family named in tests/README
                           that no registry call creates
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path

from .findings import Finding

_KNOB_RE = re.compile(r"LO_TPU_[A-Z0-9_]+")
_FAMILY_RE = re.compile(r"(?<![A-Za-z0-9_])lo_[a-z0-9_]+")
_GROUP_RE = re.compile(r"\(\?P<[A-Za-z_]+>[^)]*\)")
_PROM_SUFFIXES = ("_bucket", "_sum", "_count")
#: ``lo_``-prefixed tokens that are not metric families: the check
#: tool's own name shows up in test/README strings.
_FAMILY_IGNORE = {"lo_check"}
#: The README's port section.
README_SECTION = "## PyTorch/CUDA port"


@dataclasses.dataclass
class DriftPaths:
    """Where each artifact lives — parameterized so golden tests can
    point the gates at fixture copies."""

    package_root: Path
    config: Path
    compose: Path
    k8s: Path
    readme: Path
    server: Path
    client: Path
    plane: Path
    tests_dir: Path
    scripts: tuple = ()
    #: The README heading whose section alone is read (None: the whole
    #: file).
    readme_section: str | None = None
    #: The test files the metric gate reads.
    tests_glob: str = "test_*.py"
    #: (test file, test name) of the every-route-metered gate.
    route_gate: tuple = ("test_obs.py",
                         "test_every_registered_route_is_metered")

    @staticmethod
    def for_repo(repo_root: str | Path) -> "DriftPaths":
        root = Path(repo_root)
        pkg = root / "learningorchestra_tpu_torch"
        return DriftPaths(
            package_root=pkg,
            config=pkg / "config.py",
            compose=root / "deploy" / "torch" / "docker-compose.yml",
            k8s=root / "deploy" / "torch" / "k8s.yaml",
            readme=root / "README.md",
            server=pkg / "api" / "server.py",
            client=pkg / "client.py",
            plane=pkg / "faults" / "plane.py",
            tests_dir=root / "tests",
            scripts=(root / "chip_smoke.py",),
            readme_section=README_SECTION,
            tests_glob="test_torch_*.py",
            route_gate=("test_torch_obs.py",
                        "test_every_route_in_the_table_is_metered"),
        )


def _read(path: Path) -> str:
    try:
        return path.read_text()
    except OSError:
        return ""


def _section(text: str, heading: str | None) -> str:
    """``text`` with every line outside the ``heading`` section (to the
    next heading of its level) blanked, so line numbers still hold."""
    if heading is None:
        return text
    level = heading.split(" ", 1)[0] + " "
    out, inside = [], False
    for line in text.split("\n"):
        if line.startswith(heading):
            inside = True
        elif inside and line.startswith(level):
            inside = False
        out.append(line if inside else "")
    return "\n".join(out)


class _Sources:
    """Read/parse-once cache over the artifact set.  An unparsable
    file yields ``None`` (the runner reports package syntax errors
    separately; the drift gates must degrade, not crash the CLI)."""

    def __init__(self):
        self._texts: dict[Path, str] = {}
        self._trees: dict[Path, ast.Module | None] = {}

    def readme(self, paths: "DriftPaths") -> str:
        return _section(self.text(paths.readme), paths.readme_section)

    def text(self, path: Path) -> str:
        if path not in self._texts:
            self._texts[path] = _read(path)
        return self._texts[path]

    def tree(self, path: Path) -> ast.Module | None:
        if path not in self._trees:
            try:
                self._trees[path] = ast.parse(self.text(path))
            except SyntaxError:
                self._trees[path] = None
        return self._trees[path]


def _package_files(paths: DriftPaths):
    for p in sorted(paths.package_root.rglob("*.py")):
        if "__pycache__" in p.parts:
            continue
        yield p


def _knob_tokens(text: str):
    """Full LO_TPU_* tokens; trailing-underscore hits are prefix
    mentions (``LO_TPU_SERVE_*``-style docs), not knobs."""
    for m in _KNOB_RE.finditer(text):
        tok = m.group(0)
        if not tok.endswith("_"):
            yield tok, m.start()


def _first_site(text: str, token: str, path: Path):
    idx = text.find(token)
    line = text.count("\n", 0, idx) + 1 if idx >= 0 else 1
    return str(path), line


# -- fault points ------------------------------------------------------------


def registered_fault_points(
    paths: DriftPaths, src: "_Sources | None" = None
) -> set[str]:
    """POINTS tuple literal in plane.py + register_point("...") call
    literals anywhere in the package."""
    src = src or _Sources()
    points: set[str] = set()
    plane_tree = src.tree(paths.plane)
    for node in (plane_tree.body if plane_tree else ()):
        if (
            isinstance(node, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == "POINTS"
                for t in node.targets
            )
            and isinstance(node.value, (ast.Tuple, ast.List))
        ):
            for elt in node.value.elts:
                if isinstance(elt, ast.Constant) and isinstance(
                    elt.value, str
                ):
                    points.add(elt.value)
    for p in _package_files(paths):
        tree = src.tree(p)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if (
                isinstance(node, ast.Call)
                and (
                    (isinstance(node.func, ast.Name)
                     and node.func.id == "register_point")
                    or (isinstance(node.func, ast.Attribute)
                        and node.func.attr == "register_point")
                )
                and node.args
                and isinstance(node.args[0], ast.Constant)
            ):
                points.add(node.args[0].value)
    return points


def _env_spelling(point: str) -> str:
    return point.upper().replace(".", "_")


def check_fault_points(
    paths: DriftPaths, src: "_Sources | None" = None
) -> list[Finding]:
    src = src or _Sources()
    points = registered_fault_points(paths, src)
    env_ok = {_env_spelling(p) for p in points}
    findings: list[Finding] = []
    # LO_TPU_FAULT_<X> spellings anywhere an operator could write one.
    surfaces = (
        list(_package_files(paths))
        + [paths.compose, paths.k8s, paths.readme]
        + sorted(paths.tests_dir.glob(paths.tests_glob))
        + [Path(s) for s in paths.scripts]
    )
    for p in surfaces:
        text = (src.readme(paths) if p == paths.readme
                else src.text(Path(p)))
        for tok, pos in _knob_tokens(text):
            if not tok.startswith("LO_TPU_FAULT_"):
                continue
            suffix = tok[len("LO_TPU_FAULT_"):]
            if suffix and suffix not in env_ok:
                line = text.count("\n", 0, pos) + 1
                findings.append(Finding(
                    str(p), line, "fault-point-unknown",
                    f"{tok} names no registered fault point "
                    f"(known: {', '.join(sorted(points))})",
                ))
    # faults.hit("x") / arm("x") literals in the package.
    for p in _package_files(paths):
        if p == paths.plane:
            continue
        tree = src.tree(p)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            fn = node.func
            name = (
                fn.attr if isinstance(fn, ast.Attribute)
                else fn.id if isinstance(fn, ast.Name) else ""
            )
            if name in ("hit", "arm") and "." in node.args[0].value:
                point = node.args[0].value
                if point not in points:
                    findings.append(Finding(
                        str(p), node.lineno, "fault-point-unknown",
                        f"faults.{name}({point!r}) names no "
                        "registered fault point",
                    ))
    return findings


# -- env knobs ---------------------------------------------------------------


def knob_fields(
    paths: DriftPaths, src: "_Sources | None" = None
) -> dict[str, str]:
    """knob -> ``section.field`` from config.py's ``from_env`` tables:
    tuples ``("LO_TPU_<KNOB>", cfg.<section>, "<field>", ...)``."""
    tree = (src or _Sources()).tree(paths.config)
    out: dict[str, str] = {}
    for node in ast.walk(tree) if tree is not None else ():
        if not (isinstance(node, ast.Tuple) and len(node.elts) >= 3):
            continue
        knob, section, attr = node.elts[:3]
        if (
            isinstance(knob, ast.Constant)
            and isinstance(knob.value, str)
            and knob.value.startswith("LO_TPU_")
            and isinstance(section, ast.Attribute)
            and isinstance(attr, ast.Constant)
            and isinstance(attr.value, str)
        ):
            out[knob.value] = f"{section.attr}.{attr.value}"
    return out


def check_knobs(
    paths: DriftPaths, src: "_Sources | None" = None
) -> list[Finding]:
    src = src or _Sources()
    findings: list[Finding] = []
    code_refs: dict[str, tuple] = {}
    for p in list(_package_files(paths)) + [
        Path(s) for s in paths.scripts
    ]:
        text = src.text(p)
        for tok, pos in _knob_tokens(text):
            if tok.startswith("LO_TPU_FAULT_"):
                continue  # fault-point rule's jurisdiction
            if tok not in code_refs:
                line = text.count("\n", 0, pos) + 1
                code_refs[tok] = (str(p), line)

    config_text = src.text(paths.config)
    compose_text = src.text(paths.compose)
    k8s_text = src.text(paths.k8s)
    readme_text = src.readme(paths)
    fields = knob_fields(paths, src)

    for tok in sorted(code_refs):
        site = code_refs[tok]
        for artifact_text, rule, what in (
            (config_text, "knob-missing-config",
             "config.py (the canonical knob index)"),
            (compose_text, "knob-missing-compose",
             "deploy/docker-compose.yml"),
            (k8s_text, "knob-missing-k8s", "deploy/k8s.yaml"),
            (readme_text, "knob-missing-readme",
             "the README knob tables"),
        ):
            if tok not in artifact_text and not (
                rule == "knob-missing-readme" and tok in fields
                and fields[tok] in artifact_text
            ):
                findings.append(Finding(
                    site[0], site[1], rule,
                    f"{tok} is referenced in code but absent from "
                    f"{what}",
                ))
    # Reverse direction: manifest/README entries no code reads are
    # stale — a renamed knob's old spelling silently configuring
    # nothing.
    for artifact, path in (
        (compose_text, paths.compose),
        (k8s_text, paths.k8s),
        (readme_text, paths.readme),
    ):
        for tok, pos in _knob_tokens(artifact):
            if tok.startswith("LO_TPU_FAULT_"):
                continue
            if tok not in code_refs and tok not in config_text:
                line = artifact.count("\n", 0, pos) + 1
                findings.append(Finding(
                    str(path), line, "knob-unknown",
                    f"{tok} appears here but no code reads it — "
                    "stale entry or typo",
                ))
    return findings


# -- routes ------------------------------------------------------------------


def server_routes(
    paths: DriftPaths, src: "_Sources | None" = None
) -> list[tuple]:
    """→ [(verb, template, line)] where template segments are literal
    strings or "*" for a regex group."""
    tree = (src or _Sources()).tree(paths.server)
    if tree is None:
        return []
    # Literal string assignments anywhere (TOOL/NAME pattern vars).
    consts: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(
            node.value, ast.Constant
        ) and isinstance(node.value.value, str):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    consts[t.id] = node.value.value

    def resolve(expr) -> str | None:
        if isinstance(expr, ast.Constant) and isinstance(
            expr.value, str
        ):
            return expr.value
        if isinstance(expr, ast.Name):
            return consts.get(expr.id)
        if isinstance(expr, ast.JoinedStr):
            parts = []
            for val in expr.values:
                if isinstance(val, ast.Constant):
                    parts.append(str(val.value))
                elif isinstance(val, ast.FormattedValue):
                    inner = resolve(val.value)
                    if inner is None:
                        return None
                    parts.append(inner)
            return "".join(parts)
        if isinstance(expr, ast.BinOp) and isinstance(
            expr.op, ast.Add
        ):
            left, right = resolve(expr.left), resolve(expr.right)
            if left is not None and right is not None:
                return left + right
        return None

    routes = []
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "add"
            and len(node.args) >= 2
            and isinstance(node.args[0], ast.Constant)
        ):
            continue
        verb = node.args[0].value
        raw = resolve(node.args[1])
        if raw is None:
            continue
        template = _GROUP_RE.sub("*", raw)
        routes.append((verb, template, node.lineno))
    return routes


def client_templates(
    paths: DriftPaths, src: "_Sources | None" = None
) -> list[tuple]:
    """→ [(verb, template)] from every ``request("VERB", path)`` call
    in client.py; f-string placeholders become "*"."""
    tree = (src or _Sources()).tree(paths.client)
    if tree is None:
        return []
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "request"
                and len(node.args) >= 2
                and isinstance(node.args[0], ast.Constant)):
            continue
        verb = node.args[0].value
        expr = node.args[1]
        if isinstance(expr, ast.Constant) and isinstance(
            expr.value, str
        ):
            out.append((verb, expr.value))
        elif isinstance(expr, ast.JoinedStr):
            parts = []
            for val in expr.values:
                if isinstance(val, ast.Constant):
                    parts.append(str(val.value))
                else:
                    parts.append("*")
            out.append((verb, "".join(parts)))
    return out


def _segments(template: str) -> list[str]:
    segs = [s for s in template.strip("/").split("/") if s]
    # A placeholder glued to text ("shard*" from f"/shard{i}") still
    # counts as one wildcard segment.
    return ["*" if "*" in s else s for s in segs]


def _client_matches(server_segs, client_segs) -> bool:
    """Server "*" matches exactly one segment; client "*" matches one
    OR MORE (``f"/{self.service_path}/{name}"`` covers nested service
    paths like ``dataset/csv``)."""

    def match(i: int, j: int) -> bool:
        if i == len(server_segs) and j == len(client_segs):
            return True
        if i == len(server_segs) or j == len(client_segs):
            return False
        s, c = server_segs[i], client_segs[j]
        if c == "*":
            # one-or-more server segments
            return any(
                match(k, j + 1)
                for k in range(i + 1, len(server_segs) + 1)
            )
        if s == "*":
            return match(i + 1, j + 1)
        return s == c and match(i + 1, j + 1)

    return match(0, 0)


def check_routes(
    paths: DriftPaths, src: "_Sources | None" = None
) -> list[Finding]:
    src = src or _Sources()
    findings: list[Finding] = []
    clients = [
        (verb, _segments(tpl))
        for verb, tpl in client_templates(paths, src)
    ]
    for verb, template, line in server_routes(paths, src):
        segs = _segments(template)
        if not any(
            cv == verb and _client_matches(segs, cseg)
            for cv, cseg in clients
        ):
            findings.append(Finding(
                str(paths.server), line, "route-missing-client",
                f"{verb} {template} has no client.py binding — the "
                "uniform REST surface promises one per route",
            ))
    # The dynamic every-route-metered gate must stay in the suite: it
    # is what guarantees new routes get metrics without a listing.
    gate_file, gate_test = paths.route_gate
    obs_test = paths.tests_dir / gate_file
    text = src.text(obs_test)
    if gate_test not in text or "router.routes" not in text:
        findings.append(Finding(
            str(obs_test), 1, "route-gate-missing",
            f"tests/{gate_file} no longer carries the every-route-"
            "metered gate over server.router.routes",
        ))
    return findings


# -- metric families ---------------------------------------------------------


def _families_in_tree(tree: ast.Module) -> set[str]:
    """Family names created by this tree: registry ``counter/gauge/
    histogram(name, ...)`` calls, ``Counter/Gauge/Histogram(name,
    ...)`` constructors, and collector ``Family(kind, name, ...)``
    records (name is the SECOND positional there)."""
    fams: set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = (
            fn.attr if isinstance(fn, ast.Attribute)
            else fn.id if isinstance(fn, ast.Name) else ""
        )
        if name in ("counter", "gauge", "histogram",
                    "Counter", "Gauge", "Histogram"):
            arg_idx = 0
        elif name == "Family":
            arg_idx = 1
        else:
            continue
        if len(node.args) > arg_idx and isinstance(
            node.args[arg_idx], ast.Constant
        ) and isinstance(node.args[arg_idx].value, str):
            value = node.args[arg_idx].value
            if value.startswith("lo_"):
                fams.add(value)
    return fams


def registered_families(
    paths: DriftPaths, src: "_Sources | None" = None
) -> set[str]:
    src = src or _Sources()
    fams: set[str] = set()
    for p in _package_files(paths):
        tree = src.tree(p)
        if tree is not None:
            fams |= _families_in_tree(tree)
    return fams


def _local_families(tree: ast.Module) -> set[str]:
    return _families_in_tree(tree)


def _family_known(token: str, known: set[str]) -> bool:
    if token in known or token in _FAMILY_IGNORE:
        return True
    for suffix in _PROM_SUFFIXES:
        if token.endswith(suffix) and token[: -len(suffix)] in known:
            return True
    # Prefix mention ("lo_program_" startswith-style assertions).
    if token.endswith("_"):
        return any(fam.startswith(token) for fam in known)
    return False


def check_metrics(
    paths: DriftPaths, src: "_Sources | None" = None
) -> list[Finding]:
    src = src or _Sources()
    known = registered_families(paths, src)
    findings: list[Finding] = []
    for p in sorted(paths.tests_dir.glob(paths.tests_glob)):
        tree = src.tree(p)
        if tree is None:
            continue
        local = _local_families(tree)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)):
                continue
            for m in _FAMILY_RE.finditer(node.value):
                tok = m.group(0)
                if not _family_known(tok, known | local):
                    findings.append(Finding(
                        str(p), node.lineno, "metric-unregistered",
                        f"{tok!r} looks like a metric family but no "
                        "registry call creates it",
                    ))
    readme_text = src.readme(paths)
    for m in _FAMILY_RE.finditer(readme_text):
        tok = m.group(0)
        if not _family_known(tok, known):
            line = readme_text.count("\n", 0, m.start()) + 1
            findings.append(Finding(
                str(paths.readme), line, "metric-unregistered",
                f"{tok!r} is documented in the README but no "
                "registry call creates it",
            ))
    return findings


def analyze_drift(paths: DriftPaths) -> list[Finding]:
    src = _Sources()  # one read+parse per artifact across all gates
    findings: list[Finding] = []
    findings += check_knobs(paths, src)
    findings += check_fault_points(paths, src)
    findings += check_routes(paths, src)
    findings += check_metrics(paths, src)
    return findings
