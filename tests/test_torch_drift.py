"""The port's drift gates (``learningorchestra_tpu_torch/analysis/drift.py``)
against the JAX package's (``learningorchestra_tpu/analysis/drift.py``):

- on one fixture tree, read through each package's ``DriftPaths`` at the
  same files, both give the same findings rule for rule (a knob missing
  everywhere, a stale manifest knob, an unknown fault point, a route
  without a client binding, an unregistered metric family, a missing
  route gate);
- over the port's layout (``DriftPaths.for_repo``) they read the
  README's port section alone, ``deploy/torch/``, ``tests/test_torch_*.py``
  and ``chip_smoke.py``, and a knob only the port reads may be named in
  the README by its config field;
- the port's tree is clean, and deleting a knob from its k8s manifest
  trips the gate.
"""

import dataclasses
from pathlib import Path

import pytest

from learningorchestra_tpu.analysis import drift as jax_drift
from learningorchestra_tpu_torch.analysis import drift

ROOT = Path(__file__).resolve().parents[1]
#: Built from parts so this file trips no gate itself.
K = "LO_TPU" + "_"
LO = "l" + "o_"


def _fixture(root: Path, *, pkg_name: str, compose_extra="",
             readme_extra="", client_extra="", config_extra=""):
    pkg = root / pkg_name
    files = {
        pkg / "__init__.py": "",
        pkg / "config.py": f'X = "{K}FOO"\n{config_extra}',
        pkg / "mod.py": (
            f'import os\n'
            f'foo = os.environ.get("{K}FOO")\n'
            f'bar = os.environ.get("{K}BAR")\n'
            f'REG.counter("{LO}a_total", "help")\n'
            f'faults.hit("x.y")\n'
            f'faults.hit("x.z")\n'),
        pkg / "api" / "server.py": (
            'def reg(add):\n'
            '    NAME = r"(?P<name>[A-Za-z0-9_.\\-]+)"\n'
            '    add("GET", r"/widget/" + NAME, None)\n'
            '    add("POST", r"/widget", None)\n'),
        pkg / "client.py": (
            'class W:\n'
            '    def get(self, name):\n'
            '        return self.ctx.request(\n'
            '            "GET", f"/widget/{name}"\n'
            '        )\n' + client_extra),
        pkg / "faults" / "plane.py": 'POINTS = (\n    "x.y",\n)\n',
        root / "compose.yml": f"environment:\n  {K}FOO: '1'\n{compose_extra}",
        root / "k8s.yaml": f"env:\n- name: {K}FOO\n",
        root / "README.md": (
            f"# intro\n`{K}FOO` knob\n{readme_extra}"),
        root / "tests" / "test_obs.py": (
            "def test_every_registered_route_is_metered():\n"
            "    assert server.router.routes\n"
            f'    assert "{LO}c_total"\n'),
    }
    for path, src in files.items():
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
    kw = dict(package_root=pkg, config=pkg / "config.py",
              compose=root / "compose.yml", k8s=root / "k8s.yaml",
              readme=root / "README.md", server=pkg / "api" / "server.py",
              client=pkg / "client.py", plane=pkg / "faults" / "plane.py",
              tests_dir=root / "tests")
    return jax_drift.DriftPaths(**kw), drift.DriftPaths(**kw)


def _keys(findings):
    return sorted((Path(f.file).name, f.line, f.rule, f.message)
                  for f in findings)


CASES = {
    "plain": {},
    "stale compose knob": {"compose_extra": f"  {K}GHOST: '1'\n"},
    "unregistered README family": {"readme_extra": f"`{LO}b_total`\n"},
    "bound route": {"client_extra": (
        '    def create(self):\n'
        '        return self.ctx.request("POST", "/widget")\n')},
    "indexed knob": {"config_extra": f'Y = "{K}BAR"\n'},
}


@pytest.mark.parametrize("case", list(CASES))
def test_gates_match_jax_on_the_fixture(tmp_path, case):
    jax_paths, port_paths = _fixture(tmp_path, pkg_name="pkg",
                                     **CASES[case])
    port = drift.analyze_drift(port_paths)
    jax = jax_drift.analyze_drift(jax_paths)
    assert _keys(port) == _keys(jax)
    rules = {f.rule for f in port}
    assert {"fault-point-unknown", "metric-unregistered"} <= rules
    assert ("route-missing-client" in rules) == (case != "bound route")
    assert ("knob-unknown" in rules) == (case == "stale compose knob")
    assert ("knob-missing-config" in rules) == (case != "indexed knob")


def test_route_gate_tracked_like_jax(tmp_path):
    jax_paths, port_paths = _fixture(tmp_path, pkg_name="pkg")
    (tmp_path / "tests" / "test_obs.py").write_text("# gone\n")
    port = drift.analyze_drift(port_paths)
    assert "route-gate-missing" in {f.rule for f in port}
    assert _keys(port) == _keys(jax_drift.analyze_drift(jax_paths))


def _port_layout(root: Path, readme: str, config_extra: str = ""):
    """A fixture in the port's layout, read through ``for_repo``."""
    _fixture(root, pkg_name="learningorchestra_tpu_torch",
             config_extra=config_extra)
    (root / "README.md").write_text(readme)
    for name in ("docker-compose.yml", "k8s.yaml"):
        dest = root / "deploy" / "torch" / name
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_text((root / ("compose.yml" if "compose" in name
                                 else "k8s.yaml")).read_text())
    (root / "tests" / "test_obs.py").rename(
        root / "tests" / "test_torch_obs.py")
    (root / "tests" / "test_torch_obs.py").write_text(
        "def test_every_route_in_the_table_is_metered():\n"
        "    assert srv.router.routes\n")
    (root / "tests" / "test_jax_only.py").write_text(
        f'X = "{LO}jax_only_total"\n')
    (root / "chip_smoke.py").write_text(f'Y = "{K}SMOKE"\n')
    return drift.DriftPaths.for_repo(root)


def test_for_repo_reads_the_port_section_manifests_and_tests(tmp_path):
    readme = (f"# top\n`{K}OUTSIDE` and `{LO}outside_total`\n"
              f"{drift.README_SECTION} (`pkg/`)\n`{K}FOO` knob\n"
              "## Next section\n"
              f"`{K}AFTER`\n")
    paths = _port_layout(tmp_path, readme)
    assert paths.compose == tmp_path / "deploy" / "torch" / \
        "docker-compose.yml"
    findings = drift.analyze_drift(paths)
    text = " ".join(f.message for f in findings)
    # Outside the section nothing is read; the section is.
    assert K + "OUTSIDE" not in text and LO + "outside" not in text
    assert K + "AFTER" not in text
    # The script is code: its knob must be indexed everywhere.
    smoke = [f for f in findings if K + "SMOKE" in f.message]
    assert {f.rule for f in smoke} == {
        "knob-missing-config", "knob-missing-compose", "knob-missing-k8s",
        "knob-missing-readme"}
    # Only test_torch_*.py is read; the route gate is the port's.
    assert LO + "jax_only" not in text
    assert "route-gate-missing" not in {f.rule for f in findings}
    # A readme line's number is its line in the whole file.
    (tmp_path / "README.md").write_text(
        readme.replace("knob\n", f"knob `{K}GHOST`\n"))
    ghost = [f for f in drift.analyze_drift(paths)
             if K + "GHOST" in f.message]
    assert [(f.rule, f.line) for f in ghost] == [("knob-unknown", 4)]


def test_a_port_only_knob_may_be_named_by_its_config_field(tmp_path):
    table = (f'def from_env(cfg):\n'
             f'    return (("{K}BAR", cfg.dist, "cpu_ranks", int),)\n')
    by_field = _port_layout(
        tmp_path / "a", f"{drift.README_SECTION}\n`{K}FOO`, "
        "`dist.cpu_ranks`\n", config_extra=table)
    assert drift.knob_fields(by_field) == {K + "BAR": "dist.cpu_ranks"}
    rules = {(f.rule, f.message.split()[0])
             for f in drift.analyze_drift(by_field)}
    assert ("knob-missing-readme", K + "BAR") not in rules
    assert ("knob-missing-compose", K + "BAR") in rules
    unnamed = _port_layout(tmp_path / "b", f"{drift.README_SECTION}\n"
                           f"`{K}FOO`\n", config_extra=table)
    assert ("knob-missing-readme", K + "BAR") in {
        (f.rule, f.message.split()[0])
        for f in drift.analyze_drift(unnamed)}


def test_the_port_tree_is_clean():
    findings = drift.analyze_drift(drift.DriftPaths.for_repo(ROOT))
    assert findings == [], "\n".join(f.render() for f in findings)


def test_deleting_a_real_k8s_knob_line_trips_the_gate(tmp_path):
    _delete_k8s_knob_line(tmp_path, K + "COMPILE_CACHE_ENTRIES")


@pytest.mark.parametrize("knob", ["CLUSTER_ENABLED", "CLUSTER_TTL_S",
                                  "TENANT_MAX_QUEUED"])
def test_the_control_plane_knobs_are_held_by_the_gate(tmp_path, knob):
    _delete_k8s_knob_line(tmp_path, K + knob)


def _delete_k8s_knob_line(tmp_path, knob):
    real = (ROOT / "deploy" / "torch" / "k8s.yaml").read_text()
    assert knob in real
    tampered = tmp_path / "k8s.yaml"
    tampered.write_text("\n".join(
        line for line in real.splitlines() if knob not in line))
    paths = dataclasses.replace(drift.DriftPaths.for_repo(ROOT),
                                k8s=tampered)
    findings = [f for f in drift.analyze_drift(paths)
                if f.rule == "knob-missing-k8s"]
    assert len(findings) == 1 and knob in findings[0].message
