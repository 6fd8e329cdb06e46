"""The port's process entry point (``python -m learningorchestra_tpu_torch``)
against the JAX package's (``learningorchestra_tpu/__main__.py``):

- ``serve --device cpu`` in a fresh process, with the lock witness on,
  answers a predict through the port's client that equals the direct
  predict of the same int8 artifact, stops on SIGINT with exit status 0
  within a bound, and writes a witness dump that the port's static lock
  graph accounts for edge by edge;
- ``serve`` with no device runs on the card, so on a host without one it
  exits non-zero;
- ``coordinator`` and ``agent`` parse as in the JAX package and exit 2
  naming the ROADMAP item that ports them (A.9 part 2);
- ``standby --device cpu`` runs: before any contact with its primary it
  answers ``/replication/status`` as a standby and 503 elsewhere, never
  promotes, and stops on SIGINT with exit status 0;
- the parser's subcommands and flags are the JAX parser's, plus
  ``serve --device`` and ``standby --device``.
"""

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from learningorchestra_tpu import __main__ as jax_main
from learningorchestra_tpu_torch import __main__ as port_main
from learningorchestra_tpu_torch.analysis import run_checks
from learningorchestra_tpu_torch.client import ClientError, Context
from learningorchestra_tpu_torch.models.text import BertModel
from learningorchestra_tpu_torch.serve.service import ARTIFACT_TYPE
from learningorchestra_tpu_torch.store.volumes import VolumeStorage
from learningorchestra_tpu_torch.train.neural import load_artifact

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(vocab_size=50, hidden_dim=32, num_layers=2, num_heads=2,
             max_len=12)
#: Seconds a served process may take to exit after SIGINT.
EXIT_BOUND_S = 30


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _env(tmp_path, **extra):
    return {**os.environ, "PYTHONPATH": str(ROOT),
            "LO_TPU_STORE_ROOT": str(tmp_path / "store"),
            "LO_TPU_VOLUME_ROOT": str(tmp_path / "volumes"), **extra}


def test_serve_on_the_cpu_answers_stops_on_sigint_and_dumps(tmp_path):
    est = BertModel(**SMALL, seed=4, device="cpu")
    artifact = est.to_artifact(quantize=True)
    VolumeStorage(tmp_path / "volumes").save_object(ARTIFACT_TYPE, "bert",
                                                    artifact)
    rng = np.random.default_rng(21)
    x = rng.integers(1, SMALL["vocab_size"], (3, SMALL["max_len"]))
    x[1, 5:] = 0
    want = load_artifact(artifact, device="cpu").predict(x)

    port, dump = _free_port(), tmp_path / "witness.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "learningorchestra_tpu_torch", "serve",
         "--port", str(port), "--device", "cpu"],
        cwd=tmp_path, env=_env(tmp_path, LO_TPU_WITNESS="1",
                               LO_TPU_WITNESS_DUMP=str(dump)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ctx = Context(f"http://127.0.0.1:{port}", request_timeout=30)
        deadline = time.monotonic() + 90
        while True:
            assert proc.poll() is None, proc.stdout.read()
            try:
                ctx.request("GET", "/health")
                break
            except (OSError, ClientError):
                assert time.monotonic() < deadline, "server never answered"
                time.sleep(0.2)
        assert ctx.serve.load("bert")["result"]
        got = ctx.serve.predict("bert", x.tolist())
        np.testing.assert_allclose(np.asarray(got["predictions"]), want,
                                   rtol=0, atol=1e-5)
        locks = ctx.observability.locks()
        assert locks["enabled"] is True and locks["edges"]
        assert locks["stalls"] == []
        t0 = time.monotonic()
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(EXIT_BOUND_S)
        exit_s = time.monotonic() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        out = proc.stdout.read()
        proc.stdout.close()
    assert rc == 0, out
    assert exit_s < EXIT_BOUND_S
    doc = json.loads(dump.read_text())
    assert doc["enabled"] and doc["edges"]
    report = run_checks(ROOT / "learningorchestra_tpu_torch",
                        whole_program=True, drift=False, witness_dump=dump)
    assert report.errors == [], "\n".join(f.render() for f in report.errors)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a card is present: serve would start on it")
def test_serve_defaults_to_the_card(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "learningorchestra_tpu_torch", "serve",
         "--port", str(_free_port())],
        cwd=tmp_path, env=_env(tmp_path), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr


@pytest.mark.parametrize("argv,item", [
    (["coordinator"], "A.9 part 2"),
    (["coordinator", "--host", "127.0.0.1", "--port", "7071"], "A.9 part 2"),
    (["agent", "--coordinator", "h:7070", "--capacity", "2"], "A.9 part 2"),
])
def test_unported_subcommands_say_which_item_ports_them(capsys, argv, item):
    assert port_main.main(argv) == 2
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1
    assert f"{argv[0]}: not ported yet" in err[0] and item in err[0]


def test_standby_runs_monitors_and_stops_on_sigint(tmp_path):
    """A standby whose primary never answered stands by (no takeover
    without first contact), serves its status route, 503s the rest, and
    SIGINT ends it with status 0."""
    port, dead = _free_port(), _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "learningorchestra_tpu_torch", "standby",
         "--primary", f"127.0.0.1:{dead}", "--replica",
         str(tmp_path / "replica"), "--port", str(port), "--host",
         "127.0.0.1", "--interval", "0.05", "--misses", "2",
         "--device", "cpu"],
        cwd=tmp_path, env=_env(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}/api/learningOrchestra/v1"
    try:
        deadline = time.time() + 90
        status = {}
        # Past --misses and still standing by.
        while status.get("misses", 0) < 4:
            assert proc.poll() is None, proc.communicate()[0][-3000:]
            assert time.time() < deadline, ("no standby status", status)
            try:
                with urllib.request.urlopen(
                        base + "/replication/status", timeout=2) as resp:
                    status = json.loads(resp.read())
            except OSError:
                time.sleep(0.1)
        assert status["role"] == "standby" and status["saw_primary"] is False
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(base + "/health", timeout=2)
        assert exc.value.code == 503
        assert not (tmp_path / "replica" / ".promoted").exists()
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def _jax_parser() -> argparse.ArgumentParser:
    """The parser the JAX ``main`` builds, caught at its parse."""
    caught = {}
    real = argparse.ArgumentParser.parse_args

    def catch(self, *args, **kwargs):
        caught["parser"] = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = catch
    try:
        with pytest.raises(SystemExit):
            jax_main.main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return caught["parser"]


def _shape(parser) -> dict:
    """subcommand -> {dest: (option strings, default, type, required)}."""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {
        name: {a.dest: (tuple(a.option_strings), a.default,
                        getattr(a.type, "__name__", a.type), a.required)
               for a in p._actions if a.dest != "help"}
        for name, p in sub.choices.items()}


def test_parser_matches_the_jax_main():
    jax, port = _shape(_jax_parser()), _shape(port_main.build_parser())
    assert sorted(port) == sorted(jax) == [
        "agent", "coordinator", "serve", "standby"]
    assert port["serve"].pop("device") == (("--device",), "cuda", None,
                                           False)
    assert port["standby"].pop("device") == (("--device",), "cuda", None,
                                             False)
    assert port == jax
    for argv in (["serve"], ["serve", "--port", "8080"],
                 ["agent", "--coordinator", "h:1"]):
        assert vars(port_main.build_parser().parse_args(argv)).items() >= \
            vars(_jax_parser_parse(argv)).items()


def _jax_parser_parse(argv):
    parser = _jax_parser()
    return argparse.ArgumentParser.parse_args(parser, argv)
