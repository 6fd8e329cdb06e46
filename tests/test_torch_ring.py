"""The port's ring attention (``parallel/ring_attention.py``) against the
JAX package's, on the CPU.

The port's side is one gloo world of 4 CPU rank processes
(``tests/torch_ring_worker.py``, spawned once for the module), over which
the port's ``DataParallel`` lays two sequence-parallel layouts: dp 2 x
sp 2 (two rings of two; each ring takes its dp index's rows) and one ring
of sp 4.  The JAX side is ``ring_flash_attention(..., interpret=True)``
and ``ring_attention`` on a ``MeshSpec(dp=2, sp=4)`` of the 8 virtual
devices, as ``tests/test_parallel.py`` runs them.  The same seeded numpy
inputs (B, T, H, D) with a key mask that holds one fully masked row go
through both; every rank's block of the output and of dQ/dK/dV (the
backward of ``sum(out * cotangent)``) is held against the JAX arrays at
its rows and tokens: f32 2e-5 on outputs and 5e-5 on gradients, bf16
3e-2.

- the flash ring, causal and not, f32 and bf16 storage, plus a local
  length of 384 (the JAX test's intermediate length, sp 4, causal); its
  fully masked row is exactly 0 (the kernels' rule);
- the online-softmax ring, causal and not (its fully masked row is the
  mean of V, as the JAX function's);
- ``reference_attention``, the unsharded oracle, causal and not;
- the group layout (rank r is dp index r // sp, sp index r % sp), the
  kernel wrappers' calls per rank (n per step, a causal rank skipping the
  blocks of later ranks), and a hung rotation raising after its timeout.
"""

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learningorchestra_tpu.parallel.mesh import MeshSpec as JaxSpec
from learningorchestra_tpu.parallel.mesh import build_mesh as jax_mesh
from learningorchestra_tpu.parallel.ring_attention import (
    ring_attention as jax_ring,
)
from learningorchestra_tpu.parallel.ring_attention import (
    reference_attention as jax_reference,
)
from learningorchestra_tpu.parallel.ring_attention import (
    ring_flash_attention as jax_ring_flash,
)
from learningorchestra_tpu_torch.parallel.ring_attention import (
    reference_attention,
)

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
TOL = {"float32": (2e-5, 5e-5), "bfloat16": (3e-2, 3e-2)}
WORKER_TIMEOUT_S = 120


def _inputs(b, t, h, d, seed):
    rng = np.random.default_rng(seed)

    def mk():
        return rng.normal(size=(b, t, h, d)).astype(np.float32)

    km = rng.random((b, t)) > 0.2
    km[:, 0] = True
    km[1] = False  # a row with no valid key
    return {"q": mk(), "k": mk(), "v": mk(), "kmask": km,
            "cotangent": mk()}


def _cases() -> dict:
    cases = {}
    for fn in ("flash", "online"):
        for causal in (False, True):
            for dtype in (("float32", "bfloat16") if fn == "flash"
                          else ("float32",)):
                key = f"{fn}-{'causal' if causal else 'full'}-{dtype}"
                cases[key] = {"fn": fn, "causal": causal, "dtype": dtype,
                              "layouts": ("sp2", "sp4"),
                              **_inputs(4, 32, 2, 8, seed=len(cases))}
    # T_loc = 384 at sp 4 (the JAX test's intermediate local length).
    cases["flash-causal-float32-tloc384"] = {
        "fn": "flash", "causal": True, "dtype": "float32",
        "layouts": ("sp4",), **_inputs(2, 4 * 384, 2, 8, seed=99)}
    return cases


CASES = _cases()
IDS = [(key, lay) for key, case in CASES.items() for lay in case["layouts"]]


def _jax_side(case) -> dict:
    """Output and gradients of the JAX function of ``case``, in f32."""
    mesh = jax_mesh(JaxSpec(dp=2, sp=4))
    dt = jnp.bfloat16 if case["dtype"] == "bfloat16" else jnp.float32
    km = jnp.asarray(case["kmask"])
    small = case["q"].shape[1] <= 32

    def attend(q, k, v):
        if case["fn"] == "online":
            return jax_ring(q, k, v, mesh=mesh, kmask=km,
                            causal=case["causal"])
        blocks = {"block_q": 8, "block_k": 8} if small else {}
        return jax_ring_flash(q, k, v, mesh=mesh, kmask=km,
                              causal=case["causal"], interpret=True,
                              **blocks)

    g = jnp.asarray(case["cotangent"])

    def loss(q, k, v):
        out = attend(q, k, v)
        return jnp.sum(out.astype(jnp.float32) * g), out

    q, k, v = (jnp.asarray(case[n]).astype(dt) for n in ("q", "k", "v"))
    (_, out), (dq, dk, dv) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return {name: np.asarray(a, np.float32) for name, a in
            (("out", out), ("dq", dq), ("dk", dk), ("dv", dv))}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results: the 4 rank processes run while the JAX side
    computes; they are bounded by WORKER_TIMEOUT_S and killed on any
    failure."""
    stage = tmp_path_factory.mktemp("ring")
    with open(stage / "cases.pkl", "wb") as fh:
        pickle.dump(CASES, fh)
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_ring_worker.py"),
         str(stage), str(r), str(WORLD)], env=env,
        stdout=subprocess.DEVNULL, stdin=subprocess.DEVNULL)
        for r in range(WORLD)]
    try:
        jax_out = {key: _jax_side(case) for key, case in CASES.items()}
        deadline = time.monotonic() + WORKER_TIMEOUT_S
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    results = []
    for r in range(WORLD):
        with open(stage / f"rank{r}.pkl", "rb") as fh:
            res = pickle.load(fh)
        assert "error" not in res, res["error"]
        results.append(res)
    return {"ranks": results, "jax": jax_out}


@pytest.mark.parametrize("key,layout", IDS, ids=[f"{k}-{lay}"
                                                 for k, lay in IDS])
def test_ring_matches_jax(ranks, key, layout):
    case = CASES[key]
    want = ranks["jax"][key]
    out_tol, grad_tol = TOL[case["dtype"]]
    covered = np.zeros(case["q"].shape[:2], bool)
    for res in ranks["ranks"]:
        got = res["cases"][(key, layout)]
        rows, toks = slice(*got["rows"]), slice(*got["toks"])
        covered[rows, toks] = True
        assert got["dtype"] == f"torch.{case['dtype']}"
        np.testing.assert_allclose(got["out"], want["out"][rows, toks],
                                   atol=out_tol, rtol=0)
        for name in ("dq", "dk", "dv"):
            np.testing.assert_allclose(got[name], want[name][rows, toks],
                                       atol=grad_tol, rtol=0,
                                       err_msg=name)
        if case["fn"] == "flash" and got["rows"][0] <= 1 < got["rows"][1]:
            # The fully masked row: exactly 0 on the flash ring.
            assert not got["out"][1 - got["rows"][0]].any()
    assert covered.all()


def test_online_ring_gives_the_mean_of_v_on_a_masked_row(ranks):
    """The JAX online ring's (and reference_attention's) rule, which the
    flash ring does not share: a row with no valid key attends every key
    alike."""
    case = CASES["online-full-float32"]
    for res in ranks["ranks"]:
        got = res["cases"][("online-full-float32", "sp4")]
        rows, toks = slice(*got["rows"]), slice(*got["toks"])
        if rows.start <= 1 < rows.stop:
            mean_v = case["v"][1].mean(0)
            np.testing.assert_allclose(got["out"][1 - rows.start],
                                       np.broadcast_to(mean_v, (
                                           toks.stop - toks.start,)
                                           + mean_v.shape), atol=2e-5)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_reference_attention_matches_jax(causal):
    """The unsharded oracle, fully masked row (the mean of V) included."""
    case = _inputs(2, 16, 2, 8, seed=5)
    want = jax_reference(*(jnp.asarray(case[n]) for n in ("q", "k", "v")),
                         kmask=jnp.asarray(case["kmask"]), causal=causal)
    got = reference_attention(
        *(torch.from_numpy(case[n]) for n in ("q", "k", "v")),
        kmask=torch.from_numpy(case["kmask"]), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def test_group_layout(ranks):
    for r, res in enumerate(ranks["ranks"]):
        assert res["layouts"]["sp2"] == {
            "rank": r, "dp_index": r // 2, "sp_index": r % 2,
            "ring": r % 2, "ring_size": 2}
        assert res["layouts"]["sp4"] == {
            "rank": r, "dp_index": 0, "sp_index": r, "ring": r,
            "ring_size": 4}


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_kernel_calls_per_rank(ranks, causal):
    """K1 once per ring step forward, K2 + K3 once per step backward; a
    causal rank s runs s + 1 steps (the blocks of later ranks are
    skipped, no launch)."""
    key = f"flash-{'causal' if causal else 'full'}-float32"
    for layout, sp in (("sp2", 2), ("sp4", 4)):
        for res in ranks["ranks"]:
            got = res["cases"][(key, layout)]
            want = got["sp_index"] + 1 if causal else sp
            assert got["calls"] == {"fwd": want, "bwd": want}
        online = ranks["ranks"][0]["cases"][(
            f"online-{'causal' if causal else 'full'}-float32", layout)]
        assert online["calls"] == {"fwd": 0, "bwd": 0}


def test_hung_rotation_raises_after_its_timeout(ranks):
    hung = ranks["ranks"][0]["hung"]
    assert hung["error"] and "1000ms" in hung["error"]
    assert 0.9 <= hung["seconds"] < 3.0
