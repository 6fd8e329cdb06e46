"""The port's durable program store (train/aot_store.py) held against the
JAX package's AOT executable store: one scripted sequence (offer, load,
reopen, a vanished blob, the entry cap, a corrupt payload, a bad magic, a
version, key and device-signature mismatch) gives equal ``stats()``
counters and manifest rows on both, times and byte sizes aside; every
corruption and mismatch of a port blob counts a load error, deletes the
blob and builds live; a key holding an opaque serial or an object address
is never offered; a restored program that fails at call rebuilds once;
a restored program's first call runs no FLOP analysis and keeps the
stored FLOPs; a restored decode step's graph cell warms before the first
stream; two fresh interpreters run the restart drill (the second reads
``misses 0`` and no analysis, with equal outputs); and a JAX and a port
server with the store on answer ``GET /monitoring/<tool>/compileCache``
with the same ``aot`` key set after the same train job.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from learningorchestra_tpu.train import aot_store as jaot
from learningorchestra_tpu_torch.models.mlp import MLPClassifier
from learningorchestra_tpu_torch.obs import costs
from learningorchestra_tpu_torch.train import aot_store
from learningorchestra_tpu_torch.train import compile_cache as cc
from learningorchestra_tpu_torch.train.neural import (
    OptimizerSpec,
    _apply_program,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEURAL = "learningorchestra_tpu_torch.train.neural"


@pytest.fixture(autouse=True)
def _fresh_process_state():
    """Process-wide singletons of both packages start and end empty."""
    for reset in (cc.reset_cache, costs.reset, aot_store.reset_store,
                  jaot.reset_store):
        reset()
    yield
    for reset in (cc.reset_cache, costs.reset, aot_store.reset_store,
                  jaot.reset_store):
        reset()


def _jax_payload():
    """A real serialized CPU executable (``tests/test_warmboot.py``'s
    ``a * 2``): the JAX store's load deserializes it."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import serialize_executable

    compiled = jax.jit(lambda a: a * 2.0).lower(
        jax.ShapeDtypeStruct((4,), jnp.float32)).compile()
    return serialize_executable.serialize(compiled)


def _port_payload(fn=None, analyze=True, cost=None):
    return {"kind": "program", "fn": list(fn or [NEURAL, "_apply_program"]),
            "analyze": analyze, "cost": cost}


def _tamper(store, key, mutate):
    """Rewrite ``key``'s blob through ``mutate(magic, header, blob)``."""
    path = store._blob_path(key)
    with open(path, "rb") as fh:
        magic = fh.read(7)
        header = json.loads(fh.readline().decode("utf-8"))
        blob = fh.read()
    magic, header, blob = mutate(magic, header, blob)
    with open(path, "wb") as fh:
        fh.write(magic)
        fh.write(json.dumps(header).encode("utf-8"))
        fh.write(b"\n")
        fh.write(blob)


#: The mismatches both stores must refuse, by the JAX tests' names.
MISMATCHES = {
    "checksum": lambda m, h, b: (m, h, b + b"corrupt"),
    "magic": lambda m, h, b: (b"NOTAOT\n", h, b),
    "version": lambda m, h, b: (m, {**h, "version": 99}, b),
    "key": lambda m, h, b: (m, {**h, "key": "other"}, b),
    "device signature": lambda m, h, b: (
        m, {**h, "deviceSig": [["gone", 0]]}, b),
}


def _script(mod, root, payload):
    """The scripted sequence; -> (stats, manifest rows) of the main store,
    of the reopened one and of the capped one."""
    store = mod.AOTExecutableStore(str(root / "main"), max_entries=16,
                                   max_bytes=1 << 30)
    assert store.offer("k1", payload, label="L1")
    assert store.load("k1") is not None
    store.offer("k1", payload, label="L1")  # heat
    assert store.load("absent") is None
    store.offer("k2", payload, label="L2")
    os.unlink(store._blob_path("k2"))  # vanished under the manifest
    assert store.load("k2") is None and not store.contains("k2")
    for what, mutate in MISMATCHES.items():
        key = f"m_{what.replace(' ', '_')}"
        store.offer(key, payload, label=what)
        _tamper(store, key, mutate)
        assert store.load(key) is None, what
        assert not os.path.exists(store._blob_path(key))
    reopened = mod.AOTExecutableStore(str(root / "main"), max_entries=16,
                                      max_bytes=1 << 30)
    capped = mod.AOTExecutableStore(str(root / "cap"), max_entries=2,
                                    max_bytes=1 << 30)
    for key in ("a", "b", "b", "c"):  # over the cap: "a", the coldest
        capped.offer(key, payload, label=key)
    assert capped.load("a") is None
    return [(_stats(s), _rows(s)) for s in (store, reopened, capped)]


def _stats(store):
    return {k: v for k, v in store.stats().items()
            if k not in ("dir", "persistedBytes", "entries_detail")}


def _rows(store):
    return [{k: v for k, v in rec.items() if k not in ("storedAt", "bytes")}
            for rec in store.manifest_entries()]


def test_scripted_sequence_matches_the_jax_store(tmp_path):
    port = _script(aot_store, tmp_path / "port", _port_payload())
    ref = _script(jaot, tmp_path / "jax", _jax_payload())
    assert port == ref
    main, _, capped = port
    assert (main[0]["hits"], main[0]["misses"], main[0]["loadErrors"],
            main[0]["stores"]) == (1, 2, 5, 8)
    assert capped[0]["evictions"] == 1


@pytest.mark.parametrize("what", [
    "checksum", "magic", "version", "key", "device signature",
    "torch version", "port code", "module outside the table",
    "function not registered", "not JSON",
])
def test_every_mismatch_counts_deletes_and_builds_live(tmp_path, what):
    store = aot_store.reset_store(root=str(tmp_path / "aot"))
    key = cc.fingerprint("aot-mismatch", what)
    store.offer(key, _port_payload(), label="m")

    def resign(header, blob):
        import hashlib

        return {**header, "sha256": hashlib.sha256(blob).hexdigest()}

    mutate = MISMATCHES.get(what) or {
        "torch version": lambda m, h, b: (m, {**h, "torch": "0.0.1"}, b),
        "port code": lambda m, h, b: (m, {**h, "code": "0" * 64}, b),
        "module outside the table": lambda m, h, b: (
            m, *_repayload(h, _port_payload(["os", "system"]), resign)),
        "function not registered": lambda m, h, b: (
            m, *_repayload(h, _port_payload([NEURAL, "load_artifact"]),
                           resign)),
        "not JSON": lambda m, h, b: (m, resign(h, b"\x80\x04pickled"),
                                     b"\x80\x04pickled"),
    }[what]
    _tamper(store, key, mutate)
    cache = cc.CompiledProgramCache(max_entries=8)
    built = []

    def builder():
        built.append(1)
        return cc.Program(_apply_program, key, "m")

    program = cache.get_or_build(key, builder, label="m")
    assert built == [1], what
    assert store.load_errors == 1 and store.hits == 0
    assert not os.path.exists(store._blob_path(key))
    assert not store.contains(key)
    est = _mlp()
    x = np.ones((4, 5), np.float32)
    np.testing.assert_array_equal(program(est.module, x), est.apply(x))


def _repayload(header, payload, resign):
    blob = json.dumps(payload).encode("utf-8")
    return resign(header, blob), blob


def _mlp(seed=0, **kw):
    est = MLPClassifier(hidden_layer_sizes=[11], num_classes=2, seed=seed,
                        device="cpu", **kw)
    est.compute_dtype = "float32"
    rng = np.random.default_rng(seed)
    est.fit(rng.standard_normal((16, 5)).astype(np.float32),
            rng.integers(0, 2, 16).astype(np.int32), epochs=1, batch_size=8)
    return est


def test_a_card_signature_round_trips(tmp_path, monkeypatch):
    """A card's signature holds its capability as a tuple, which the JSON
    header gives back as a list: the blob written on a card loads there."""
    monkeypatch.setattr(cc, "_device_signature", lambda: (
        (0, "NVIDIA H100 80GB HBM3", (9, 0)),))
    store = aot_store.reset_store(root=str(tmp_path / "aot"))
    key = cc.fingerprint("signature")
    assert store.offer(key, _port_payload(), label="sig")
    assert store.load(key) is not None
    assert (store.hits, store.load_errors) == (1, 0)
    monkeypatch.setattr(cc, "_device_signature", lambda: (
        (0, "NVIDIA H100 80GB HBM3", (8, 0)),))
    assert store.load(key) is None and store.load_errors == 1


def test_process_local_keys_are_never_offered(tmp_path):
    store = aot_store.reset_store(root=str(tmp_path / "aot"))
    assert cc.fingerprint("apply", ("rows", 8)).persistable
    assert not cc.persistable("a plain string, not a fingerprint")
    est = MLPClassifier(hidden_layer_sizes=[11], num_classes=2, seed=0,
                        device="cpu")
    est.compile(optimizer=OptimizerSpec("adam", 1e-3))
    opaque = cc.program_key("device_epoch", module=None,
                            optimizer=cc.optimizer_fingerprint(est),
                            loss="softmax_ce", dtype=None)
    assert not opaque.persistable
    by_address = cc.program_key("device_epoch", module=None, optimizer=None,
                                loss=lambda y, p: 0.0, dtype=None)
    assert not by_address.persistable
    for key in (opaque, by_address):
        assert not aot_store.offer_program(key, "x", fn=_apply_program)
        assert not os.path.exists(store._blob_path(key))
    # A fit whose optimizer is an object: its epoch program's key holds
    # the object's serial, so nothing of it is stored.
    rng = np.random.default_rng(0)
    est.fit(rng.standard_normal((16, 5)).astype(np.float32),
            rng.integers(0, 2, 16).astype(np.int32), epochs=1, batch_size=8)
    assert store.stats()["stores"] == 0
    assert store.skipped >= 3


def test_restored_program_that_fails_at_call_rebuilds_once(
        tmp_path, monkeypatch):
    """The name is kept from the JAX package's fallback; the port's
    restored program does NOT rebuild and re-run a failed call (a rebuild
    runs the same table function, and an epoch program would apply its
    steps twice): the failure counts ``callFallbacks`` and raises once,
    and the builder is never called."""
    store = aot_store.reset_store(root=str(tmp_path / "aot"))
    est = _mlp()
    key = cc.apply_program_key(est.module, rows=8)
    x = np.ones((8, 5), np.float32)
    first = cc.get_cache().get_or_build(
        key, lambda: cc.Program(_apply_program, key, "apply"), label="apply")
    first(est.module, x)
    assert store.contains(key)
    # The stored name resolves to a function that mutates its argument,
    # then fails (an epoch program that raises part-way).
    runs = []

    def failing(module, xs):
        runs.append(1)
        raise RuntimeError("device fault")

    monkeypatch.setitem(aot_store._TABLE, (NEURAL, "_apply_program"),
                        failing)
    cache = cc.reset_cache()
    costs.reset()
    built = []

    def builder():
        built.append(1)
        return cc.Program(_apply_program, key, "apply")

    program = cache.get_or_build(key, builder, label="apply")
    assert type(program) is cc._Restored and built == []
    with pytest.raises(RuntimeError, match="device fault"):
        program(est.module, x)
    assert runs == [1] and built == [] and store.call_fallbacks == 1
    # A hit returns the same program, which still raises: nothing was
    # swapped in behind the caller's back.
    assert cache.get_or_build(key, builder, label="apply") is program
    with pytest.raises(RuntimeError, match="device fault"):
        program(est.module, x)
    assert runs == [1, 1] and built == [] and store.call_fallbacks == 2
    assert costs.get_ledger().analyses == 0


def test_restored_program_skips_the_flop_analysis(tmp_path):
    store = aot_store.reset_store(root=str(tmp_path / "aot"))
    est = _mlp()
    x = np.ones((8, 5), np.float32)
    key = cc.apply_program_key(est.module, rows=8)
    make = lambda: cc.Program(_apply_program, key, "apply")  # noqa: E731
    before = costs.get_ledger().analyses  # the fit's
    want = cc.get_cache().get_or_build(key, make)(est.module, x)
    analyzed = costs.get_ledger().get(key)
    assert analyzed.analyzed and analyzed.flops > 0
    assert costs.get_ledger().analyses == before + 1
    cc.reset_cache()
    costs.reset()
    program = cc.get_cache().get_or_build(key, make)
    np.testing.assert_array_equal(program(est.module, x), want)
    ledger = costs.get_ledger()
    assert ledger.analyses == 0
    assert ledger.get(key).analyzed
    assert ledger.get(key).flops == analyzed.flops
    assert ledger.get(key).argument_bytes == analyzed.argument_bytes
    assert store.hits == 1 and cc.get_cache().stats()["misses"] == 1


def test_decode_step_cells_warm_before_the_first_stream(tmp_path):
    from learningorchestra_tpu_torch.api.server import APIServer
    from learningorchestra_tpu_torch.config import (
        AotConfig,
        Config,
        StoreConfig,
    )
    from learningorchestra_tpu_torch.models.text import DecoderLM

    lm = DecoderLM(vocab_size=16, hidden_dim=32, num_layers=2, num_heads=4,
                   max_len=16, seed=0, device="cpu")
    lm.compute_dtype = "float32"
    rng = np.random.default_rng(7)
    x = rng.integers(1, 16, size=(8, 14)).astype(np.int32)
    lm.fit(x, np.roll(x, -1, axis=1), epochs=1, batch_size=8)

    def boot():
        cfg = Config(store=StoreConfig(root=str(tmp_path / "store"),
                                       volume_root=str(tmp_path / "vol")),
                     aot=AotConfig(enabled=True, dir=str(tmp_path / "aot")))
        server = APIServer(cfg, device="cpu")
        thread = server.ctx._aot_prewarm_thread
        if thread is not None:
            thread.join(60)
        return server

    body = {"prompts": [[3, 5, 7]], "maxNewTokens": 4}
    server = boot()
    try:
        server.ctx.volumes.save_estimator("train/pytorch", "lm", lm)
        status, first = server.handle("POST", "/api/learningOrchestra/v1/"
                                      "serve/lm/generate", body)
        assert status == 200, first
    finally:
        server.shutdown()
    stored = [r for r in aot_store.get_store().manifest_entries()
              if r["label"].startswith("decode:")]
    assert len(stored) == 1
    cc.reset_cache()
    aot_store.reset_store()
    server = boot()
    try:
        assert server.ctx.aot_prewarm_stats["warmed"] >= 1
        assert server.serving.load("lm")["name"] == "lm"
        decoder = server.serving.decode._decoders["lm"]
        entry = server.serving.registry.get("lm")
        # The restored cell is resolved and its pool resident before any
        # stream (on the card its graph is captured there too).
        assert list(entry.decode_warm) == [(1, 8)]
        assert list(decoder._pools) == [(None, 8)]
        status, second = server.handle("POST", "/api/learningOrchestra/v1/"
                                       "serve/lm/generate", body)
        assert status == 200 and second["tokens"] == first["tokens"]
        assert list(decoder._pools) == [(None, 8)]
        assert cc.get_cache().stats()["misses"] == 0
    finally:
        server.shutdown()


_DRILL = textwrap.dedent("""
    import json, sys
    import numpy as np
    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.models.mlp import MLPClassifier
    from learningorchestra_tpu_torch.obs import costs
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.train import aot_store
    from learningorchestra_tpu_torch.train import compile_cache as cc

    ctx = ServiceContext(Config.from_env(), device="cpu")
    thread = ctx._aot_prewarm_thread
    if thread is not None:
        thread.join(120)
        assert not thread.is_alive(), "pre-warm wedged"
    rng = np.random.default_rng(0)
    x = rng.standard_normal((24, 5)).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.int32)
    est = MLPClassifier(hidden_layer_sizes=[11], num_classes=2, seed=0,
                        device="cpu")
    est.compute_dtype = "float32"
    est.fit(x, y, epochs=2, batch_size=8)
    out = est.apply(x[:8])
    bucket = est._apply_for(8)(est.module, x[:8])
    stats = cc.get_cache().stats()
    print(json.dumps({
        "loss": [float(v) for v in est.history["loss"]],
        "apply": bucket.tolist(), "direct": out.tolist(),
        "misses": stats["misses"], "hits": stats["hits"],
        "analyses": costs.get_ledger().analyses,
        "aot": {k: v for k, v in aot_store.stats_snapshot().items()
                if k != "entries_detail"},
        "prewarm": ctx.aot_prewarm_stats}))
    ctx.close()
""")


def test_restart_drill_in_two_fresh_interpreters(tmp_path):
    env = {
        **os.environ,
        "PYTHONPATH": ROOT,
        "LO_TPU_AOT_ENABLED": "1",
        "LO_TPU_AOT_PREWARM": "1",
        "LO_TPU_AOT_DIR": str(tmp_path / "aot"),
        "LO_TPU_STORE_ROOT": str(tmp_path / "store"),
        "LO_TPU_VOLUME_ROOT": str(tmp_path / "volumes"),
    }
    runs = []
    for _ in range(2):
        proc = subprocess.run([sys.executable, "-c", _DRILL], env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-4000:]
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    cold, warm = runs
    assert cold["misses"] >= 3 and cold["analyses"] >= 2
    assert cold["aot"]["stores"] == cold["aot"]["persistedEntries"] >= 3
    assert warm["prewarm"]["warmed"] == cold["aot"]["persistedEntries"]
    assert warm["aot"]["hits"] == cold["aot"]["persistedEntries"]
    assert (warm["misses"], warm["analyses"], warm["aot"]["loadErrors"]) \
        == (0, 0, 0)
    assert warm["loss"] == cold["loss"]
    assert warm["apply"] == cold["apply"] == cold["direct"]


def test_compile_cache_aot_block_has_the_jax_keys(tmp_path):
    from learningorchestra_tpu_torch.config import AotConfig
    from tests.torch_rest_pair import server_pair

    jaot.reset_store(root=str(tmp_path / "jax_aot"))
    out = {}
    with server_pair(tmp_path) as (servers, clients):
        aot_store.configure(AotConfig(enabled=True,
                                      dir=str(tmp_path / "port_aot")))
        for side, ctx in clients.items():
            ctx.model.create(
                "mlp", module_path="learningorchestra_tpu.models.mlp",
                class_name="MLPClassifier",
                class_parameters={"hidden_layer_sizes": [11],
                                  "num_classes": 2})
            ctx.observe.wait("mlp", timeout=120)
            rng = np.random.default_rng(0)
            xs = rng.standard_normal((24, 5)).astype(np.float32)
            ctx.train.create("fit1", parent_name="mlp", method="fit",
                             method_parameters={
                                 "x": xs.tolist(),
                                 "y": (xs.sum(1) > 0).astype(int).tolist(),
                                 "epochs": 2, "batch_size": 8})
            ctx.observe.wait("fit1", timeout=300)
            out[side] = ctx.monitoring.lookup("compileCache")["aot"]
    assert set(out["port"]) == set(out["jax"])
    assert out["port"]["enabled"] is True
    assert out["port"]["stores"] >= 1
    assert set(out["port"]["entries_detail"][0]) == {
        "key", "label", "hits", "bytes"}
