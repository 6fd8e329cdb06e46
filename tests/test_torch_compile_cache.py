"""The port's program cache (train/compile_cache.py) held against the JAX
package's ``CompiledProgramCache``: the same scripted sequences give the
same ``stats()`` (trace and build seconds aside) — hits, misses, LRU
order, the byte cap, the disabled cache, a failed build releasing its
waiters, 8 threads coalescing on one key, a build in flight across a
device-set change, ``install`` and the invalidation listeners.  Then the
port's own fingerprints of ``torch.nn.Module`` programs, estimators
sharing a program while computing with their own weights, the engine's
warm-key dispatch (``tests/test_compile_cache.py::TestWarmStartDispatch``
against the port's engine), and the context's listener lifecycle.
"""

import threading
import time

import numpy as np
import pytest
import torch

from learningorchestra_tpu.train import compile_cache as jcc
from learningorchestra_tpu_torch.jobs.engine import JobEngine
from learningorchestra_tpu_torch.models.mlp import MLPClassifier
from learningorchestra_tpu_torch.models.text import BertModel, DecoderLM
from learningorchestra_tpu_torch.ops.layers import MultiHeadSelfAttention
from learningorchestra_tpu_torch.store import ArtifactStore, open_document_store
from learningorchestra_tpu_torch.train import compile_cache as cc
from learningorchestra_tpu_torch.train.neural import (
    OptimizerSpec,
    _cached_program,
    _device_epoch_program,
)

_TIMED = ("traceTimeS", "entries_detail")


def _stats(cache) -> dict:
    """``stats()`` without the seconds (each entry's ``builtS`` rides in
    ``entries_detail``, compared without it)."""
    out = {k: v for k, v in cache.stats().items() if k not in _TIMED}
    out["entries_detail"] = [
        {k: v for k, v in e.items() if k != "builtS"}
        for e in cache.stats()["entries_detail"]]
    return out


def _lru(mod):
    cache = mod.CompiledProgramCache(max_entries=2)
    cache.get_or_build("k1", lambda: "v1", label="a")
    cache.get_or_build("k2", lambda: "v2", label="b")
    assert cache.get_or_build("k1", lambda: "WRONG") == "v1"  # refresh
    cache.get_or_build("k3", lambda: "v3", label="c")  # evicts k2
    assert cache.contains("k1") and cache.contains("k3")
    assert not cache.contains("k2")
    return cache


def _byte_cap(mod):
    cache = mod.CompiledProgramCache(max_entries=10, max_bytes=100,
                                     entry_bytes=60)
    cache.get_or_build("k1", lambda: "v1")
    cache.get_or_build("k2", lambda: "v2")  # 120 estimated bytes > 100
    cache.get_or_build("k3", lambda: "v3", nbytes=500)  # alone past cap
    assert not cache.contains("k2") and cache.contains("k3")
    return cache


def _disabled(mod):
    cache = mod.CompiledProgramCache(max_entries=0)
    assert cache.get_or_build("k", lambda: 1) == 1
    assert cache.get_or_build("k", lambda: 2) == 2
    assert not cache.install("k", 3)
    return cache


def _failed_build(mod):
    cache = mod.CompiledProgramCache(max_entries=4)
    with pytest.raises(RuntimeError):
        cache.get_or_build("k", lambda: (_ for _ in ()).throw(
            RuntimeError("build failed")))
    assert not cache.contains("k")
    assert cache.get_or_build("k", lambda: "ok") == "ok"
    return cache


def _coalesce(mod):
    """8 threads on one key: one builds, seven wait on its build (each
    counted once it is parked on the build's event) and coalesce."""
    cache = mod.CompiledProgramCache(max_entries=4)
    gate, builds, results = threading.Event(), [], []

    def builder():
        gate.wait(10)
        builds.append(1)
        return "v"

    threads = [threading.Thread(target=lambda: results.append(
        cache.get_or_build("k", builder))) for _ in range(8)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        ev = cache._building.get("k")
        if ev is not None and len(ev._cond._waiters) == 7:
            break
        time.sleep(0.005)
    gate.set()
    for t in threads:
        t.join(10)
    assert results == ["v"] * 8 and len(builds) == 1
    return cache


def _device_change(mod, monkeypatch):
    cache = mod.CompiledProgramCache(max_entries=4)
    fired = []
    cache.add_invalidation_listener(lambda: fired.append(1))
    dropped = lambda: fired.append("never")  # noqa: E731
    cache.add_invalidation_listener(dropped)
    cache.remove_invalidation_listener(dropped)
    cache.remove_invalidation_listener(dropped)  # absent: no error
    cache.get_or_build("k", lambda: "v")
    started, release, result = threading.Event(), threading.Event(), {}

    def slow():
        started.set()
        release.wait(10)
        return "stale"

    t = threading.Thread(target=lambda: result.setdefault(
        "v", cache.get_or_build("slow", slow)))
    t.start()
    assert started.wait(10)
    monkeypatch.setattr(mod, "_device_signature", lambda: (("changed",),))
    # The lookup that sees the new device set clears the cache; the
    # build in flight across it is handed to its caller, never cached.
    assert cache.get_or_build("k", lambda: "rebuilt") == "rebuilt"
    release.set()
    t.join(10)
    assert result["v"] == "stale" and not cache.contains("slow")
    assert fired == [1]
    return cache


def _install(mod):
    cache = mod.CompiledProgramCache(max_entries=2)
    assert cache.install("a", "va", label="pre", nbytes=7)
    assert cache.install("a", "other")  # resident wins, no count
    assert cache.get_or_build("a", lambda: "WRONG") == "va"
    cache.get_or_build("b", lambda: "vb")
    assert cache.install("c", "vc")  # evicts the LRU entry
    cache.clear()
    cache.get_or_build("a", lambda: "va2")
    return cache


@pytest.mark.parametrize("script", [
    _lru, _byte_cap, _disabled, _failed_build, _coalesce, _install,
    _device_change,
], ids=lambda f: f.__name__.strip("_"))
def test_scripted_sequence_stats_equal_jax(script, monkeypatch):
    args = (monkeypatch,) if script is _device_change else ()
    assert _stats(script(cc, *args)) == _stats(script(jcc, *args))


def test_delta_and_enabled_follow_the_singleton():
    cc.reset_cache(max_entries=0)
    try:
        assert not cc.enabled()
    finally:
        cc.reset_cache()
    assert cc.enabled()
    before = cc.counters_snapshot()
    cache = cc.get_cache()
    cache.get_or_build("delta-k", lambda: 1)
    cache.get_or_build("delta-k", lambda: 2)
    delta = cc.delta_since(before)
    assert {k: delta[k] for k in ("hits", "misses", "evictions",
                                  "coalesced")} == {
        "hits": 1, "misses": 1, "evictions": 0, "coalesced": 0}
    assert set(delta) == set(jcc._COUNTER_KEYS)


def test_device_signature_is_empty_without_a_card():
    assert cc._device_signature() == ()


# -- fingerprints ---------------------------------------------------------------


def _bert(**kw):
    kw = {"vocab_size": 64, "hidden_dim": 32, "num_layers": 1,
          "num_heads": 2, "max_len": 16, **kw}
    return BertModel(**kw, device="cpu")


def _lm(**kw):
    kw = {"vocab_size": 64, "hidden_dim": 32, "num_layers": 1,
          "num_heads": 4, "max_len": 32, **kw}
    return DecoderLM(**kw, device="cpu")


def _key(est, shapes=(64, 32, True)):
    return cc.program_key(
        "device_epoch", module=cc.module_fingerprint(est.module),
        optimizer=cc.optimizer_fingerprint(est), loss="softmax_ce",
        dtype=est.compute_dtype, shapes=shapes)


def test_same_config_same_key_across_instances_and_seeds():
    assert _key(_bert()) == _key(_bert())
    assert _key(_bert(seed=1)) == _key(_bert(seed=2))
    assert _key(_lm(attention_window=8)) == _key(_lm(attention_window=8))


def test_heads_change_with_equal_shapes_changes_the_key():
    a, b = _bert(num_heads=2), _bert(num_heads=4)
    assert [p.shape for p in a.module.parameters()] == \
        [p.shape for p in b.module.parameters()]
    assert _key(a) != _key(b)


@pytest.mark.parametrize("change", [
    "window", "rope", "gqa", "causal", "dtype", "param_dtype", "optimizer",
    "schedule", "batch", "remat",
])
def test_each_program_change_changes_the_key(change):
    base, other = _lm(), _lm()
    shapes = (64, 32, True)
    if change == "window":
        other = _lm(attention_window=8)
    elif change == "rope":
        base, other = _lm(num_heads=4), _lm(num_heads=4, positional="rope")
    elif change == "gqa":
        other = _lm(num_kv_heads=2)
    elif change == "causal":
        a = MultiHeadSelfAttention(4, 32, causal=False)
        b = MultiHeadSelfAttention(4, 32, causal=True)
        assert cc.module_fingerprint(a) != cc.module_fingerprint(b)
        return
    elif change == "dtype":
        other.compute_dtype = "float32"
    elif change == "param_dtype":
        other.module.to(torch.float64)
    elif change == "optimizer":
        other.compile(optimizer="sgd")
    elif change == "schedule":
        spec = {"schedule": "cosine", "init_value": 1e-3,
                "decay_steps": 10}
        base.compile(learning_rate=spec)
        other.compile(learning_rate={**spec, "decay_steps": 20})
    elif change == "batch":
        assert _key(base, shapes) != _key(base, (64, 16, True))
        return
    elif change == "remat":
        base, other = _bert(), _bert(remat=True)
        assert _key(other, shapes) != _key(_bert(remat="dots"), shapes)
    assert _key(base, shapes) != _key(other, shapes)


def test_opaque_optimizer_and_lambda_never_false_hit():
    a, b = _bert(), _bert()
    a.compile(optimizer=OptimizerSpec("adam", 1e-3))
    b.compile(optimizer=OptimizerSpec("adam", 1e-3))
    assert cc.optimizer_fingerprint(a) != cc.optimizer_fingerprint(b)
    # The same object keys the same (reuse within one estimator).
    assert cc.optimizer_fingerprint(a) == cc.optimizer_fingerprint(a)
    m1, m2 = MultiHeadSelfAttention(2, 8), MultiHeadSelfAttention(2, 8)
    m1.act, m2.act = (lambda x: x), (lambda x: x)
    assert cc.module_fingerprint(m1) != cc.module_fingerprint(m2)
    assert cc.module_fingerprint(m1) == cc.module_fingerprint(m1)
    m2.act = torch.nn.functional.gelu  # a named function keys by name
    m3 = MultiHeadSelfAttention(2, 8)
    m3.act = torch.nn.functional.gelu
    assert cc.module_fingerprint(m2) == cc.module_fingerprint(m3)


def test_mesh_fingerprint_is_in_the_key():
    from learningorchestra_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    one = build_mesh(MeshSpec(dp=1), ["cpu"])
    two = build_mesh(MeshSpec(dp=2), ["cpu", "cpu"])
    est = _bert()
    keys = {cc.program_key("device_epoch",
                           module=cc.module_fingerprint(est.module),
                           optimizer=None, loss="-", dtype="-", mesh=m)
            for m in (None, cc.mesh_fingerprint(one),
                      cc.mesh_fingerprint(two))}
    assert len(keys) == 3


def test_two_estimators_share_a_program_with_their_own_weights():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 6)).astype(np.float32)
    a = MLPClassifier(hidden_layer_sizes=[5], num_classes=3, seed=1,
                      device="cpu")
    b = MLPClassifier(hidden_layer_sizes=[5], num_classes=3, seed=2,
                      device="cpu")
    y = rng.integers(0, 3, 8)
    for est in (a, b):
        est.compute_dtype = "float32"
        est.fit(x, y, epochs=1, batch_size=8)
    assert a._device_epoch_prog is b._device_epoch_prog
    pa, pb = a._apply_for(8), b._apply_for(8)
    assert pa is pb
    out_a, out_b = pa(a.module, x), pb(b.module, x)
    np.testing.assert_array_equal(out_a, a.apply(x))
    np.testing.assert_array_equal(out_b, b.apply(x))
    assert not np.allclose(out_a, out_b)
    # The epoch program steps the estimator it is handed.
    before = {k: v.clone() for k, v in b.module.state_dict().items()}
    prog = _cached_program("device_epoch", a, "softmax_ce",
                           shapes=(8, 8, True), fn=_device_epoch_program)
    assert prog is a._device_epoch_prog
    xs, ys = torch.from_numpy(x), torch.from_numpy(y.astype(np.int32))
    prog(a, xs, ys, a._loss_and_metrics("softmax_ce"), None, 8, True, 5)
    assert all(torch.equal(v, b.module.state_dict()[k])
               for k, v in before.items())


def test_second_fit_and_predict_of_a_fresh_estimator_hit():
    cc.reset_cache()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((16, 4)).astype(np.float32)
    y = rng.integers(0, 2, 16)
    deltas = []
    for _ in range(2):
        before = cc.counters_snapshot()
        est = MLPClassifier(hidden_layer_sizes=[7], num_classes=2,
                            device="cpu")
        est.fit(x, y, epochs=2, batch_size=8)
        est.predict(x)
        est.evaluate(x, y)
        deltas.append(cc.delta_since(before))
    # epoch_fns, device_epoch and apply: built once, then all hits.
    assert (deltas[0]["misses"], deltas[0]["hits"]) == (3, 0)
    assert (deltas[1]["misses"], deltas[1]["hits"]) == (0, 3)


def test_compile_invalidates_the_programs_it_changes():
    cc.reset_cache()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, 4)).astype(np.float32)
    y = rng.integers(0, 2, 16)
    est = MLPClassifier(hidden_layer_sizes=[9], num_classes=2, device="cpu")
    est.fit(x, y, epochs=1, batch_size=8)
    first = est._device_epoch_prog
    est.compile(optimizer="sgd")
    est.fit(x, y, epochs=1, batch_size=8)
    assert est._device_epoch_prog is not first
    est.compile(optimizer={"name": "adam"})  # the default's spec again
    est.fit(x, y, epochs=1, batch_size=8)
    assert est._device_epoch_prog is first  # the adam program, a hit


# -- the engine's warm-start dispatch (the JAX TestWarmStartDispatch) ---------


@pytest.fixture
def port_artifacts(tmp_path):
    store = open_document_store(tmp_path / "store", backend="python")
    yield ArtifactStore(store)
    store.close()


def test_warm_job_dispatches_before_cold_within_class(port_artifacts):
    engine = JobEngine(port_artifacts, max_workers=1)
    try:
        order, release = [], threading.Event()
        for name in ("blocker", "cold_a", "cold_b", "warm_j"):
            port_artifacts.metadata.create(name, "train/x")
        engine.submit("blocker", lambda: release.wait(10), job_class="t")
        time.sleep(0.1)
        engine.submit("cold_a", lambda: order.append("cold_a"),
                      job_class="t", warm_key="prog:cold")
        engine.submit("cold_b", lambda: order.append("cold_b"),
                      job_class="t", warm_key="prog:cold")
        engine.submit("warm_j", lambda: order.append("warm_j"),
                      job_class="t", warm_key="prog:warm")
        engine.note_warm("prog:warm")
        release.set()
        for name in ("cold_a", "cold_b", "warm_j"):
            engine.wait(name, timeout=10)
        assert order[0] == "warm_j"
        assert set(order) == {"warm_j", "cold_a", "cold_b"}
    finally:
        engine.shutdown(wait=True)


def test_warm_bypass_is_bounded_no_cold_starvation(port_artifacts):
    engine = JobEngine(port_artifacts, max_workers=1)
    try:
        order, release = [], threading.Event()
        names = ["blocker", "cold"] + [f"warm{i}" for i in range(8)]
        for name in names:
            port_artifacts.metadata.create(name, "train/x")
        engine.submit("blocker", lambda: release.wait(10), job_class="t")
        time.sleep(0.1)
        engine.submit("cold", lambda: order.append("cold"),
                      job_class="t", warm_key="prog:cold")
        for i in range(8):
            engine.submit(f"warm{i}", lambda i=i: order.append(f"warm{i}"),
                          job_class="t", warm_key="prog:warm")
        engine.note_warm("prog:warm")
        release.set()
        for name in names[1:]:
            engine.wait(name, timeout=10)
        assert order.index("cold") <= engine._max_warm_bypass
    finally:
        engine.shutdown(wait=True)


def test_device_invalidation_drops_warm_hints(tmp_path, monkeypatch):
    from learningorchestra_tpu_torch.config import Config, StoreConfig
    from learningorchestra_tpu_torch.services.context import ServiceContext

    cc.reset_cache()
    ctx = ServiceContext(Config(store=StoreConfig(
        root=str(tmp_path / "store"), volume_root=str(tmp_path / "vol"))),
        device="cpu")
    try:
        cache = cc.get_cache()
        cache.get_or_build("k", lambda: "v")  # pins the device signature
        ctx.engine.note_warm("prog:x")
        assert "prog:x" in ctx.engine._warm_keys
        monkeypatch.setattr(cc, "_device_signature", lambda: (("x",),))
        cache.get_or_build("k2", lambda: "v2")  # triggers the clear
        assert not ctx.engine._warm_keys
    finally:
        ctx.close()


def test_note_warm_is_bounded_and_null_safe(port_artifacts):
    engine = JobEngine(port_artifacts, max_workers=1)
    try:
        engine.note_warm(None)
        engine._max_warm_keys = 4
        for i in range(10):
            engine.note_warm(f"k{i}")
        assert len(engine._warm_keys) == 4
        assert "k9" in engine._warm_keys and "k0" not in engine._warm_keys
    finally:
        engine.shutdown(wait=True)


def test_context_close_deregisters_invalidation_listener(tmp_path):
    from learningorchestra_tpu_torch.config import Config, StoreConfig
    from learningorchestra_tpu_torch.services.context import ServiceContext

    cc.reset_cache()
    cache = cc.get_cache()
    n0 = len(cache._invalidation_listeners)
    ctx = ServiceContext(Config(store=StoreConfig(
        root=str(tmp_path / "store"), volume_root=str(tmp_path / "vol"))),
        device="cpu")
    assert len(cache._invalidation_listeners) == n0 + 1
    ctx.close()
    assert len(cache._invalidation_listeners) == n0


def test_warm_fingerprint_ignores_knobs_outside_the_program():
    a = cc.warm_fingerprint("m", "C", "fit", {"epochs": 2, "verbose": 1,
                                              "checkpoint_dir": "/a"})
    b = cc.warm_fingerprint("m", "C", "fit", {"epochs": 2, "verbose": 0})
    c = cc.warm_fingerprint("m", "C", "fit", {"epochs": 3})
    assert a == b != c
