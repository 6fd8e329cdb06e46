"""The port's cost plane (obs/costs.py) held against the JAX package's:
scripted ``DeviceTimeLedger`` and ``CostLedger`` sequences give equal
snapshots, ``mfu`` agrees (None for an unknown peak), the FLOPs that
``analyze_program`` counts over one real call of an MLP's forward and
train step lie within 2 % of the JAX ``Lowered.cost_analysis()`` (both
equal the analytic GEMM count here), a small BERT's FLOPs carry K1–K3 by
formula whether the plain versions or a mocked kernel path run, an
analysis on one thread leaves another thread's forwards alone, the
fit's per-epoch attribution reaches the job's ledger entry, and the
autoscaler with ``up_device_frac > 0`` makes the JAX autoscaler's
decisions and ledger records on a scripted device-seconds feed.
"""

import contextlib
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

from learningorchestra_tpu.config import CostsConfig as JaxCostsConfig
from learningorchestra_tpu.config import FleetConfig as JaxFleetConfig
from learningorchestra_tpu.models.mlp import MLPClassifier as JaxMLP
from learningorchestra_tpu.obs import costs as jcosts
from learningorchestra_tpu.serve.fleet import Autoscaler as JaxAutoscaler
from learningorchestra_tpu_torch.config import CostsConfig, FleetConfig
from learningorchestra_tpu_torch.models.mlp import MLPClassifier
from learningorchestra_tpu_torch.models.text import BertModel
from learningorchestra_tpu_torch.obs import costs
from learningorchestra_tpu_torch.ops import attention
from learningorchestra_tpu_torch.serve.fleet import Autoscaler
from learningorchestra_tpu_torch.train import compile_cache as cc


@pytest.fixture(autouse=True)
def _fresh_ledgers():
    costs.reset()
    jcosts.reset()
    yield
    costs.reset()
    jcosts.reset()


# -- scripted ledgers -----------------------------------------------------------


def _devtime_script(mod, sample, max_jobs, max_models):
    led = mod.DeviceTimeLedger(max_jobs=max_jobs, sample=sample,
                               max_models=max_models)
    out = []
    for i in range(12):
        out.append(led.attribute(0.01 * (i + 1), flops=100.0 * i,
                                 nbytes=7.0, job=f"job{i % 5}"))
        out.append(led.attribute(0.002, flops=None, model=f"m{i % 4}",
                                 bucket=16 if i % 2 else 64))
        weight = led.will_record(f"d{i % 3}")
        if weight:
            led.record_model(weight, 0.003, 50.0, None, f"d{i % 3}",
                             f"dec{i % 2}x128")
        led.record(1, 0.004, flops=10.0, job="both", model="mb", bucket=8)
        out.append(led.model_device_s(f"m{i % 4}"))
    out.append(led.job_summary("both", peak_flops=1e4))
    out.append(led.job_summary("missing"))
    out.append(led.snapshot(peak_flops=2e4))
    out.append(led.snapshot())
    return out


@pytest.mark.parametrize("sample,max_jobs,max_models", [
    (1.0, 64, 64), (0.5, 3, 2), (0.25, 8, 3), (0.0, 4, 4), (0.7, 2, 8),
])
def test_device_time_ledger_script_equals_jax(sample, max_jobs,
                                              max_models):
    assert _devtime_script(costs, sample, max_jobs, max_models) == \
        _devtime_script(jcosts, sample, max_jobs, max_models)


def _cost_ledger_script(mod):
    led = mod.CostLedger(max_programs=3)
    memory = types.SimpleNamespace(
        argument_size_in_bytes=100, output_size_in_bytes=None,
        temp_size_in_bytes=5, generated_code_size_in_bytes=None)
    led.note_build("k" * 40, "epoch:a", 0.25)
    led.note_build("k" * 40, "", 0.5)
    led.record_analysis("k" * 40, "other", flops=123.0, memory=memory,
                        analysis_s=0.125)
    led.record_analysis("j" * 40, "apply:b", bytes_accessed=9.0,
                        serialized=77, collectives_excluded=True)
    led.note_failure()
    for i in range(3):
        led.note_build(f"{i}" * 40, f"p{i}", 0.0)
    docs = led.snapshot()
    for doc in docs["programs"]:
        doc.pop("builtS")
    return [docs, led.serialized_bytes("j" * 40),
            led.serialized_bytes("absent"),
            led.get("k" * 40) is None]


def test_cost_ledger_script_equals_jax():
    assert _cost_ledger_script(costs) == _cost_ledger_script(jcosts)


@pytest.mark.parametrize("flops,device_s,peak", [
    (1e12, 1.0, 1e13), (5.0, 1e-3, 9.894e14), (1e9, 0.0, 1e12),
    (0.0, 1.0, 1e12), (1e9, 1.0, 0.0), (3e14, 0.5, 9.894e14),
    (float("inf"), 1.0, 1.0),
])
def test_mfu_agrees_with_jax(flops, device_s, peak):
    assert costs.mfu(flops, device_s, peak_flops=peak) == \
        jcosts.mfu(flops, device_s, peak_flops=peak)
    if peak <= 0:
        assert costs.mfu(flops, device_s, peak_flops=peak) is None


def test_snapshot_and_serving_totals_key_sets_equal_jax():
    for mod in (costs, jcosts):
        mod.devtime().record_model(1, 0.5, 10.0, None, "m", 8)
    assert costs.serving_totals() == jcosts.serving_totals()
    port, ref = costs.snapshot(), jcosts.snapshot()
    assert set(port) == set(ref)
    assert set(port["ledger"]) == set(ref["ledger"])
    assert port["deviceTime"] == ref["deviceTime"]
    costs.reset(CostsConfig(enabled=False))
    jcosts.reset(JaxCostsConfig(enabled=False))
    assert costs.snapshot() == jcosts.snapshot()
    assert costs.serving_totals() == jcosts.serving_totals()


# -- FLOPs of one real call against XLA's cost analysis ----------------------


def _mlp_pair(n=64, d=128, hidden=256, classes=10):
    """The JAX MLP's initial params and the port's MLP carrying them."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = rng.integers(0, classes, n).astype(np.int32)
    jest = JaxMLP(hidden_layer_sizes=[hidden], num_classes=classes)
    jest._init_params(jnp.asarray(x[:1]))
    pest = MLPClassifier(hidden_layer_sizes=[hidden], num_classes=classes,
                         device="cpu")
    pest.compute_dtype = "float32"
    pest.load_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, jest.params)})
    return jest, pest, x, y


def _jax_loss(module, params, x, y):
    logits = module.apply(params, x)
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, y[:, None], 1))


def _port_flops(key, fn, *args):
    costs.analyze_program(key, "test", fn, args)
    return costs.get_ledger().get(key).flops


def test_mlp_forward_and_train_step_flops_within_2pc_of_jax():
    jest, pest, x, y = _mlp_pair()
    n, d, hidden, classes = 64, 128, 256, 10
    ref_fwd = jax.jit(jest.module.apply).lower(
        jest.params, x).cost_analysis()
    ref_step = jax.jit(jax.grad(lambda p: _jax_loss(
        jest.module, p, x, y))).lower(jest.params).cost_analysis()
    ref_fwd = ref_fwd[0] if isinstance(ref_fwd, list) else ref_fwd
    ref_step = ref_step[0] if isinstance(ref_step, list) else ref_step

    def step(module, xt, yt):
        loss = torch.nn.functional.cross_entropy(module(xt), yt.long())
        loss.backward()
        module.zero_grad(set_to_none=True)
        return loss

    with torch.no_grad():
        fwd = _port_flops("fwd", pest.module, torch.from_numpy(x))
    step_flops = _port_flops("step", step, pest.module, torch.from_numpy(x),
                             torch.from_numpy(y))
    gemm_fwd = 2 * n * (d * hidden + hidden * classes)
    # Backward: dW of both layers, dX of the second (no input gradient).
    gemm_step = gemm_fwd + 2 * n * (d * hidden + 2 * hidden * classes)
    assert fwd == gemm_fwd and step_flops == gemm_step
    assert abs(fwd - ref_fwd["flops"]) / ref_fwd["flops"] <= 0.02
    assert abs(step_flops - ref_step["flops"]) / ref_step["flops"] <= 0.02


def test_analyze_program_records_once_returns_the_result_and_measures_args():
    _, pest, x, _ = _mlp_pair(n=8, d=4, hidden=3, classes=2)
    xt = torch.from_numpy(x)
    def apply(module, t):
        return module(t)

    with torch.no_grad():
        out = costs.analyze_program("k", "lbl", apply, (pest.module, xt))
        again = costs.analyze_program("k", "lbl", apply, (pest.module, xt))
    torch.testing.assert_close(out, again)
    rec = costs.get_ledger().get("k")
    assert rec.analyzed and rec.flops == 2 * 8 * (4 * 3 + 3 * 2)
    # Deep: the arguments' bytes (parameters + input); nothing on a card
    # to take a peak from; what a PyTorch program cannot report is None.
    params = sum(p.numel() * 4 for p in pest.module.parameters())
    assert rec.argument_bytes == params + xt.numel() * 4
    doc = rec.to_doc()
    assert doc["tempBytes"] is None and doc["bytesAccessed"] is None
    assert doc["serializedBytes"] is None
    assert costs.get_ledger().snapshot()["analyses"] == 1
    # A failing call propagates and records nothing.
    with pytest.raises(RuntimeError):
        costs.analyze_program("bad", "x", lambda: (_ for _ in ()).throw(
            RuntimeError("boom")), ())
    assert costs.get_ledger().get("bad") is None


def test_analysis_leaves_other_threads_forwards_and_backwards_alone():
    """One thread analyzes programs while another trains a module of the
    same class: the analysis hooks no module process-wide, counts none
    of the other thread's operators, and both loops finish untouched."""
    _, mine, x, _ = _mlp_pair(n=8, d=16, hidden=12, classes=4)
    _, other, _, _ = _mlp_pair(n=8, d=16, hidden=12, classes=4)
    xt = torch.from_numpy(x)
    want = [p.detach().clone() for p in _grads(other.module, xt)]
    stop = threading.Event()
    errors, hooks_seen, grads_ok = [], [], []

    def train_loop():
        try:
            while not stop.is_set():
                got = _grads(other.module, xt)
                grads_ok.append(all(torch.equal(g, w)
                                    for g, w in zip(got, want)))
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    def program(module, t):
        from torch.nn.modules import module as nn_module

        hooks_seen.append(len(nn_module._global_forward_pre_hooks)
                          + len(nn_module._global_forward_hooks))
        return module(t)

    thread = threading.Thread(target=train_loop)
    thread.start()
    try:
        for i in range(40):
            with torch.no_grad():
                costs.analyze_program(f"t{i}", "t", program,
                                      (mine.module, xt))
            assert costs.get_ledger().get(f"t{i}").flops == \
                2 * 8 * (16 * 12 + 12 * 4)
    finally:
        stop.set()
        thread.join(30)
    assert not errors and grads_ok and all(grads_ok)
    assert hooks_seen == [0] * 40


def _grads(module, xt):
    module.zero_grad(set_to_none=True)
    module(xt).square().sum().backward()
    return [p.grad for p in module.parameters()]


def test_repeats_counts_the_first_unit_and_scales():
    a = torch.ones(4, 8)
    b = torch.ones(8, 3)

    def program(units):
        for i in range(units):
            a @ b
            if i == 0:
                costs.repeats(units)
        (a @ b @ b.T).sum()  # after the units: not counted

    costs.analyze_program("units", "u", program, (5,))
    assert costs.get_ledger().get("units").flops == 5 * 2 * 4 * 8 * 3
    costs.repeats(3)  # outside an analysis: a no-op
    assert not costs.counting()


def test_attention_pairs_count_the_live_pairs():
    for tq, tk, causal, window in [(7, 7, False, None), (9, 9, True, None),
                                   (12, 12, True, 4), (5, 8, True, None),
                                   (8, 5, True, 3)]:
        rows = np.arange(tq)[:, None]
        cols = np.arange(tk)[None, :]
        keep = np.ones((tq, tk), bool)
        if causal:
            keep = cols <= rows
            if window:
                keep &= cols > rows - window
        assert costs.attention_pairs(tq, tk, causal, window) == keep.sum()


def _bert_train_flops(monkeypatch, kernel_path: bool):
    """FLOPs of one small-BERT train step (fwd + bwd), with the plain
    versions or a mocked kernel path (whose ops no counter can see, as
    a ctypes launch)."""
    torch.manual_seed(0)
    est = BertModel(vocab_size=64, hidden_dim=32, num_layers=2,
                    num_heads=4, max_len=16, device="cpu")
    if kernel_path:
        for name in ("flash_attention_fwd_plain", "flash_attention_bwd_plain",
                     "flash_attention_bwd_dq_plain",
                     "flash_attention_bwd_dkv_plain"):
            real = getattr(attention, name)

            def invisible(*a, _real=real, **k):
                with _disable_current_modes():
                    return _real(*a, **k)

            monkeypatch.setattr(attention, name, invisible)
        monkeypatch.setattr(costs, "uncounted", contextlib.nullcontext)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        1, 64, (3, 16)))

    def step(module, t):
        module(t).float().sum().backward()

    costs.analyze_program(f"bert{kernel_path}", "b", step, (est.module,
                                                            tokens))
    return costs.get_ledger().get(f"bert{kernel_path}").flops


def test_bert_flops_carry_the_kernels_formula_on_both_paths(monkeypatch):
    plain = _bert_train_flops(monkeypatch, kernel_path=False)
    kernel = _bert_train_flops(monkeypatch, kernel_path=True)
    assert plain == kernel
    b, h, t, dh, layers = 3, 4, 16, 8, 2
    formula = (4 + 6 + 8) * b * h * t * t * dh * layers
    # Without the formula (and with the plain versions' einsums hidden)
    # the count drops by exactly the formula.
    monkeypatch.setattr(costs, "note_kernel_flops", lambda *a: None)
    costs.reset()
    assert _bert_train_flops(monkeypatch, kernel_path=True) == \
        plain - formula


def test_fit_attributes_each_epoch_to_the_job_with_mfu():
    costs.reset(CostsConfig(peak_flops=1e12))
    cc.reset_cache()
    _, pest, x, y = _mlp_pair(n=32, d=8, hidden=6, classes=2)
    y = y % 2
    with costs.job_scope("fit-job"):
        pest.fit(x, y, epochs=3, batch_size=16)
    summary = costs.job_summary("fit-job")
    assert summary["dispatches"] == 3 and summary["deviceTimeS"] > 0
    epoch = 2 * 32 * (8 * 6 + 6 * 2) + 2 * 32 * (8 * 6 + 2 * 6 * 2)
    assert summary["flops"] == 3 * epoch
    assert 0 < summary["mfu"] <= 1.0
    costs.reset()
    with costs.job_scope("nopeak"):
        pest.fit(x, y, epochs=1, batch_size=16)
    assert "mfu" not in costs.job_summary("nopeak")


# -- the autoscaler's device-time trigger ------------------------------------


class _Set:
    max_queue = 64

    def __init__(self):
        self.name, self.n = "m", 1
        self.min_replicas, self.max_replicas = 1, 3

    def signals(self):
        return {"replicas": self.n, "queue_depth": 0, "queue_frac": 0.0,
                "p99_ms": 0.0, "sheds": 0, "requests": 0}

    def scale_to(self, n):
        self.n = max(self.min_replicas, min(self.max_replicas, n))
        return self.n


class _Manager:
    def __init__(self):
        self.rs = _Set()

    def sets_snapshot(self):
        return [("m", self.rs)]

    def scale(self, name, n, *, reason):
        return self.rs.scale_to(n)


#: Device seconds attributed to "m" before each tick (one second apart).
_FEED = [0.0, 0.1, 0.95, 0.9, 0.2, 0.85, 0.9, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]


def _drive(mod, autoscaler_cls, cfg, monkeypatch):
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    mgr = _Manager()
    scaler = autoscaler_cls(mgr, cfg)
    for dev_s in _FEED:
        if dev_s:
            mod.devtime().record_model(1, dev_s, None, None, "m", 8)
        scaler.tick()
        clock[0] += 1.0
    status = scaler.status()
    for key in ("decisions", "ledger"):
        for record in status[key]:
            record.pop("t")
    return status


def test_device_frac_autoscaler_equals_jax(monkeypatch):
    knobs = dict(interval_s=0.0, up_queue_frac=0.25, up_ticks=2,
                 down_ticks=3, up_device_frac=0.8, lease_timeout_s=1000.0)
    port = _drive(costs, Autoscaler, FleetConfig(**knobs), monkeypatch)
    ref = _drive(jcosts, JaxAutoscaler, JaxFleetConfig(**knobs),
                 monkeypatch)
    assert port == ref
    assert any(r["action"] == "up" and r.get("deviceFrac", 0) >= 0.8
               for r in port["ledger"]), port["ledger"]


def test_up_device_frac_is_accepted_at_boot(monkeypatch):
    from learningorchestra_tpu_torch.config import Config

    monkeypatch.setenv("LO_TPU_FLEET_UP_DEVICE_FRAC", "0.8")
    assert Config.from_env().fleet.up_device_frac == 0.8
