"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py

Phases (each prints its own line; any failure exits nonzero):

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds every kernel source under
   learningorchestra_tpu_torch/csrc/, all at once;
3. kernels against their plain PyTorch versions, on the card:
   K1 flash-attention forward at the serving shape (64, 12, 512, 64) f32
   with a key mask and a fully-masked row, plus the fine-tune shape
   (32, 12, 128, 64) bf16, bf16 at T=512, causal, causal+window and
   unaligned lengths; K2 (dQ) and K3 (dK, dV) at the fine-tune shape in
   bf16 and f32 with a key mask and a fully-masked row (exact zeros
   asserted), plus (8, 12, 512, 64) bf16, causal, causal+window, unaligned
   lengths and D = 40 / 128 in bf16; every K1 case and every bf16 K2/K3
   case launched twice and required bitwise equal (run to run), and no
   register spills in any tensor-core instance of K1, K2 or K3 (ptxas);
   K4 quantize bit-exact on every quantized leaf of a BERT-base model plus
   a stochastic mean-bias check; K5 dequantize exact;
4. training: one batch of BERT-base (full width and depth, random weights
   from a seeded torch.Generator) in f32 on the card against the CPU plain
   path, loss and every parameter's gradient; then the slice's first main
   path: ``BertModel.fit`` for 2 epochs of 250 seeded rows at T=128,
   batch 32, bf16 compute on f32 masters, and ``evaluate``; losses finite,
   parameters moved, K1/K2/K3 launch counters = 12 per step (+ K1 per
   evaluate batch); step time (CUDA events, second epoch); a
   torch.profiler breakdown of train steps by kernel family;
5. serving, the second main path: the trained model saved as an int8
   artifact (K4), loaded by the port's REST server on the card (K5), and
   ~24 concurrent predicts of 1-8 rows at T=512 answered through coalesced
   bucket dispatches; every answer is checked for status, shape and
   finiteness, a few rows against the same artifact run on the CPU (plain
   path), and the kernels' launch counters against the dispatches;
6. timings (CUDA events, after warm-up; K1 and the forward of
   scaled_dot_product_attention at the serving shape in f32, whose kernel
   name is printed from one profiled call; K1, K2/K3 and SDPA's forward and
   backward at the fine-tune shape and at (8, 12, 512, 64) bf16), a
   torch.profiler breakdown of one 64-row bucket by kernel family, and the
   `kernels` JSON line;
7. last line: {"ok": true, "device": {...}}.

Without a visible GPU, or without the repository beside it, it exits
nonzero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import http.client
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet), used for bound_ms.
# Tensor cores, dense.  K1's f32 route runs each f32 product as three
# TF32 products (split TF32), so its operations bound is 3x its FLOPs at
# the TF32 rate (not f32 FLOPs at the CUDA cores' 67 TFLOP/s).
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12  # tensor cores, dense
PEAK_BYTES = 3.35e12  # HBM3

PATH_SHAPE = (64, 12, 512, 64)  # largest serving bucket, BERT-base heads
SEQ_LEN = 512
N_REQUESTS = 24
CPU_ATOL = 1e-3
# BERT fine-tuning recipe (Devlin et al. 2019, run_classifier.py defaults):
# max_seq_length 128, train_batch_size 32; the JAX default lr 2e-5.
TRAIN_SHAPE = (32, 12, 128, 64)  # (batch, heads, T, head dim) of K2/K3
TRAIN_ROWS, TRAIN_EPOCHS = 250, 2
# One f32 batch, card vs CPU: per parameter max|dg| <= GRAD_RTOL *
# max|g| + GRAD_ATOL_REL * (the model's largest gradient); the second
# term covers parameters whose gradient is rounding noise on both sides
# (the key bias: softmax ignores a per-row shift).
GRAD_RTOL = 1e-3
GRAD_ATOL_REL = 1e-6
LOSS_RTOL = 1e-5
# About 50 ms of device time at the H100's clocks: longer than the host
# takes to enqueue any timed run below.
SLEEP_CYCLES = 100_000_000

failures: list[str] = []


def phase(name: str, ok: bool, detail: str) -> None:
    print(f"[{'ok' if ok else 'FAIL'}] {name}: {detail}", flush=True)
    if not ok:
        failures.append(f"{name}: {detail}")


def time_ms(fn, reps: int = 10, warmup: int = 2,
            hide_launch: bool = True) -> float:
    """Mean device time of fn() over reps, by CUDA events.

    With ``hide_launch`` a device-side sleep is queued before the start
    event, so the host enqueues the reps while the card is still busy and
    the interval holds the kernels' own time, not the host's launch rate
    (which dominates short kernels launched one by one through ctypes).
    Without it the interval is what a caller on the host waits."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if hide_launch:
        torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_report(log: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) for each
    entry function in nvcc's ``-Xptxas -v`` output."""
    out, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spills = _kernel_name(m.group(1)), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), *spills))
            name = None
    return out


def _kernel_name(mangled: str) -> str:
    """``flash_bwd_dq_tc_kernel<64,64,true>`` from an Itanium-mangled
    name: the length-prefixed identifier that ends in "kernel", then its
    template arguments."""
    i = 0
    while i < len(mangled):
        m = re.match(r"\d+", mangled[i:])
        if not m:
            i += 1
            continue
        start = i + m.end()
        ident = mangled[start:start + int(m.group())]
        i = start + len(ident)
        if ident.endswith("kernel"):
            tail = mangled[i:]
            if not tail.startswith("I"):
                return ident
            names = {"f": "f32", "13__nv_bfloat16": "bf16",
                     "Lb0E": "false", "Lb1E": "true"}
            args = re.findall(r"(f|13__nv_bfloat16|Lb[01]E|Li(\d+)E)",
                              tail.split("EEv")[0])
            return ident + "<" + ",".join(n or names[a] for a, n in args) \
                + ">"
    return mangled


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# -- phase 3: kernels against their plain versions ---------------------------


def check_flash(attention, gen) -> dict:
    b, h, t, d = PATH_SHAPE
    results = {}
    cases = [
        # name, (B, H, Tq, Tk, D), dtype, causal, window, masked, tol
        ("path_f32", (b, h, t, t, d), torch.float32, False, None, True, 2e-5),
        ("bf16", (8, h, t, t, d), torch.bfloat16, False, None, True, 3e-2),
        ("causal", (8, h, t, t, d), torch.float32, True, None, True, 2e-5),
        ("causal_window", (8, h, t, t, 128), torch.float32, True, 100,
         False, 2e-5),
        ("unaligned", (4, h, 37, 41, d), torch.float32, False, None, True,
         2e-5),
        ("unaligned_bf16_causal", (4, h, 300, 300, 40), torch.bfloat16,
         True, 65, True, 3e-2),
        ("train_bf16", (32, h, 128, 128, d), torch.bfloat16, False, None,
         True, 3e-2),
    ]
    for name, (bb, hh, tq, tk, dd), dtype, causal, window, masked, tol in \
            cases:
        q = torch.randn(bb, hh, tq, dd, device="cuda", generator=gen)
        k = torch.randn(bb, hh, tk, dd, device="cuda", generator=gen)
        v = torch.randn(bb, hh, tk, dd, device="cuda", generator=gen)
        q, k, v = (x.to(dtype) for x in (q, k, v))
        km = None
        if masked:
            km = torch.rand(bb, tk, device="cuda", generator=gen) > 0.25
            km[1] = False  # a fully-masked batch row
        with torch.inference_mode():
            o, lse = attention.flash_attention_fwd(q, k, v, km, causal,
                                                   window)
            # No atomics, a fixed summation order: the same bits every run.
            o2, lse2 = attention.flash_attention_fwd(q, k, v, km, causal,
                                                     window)
            torch.cuda.synchronize()
            same = torch.equal(o, o2) and torch.equal(lse, lse2)
            o_ref, lse_ref = attention.flash_attention_fwd_plain(
                q, k, v, km, causal, window)
        err_o = max_abs(o, o_ref)
        err_lse = max_abs(lse, lse_ref)
        empty_ok = True
        if masked:
            empty_ok = bool((o[1] == 0).all()) and bool((lse[1] == 1e30).all())
        ok = err_o <= tol and err_lse <= tol and empty_ok and same
        phase(f"K1 flash_fwd {name} {tuple(q.shape)} Tk={tk} "
              f"{str(dtype)[6:]}", ok,
              f"max|dO|={err_o:.3g} max|dLSE|={err_lse:.3g} "
              f"masked_row_zero_lse_1e30={empty_ok} tol={tol} "
              f"run_to_run_bitwise={same}")
        results[name] = (q, k, v, km, err_o)
    return results


def check_quant(quant, leaves, gen) -> dict:
    errs = {"quantize": 0.0, "dequantize": 0.0}
    bad = []
    mats = {}
    for path, leaf in leaves.items():
        x = leaf.detach().float().reshape(-1, leaf.shape[-1]).contiguous()
        v, s = quant.quantize_rowwise(x)
        v_ref, s_ref = quant.quantize_rowwise_plain(x)
        deq = quant.dequantize_rowwise(v, s)
        deq_ref = quant.dequantize_rowwise_plain(v, s)
        torch.cuda.synchronize()
        if not (torch.equal(v, v_ref) and torch.equal(s, s_ref)):
            bad.append(f"quantize {path}")
            errs["quantize"] = max(errs["quantize"], max_abs(v, v_ref))
        if not torch.equal(deq, deq_ref):
            bad.append(f"dequantize {path}")
            errs["dequantize"] = max(errs["dequantize"],
                                     max_abs(deq, deq_ref))
        mats[path] = (x, v, s)
    shapes = sorted({tuple(m[0].shape) for m in mats.values()})
    phase("K4 quantize bit-exact", not any(b.startswith("q") for b in bad),
          f"{len(mats)} BERT-base leaves, row shapes {shapes}; "
          f"mismatches {[b for b in bad if b.startswith('q')]}")
    phase("K5 dequantize exact", not any(b.startswith("d") for b in bad),
          f"{len(mats)} leaves; mismatches "
          f"{[b for b in bad if b.startswith('d')]}")

    # Stochastic rounding: kernel == plain (same Philox words), and the
    # mean over many seeds is unbiased.
    x = torch.randn(256, 768, device="cuda", generator=gen)
    v_k, s_k = quant.quantize_rowwise(x, stochastic=True, seed=11)
    v_p, _ = quant.quantize_rowwise_plain(x, stochastic=True, seed=11)
    same = torch.equal(v_k, v_p)
    n_seeds = 256
    acc = torch.zeros_like(x)
    for seed in range(n_seeds):
        acc += quant.dequantize_rowwise(
            *quant.quantize_rowwise(x, stochastic=True, seed=seed))
    bias = ((acc / n_seeds - x).abs() / s_k).max().item()
    det_bias = ((quant.dequantize_rowwise(*quant.quantize_rowwise(x)) - x)
                .abs() / s_k).mean().item()
    # Each draw is one of two neighbours a scale apart: the mean of 256
    # sits within 0.5/sqrt(256) = 0.031 scales per standard error; 0.2
    # allows > 6 standard errors over 196k entries.
    phase("K4 quantize stochastic", same and bias < 0.2,
          f"kernel==plain bits: {same}; max |mean-x|/scale over "
          f"{n_seeds} seeds = {bias:.4f} (deterministic mean error "
          f"{det_bias:.3f})")
    return {"mats": mats, **errs}


def _random_qkv(gen, bb, hh, tq, tk, dd, dtype, masked):
    q = torch.randn(bb, hh, tq, dd, device="cuda", generator=gen)
    k = torch.randn(bb, hh, tk, dd, device="cuda", generator=gen)
    v = torch.randn(bb, hh, tk, dd, device="cuda", generator=gen)
    do = torch.randn(bb, hh, tq, dd, device="cuda", generator=gen)
    km = None
    if masked:
        km = torch.rand(bb, tk, device="cuda", generator=gen) > 0.25
        km[1] = False  # a fully-masked batch row
    return (*(x.to(dtype) for x in (q, k, v, do)), km)


def check_flash_bwd(attention, gen) -> dict:
    """K2 and K3 against their plain versions: elementwise |d| <= tol *
    (1 + |ref|) (the JAX suite's f32 grad / bf16 tolerances as atol and
    rtol), exact zeros for the fully-masked row and the masked keys."""
    b, h, t, d = TRAIN_SHAPE
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # name, (B, H, Tq, Tk, D), dtype, causal, window, masked, tol
        ("path_bf16", (b, h, t, t, d), bf16, False, None, True, 3e-2),
        ("path_f32", (b, h, t, t, d), f32, False, None, True, 5e-5),
        ("long_bf16", (8, h, 512, 512, d), bf16, False, None, True, 3e-2),
        ("causal", (8, h, 256, 256, d), f32, True, None, True, 5e-5),
        ("causal_window", (4, h, 256, 256, 128), f32, True, 100, False,
         5e-5),
        ("unaligned", (4, h, 37, 41, d), f32, False, None, True, 5e-5),
        ("unaligned_bf16_causal_window", (2, h, 300, 300, 40), bf16, True,
         65, True, 3e-2),
        ("causal_window_bf16_d128", (4, h, 256, 256, 128), bf16, True, 100,
         True, 3e-2),
    ]
    results = {}
    for name, (bb, hh, tq, tk, dd), dtype, causal, window, masked, tol in \
            cases:
        q, k, v, do, km = _random_qkv(gen, bb, hh, tq, tk, dd, dtype, masked)
        args = (q, k, v, km, do)
        with torch.inference_mode():
            o, lse = attention.flash_attention_fwd(q, k, v, km, causal,
                                                   window)
            delta = (do.float() * o.float()).sum(-1, keepdim=True)
            args = (*args, lse, delta, causal, window)
            got = (attention.flash_attention_bwd_dq(*args),
                   *attention.flash_attention_bwd_dkv(*args))
            # The bf16 route sums in mma fragment order, not the plain
            # version's: it must still give the same bits every run.
            same = dtype != bf16 or all(
                torch.equal(g, r) for g, r in zip(got, (
                    attention.flash_attention_bwd_dq(*args),
                    *attention.flash_attention_bwd_dkv(*args))))
            torch.cuda.synchronize()
            ref = (attention.flash_attention_bwd_dq_plain(*args),
                   *attention.flash_attention_bwd_dkv_plain(*args))
        errs = [max_abs(g, r) for g, r in zip(got, ref)]
        close = all(bool(((g.float() - r.float()).abs()
                          <= tol * (1 + r.float().abs())).all())
                    for g, r in zip(got, ref))
        zeros = True
        if masked:
            dead = ~km[0]  # masked keys of batch row 0
            zeros = all(bool((g[1] == 0).all()) for g in got) and bool(
                (got[1][0][:, dead] == 0).all()) and bool(
                (got[2][0][:, dead] == 0).all())
        phase(f"K2/K3 flash_bwd {name} {tuple(q.shape)} "
              f"Tk={tk} {str(dtype)[6:]}", close and zeros and same,
              f"max|ddQ|={errs[0]:.3g} max|ddK|={errs[1]:.3g} "
              f"max|ddV|={errs[2]:.3g} exact_zeros(masked row, masked "
              f"keys)={zeros} tol={tol}*(1+|ref|)"
              + (f" run_to_run_bitwise={same}" if dtype == bf16 else ""))
        results[name] = {"errs": errs, "args": args}
    return results


def make_train_data(vocab: int):
    """250 seeded rows at T=128 with seeded pad tails and one all-pad row;
    the label is the parity of the [CLS]-position token (learnable)."""
    rng = np.random.default_rng(7)
    t = TRAIN_SHAPE[2]
    x = rng.integers(1, vocab, (TRAIN_ROWS, t)).astype(np.int32)
    for r, n in enumerate(rng.integers(16, t + 1, TRAIN_ROWS)):
        x[r, n:] = 0
    x[3] = 0  # an all-pad row: every key masked in every layer
    return x, (x[:, 0] % 2).astype(np.int32)


def check_train_vs_cpu(est) -> dict:
    """One batch of 4 rows (one all-pad) through BERT-base in f32 on the
    card (K1/K2/K3) and on the CPU (plain versions), from the same
    weights: the loss and every parameter's gradient."""
    from learningorchestra_tpu_torch.models.text import BertModel

    x, y = make_train_data(est.vocab_size)
    rows = [3, 0, 1, 2]
    t0 = time.perf_counter()
    cpu = BertModel(seed=est.seed, device="cpu")
    cpu.load_state_dict(est.state_dict())
    loss_fn = est._loss_and_metrics("softmax_ce")

    def loss_and_grads(e):
        e.module.zero_grad(set_to_none=True)
        xt = torch.from_numpy(x[rows]).to(e.device)
        yt = torch.from_numpy(y[rows]).to(e.device)
        loss, _ = loss_fn(e.module(xt).float(), yt,
                          torch.ones(len(rows), device=e.device))
        loss.backward()
        grads = {n: p.grad.detach().float().cpu()
                 for n, p in e.module.named_parameters()}
        e.module.zero_grad(set_to_none=True)
        return float(loss.detach()), grads

    loss_gpu, g_gpu = loss_and_grads(est)
    loss_cpu, g_cpu = loss_and_grads(cpu)
    cpu_s = time.perf_counter() - t0
    gmax = max(float(g.abs().max()) for g in g_cpu.values())
    worst, worst_name, bad = 0.0, "", []
    for name, gc in g_cpu.items():
        err = float((g_gpu[name] - gc).abs().max())
        ref = float(gc.abs().max())
        if err > GRAD_RTOL * ref + GRAD_ATOL_REL * gmax:
            bad.append(name)
        rel = err / max(ref, GRAD_ATOL_REL * gmax)
        if rel > worst:
            worst, worst_name = rel, name
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    phase("train step vs CPU plain path", not bad and loss_rel <= LOSS_RTOL,
          f"BERT-base f32, rows {rows} (first all-pad) at T={x.shape[1]}: "
          f"loss {loss_gpu:.6f} vs {loss_cpu:.6f} (rel {loss_rel:.2g}, tol "
          f"{LOSS_RTOL}); {len(g_cpu)} gradients, worst max|dg|/max|g| "
          f"{worst:.3g} ({worst_name}); tol {GRAD_RTOL}*max|g| + "
          f"{GRAD_ATOL_REL}*{gmax:.3g}; failing {bad[:5]} (CPU side "
          f"{cpu_s:.1f}s)")
    return {"loss_rel_err": loss_rel, "worst_grad_rel_err": worst,
            "worst_grad_param": worst_name}


def run_training(est, attention) -> dict:
    """The slice's training path through the entry points a user calls:
    ``fit`` then ``evaluate``, with the kernels' counters at 0 just before
    and read just after."""
    x, y = make_train_data(est.vocab_size)
    before = [p.detach().clone() for p in est.module.parameters()]
    marks = []

    def mark_epoch(epoch, metrics, model):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    attention.launches = 0
    attention.bwd_dq_launches = 0
    attention.bwd_dkv_launches = 0
    t0 = time.perf_counter()
    est.fit(x, y, epochs=TRAIN_EPOCHS, batch_size=TRAIN_SHAPE[0],
            callbacks=[mark_epoch])
    fit_s = time.perf_counter() - t0
    evaluation = est.evaluate(x, y)
    torch.cuda.synchronize()
    counts = {"flash_fwd": attention.launches,
              "flash_bwd_dq": attention.bwd_dq_launches,
              "flash_bwd_dkv": attention.bwd_dkv_launches}

    per_epoch = -(-TRAIN_ROWS // TRAIN_SHAPE[0])
    steps = TRAIN_EPOCHS * per_epoch
    eval_batches = -(-TRAIN_ROWS // 128)
    layers = est.num_layers
    expected = {"flash_fwd": layers * (steps + eval_batches),
                "flash_bwd_dq": layers * steps,
                "flash_bwd_dkv": layers * steps}
    losses = est.history["loss"]
    finite = all(math.isfinite(v) for v in losses + [evaluation["loss"]])
    moved = sum(1 for p, p0 in zip(est.module.parameters(), before)
                if not torch.equal(p.detach(), p0))
    epoch2_ms = marks[0].elapsed_time(marks[1])
    step_ms = epoch2_ms / per_epoch
    padded_tokens = per_epoch * TRAIN_SHAPE[0] * TRAIN_SHAPE[2]
    phase("train fit", finite and moved == len(before),
          f"BertModel L={layers} H={est.hidden_dim} bf16 compute / f32 "
          f"masters, {TRAIN_ROWS} rows T={TRAIN_SHAPE[2]}, batch "
          f"{TRAIN_SHAPE[0]}, {TRAIN_EPOCHS} epochs x {per_epoch} steps: "
          f"loss {losses}, accuracy {est.history['accuracy']}, evaluate "
          f"{evaluation}; {moved}/{len(before)} parameters moved; fit "
          f"{fit_s:.2f}s (epoch_time {est.history['epoch_time']})")
    phase("train launch counters", counts == expected,
          f"{counts}; expected K1 = {layers} x ({steps} steps + "
          f"{eval_batches} evaluate batches), K2 = K3 = {layers} x {steps}")
    return {
        "counts": counts, "x": x, "y": y,
        "train": {
            "epoch2_ms": epoch2_ms, "step_ms": step_ms,
            "samples_per_s": TRAIN_ROWS / (epoch2_ms / 1e3),
            "padded_tokens_per_s": padded_tokens / (epoch2_ms / 1e3),
            "nonpad_tokens_per_s": float((x != 0).sum())
            / (epoch2_ms / 1e3),
            "losses": losses, "evaluate": evaluation,
        },
    }


def device_kernels(prof) -> dict:
    """Device ms by kernel name from a torch.profiler run.  A user
    annotation (``Optimizer.step#Adam.step``) also shows a device-side
    range spanning its kernels: it is left out, not counted twice."""
    return {
        ev.key: ev.self_device_time_total / 1e3  # us -> ms
        for ev in prof.key_averages()
        if str(ev.device_type).endswith("CUDA")
        and not getattr(ev, "is_user_annotation", False)
    }


def _family(name: str, families: dict) -> str:
    low = name.lower()
    for fam, tags in families.items():
        if any(tag in low for tag in tags):
            return fam
    return "other"


def profile_train_step(est, x, y) -> dict:
    """One train step (a ``fit`` of one 32-row batch: upload, permute,
    forward, backward, Adam, the metrics' host transfer) by kernel family
    from torch.profiler; its wall time, measured apart without the
    profiler, gives the device's busy and idle share inside the step."""
    from torch.profiler import ProfilerActivity, profile

    bs = TRAIN_SHAPE[0]
    xs, ys = x[:bs], y[:bs]
    est.fit(xs, ys, epochs=1, batch_size=bs)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est.fit(xs, ys, epochs=1, batch_size=bs)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        est.fit(xs, ys, epochs=1, batch_size=bs)
        torch.cuda.synchronize()
    families = {
        "flash_bwd_dq": ("flash_bwd_dq",), "flash_bwd_dkv": ("flash_bwd_dkv",),
        "flash_fwd": ("flash_fwd",),
        "gemm": ("gemm", "cutlass", "xmma", "cublas", "nvjet"),
        "optimizer": ("multi_tensor_apply", "adam"),
    }
    totals = {fam: 0.0 for fam in (*families, "other")}
    kernels = device_kernels(prof)
    for name, ms in kernels.items():
        totals[_family(name, families)] += ms
    device_ms = sum(totals.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    events = prof.key_averages()
    launches = sum(ev.count for ev in events
                   if str(ev.device_type).endswith("CUDA")
                   and not getattr(ev, "is_user_annotation", False))
    host = sorted((ev for ev in events
                   if not str(ev.device_type).endswith("CUDA")),
                  key=lambda ev: -ev.self_cpu_time_total)[:8]
    return {
        "steps": 1, "wall_ms": wall_ms, "device_ms": device_ms,
        "busy_share": device_ms / wall_ms if device_ms else None,
        "idle_share": 1 - device_ms / wall_ms if device_ms else None,
        **{f"{k}_ms": v for k, v in totals.items()},
        "device_kernels": launches,
        "top": [[name[:60], ms] for name, ms in top],
        # Host self time under the profiler (which slows the host).
        "host_top": [[ev.key[:48], ev.count, ev.self_cpu_time_total / 1e3]
                     for ev in host],
    }


def time_bwd(attention, bwd_res) -> dict:
    """K2 and K3 in bf16 at the fine-tune shape ("train") and at (8, 12,
    512, 64) ("long"), each with a key mask with pad tails and no empty
    row: their plain versions, the backward of
    ``F.scaled_dot_product_attention`` with the same boolean mask (its
    fwd+bwd time minus its fwd time) as the yardstick for the pair, and K1
    beside its bound and SDPA's forward."""
    return {label: _time_bwd_at(attention, bwd_res[case]["args"])
            for label, case in (("train", "path_bf16"),
                                ("long", "long_bf16"))}


def _time_bwd_at(attention, args) -> dict:
    import torch.nn.functional as F

    q, k, v, _, do, *_ = args
    b, h, t, d = q.shape
    km = torch.ones(b, t, dtype=torch.bool, device="cuda")
    km[:, -37:] = False
    with torch.inference_mode():
        o, lse = attention.flash_attention_fwd(q, k, v, km)
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        args = (q, k, v, km, do, lse, delta)
        dq_ms = time_ms(lambda: attention.flash_attention_bwd_dq(*args),
                        reps=30)
        dkv_ms = time_ms(lambda: attention.flash_attention_bwd_dkv(*args),
                         reps=30)
        dq_plain = time_ms(
            lambda: attention.flash_attention_bwd_dq_plain(*args), reps=3)
        dkv_plain = time_ms(
            lambda: attention.flash_attention_bwd_dkv_plain(*args), reps=3)
        k1_ms = time_ms(lambda: attention.flash_attention_fwd(q, k, v, km),
                        reps=30)
        k1_plain = time_ms(
            lambda: attention.flash_attention_fwd_plain(q, k, v, km), reps=3)
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
    mask4 = km[:, None, None, :]

    def lib_fwd():
        return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask4)

    lib_fb = time_ms(lambda: torch.autograd.grad(lib_fwd(), (qg, kg, vg),
                                                 do), reps=30)
    lib_f = time_ms(lib_fwd, reps=30)
    elems = b * h * t * d * q.element_size()
    rows = 2 * b * h * t * 4 + b * t * 4  # LSE + delta, key mask
    work = {
        "dq": (6 * b * h * t * t * d, 5 * elems + rows),
        "dkv": (8 * b * h * t * t * d, 6 * elems + rows),
        # K1: q, k, v read, O written, LSE written, the key mask read.
        "k1": (4 * b * h * t * t * d, 4 * elems + b * h * t * 4 + b * t * 4),
    }
    out = {"shape": [b, h, t, d], "library_bwd_ms": lib_fb - lib_f,
           "library_fwd_bwd_ms": lib_fb, "library_fwd_ms": lib_f}
    for key, ms, plain in (("dq", dq_ms, dq_plain), ("dkv", dkv_ms,
                                                        dkv_plain),
                           ("k1", k1_ms, k1_plain)):
        flops, nbytes = work[key]
        by_ops = flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES
        out[key] = {
            "ms": ms, "plain_ms": plain, "flops": flops, "bytes": nbytes,
            "bound_ms": 1e3 * max(flops / PEAK_BF16_FLOPS,
                                  nbytes / PEAK_BYTES),
            "bound_by": "operations" if by_ops else "bytes",
        }
    return out


# -- phase 4: the slice ------------------------------------------------------


def request(port, verb, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(verb, "/api/learningOrchestra/v1" + path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def make_requests(vocab: int) -> list[np.ndarray]:
    rng = np.random.default_rng(2024)
    reqs = []
    for i in range(N_REQUESTS):
        rows = int(rng.integers(1, 9))
        x = rng.integers(1, vocab, (rows, SEQ_LEN)).astype(np.int32)
        for r in range(rows):
            x[r, int(rng.integers(16, SEQ_LEN + 1)):] = 0  # pad tail
        reqs.append(x)
    reqs[5][0] = 0  # an all-pad row: every key masked in every layer
    return reqs


def run_slice(est, tmp) -> dict:
    from learningorchestra_tpu_torch.api.server import APIServer
    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.ops import attention, quant
    from learningorchestra_tpu_torch.ops.quant import QuantizedLeaf
    from learningorchestra_tpu_torch.serve.service import ARTIFACT_TYPE
    from learningorchestra_tpu_torch.store.volumes import VolumeStorage
    from learningorchestra_tpu_torch.train.neural import load_artifact

    reqs = make_requests(est.vocab_size)
    volumes = VolumeStorage(tmp)
    cfg = Config(volume_root=tmp)

    # Main path: counters at 0 just before, read just after.
    attention.launches = 0
    quant.quantize_launches = 0
    quant.dequantize_launches = 0
    t0 = time.perf_counter()
    artifact = est.to_artifact(quantize=True)
    volumes.save_object(ARTIFACT_TYPE, "bert-base", artifact)
    save_s = time.perf_counter() - t0
    server = APIServer(cfg, volumes=volumes, device="cuda")
    port = server.start_background()
    try:
        t0 = time.perf_counter()
        status, body = request(port, "POST", "/serve/bert-base/load")
        load_s = time.perf_counter() - t0
        phase("slice load", status == 200,
              f"POST /serve/bert-base/load -> {status} "
              f"{body.get('result', body)} in {load_s:.2f}s "
              f"(artifact save {save_s:.2f}s)")
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(N_REQUESTS) as pool:
            answers = list(pool.map(
                lambda x: request(port, "POST", "/serve/bert-base/predict",
                                  {"instances": x.tolist()}), reqs))
        wall_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = {
            "flash_fwd": attention.launches,
            "quantize_rowwise": quant.quantize_launches,
            "dequantize_rowwise": quant.dequantize_launches,
        }
        status, listing = request(port, "GET", "/serve")
    finally:
        server.shutdown()

    stats = listing["stats"]["models"]["bert-base"]
    preds = []
    ok = True
    for x, (st, body) in zip(reqs, answers):
        p = np.asarray(body.get("predictions", []), np.float32)
        ok &= st == 200 and p.shape == (len(x), 2) and bool(
            np.isfinite(p).all())
        preds.append(p)
    rows = sum(len(x) for x in reqs)
    lat = sorted(b.get("latencyMs", 0.0) for _, b in answers)
    phase("slice predict", ok,
          f"{len(reqs)} concurrent requests, {rows} rows of T={SEQ_LEN}: "
          f"statuses {sorted({s for s, _ in answers})}, shapes (rows, 2), "
          f"finite; {stats['batches']} dispatches, buckets "
          f"{stats['bucketHistogram']}, wall {wall_s:.3f}s")

    n_quant = sum(1 for _ in _leaves_of(artifact["state"]["params"],
                                        QuantizedLeaf))
    dispatches = stats["batches"]
    phase("launch counters", counts["flash_fwd"] == 12 * dispatches
          and counts["dequantize_rowwise"] == n_quant
          and counts["quantize_rowwise"] == n_quant,
          f"{counts}; expected flash 12 x {dispatches} dispatches = "
          f"{12 * dispatches}, quantize = dequantize = {n_quant} leaves")

    # The same artifact on the CPU (plain attention, plain dequantize).
    picks = [(5, 0), (0, 0), (7, len(reqs[7]) - 1)]
    x_cpu = np.stack([reqs[i][r] for i, r in picks])
    t0 = time.perf_counter()
    ref = load_artifact(artifact, device="cpu").predict(x_cpu)
    cpu_s = time.perf_counter() - t0
    got = np.stack([preds[i][r] for i, r in picks])
    err = float(np.abs(got - ref).max())
    phase("slice vs CPU plain path", err <= CPU_ATOL,
          f"rows {picks} (first is all-pad): max|dlogit|={err:.3g} "
          f"atol={CPU_ATOL} (CPU {cpu_s:.1f}s)")
    return {
        "counts": counts,
        "serve": {
            "requests": len(reqs), "rows": rows, "dispatches": dispatches,
            "buckets": stats["bucketHistogram"], "wall_s": wall_s,
            "rows_per_s": rows / wall_s,
            "latency_ms_p50": lat[len(lat) // 2], "latency_ms_max": lat[-1],
            "artifact_save_s": save_s, "load_s": load_s,
            "cpu_max_abs_err": err,
        },
    }


def _leaves_of(tree, cls):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves_of(v, cls)
    elif isinstance(tree, cls):
        yield tree


# -- phase 5: timings --------------------------------------------------------


def time_fwd_f32(attention, q, k, v) -> dict:
    """K1's f32 route at the serving shape with a key mask with pad tails
    and no empty row: kernel, plain version and the forward of
    ``F.scaled_dot_product_attention`` with the same boolean mask, and the
    bound: the bytes (q, k, v read, O and LSE written, the mask read)
    against three TF32 products per f32 product (split TF32)."""
    import torch.nn.functional as F

    b, h, t, d = q.shape
    km = torch.ones(b, t, dtype=torch.bool, device="cuda")
    km[:, -37:] = False
    mask4 = km[:, None, None, :]
    with torch.inference_mode():
        flash_ms = time_ms(lambda: attention.flash_attention_fwd(q, k, v,
                                                                    km))
        plain_ms = time_ms(lambda: attention.flash_attention_fwd_plain(
            q, k, v, km), reps=3)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask4))
    flops = 4 * b * h * t * t * d
    nbytes = 4 * (4 * q.numel()) + 4 * km.numel() + 4 * b * h * t
    by_ops = 3 * flops / PEAK_TF32_FLOPS >= nbytes / PEAK_BYTES
    return {
        "shape": [b, h, t, d], "ms": flash_ms, "plain_ms": plain_ms,
        "library_ms": lib_ms, "flops": flops, "bytes": nbytes,
        "bound_ms": 1e3 * max(3 * flops / PEAK_TF32_FLOPS,
                              nbytes / PEAK_BYTES),
        "bound_by": "operations" if by_ops else "bytes",
    }


def sdpa_kernel_names(q, k, v) -> list:
    """The device kernels of one f32 ``scaled_dot_product_attention`` call
    with a boolean key mask (the yardstick's method, by name)."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    km = torch.ones(q.shape[0], k.shape[2], dtype=torch.bool, device="cuda")
    km[:, -37:] = False
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, k, v, attn_mask=km[:, None, None])
        torch.cuda.synchronize()
    return sorted(device_kernels(prof))


def time_kernels(flash_inputs, quant_mats, est) -> dict:
    from learningorchestra_tpu_torch.ops import attention, quant

    q, k, v, _, _ = flash_inputs["path_f32"]
    b = q.shape[0]
    fwd = time_fwd_f32(attention, q, k, v)

    mats = list(quant_mats.values())
    q_bytes = sum(x.numel() * 5 + x.shape[0] * 4 for x, _, _ in mats)
    dq_bytes = sum(v.numel() * 5 + v.shape[0] * 4 for _, v, _ in mats)

    def each(fn):
        return lambda: [fn(*args) for args in mats]

    quant_ms = time_ms(each(lambda x, v, s: quant.quantize_rowwise(x)),
                       reps=5)
    quant_plain_ms = time_ms(
        each(lambda x, v, s: quant.quantize_rowwise_plain(x)), reps=3)
    deq_ms = time_ms(each(lambda x, v, s: quant.dequantize_rowwise(v, s)),
                     reps=5)
    deq_plain_ms = time_ms(
        each(lambda x, v, s: quant.dequantize_rowwise_plain(v, s)), reps=3)
    deq_lib_ms = time_ms(each(lambda x, v, s: torch.mul(v, s)), reps=5)
    # What the artifact save / load wait for: the same launches paced by
    # the host.
    host_paced = {
        "quantize": time_ms(each(lambda x, v, s: quant.quantize_rowwise(x)),
                            reps=5, hide_launch=False),
        "dequantize": time_ms(
            each(lambda x, v, s: quant.dequantize_rowwise(v, s)), reps=5,
            hide_launch=False),
    }

    # One full serving bucket through the model, for the layer breakdown.
    x = torch.randint(1, est.vocab_size, (b, SEQ_LEN), device="cuda")
    with torch.inference_mode():
        forward_ms = time_ms(lambda: est.module(x), reps=5)
    return {
        "flash": fwd,
        "quant": (quant_ms, quant_plain_ms, 1e3 * q_bytes / PEAK_BYTES,
                  q_bytes),
        "dequant": (deq_ms, deq_plain_ms, 1e3 * dq_bytes / PEAK_BYTES,
                    deq_lib_ms, dq_bytes),
        "forward_ms": forward_ms,
        "host_paced_ms": host_paced,
    }


def profile_forward(est) -> dict:
    """Device time of one 64-row bucket through the model, by kernel
    family, from torch.profiler (CUPTI); the forward's wall time from CUDA
    events gives the device's idle share inside one dispatch."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randint(1, est.vocab_size, (PATH_SHAPE[0], SEQ_LEN),
                      device="cuda")
    with torch.inference_mode():
        forward_ms = time_ms(lambda: est.module(x), reps=1,
                             hide_launch=False)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            est.module(x)
            torch.cuda.synchronize()
    kernels = device_kernels(prof)
    families = {"flash_fwd": 0.0, "gemm": 0.0, "other": 0.0}
    for name, ms in kernels.items():
        low = name.lower()
        fam = "flash_fwd" if "flash_fwd" in low else "gemm" if any(
            tag in low for tag in ("gemm", "cutlass", "xmma", "cublas")
        ) else "other"
        families[fam] += ms
    device_ms = sum(families.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return {
        "forward_ms": forward_ms, "device_ms": device_ms,
        "idle_share": 1 - device_ms / forward_ms if device_ms else None,
        **{f"{k}_ms": v for k, v in families.items()},
        "top": [[name[:60], ms] for name, ms in top],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a GPU", file=sys.stderr)
        return 2
    try:
        from learningorchestra_tpu_torch import convert
        from learningorchestra_tpu_torch.kernels import build
        from learningorchestra_tpu_torch.models.text import BertModel
        from learningorchestra_tpu_torch.ops import attention, quant
    except ImportError as exc:
        print(f"chip_smoke: the port's package is missing beside this "
              f"script ({exc})", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    phase("device", smi.returncode == 0,
          f"{torch.cuda.get_device_name(0)}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(card, flush=True)

    t0 = time.perf_counter()
    try:
        secs = build.build()
        phase("build", True, f"{ {k: round(v, 2) for k, v in secs.items()} } "
              f"wall {time.perf_counter() - t0:.2f}s (nvcc -gencode "
              "arch=compute_90a,code=sm_90a, one process per source)")
    except build.KernelBuildError as exc:
        phase("build", False, str(exc))
        return 1
    tc, spilled = [], []
    for name, log in build.build_log.items():
        report = ptxas_report(log)
        print(f"  ptxas {name}: " + "; ".join(
            f"{k} {regs} registers, spill stores {st} B, loads {ld} B"
            for k, regs, st, ld in report), flush=True)
        tc += [k for k, *_ in report if "_tc_" in k]
        spilled += [k for k, _, st, ld in report if st or ld]
    families = {k.split("_tc_")[0] for k in tc}
    phase("tensor-core registers",
          {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"} <= families
          and not any("_tc_" in k for k in spilled),
          f"tensor-core instances {tc}; kernels that spill: {spilled}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    est = BertModel(seed=0, device="cuda")  # BERT-base, L=12 H=768 A=12
    phase("model", True,
          f"BertModel(L={est.num_layers}, H={est.hidden_dim}, "
          f"A={est.num_heads}, MLP={est.mlp_dim}, vocab={est.vocab_size}, "
          f"max_len={est.max_len}) seeded init in "
          f"{time.perf_counter() - t0:.1f}s")

    flash_inputs = check_flash(attention, gen)
    bwd_res = check_flash_bwd(attention, gen)
    tree = convert.flax_tree(est.module)
    leaves = {
        "/".join(p): t for p, t in _flat(tree)
        if t.dim() >= 2 and t.numel() >= 4096
    }
    quant_res = check_quant(quant, leaves, gen)

    grad_res = check_train_vs_cpu(est)
    train_res = run_training(est, attention)
    try:
        train_prof = profile_train_step(est, train_res["x"], train_res["y"])
    except Exception as exc:  # noqa: BLE001 — where CUPTI tracing is
        # unavailable this breakdown is reported as not measured.
        train_prof = {"not_measured": repr(exc)}

    # The trained model is what the serving path saves and serves.
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        slice_res = run_slice(est, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    timing = time_kernels(flash_inputs, quant_res["mats"], est)
    bwd_times = time_bwd(attention, bwd_res)
    bwd_t = bwd_times["train"]
    fwd = timing["flash"]
    k1_bf16 = bwd_t["k1"]
    q_ms, q_plain, q_bound, q_bytes = timing["quant"]
    d_ms, d_plain, d_bound, d_lib, d_bytes = timing["dequant"]
    counts = slice_res["counts"]
    train_counts = train_res["counts"]
    path_errs = bwd_res["path_bf16"]["errs"]
    kernels = [
        # K1's two routes: f32 (split TF32) on the serving path, bf16 on
        # the training path; one launch counter, read after each path.
        {"name": "flash_fwd", "route": "cuda",
         "source": "learningorchestra_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "learningorchestra_tpu/ops/attention.py:167",
         "launches": counts["flash_fwd"],
         "max_abs_err": flash_inputs["path_f32"][4],
         "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
         "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
         "library_ms": fwd["library_ms"]},
        {"name": "flash_fwd_bf16", "route": "cuda",
         "source": "learningorchestra_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "learningorchestra_tpu/ops/attention.py:167",
         "launches": train_counts["flash_fwd"],
         "max_abs_err": flash_inputs["train_bf16"][4],
         "ms": k1_bf16["ms"], "plain_ms": k1_bf16["plain_ms"],
         "bound_ms": k1_bf16["bound_ms"], "bound_by": k1_bf16["bound_by"],
         "library_ms": bwd_t["library_fwd_ms"]},
        {"name": "quantize_rowwise", "route": "cuda",
         "source": "learningorchestra_tpu_torch/csrc/quant.cu",
         "replaces": "learningorchestra_tpu/ops/quant.py:29",
         "launches": counts["quantize_rowwise"],
         "max_abs_err": quant_res["quantize"],
         "ms": q_ms, "plain_ms": q_plain, "bound_ms": q_bound,
         "bound_by": "bytes", "library_ms": None},
        {"name": "dequantize_rowwise", "route": "cuda",
         "source": "learningorchestra_tpu_torch/csrc/quant.cu",
         "replaces": "learningorchestra_tpu/ops/quant.py:56",
         "launches": counts["dequantize_rowwise"],
         "max_abs_err": quant_res["dequantize"],
         "ms": d_ms, "plain_ms": d_plain, "bound_ms": d_bound,
         "bound_by": "bytes", "library_ms": d_lib},
        *({"name": f"flash_bwd_{key}", "route": "cuda",
           "source": "learningorchestra_tpu_torch/csrc/flash_bwd.cu",
           "replaces": f"learningorchestra_tpu/ops/attention.py:{line}",
           "launches": train_counts[f"flash_bwd_{key}"],
           "max_abs_err": err, "ms": bwd_t[key]["ms"],
           "plain_ms": bwd_t[key]["plain_ms"],
           "bound_ms": bwd_t[key]["bound_ms"],
           "bound_by": bwd_t[key]["bound_by"],
           "library_ms": bwd_t["library_bwd_ms"]}
          for key, line, err in (("dq", 245, path_errs[0]),
                                 ("dkv", 297, max(path_errs[1:])))),
    ]
    try:
        prof = profile_forward(est)
    except Exception as exc:  # noqa: BLE001 — where CUPTI tracing is
        # unavailable this breakdown is reported as not measured.
        prof = {"not_measured": repr(exc)}
    print("profile " + json.dumps(prof), flush=True)
    print("train_profile " + json.dumps(train_prof), flush=True)
    print("train " + json.dumps({**train_res["train"], **grad_res,
                                 "counts": train_counts}), flush=True)
    print("bwd_timing " + json.dumps(bwd_times), flush=True)
    print("fwd_timing_f32 " + json.dumps(fwd), flush=True)
    q, k, v, _, _ = flash_inputs["path_f32"]
    try:
        sdpa = sdpa_kernel_names(q, k, v)
    except Exception as exc:  # noqa: BLE001 — as for the profiles above
        sdpa = {"not_measured": repr(exc)}
    print("sdpa_f32_kernels " + json.dumps(sdpa), flush=True)
    print(f"launches by path: train {train_counts}, serve {counts}; "
          "flash_fwd is K1's f32 route at the serving shape (launches: the "
          "serving path), flash_fwd_bf16 its bf16 route at the fine-tune "
          "shape (launches: the training path); "
          "library_ms of flash_bwd_dq and flash_bwd_dkv is ONE number: the "
          "backward of scaled_dot_product_attention (bf16, boolean mask), "
          "which computes K2 and K3's outputs together", flush=True)
    serve = slice_res["serve"]
    serve["forward_ms_bucket64"] = timing["forward_ms"]
    serve["flash_share_of_forward"] = 12 * fwd["ms"] / timing["forward_ms"]
    print("serve " + json.dumps(serve), flush=True)
    print("timing shapes: flash_bwd (B,H,T,D)=" + str(TRAIN_SHAPE)
          + f" bf16, dq {bwd_t['dq']['flops'] / 1e9:.2f} GFLOP "
          f"{bwd_t['dq']['bytes'] / 1e6:.1f} MB, dkv "
          f"{bwd_t['dkv']['flops'] / 1e9:.2f} GFLOP "
          f"{bwd_t['dkv']['bytes'] / 1e6:.1f} MB (bounds at "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16, "
          f"{PEAK_BYTES / 1e12} TB/s); flash fwd (B,H,T,D)=" + str(PATH_SHAPE)
          + f" f32, {fwd['flops'] / 1e9:.2f} GFLOP (x3 in TF32 at "
          f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s), {fwd['bytes'] / 1e6:.1f} "
          f"MB; "
          f"quantize/dequantize = every quantized leaf of the artifact "
          f"once ({q_bytes / 1e6:.1f} / {d_bytes / 1e6:.1f} MB); kernel "
          f"ms are device time (launches queued behind a device sleep); "
          f"paced by the host's launches they take "
          f"{json.dumps(timing['host_paced_ms'])} ms", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    if failures:
        print("chip_smoke FAILED:\n  " + "\n  ".join(failures),
              file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


if __name__ == "__main__":
    sys.exit(main())
