"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py

Phases (each prints its own line; any failure exits nonzero):

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds every kernel source under
   learningorchestra_tpu_torch/csrc/, all at once;
3. kernels against their plain PyTorch versions, on the card:
   K1 flash-attention forward at the serving shape (64, 12, 512, 64) f32
   with a key mask and a fully-masked row, plus bf16, causal,
   causal+window and unaligned lengths; K4 quantize bit-exact on every
   quantized leaf of a BERT-base model plus a stochastic mean-bias check;
   K5 dequantize exact;
4. the slice: a BERT-base model (full width and depth, random weights
   from a seeded torch.Generator) saved as an int8 artifact, loaded by
   the port's REST server on the card, and ~24 concurrent predicts of
   1-8 rows at T=512 answered through coalesced bucket dispatches; every
   answer is checked for status, shape and finiteness, a few rows against
   the same artifact run on the CPU (plain path), and the kernels' launch
   counters against the dispatches;
5. timings (CUDA events, after warm-up), a torch.profiler breakdown of
   one 64-row bucket by kernel family, and the `kernels` JSON line;
6. last line: {"ok": true, "device": {...}}.

Without a visible GPU, or without the repository beside it, it exits
nonzero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import http.client
import json
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet), used for bound_ms.
PEAK_F32_FLOPS = 67e12  # CUDA cores, no tensor cores
PEAK_BYTES = 3.35e12  # HBM3

PATH_SHAPE = (64, 12, 512, 64)  # largest serving bucket, BERT-base heads
SEQ_LEN = 512
N_REQUESTS = 24
CPU_ATOL = 1e-3
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
            torch.cuda.synchronize()
            o_ref, lse_ref = attention.flash_attention_fwd_plain(
                q, k, v, km, causal, window)
        err_o = max_abs(o, o_ref)
        err_lse = max_abs(lse, lse_ref)
        empty_ok = True
        if masked:
            empty_ok = bool((o[1] == 0).all()) and bool((lse[1] == 1e30).all())
        ok = err_o <= tol and err_lse <= tol and empty_ok
        phase(f"K1 flash_fwd {name} {tuple(q.shape)} {str(dtype)[6:]}", ok,
              f"max|dO|={err_o:.3g} max|dLSE|={err_lse:.3g} "
              f"masked_row_zero={empty_ok} tol={tol}")
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


def time_kernels(flash_inputs, quant_mats, est) -> dict:
    import torch.nn.functional as F

    from learningorchestra_tpu_torch.ops import attention, quant

    q, k, v, km, _ = flash_inputs["path_f32"]
    km = torch.ones_like(km)  # library yardstick: no fully-masked row
    km[:, -37:] = False
    b, h, t, d = q.shape
    with torch.inference_mode():
        flash_ms = time_ms(lambda: attention.flash_attention_fwd(q, k, v,
                                                                    km))
        plain_ms = time_ms(lambda: attention.flash_attention_fwd_plain(
            q, k, v, km), reps=3)
        mask4 = km[:, None, None, :]
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask4))
    flops = 4 * b * h * t * t * d
    nbytes = 4 * (4 * q.numel()) + 4 * km.numel() + 4 * b * h * t
    flash_bound = 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)

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
        "flash": (flash_ms, plain_ms, flash_bound, lib_ms, flops, nbytes),
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
    kernels = {}
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA"):
            kernels[ev.key] = ev.self_device_time_total / 1e3  # us -> ms
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
    for name, log in build.build_log.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  ptxas {name}: {regs}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    est = BertModel(seed=0, device="cuda")  # BERT-base, L=12 H=768 A=12
    phase("model", True,
          f"BertModel(L={est.num_layers}, H={est.hidden_dim}, "
          f"A={est.num_heads}, MLP={est.mlp_dim}, vocab={est.vocab_size}, "
          f"max_len={est.max_len}) seeded init in "
          f"{time.perf_counter() - t0:.1f}s")

    flash_inputs = check_flash(attention, gen)
    tree = convert.flax_tree(est.module)
    leaves = {
        "/".join(p): t for p, t in _flat(tree)
        if t.dim() >= 2 and t.numel() >= 4096
    }
    quant_res = check_quant(quant, leaves, gen)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        slice_res = run_slice(est, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    timing = time_kernels(flash_inputs, quant_res["mats"], est)
    f_ms, f_plain, f_bound, f_lib, flops, f_bytes = timing["flash"]
    q_ms, q_plain, q_bound, q_bytes = timing["quant"]
    d_ms, d_plain, d_bound, d_lib, d_bytes = timing["dequant"]
    counts = slice_res["counts"]
    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "learningorchestra_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "learningorchestra_tpu/ops/attention.py:167",
         "launches": counts["flash_fwd"],
         "max_abs_err": flash_inputs["path_f32"][4],
         "ms": f_ms, "plain_ms": f_plain, "bound_ms": f_bound,
         "bound_by": "operations" if flops / PEAK_F32_FLOPS
         >= f_bytes / PEAK_BYTES else "bytes",
         "library_ms": f_lib},
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
    ]
    try:
        prof = profile_forward(est)
    except Exception as exc:  # noqa: BLE001 — where CUPTI tracing is
        # unavailable this breakdown is reported as not measured.
        prof = {"not_measured": repr(exc)}
    print("profile " + json.dumps(prof), flush=True)
    serve = slice_res["serve"]
    serve["forward_ms_bucket64"] = timing["forward_ms"]
    serve["flash_share_of_forward"] = 12 * f_ms / timing["forward_ms"]
    print("serve " + json.dumps(serve), flush=True)
    print("timing shapes: flash (B,H,T,D)=" + str(PATH_SHAPE)
          + f" f32, {flops / 1e9:.2f} GFLOP, {f_bytes / 1e6:.1f} MB; "
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
