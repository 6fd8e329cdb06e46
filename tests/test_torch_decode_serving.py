"""The port's streaming LM decode engine (serve/decode/) over live HTTP,
mirroring ``tests/test_decode_serving.py``'s cases that need neither the
program cache nor the operations plane: SSE round trips, continuous
batching under mid-flight admission, stream teardown within one step,
and the stdlib client's bindings; then a JAX and a port server given the
same DecoderLM, train and ``/generate`` bodies, which must answer the
same tokens (the batch predict job with ``"method": "generate"``
included).

The invariant everything rests on: a prompt admitted into an in-flight
pool (other rows mid-generation, free slots present) decodes exactly
what a solo ``generate`` of it decodes.  The tests slow the steps with
an armed ``serve.decode_step`` delay, as the JAX ones do (the point fires
on the host after the abort sweep, before the step program).
"""

import json
import socket
import threading
import time

import jax
import numpy as np
import pytest
import requests

from learningorchestra_tpu.client import ClientError, Context
from learningorchestra_tpu_torch import faults
from learningorchestra_tpu_torch.api.server import APIServer
from learningorchestra_tpu_torch.config import Config, StoreConfig
from learningorchestra_tpu_torch.models.text import DecoderLM
from learningorchestra_tpu_torch.serve.decode import streams as dec_streams
from tests.torch_rest_pair import data_rows, server_pair

PREFIX = "/api/learningOrchestra/v1"
LM = dict(vocab_size=16, hidden_dim=32, num_layers=2, num_heads=4,
          max_len=16)


def _naive(est, prompts, total):
    """Greedy continuation by a full re-forward per token (the port's
    ``tests/lm_oracle.py``)."""
    prompts = np.asarray(prompts, np.int32)
    buf = np.zeros((len(prompts), total), np.int32)
    buf[:, :prompts.shape[1]] = prompts
    for cur in range(prompts.shape[1], total):
        buf[:, cur] = est.predict(buf)[:, cur - 1].argmax(-1)
    return buf


def _install_trained_lm(server, name):
    """A finished train artifact holding a fitted tiny DecoderLM."""
    rng = np.random.default_rng(7)
    x = rng.integers(1, LM["vocab_size"], size=(16, LM["max_len"] - 2))
    x = x.astype(np.int32)
    y = np.concatenate([x[:, 1:], np.zeros((16, 1), np.int32)], axis=1)
    est = DecoderLM(**LM, seed=0, device="cpu")
    est.compute_dtype = "float32"
    est.fit(x, y, epochs=2, batch_size=16)
    server.ctx.volumes.save_estimator("train/pytorch", name, est)
    server.ctx.artifacts.metadata.create(name, "train/pytorch")
    server.ctx.artifacts.metadata.mark_finished(name)
    return est


@pytest.fixture(scope="module")
def decode_api(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("decode_api")
    server = APIServer(Config(store=StoreConfig(
        root=str(tmp / "store"), volume_root=str(tmp / "volumes"))),
        device="cpu")
    port = server.start_background()
    est = _install_trained_lm(server, "lm_srv")
    yield server, f"http://127.0.0.1:{port}{PREFIX}", est
    server.shutdown()


class _StepDelay:
    """``delay[0] = seconds`` (re)arms the ``serve.decode_step`` delay:
    timing only, the math is untouched."""

    def __setitem__(self, index, seconds):
        assert index == 0
        faults.arm("serve.decode_step", "delay", delay_ms=seconds * 1e3)


@pytest.fixture
def slow_steps():
    """Delay every decode step by 50 ms through the fault plane; the
    test may re-arm it (``slow_steps[0] = 0.15``).  Disarmed after."""
    delay = _StepDelay()
    delay[0] = 0.05
    try:
        yield delay
    finally:
        faults.disarm_all()


def _solo(est, prompt, new):
    return est.generate(np.asarray([prompt], np.int32),
                        max_new_tokens=new)[0].tolist()


def _parse_sse(resp):
    """[(event, data-json)] from a requests streaming response."""
    events, event, data = [], None, []
    for raw in resp.iter_lines():
        line = raw.decode() if isinstance(raw, bytes) else raw
        if line:
            if line.startswith("event:"):
                event = line[len("event:"):].strip()
            elif line.startswith("data:"):
                data.append(line[len("data:"):].strip())
            continue
        if event is None and not data:
            continue
        events.append((event, json.loads("\n".join(data) or "{}")))
        event, data = None, []
    return events


class TestSSERoundTrip:
    def test_stream_matches_solo_generate(self, decode_api):
        _, base, est = decode_api
        prompt = [5, 1, 2, 9]
        resp = requests.post(
            f"{base}/serve/lm_srv/generate",
            json={"prompts": [prompt], "stream": True, "maxNewTokens": 8},
            stream=True, timeout=60)
        assert resp.status_code == 200, resp.text
        assert resp.headers["Content-Type"].startswith("text/event-stream")
        events = _parse_sse(resp)
        names = [e for e, _ in events]
        assert names[0] == "open" and names[-1] == "done"
        toks = [doc["t"] for e, doc in events if e == "token"]
        assert prompt + toks == _solo(est, prompt, 8)
        done = events[-1][1]
        assert done["promptTokens"] == len(prompt)
        assert done["newTokens"] == 8
        assert done["ttftMs"] is not None

    def test_nonstream_json_matches_and_is_batched(self, decode_api):
        server, base, est = decode_api
        prompts = [[5, 1, 2, 9], [3, 3, 7, 1]]
        resp = requests.post(f"{base}/serve/lm_srv/generate",
                             json={"prompts": prompts, "maxNewTokens": 8},
                             timeout=60)
        assert resp.status_code == 200, resp.text
        assert resp.json()["tokens"] == _naive(est, prompts, 12).tolist()
        stats = server.serving.decode.stats()["models"]["lm_srv"]
        assert stats["pools"], "no KV page pool was created"
        assert server.serving.stats()["decode"]["enabled"] is True

    def test_decode_warm_shapes_recorded(self, decode_api):
        server, _, _ = decode_api
        entry = server.serving.registry.get("lm_srv")
        assert entry.decode_warm
        for slots, kvlen in entry.decode_warm:
            assert slots & (slots - 1) == 0  # power-of-two buckets
            assert kvlen & (kvlen - 1) == 0

    def test_validation_errors_are_406(self, decode_api):
        _, base, _ = decode_api
        for body in ({"prompts": [[0, 1]], "maxNewTokens": 2},  # pad id
                     {"prompts": [list(range(1, 17))]},  # at capacity
                     {"prompts": [[1, 2]], "topK": 3},  # top_k, no temp
                     {"prompts": [[1, 2], [3, 4]], "stream": True},
                     {"prompts": [[1, 2]], "stream": True,
                      "temperature": 1.0},
                     {"maxNewTokens": 2}):
            resp = requests.post(f"{base}/serve/lm_srv/generate", json=body,
                                 timeout=30)
            assert resp.status_code == 406, (body, resp.text)
        resp = requests.post(f"{base}/serve/nosuch/generate",
                             json={"prompts": [[1]]}, timeout=30)
        assert resp.status_code == 404


class TestEngineLifecycle:
    def test_beyond_max_streams_is_429(self, decode_api, slow_steps):
        server, base, _ = decode_api
        slow_steps[0] = 0.15  # the held stream outlives the second POST
        cfg = server.serving.decode.cfg
        saved = cfg.max_streams
        cfg.max_streams = 1
        try:
            held = server.serving.decode.generate(
                "lm_srv", [1, 2, 3], max_new_tokens=12, stream=True)
            resp = requests.post(f"{base}/serve/lm_srv/generate",
                                 json={"prompts": [[4, 5]]}, timeout=30)
            assert resp.status_code == 429, resp.text
            assert resp.json()["retryAfter"] == \
                server.config.serve.retry_after_s
            assert resp.headers["Retry-After"]
            held.abort()
            assert held.wait_done(10)
        finally:
            cfg.max_streams = saved

    def test_idle_worker_parks_and_invalidation_drops_the_decoder(
            self, decode_api):
        server, _, est = decode_api
        eng = server.serving.decode
        cfg = eng.cfg
        saved = cfg.idle_timeout_s
        cfg.idle_timeout_s = 0.05
        try:
            eng.generate("lm_srv", [[3, 4]], max_new_tokens=2)
            decoder = eng._decoders["lm_srv"]
            deadline = time.monotonic() + 10
            while decoder._thread is not None and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            # Parked: no worker, the KV pools freed; the next request
            # starts it again.
            assert decoder._thread is None
            assert eng.stats()["models"]["lm_srv"]["pools"] == []
            out = eng.generate("lm_srv", [[3, 4]], max_new_tokens=2)
            assert out["tokens"][0] == _solo(est, [3, 4], 2)
        finally:
            cfg.idle_timeout_s = saved
        # A replaced artifact drops the model's decoder with its params.
        server.ctx.notify_artifact_changed("lm_srv")
        assert "lm_srv" not in eng.stats()["models"]
        assert server.serving.registry.list() == []

    def test_decode_knobs_read_the_jax_environment_names(self, monkeypatch):
        from learningorchestra_tpu.config import Config as JaxConfig

        env = {"LO_TPU_DECODE_ENABLED": "0", "LO_TPU_DECODE_MAX_SLOTS": "4",
               "LO_TPU_DECODE_MAX_KV": "512",
               "LO_TPU_DECODE_MAX_STREAMS": "9",
               "LO_TPU_DECODE_MAX_NEW": "33", "LO_TPU_DECODE_IDLE_S": "1.5"}
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        port, ref = Config.from_env().decode, JaxConfig.from_env().decode
        assert port.max_kv == 512 and not port.enabled
        assert vars(port) == vars(ref)
        assert vars(Config().decode) == vars(JaxConfig().decode)

    def test_engine_off_serves_json_through_the_solo_loop(self, decode_api):
        server, base, est = decode_api
        cfg = server.serving.decode.cfg
        cfg.enabled = False
        try:
            resp = requests.post(f"{base}/serve/lm_srv/generate",
                                 json={"prompts": [[5, 6, 7]],
                                       "maxNewTokens": 4}, timeout=30)
            assert resp.status_code == 200, resp.text
            assert resp.json()["tokens"][0] == _solo(est, [5, 6, 7], 4)
            resp = requests.post(f"{base}/serve/lm_srv/generate",
                                 json={"prompts": [[5, 6, 7]],
                                       "stream": True}, timeout=30)
            assert resp.status_code == 406
        finally:
            cfg.enabled = True


class TestContinuousBatching:
    def test_midflight_admission_is_bit_identical(self, decode_api,
                                                  slow_steps):
        """A prompt admitted while another stream is mid-generation (same
        KV bucket, so the same pool, a live foreign row and free slots)
        decodes exactly the solo result, and A is not perturbed."""
        server, _, est = decode_api
        eng = server.serving.decode
        a = eng.generate("lm_srv", [7, 2, 4, 1], max_new_tokens=12,
                         stream=True)
        deadline = time.monotonic() + 30
        while len(a.tokens) < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert 0 < len(a.tokens) < 12, "stream A not mid-flight"
        prompt_b = [3, 9, 1, 5, 2, 8, 4, 6]  # total 16: A's KV bucket
        out = eng.generate("lm_srv", [prompt_b], max_new_tokens=8)
        assert out["tokens"][0] == _solo(est, prompt_b, 8)
        assert a.wait_done(30)
        assert [7, 2, 4, 1] + a.tokens == _solo(est, [7, 2, 4, 1], 12)

    def test_concurrent_streams_share_one_pool(self, decode_api):
        server, _, est = decode_api
        eng = server.serving.decode
        prompts = [[1, 2, 3, 4], [9, 8, 7, 6], [2, 2, 4, 4]]
        results = [None] * len(prompts)

        def one(i):
            results[i] = eng.generate("lm_srv", [prompts[i]],
                                      max_new_tokens=8)

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        oracle = _naive(est, prompts, 12)
        for i, res in enumerate(results):
            assert res is not None
            assert res["tokens"][0] == oracle[i].tolist()
        pools = eng.stats()["models"]["lm_srv"]["pools"]
        assert [p["kv"] for p in pools] == [16]


class TestStreamTeardown:
    def test_abort_frees_kv_within_one_step(self, decode_api, slow_steps):
        server, _, _ = decode_api
        eng = server.serving.decode
        slow_steps[0] = 0.15
        stream = eng.generate("lm_srv", [4, 4, 2, 1], max_new_tokens=12,
                              stream=True)
        deadline = time.monotonic() + 30
        while not stream.tokens and time.monotonic() < deadline:
            time.sleep(0.005)
        assert stream.tokens, "stream never produced a token"
        steps_at_abort = eng.stats()["models"]["lm_srv"]["steps"]
        assert eng.abort("lm_srv", stream.stream_id)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            st = eng.stats()["models"]["lm_srv"]
            if st["activeStreams"] == 0 and all(
                    p["live"] == 0 for p in st["pools"]):
                break
            time.sleep(0.01)
        assert st["activeStreams"] == 0
        assert all(p["live"] == 0 for p in st["pools"])
        assert st["steps"] - steps_at_abort <= 1, (
            "the slot must be freed at the next step boundary")
        assert stream.done() and stream.token.cancelled()

    def test_delete_route_aborts_then_404(self, decode_api, slow_steps):
        server, base, _ = decode_api
        slow_steps[0] = 0.15
        stream = server.serving.decode.generate(
            "lm_srv", [6, 1, 3, 2], max_new_tokens=12, stream=True)
        resp = requests.delete(
            f"{base}/serve/lm_srv/generate/{stream.stream_id}", timeout=30)
        assert resp.status_code == 200, resp.text
        assert resp.json()["aborted"] == stream.stream_id
        assert stream.wait_done(10)
        resp = requests.delete(
            f"{base}/serve/lm_srv/generate/{stream.stream_id}", timeout=30)
        assert resp.status_code == 404

    def test_client_disconnect_aborts_the_stream(self, decode_api,
                                                 slow_steps, monkeypatch):
        """A broken pipe mid-body is the client's abort: the slot frees."""
        server, base, _ = decode_api
        slow_steps[0] = 0.05
        reasons = []
        real_abort = dec_streams.DecodeStream.abort

        def abort(stream, reason="aborted"):
            reasons.append(reason)
            real_abort(stream, reason)

        monkeypatch.setattr(dec_streams.DecodeStream, "abort", abort)
        port = int(base.split(":")[2].split("/")[0])
        body = json.dumps({"prompts": [[2, 5, 2, 5]], "stream": True,
                           "maxNewTokens": 12}).encode()
        sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        sock.sendall(
            f"POST {PREFIX}/serve/lm_srv/generate HTTP/1.1\r\n"
            f"Host: 127.0.0.1\r\nContent-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        seen = b""
        while b"event: token" not in seen:
            seen += sock.recv(4096)
        sock.close()  # hang up mid-stream
        eng = server.serving.decode
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and \
                eng.stats()["models"]["lm_srv"]["activeStreams"]:
            time.sleep(0.02)
        st = eng.stats()["models"]["lm_srv"]
        assert reasons == ["client disconnected"]
        assert st["activeStreams"] == 0
        assert all(p["live"] == 0 for p in st["pools"])


class TestClientBindings:
    def test_generate_stream_and_fallback(self, decode_api):
        server, base, est = decode_api
        port = int(base.split(":")[2].split("/")[0])
        ctx = Context(f"http://127.0.0.1:{port}")
        prompt = [2, 7, 1, 4]
        solo = _solo(est, prompt, 6)
        out = ctx.serve.generate("lm_srv", [prompt], max_new_tokens=6)
        assert out["tokens"][0] == solo
        toks, names = [], []
        for event, doc in ctx.serve.generate("lm_srv", prompt, stream=True,
                                             max_new_tokens=6):
            names.append(event)
            if event == "token":
                toks.append(doc["t"])
        assert names[0] == "open" and names[-1] == "done"
        assert prompt + toks == solo
        # Sampling runs the solo loop: in range, never pad 0.
        sampled = ctx.serve.generate("lm_srv", [prompt], max_new_tokens=6,
                                     temperature=0.9, top_k=4, seed=3)
        assert sampled["sampled"] is True
        new = sampled["newTokens"][0]
        assert len(new) == 6 and all(0 < t < LM["vocab_size"] for t in new)
        stream = server.serving.decode.generate(
            "lm_srv", [prompt], max_new_tokens=2, stream=True)
        assert stream.wait_done(30)
        with pytest.raises(ClientError) as exc:
            ctx.serve.abort_stream("lm_srv", stream.stream_id)
        assert exc.value.status == 404


def test_jax_and_port_servers_generate_the_same_tokens(tmp_path):
    """The same DecoderLM model, train, /generate (JSON and SSE) and batch
    generate bodies on a JAX and a port server: the same tokens."""
    rng = np.random.default_rng(3)
    x = rng.integers(1, LM["vocab_size"], (16, 12)).astype(np.int32)
    y = np.concatenate([x[:, 1:], np.zeros((16, 1), np.int32)], 1)
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]]
    with server_pair(tmp_path) as (servers, clients):
        for side, ctx in clients.items():
            ctx.model.create(
                "lm", module_path="learningorchestra_tpu.models.text",
                class_name="DecoderLM", class_parameters=dict(LM, seed=0))
            ctx.observe.wait("lm", timeout=120)
        # The JAX model's initial parameters into both binaries, f32.
        jvols = servers["jax"].ctx.volumes
        jest = jvols.read_object("model/tensorflow", "lm")
        jest.compute_dtype = "float32"
        jest._init_params(x[:1])
        jvols.save_object("model/tensorflow", "lm", jest)
        pvols = servers["port"].ctx.volumes
        pest = pvols.load_estimator("model/tensorflow", "lm", device="cpu")
        pest.load_state_dict({"params": jax.tree_util.tree_map(
            np.asarray, jest.params)})
        pest.compute_dtype = "float32"
        pvols.save_estimator("model/tensorflow", "lm", pest)
        out = {}
        for side, ctx in clients.items():
            ctx.train.create(
                "lm_fit", parent_name="lm", method="fit",
                method_parameters={"x": x.tolist(), "y": y.tolist(),
                                   "epochs": 3, "batch_size": 8,
                                   "shuffle": False})
            ctx.observe.wait("lm_fit", timeout=300)
            ctx.predict.create(
                "lm_gen", parent_name="lm_fit", method="generate",
                method_parameters={"prompts": prompts,
                                   "max_new_tokens": 4})
            ctx.observe.wait("lm_gen", timeout=300)
            rows = data_rows(ctx.predict.search("lm_gen", limit=20))
            sse = [doc["t"] for event, doc in ctx.serve.generate(
                "lm_fit", prompts[0], stream=True, max_new_tokens=6)
                if event == "token"]
            out[side] = {
                "json": ctx.serve.generate("lm_fit", prompts,
                                           max_new_tokens=6)["tokens"],
                "sse": sse,
                "batch": [r["result"] for r in rows],
            }
    assert out["port"] == out["jax"]
    assert len(out["port"]["batch"][0]) == 9  # 5 prompt + 4 new
    assert out["port"]["json"][0] == prompts[0] + out["port"]["sse"]
