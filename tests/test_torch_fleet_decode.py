"""Streamed generation through a two-replica fleet on the port's server:
``/generate`` (JSON and SSE) tokens equal the naive full-re-forward
greedy decode of the same weights in the JAX package
(``tests/lm_oracle.py``) and the port's solo ``generate``; the decode
engine routes streams to both replicas' page pools; an abort frees the
slot in its own replica's pool; a scale-up with replica pre-warm on
replays the model's recorded decode steps on the new replica.
"""

import time

import jax
import numpy as np
import pytest
import requests

from learningorchestra_tpu.models.text import DecoderLM as JaxLM
from learningorchestra_tpu_torch.api.server import APIServer
from learningorchestra_tpu_torch.config import (
    AotConfig,
    Config,
    FleetConfig,
    StoreConfig,
)
from learningorchestra_tpu_torch.jobs.leases import DeviceLeaser
from learningorchestra_tpu_torch.models.text import DecoderLM
from learningorchestra_tpu_torch.serve.decode import engine as dec_engine
from tests.lm_oracle import naive_greedy_decode
from tests.test_torch_decode_serving import _parse_sse

PREFIX = "/api/learningOrchestra/v1"
LM = dict(vocab_size=16, hidden_dim=32, num_layers=2, num_heads=4,
          max_len=24)
CYCLE = np.array([3, 7, 1, 12, 5, 9, 14, 2, 11, 6, 4, 13, 8, 10, 15])
NEW = 6


@pytest.fixture(scope="module")
def lm_fleet(tmp_path_factory):
    """A port server with a 2-device pool serving a tiny DecoderLM whose
    weights come from a JAX fit (a cycle of ids, so greedy margins are
    wide), and the JAX estimator as the oracle."""
    tmp = tmp_path_factory.mktemp("fleet_decode")
    rng = np.random.default_rng(5)
    offs = rng.integers(0, len(CYCLE), 16)
    x = CYCLE[(offs[:, None] + np.arange(20)[None, :]) % len(CYCLE)]
    x = x.astype(np.int32)
    y = np.concatenate([x[:, 1:], np.zeros((16, 1), np.int32)], 1)
    jest = JaxLM(**LM, seed=0, learning_rate=3e-3)
    jest.compute_dtype = "float32"
    jest.fit(x, y, epochs=30, batch_size=16)
    pest = DecoderLM(**LM, seed=0, device="cpu")
    pest.load_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, jest.params)})
    pest.compute_dtype = "float32"
    cfg = Config(store=StoreConfig(root=str(tmp / "store"),
                                   volume_root=str(tmp / "volumes")),
                 fleet=FleetConfig(interval_s=0.0),
                 aot=AotConfig(replica_prewarm=True))
    server = APIServer(cfg, device="cpu")
    server.ctx.leaser = DeviceLeaser(["cuda:0", "cuda:1"])
    server.ctx.volumes.save_estimator("train/pytorch", "lm", pest)
    server.ctx.artifacts.metadata.create("lm", "train/pytorch")
    server.ctx.artifacts.metadata.mark_finished("lm")
    base = f"http://127.0.0.1:{server.start_background()}{PREFIX}"
    yield server, base, jest
    server.shutdown()


def _prompt(i, n):
    return CYCLE[(i + np.arange(n)) % len(CYCLE)].astype(int).tolist()


def _oracle(jest, prompt):
    return naive_greedy_decode(jest, [prompt], len(prompt) + NEW)[0].tolist()


def test_generate_through_two_replicas_equals_the_oracle(lm_fleet,
                                                         monkeypatch):
    server, base, jest = lm_fleet
    warmed = []
    real_warm = dec_engine.DecodeEngine.warm_replica

    def warm(engine, name, replica):
        cells = len(engine.service.registry.peek(name).decode_warm)
        warmed.append((replica.idx, cells))
        return real_warm(engine, name, replica)

    monkeypatch.setattr(dec_engine.DecodeEngine, "warm_replica", warm)
    # One replica first: its generate records the decode steps ...
    resp = requests.post(f"{base}/serve/lm/replicas",
                         json={"min": 1, "max": 2, "count": 1}, timeout=60)
    assert resp.status_code == 200 and resp.json()["size"] == 1, resp.text
    first = _prompt(0, 5)
    resp = requests.post(f"{base}/serve/lm/generate",
                         json={"prompts": [first], "maxNewTokens": NEW},
                         timeout=60)
    assert resp.json()["tokens"] == [_oracle(jest, first)]
    entry = server.serving.registry.peek("lm")
    assert entry.decode_warm
    # ... which the scale-up's pre-warm replays on replica 1.
    resp = requests.post(f"{base}/serve/lm/replicas", json={"count": 2},
                         timeout=60)
    assert resp.status_code == 200 and resp.json()["size"] == 2, resp.text
    # Replica 0's pre-warm had nothing to replay; replica 1's replayed
    # every recorded (S, Tk) step.
    assert warmed == [(0, 0), (1, len(entry.decode_warm))]
    assert warmed[1][1] >= 1
    assert [r["warmed"] for r in resp.json()["replicas"]] == [True, True]
    # Eight prompts of two lengths: the engine routes them to both
    # replicas' pools, and every continuation is the oracle's.
    prompts = [_prompt(i, 4 + 3 * (i % 2)) for i in range(8)]
    resp = requests.post(f"{base}/serve/lm/generate",
                         json={"prompts": prompts, "maxNewTokens": NEW},
                         timeout=120)
    assert resp.status_code == 200, resp.text
    got = resp.json()["tokens"]
    assert got == [_oracle(jest, p) for p in prompts]
    est = server.serving.registry.get("lm").estimator
    assert got == [est.generate(np.asarray([p], np.int32),
                                max_new_tokens=NEW)[0].tolist()
                   for p in prompts]
    pools = server.serving.decode.stats()["models"]["lm"]["pools"]
    assert {p["replica"] for p in pools} == {0, 1}
    # SSE through the fleet: the same tokens.
    sse = requests.post(f"{base}/serve/lm/generate",
                        json={"prompts": [prompts[3]], "stream": True,
                              "maxNewTokens": NEW}, stream=True, timeout=60)
    toks = [doc["t"] for event, doc in _parse_sse(sse) if event == "token"]
    assert prompts[3] + toks == _oracle(jest, prompts[3])


def test_abort_frees_the_slot_in_its_replicas_pool(lm_fleet, monkeypatch):
    server, base, _ = lm_fleet
    assert server.serving.fleet.registered_set("lm").size == 2
    real = dec_engine._ModelDecoder._step_pool

    def slowed(self, pool):
        time.sleep(0.05)
        return real(self, pool)

    monkeypatch.setattr(dec_engine._ModelDecoder, "_step_pool", slowed)
    engine = server.serving.decode
    # A long-running stream holds one replica; the aborted one goes to
    # the other (P2C over live slots).
    holder = engine.generate("lm", [_prompt(2, 4)], max_new_tokens=16,
                             stream=True)
    resp = requests.post(f"{base}/serve/lm/generate",
                         json={"prompts": [_prompt(5, 4)], "stream": True,
                               "maxNewTokens": 16}, stream=True, timeout=60)
    lines = resp.iter_lines()
    while b"event: token" not in next(lines):
        pass
    decoder = engine._decoders["lm"]
    target = next(s for sid, s in list(decoder._streams.items())
                  if s is not holder)
    pool_of = {id(s): key for key, p in list(decoder._pools.items())
               for s in p.streams if s is not None}
    replica = pool_of[id(target)][0]
    assert replica != pool_of[id(holder)][0]
    gone = requests.delete(f"{base}/serve/lm/generate/{target.stream_id}",
                           timeout=30)
    assert gone.status_code == 200, gone.text
    assert target.wait_done(20)
    # The next step boundary frees the slot; the holder decodes on.
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and any(
            p["live"] for p in engine.stats()["models"]["lm"]["pools"]
            if p["replica"] == replica):
        time.sleep(0.02)
    pools = engine.stats()["models"]["lm"]["pools"]
    assert [p["live"] for p in pools if p["replica"] == replica] and all(
        p["live"] == 0 for p in pools if p["replica"] == replica)
    assert not holder.done()
    assert holder.wait_done(30) and holder.error is None
    resp.close()
