"""DecodeEngine — resident continuous-batching LM serving — port of
``learningorchestra_tpu/serve/decode/engine.py``.

Per-model decode workers step KV page pools (``pages.py``) with one step
per (slot bucket, KV bucket), admit newly arrived prompts into in-flight
steps (continuous batching: no barrier batching), emit tokens over SSE,
and tear a stream down through its cancel token at the next step
boundary.

Each (S, Tk) cell's step resolves through the process-wide program cache
under the JAX ``decode_step`` key (the module's architecture and the cell),
memoized per (module, S, Tk) on the model's decoder and recorded, per
(S, Tk), in the registry entry's ``decode_warm``.  The program is a
:class:`~learningorchestra_tpu_torch.serve.decode.pages.DecodeStepProgram`:
eager ops on the CPU, a CUDA graph per pool on a card (the decoder's
``stats()`` counts the captures).  The device time of the steps between
two host syncs goes to the cost plane's ledger per model, under the
bucket ``dec{S}x{Tk}`` (obs/costs.py).  With the durable program store on
(train/aot_store.py), each cell's step is offered there as its
architecture key and (S, Tk); in a process that restored such cells, a
decoder of that architecture captures them, one resident pool per KV
bucket at its smallest restored slot bucket, when its model is loaded and
before its first stream (:meth:`_ModelDecoder.prewarm`).

Fleet routing: when the model has a live replica set, each new stream is
routed to a replica by the set's P2C router over live decode slots per
replica; pools are keyed (replica index or None, Tk) and step with their
replica's placed module (replicas sharing the resident module share its
step memo).  A pool whose replica was scaled away finishes on the
resident module.  A fresh replica's pre-warm replays every recorded
(S, Tk) step (:meth:`DecodeEngine.warm_replica`).

Operations plane: time to first token, inter-token latency and tokens
per model feed the registry (the TTFT SLO reads the first); submit,
admit, pool growth, first token, abort and step errors land in the
``decode`` flight ring; and each pool's step passes the
``serve.decode_step`` fault point on the host, before the step program
runs, so a CUDA graph never captures a fault or span decision (an
injected failure fails that pool's streams, as a device fault would).
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np
import torch

from learningorchestra_tpu_torch import faults
from learningorchestra_tpu_torch.log import get_logger, kv
from learningorchestra_tpu_torch.obs import costs
from learningorchestra_tpu_torch.obs import flight as obs_flight
from learningorchestra_tpu_torch.obs.metrics import get_registry
from learningorchestra_tpu_torch.serve.batcher import QueueFull
from learningorchestra_tpu_torch.serve.bucketing import bucket_for
from learningorchestra_tpu_torch.serve.decode.pages import (
    DecodeStepProgram,
    PagePool,
)
from learningorchestra_tpu_torch.serve.decode.streams import DecodeStream
from learningorchestra_tpu_torch.serve.registry import ServeError
from learningorchestra_tpu_torch.train import aot_store
from learningorchestra_tpu_torch.train import compile_cache as cc

logger = get_logger("decode")

#: Ceiling on a non-stream request's wait for its streams to finish.
_NONSTREAM_TIMEOUT_S = 300.0

#: The decode families (the JAX engine's).
DECODE_TTFT = "lo_serving_decode_ttft_seconds"
DECODE_ITL = "lo_serving_decode_itl_seconds"
DECODE_TOKENS = "lo_serving_decode_tokens_total"


class _DecodeHists:
    """TTFT / ITL histograms and the token counter, with one bound series
    per model, re-resolved when the registry is replaced."""

    def __init__(self):
        self._reg = None
        self._ttft = None
        self._itl = None
        self._tokens = None
        self._bound: dict = {}

    def _bind(self, model: str):
        reg = get_registry()
        if reg is not self._reg:
            self._ttft = reg.histogram(
                DECODE_TTFT,
                "Time to first generated token per streamed decode "
                "(admission wait + prefill steps + first step).",
                labels=("model",))
            self._itl = reg.histogram(
                DECODE_ITL,
                "Inter-token latency between consecutive streamed "
                "decode tokens.",
                labels=("model",))
            self._tokens = reg.counter(
                DECODE_TOKENS,
                "Generated tokens per served model (all transports).",
                labels=("model",))
            self._bound = {}
            self._reg = reg
        bound = self._bound.get(model)
        if bound is None:
            if len(self._bound) >= 256:
                self._bound.clear()
            bound = self._bound[model] = (self._ttft.bind(model=model),
                                          self._itl.bind(model=model))
        return bound

    def ttft(self, dt_s: float, model: str) -> None:
        self._bind(model)[0].observe(dt_s)

    def itl(self, dt_s: float, model: str) -> None:
        self._bind(model)[1].observe(dt_s)

    def tokens(self, n: int, model: str) -> None:
        self._bind(model)
        self._tokens.inc(n, model=model)


_decode_hists = _DecodeHists()


class _ModelDecoder:
    """One model's decode worker: admission queue, page pools, step loop.
    All pool state is owned by the worker thread; the condition variable
    hands streams in and wakes the worker for aborts."""

    def __init__(self, engine: "DecodeEngine", name: str):
        self.engine = engine
        self.name = name
        self.cfg = engine.cfg
        self._cv = threading.Condition()
        self._pending: deque = deque()
        # (replica index | None, kv bucket) -> pool
        self._pools: dict[tuple, PagePool] = {}
        self._streams: dict = {}  # stream_id -> DecodeStream (active)
        # (id(module), S, kv) -> (module, DecodeStepProgram); holding the
        # module keeps its id from being reused while the memo lives.
        self._steps: dict = {}
        # CUDA graphs its pools captured: count, seconds, graph-pool bytes.
        self._graphs = [0, 0.0, 0]
        # Whether the restored-cell pre-warm ran (once per decoder).
        self._prewarmed = False
        self._thread: threading.Thread | None = None
        self._closed = False
        self.steps = 0

    # -- submission (any thread) --------------------------------------------

    def submit(self, stream: DecodeStream) -> None:
        with self._cv:
            if self._closed:
                raise ServeError(f"decode for {self.name!r} is shut down")
            active = len(self._streams) + len(self._pending)
            if active >= self.cfg.max_streams:
                obs_flight.record("decode", "queue_full", model=self.name,
                                  stream=stream.stream_id, active=active)
                raise QueueFull(
                    f"decode for {self.name!r} at max_streams="
                    f"{self.cfg.max_streams}"
                )
            obs_flight.record("decode", "submit", model=self.name,
                              stream=stream.stream_id, total=stream.total)
            self._pending.append(stream)
            self._streams[stream.stream_id] = stream
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name=f"decode-{self.name}",
                    daemon=True,
                )
                self._thread.start()
            self._cv.notify_all()

    def abort(self, stream_id: str, reason: str) -> bool:
        with self._cv:
            stream = self._streams.get(stream_id)
            if stream is None:
                return False
            stream.token.cancel(reason)
            obs_flight.record("decode", "abort", model=self.name,
                              stream=stream_id, reason=reason)
            self._cv.notify_all()
            return True

    # -- worker --------------------------------------------------------------

    def _any_live(self) -> bool:
        return any(p.live for p in self._pools.values())

    def _run(self) -> None:
        idle_since: float | None = None
        while True:
            with self._cv:
                while (not self._closed and not self._pending
                       and not self._any_live()):
                    if idle_since is None:
                        idle_since = time.monotonic()
                    waited = time.monotonic() - idle_since
                    if waited >= self.cfg.idle_timeout_s:
                        # Idle past the knob: free the resident pools (KV
                        # memory back to the allocator) and park; the next
                        # submit restarts the worker.
                        self._pools.clear()
                        self._steps.clear()
                        self._thread = None
                        return
                    self._cv.wait(timeout=self.cfg.idle_timeout_s - waited)
                if self._closed:
                    self._thread = None
                    return  # close() fails what is left
                idle_since = None
                pending = list(self._pending)
                self._pending.clear()
            deferred = []
            for stream in pending:
                try:
                    admitted = self._admit(stream)
                except Exception as exc:  # noqa: BLE001 — a fault in
                    # admission costs ONE stream, never the worker: an
                    # unfinished stream would stall its SSE client.
                    logger.error("decode admit raised %s", kv(
                        model=self.name, stream=stream.stream_id,
                        error=str(exc)))
                    obs_flight.record("decode", "admit_failed",
                                      model=self.name,
                                      stream=stream.stream_id,
                                      error=str(exc))
                    self._finish(stream, error=f"admission failed: {exc}")
                    continue
                if not admitted:
                    deferred.append(stream)
            self._step_all()
            if deferred:
                with self._cv:
                    # Back to the FRONT: arrival order is admission order
                    # once capacity frees up.
                    self._pending.extendleft(reversed(deferred))

    # -- admission -----------------------------------------------------------

    def _admit(self, stream: DecodeStream) -> bool:
        if stream.token.cancelled():
            self._finish(stream, aborted=True)
            return True
        replica = self._route_replica()
        ridx = None if replica is None else replica.idx
        kvlen = bucket_for(stream.total,
                           min(self.cfg.max_kv, self._max_len()))
        pool = self._pools.get((ridx, kvlen))
        if pool is None:
            pool = self._pools[(ridx, kvlen)] = PagePool(
                kvlen, self.cfg.max_slots, replica_idx=ridx)
            obs_flight.record("decode", "pool_grow", model=self.name,
                              kv=kvlen, slots=self.cfg.max_slots,
                              replica=-1 if ridx is None else ridx)
        module = self._module_for(pool)
        slot = pool.admit(
            stream,
            lambda want: module.init_cache(want, kvlen, per_row=True),
            cell=lambda want: self._step_for(module, want, kvlen))
        if slot is not None:
            obs_flight.record("decode", "admit", model=self.name,
                              stream=stream.stream_id, kv=kvlen, slot=slot)
        return slot is not None

    def _route_replica(self):
        """P2C-pick a replica for a new stream when the model is
        fleet-served (live decode slots per replica are the depths);
        None keeps the registry-resident single path."""
        rs = self.engine.service.fleet.registered_set(self.name)
        replicas = rs.replicas() if rs is not None else []
        if not replicas:
            return None
        depths = [sum(pool.live for key, pool in self._pools.items()
                      if key[0] == replica.idx) for replica in replicas]
        return replicas[rs.router.choose(depths)[0]]

    def _module_for(self, pool: PagePool):
        """The module ``pool`` steps with: its replica's placed module,
        or the resident one for the single path and for a pool whose
        replica was scaled away (its pages move to that module's card)."""
        entry = self.engine.service.registry.get(self.name)
        module = entry.estimator.module
        if pool.replica_idx is not None:
            rs = self.engine.service.fleet.registered_set(self.name)
            for replica in rs.replicas() if rs is not None else []:
                if replica.idx == pool.replica_idx:
                    return replica.place(entry)
            pool.to(next(module.parameters()).device)
        return module

    def _max_len(self) -> int:
        entry = self.engine.service.registry.get(self.name)
        return int(getattr(entry.estimator, "max_len", self.cfg.max_kv))

    # -- stepping ------------------------------------------------------------

    def _step_for(self, module, nslots: int, kvlen: int
                  ) -> DecodeStepProgram:
        """The step program of one (S, Tk) cell, resolved through the
        process-wide program cache under the JAX ``decode_step`` key,
        memoized per module on the decoder (it dies with the model's
        teardown; replicas that share a module share it) and recorded in
        the registry entry's ``decode_warm``."""
        memo_key = (id(module), nslots, kvlen)
        memo = self._steps.get(memo_key)
        if memo is None:
            entry = self.engine.service.registry.get(self.name)
            arch = cc.module_fingerprint(module)
            key = cc.program_key(
                "decode_step",
                module=arch,
                optimizer=None,
                loss="-",
                dtype="-",
                shapes=("decode_step", nslots, kvlen),
            )
            label = f"decode:{type(module).__name__}:s{nslots}:k{kvlen}"

            def build():
                aot_store.offer_program(key, label,
                                        arch=cc.fingerprint(arch),
                                        cell=(nslots, kvlen))
                return DecodeStepProgram(nslots, kvlen)

            program = cc.get_cache().get_or_build(key, build, label=label)
            memo = self._steps[memo_key] = (module, program)
            entry.decode_warm[(nslots, kvlen)] = True
        return memo[1]

    def warm_replica(self, replica, entry) -> None:
        """One dummy eager step per recorded (S, Tk) cell on the replica's
        placed module (every slot free, so the buffer stays all pad):
        resolves its step programs before the router may pick the
        replica; its pools capture their graphs at their first step."""
        module = replica.place(entry)
        # A copy: the worker records new cells concurrently.
        for nslots, kvlen in sorted(entry.decode_warm.copy()):
            program = self._step_for(module, nslots, kvlen)
            pool = PagePool(kvlen, nslots, replica_idx=replica.idx)
            pool._alloc(lambda want: module.init_cache(
                want, kvlen, per_row=True), nslots)
            with torch.no_grad():
                program.run_eager(module, pool, np.zeros(nslots, np.int64),
                                  np.full(nslots, kvlen + 1, np.int64),
                                  np.zeros(nslots, bool))

    def prewarm(self, entry) -> int:
        """Capture the graphs of the (S, Tk) cells this process restored
        for the model's architecture (train/aot_store.py) before its first
        stream: each cell's step resolves (recorded in ``decode_warm``),
        and per KV bucket one resident pool at its smallest restored slot
        bucket (where a first stream is seated) takes one dummy step, all
        slots free, which captures its graph on a card.  A decoder warms
        once, and only before it has a pool or a worker.  Returns the
        graphs captured."""
        captured = 0
        with self._cv:
            if self._prewarmed or self._pools or self._thread is not None:
                return 0
            self._prewarmed = True
            module = entry.estimator.module
            cap = min(self.cfg.max_kv, self._max_len())
            cells = [(s, kv) for s, kv in aot_store.restored_cells(
                cc.fingerprint(cc.module_fingerprint(module)))
                if s <= self.cfg.max_slots and kv <= cap]
            smallest: dict = {}  # kv bucket -> (slot bucket, program)
            for nslots, kvlen in cells:
                smallest.setdefault(kvlen, (nslots, self._step_for(
                    module, nslots, kvlen)))
            for kvlen, (nslots, program) in smallest.items():
                pool = PagePool(kvlen, self.cfg.max_slots)
                pool._alloc(lambda want, kv=kvlen: module.init_cache(
                    want, kv, per_row=True), nslots)
                with torch.no_grad():
                    program(module, pool, np.zeros(nslots, np.int64),
                            np.full(nslots, kvlen + 1, np.int64),
                            np.zeros(nslots, bool))
                if pool.graph is not None:
                    captured += 1
                    self._graphs[0] += 1
                    self._graphs[1] += pool.graph.capture_s
                    self._graphs[2] += pool.graph.pool_bytes
                self._pools[(None, kvlen)] = pool
        return captured

    def _step_all(self) -> None:
        for key in list(self._pools):
            pool = self._pools[key]
            # Abort sweep FIRST: a cancelled stream's slot is freed within
            # one step boundary of the cancel, even if the step then fails.
            for slot, stream in enumerate(pool.streams):
                if stream is not None and stream.token.cancelled():
                    pool.release(slot)
                    self._finish(stream, aborted=True)
            if not pool.live:
                continue
            try:
                # On the host, before the step program: a graph capture
                # never records the decision.
                faults.hit("serve.decode_step")
                with torch.no_grad():
                    self._step_pool(pool)
            except Exception as exc:  # noqa: BLE001 — a device fault's
                # blast radius is this pool's in-flight streams; the worker
                # and the other pools stay healthy.
                logger.error("decode step failed %s", kv(
                    model=self.name, pool=f"{key}", error=str(exc)))
                obs_flight.record("decode", "step_error", model=self.name,
                                  pool=f"{key}", error=str(exc))
                for slot, stream in enumerate(pool.streams):
                    if stream is not None:
                        try:
                            pool.release(slot)
                        except Exception:  # noqa: BLE001 — a device
                            # fault can fail the buffer write too; the
                            # stream still fails instead of hanging.
                            pool.streams[slot] = None
                        self._finish(stream,
                                     error=f"decode step failed: {exc}")

    def _step_pool(self, pool: PagePool) -> None:
        module = self._module_for(pool)
        program = self._step_for(module, pool.nslots, pool.kv)
        live = np.array([s is not None for s in pool.streams])
        t0s = np.array([s.t0 if s is not None else pool.kv + 1
                        for s in pool.streams], np.int64)
        eager = any(s is not None and s.eager for s in pool.streams)
        interval = costs.Interval(pool.buf.device) \
            if costs.enabled() else None
        # The program snapshots pool.pos (host state mutated right after
        # this dispatch) into its inputs.
        graph = pool.graph
        col = program(module, pool, pool.pos, t0s, live)
        if pool.graph is not graph and pool.graph is not None:
            # This step captured: its interval spans the capture's host
            # work, not device time, and is left out of the ledger.
            self._graphs[0] += 1
            self._graphs[1] += pool.graph.capture_s
            self._graphs[2] += pool.graph.pool_bytes
            interval = None
        if interval is not None:
            pool.pending.append(interval.stop())
        pool.steps += 1
        self.steps += 1
        # SSE wants the token now; lazy streams read their row at the end.
        col_host = col.cpu().numpy() if eager else None
        synced = eager
        now = time.perf_counter()
        for slot, stream in enumerate(pool.streams):
            if stream is None:
                continue
            nxt_pos = int(pool.pos[slot]) + 1
            pool.pos[slot] = nxt_pos
            if nxt_pos >= stream.t0 and stream.eager:
                self._emit(stream, int(col_host[slot]), nxt_pos, now)
            if nxt_pos >= stream.total - 1:
                # Terminal: the whole row (prompt + continuation) is in
                # the buffer; lazy streams surface everything here.
                row = pool.buf[slot].cpu().numpy()
                synced = True
                if not stream.eager:
                    stream.tokens = [int(t)
                                     for t in row[stream.t0:stream.total]]
                    stream.first_at = stream.first_at or time.perf_counter()
                    self._note_first(stream)
                    _decode_hists.tokens(len(stream.tokens), self.name)
                pool.release(slot)
                self._finish(stream)
        if synced and pool.pending:
            self._record_devtime(pool)

    def _record_devtime(self, pool: PagePool) -> None:
        """At a host sync (an eager token read or a terminal row read),
        the device time of the steps since the last one goes to the
        ledger per model, bucket ``dec{S}x{Tk}``."""
        pending, pool.pending = pool.pending, []
        led = costs.devtime()
        weight = led.will_record(self.name)
        if weight:
            led.record_model(
                weight, sum(iv.seconds() for iv in pending), None, None,
                self.name, f"dec{pool.nslots}x{pool.kv}")

    def _note_first(self, stream: DecodeStream) -> None:
        ttft = stream.first_at - stream.arrived
        _decode_hists.ttft(ttft, self.name)
        obs_flight.record("decode", "ttft", model=self.name,
                          stream=stream.stream_id, ttftS=round(ttft, 4))

    def _emit(self, stream: DecodeStream, tok: int, pos: int,
              now: float) -> None:
        if stream.first_at is None:
            stream.first_at = now
            self._note_first(stream)
        else:
            _decode_hists.itl(now - stream.last_at, self.name)
        stream.last_at = now
        stream.push_token(tok, pos)
        _decode_hists.tokens(1, self.name)

    def _finish(self, stream: DecodeStream, *, error: str | None = None,
                aborted: bool = False) -> None:
        if error is not None:
            stream.fail(error)
        elif aborted:
            stream.mark_aborted()
        else:
            stream.finish()
        with self._cv:
            self._streams.pop(stream.stream_id, None)

    # -- lifecycle / observability -------------------------------------------

    def stats(self) -> dict:
        with self._cv:
            pending = len(self._pending)
            active = len(self._streams)
            # Snapshot under the cv: the worker parks (clearing the pools)
            # and admits concurrently.
            pools = list(self._pools.values())
            graphs = list(self._graphs)
        return {
            "activeStreams": active,
            "pending": pending,
            "steps": self.steps,
            "pools": [{"kv": p.kv, "slots": p.nslots, "live": p.live,
                       "steps": p.steps, "pageBytes": p.page_bytes(),
                       "replica": p.replica_idx}
                      for p in pools],
            # CUDA graphs captured by this model's step programs (0 on
            # the CPU), their capture seconds and graph-pool bytes.
            "graphs": {"captures": graphs[0],
                       "captureS": round(graphs[1], 6),
                       "poolBytes": graphs[2]},
        }

    def close(self) -> None:
        with self._cv:
            self._closed = True
            thread = self._thread
            self._cv.notify_all()
        if thread is not None and thread.is_alive() \
                and thread is not threading.current_thread():
            thread.join(timeout=10.0)
        with self._cv:
            pending = list(self._pending)
            self._pending.clear()
            self._streams.clear()
            pools = list(self._pools.values())
            self._pools.clear()
            self._steps.clear()
        for stream in pending:
            stream.fail("decode engine shut down")
        for pool in pools:
            for slot, stream in enumerate(pool.streams):
                if stream is not None:
                    pool.release(slot)
                    stream.fail("decode engine shut down")


class DecodeEngine:
    """Facade the serving service owns: per-model decoders, request
    validation, the stream and non-stream transports.  Dormant (no
    thread, no pool) until the first ``/generate``."""

    def __init__(self, service, config):
        self.service = service
        self.cfg = config
        self._lock = threading.Lock()
        self._decoders: dict[str, _ModelDecoder] = {}
        self._closed = False

    # -- request surface -----------------------------------------------------

    def _decoder_for(self, name: str) -> _ModelDecoder:
        with self._lock:
            if self._closed:
                raise ServeError("decode engine is shut down")
            decoder = self._decoders.get(name)
            if decoder is None:
                decoder = self._decoders[name] = _ModelDecoder(self, name)
            return decoder

    @staticmethod
    def _as_prompt_rows(prompts) -> list[np.ndarray]:
        """Request JSON -> per-stream prompt rows.  Rows may be ragged
        (each stream carries its own t0); pad id 0 is reserved."""
        if isinstance(prompts, np.ndarray):
            prompts = prompts.tolist()
        if not isinstance(prompts, (list, tuple)) or not prompts:
            raise ServeError("'prompts' must be a non-empty array")
        if not isinstance(prompts[0], (list, tuple, np.ndarray)):
            prompts = [prompts]
        rows = []
        for row in prompts:
            try:
                r = np.asarray(row, dtype=np.int32)
            except (ValueError, TypeError) as exc:
                raise ServeError(
                    f"prompt row is not an int array: {exc}") from None
            if r.ndim != 1 or r.shape[0] == 0:
                raise ServeError(
                    "each prompt must be a non-empty 1-D token array")
            if (r == 0).any():
                raise ServeError("prompts must not contain pad id 0")
            rows.append(r)
        return rows

    def _open_stream(self, name: str, decoder: _ModelDecoder,
                     prompt: np.ndarray, max_new: int, max_len: int,
                     *, eager: bool) -> DecodeStream:
        t0 = int(prompt.shape[0])
        cap = min(max_len, self.cfg.max_kv)
        if t0 >= cap:
            raise ServeError(
                f"prompt length {t0} exceeds decode capacity {cap} "
                "(model max_len / DecodeConfig.max_kv)"
            )
        max_new = max(1, min(int(max_new), self.cfg.max_new_tokens))
        stream = DecodeStream(name, prompt, t0, min(cap, t0 + max_new),
                              eager=eager)
        decoder.submit(stream)
        return stream

    def generate(self, name: str, prompts, *, max_new_tokens: int = 32,
                 stream: bool = False, temperature=None, top_k=None,
                 top_p=None, seed: int = 0):
        """Entry point behind ``POST /serve/<model>/generate``.

        Greedy decodes run on the resident engine (stream or not);
        sampling parameters (or ``enabled`` off) take the solo decode loop
        (non-stream only: a sampled decode has no per-step identity to
        stream against the engine's greedy step)."""
        entry = self.service.registry.get(name)
        estimator = entry.estimator
        if not hasattr(estimator, "generate"):
            raise ServeError(
                f"artifact {name!r} ({type(estimator).__name__}) is not a "
                "generative LM; only GreedyDecodeMixin models can serve "
                "/generate"
            )
        sampling = (temperature is not None or top_k is not None
                    or top_p is not None)
        rows = self._as_prompt_rows(prompts)
        if sampling or not self.cfg.enabled:
            if stream:
                raise ServeError(
                    "streaming decode requires the resident engine (greedy "
                    "only, DecodeConfig.enabled); drop the sampling "
                    "parameters or set stream=false"
                )
            return self._solo_generate(
                name, entry, rows, max_new_tokens, temperature=temperature,
                top_k=top_k, top_p=top_p, seed=seed)
        if stream and len(rows) != 1:
            raise ServeError("stream=true serves exactly one prompt per "
                             "request")
        self.prewarm(name)
        decoder = self._decoder_for(name)
        max_len = int(getattr(estimator, "max_len", self.cfg.max_kv))
        streams = [self._open_stream(name, decoder, row, max_new_tokens,
                                     max_len, eager=stream)
                   for row in rows]
        entry.requests += 1
        if stream:
            return streams[0]
        t0 = time.perf_counter()
        for s in streams:
            remaining = _NONSTREAM_TIMEOUT_S - (time.perf_counter() - t0)
            if not s.wait_done(max(0.1, remaining)):
                for other in streams:
                    other.abort("decode timed out")
                raise ServeError("decode timed out")
        failed = [s for s in streams if s.error is not None]
        if failed:
            raise ServeError(failed[0].error)
        aborted = [s for s in streams if s.token.cancelled()]
        if aborted:
            raise ServeError(f"decode aborted: {aborted[0].token.reason}")
        return {
            "model": name,
            "tokens": [s.prompt.tolist() + s.tokens for s in streams],
            "newTokens": [s.tokens for s in streams],
            "streams": [s.summary() for s in streams],
        }

    def _solo_generate(self, name, entry, rows, max_new_tokens, *,
                       temperature, top_k, top_p, seed):
        """The solo decode loop (sampling, or the engine off): one call per
        prompt, so ragged rows stay legal."""
        out_tokens: list[list[int]] = []
        for row in rows:
            try:
                buf = entry.estimator.generate(
                    row[None, :], max_new_tokens=int(max_new_tokens),
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    seed=int(seed))
            except ValueError as exc:
                # A bad sampling spec is the client's error: 406.
                raise ServeError(str(exc)) from None
            out_tokens.append(np.asarray(buf)[0].tolist())
        entry.requests += 1
        return {
            "model": name,
            "tokens": out_tokens,
            "newTokens": [t[rows[i].shape[0]:]
                          for i, t in enumerate(out_tokens)],
            "sampled": temperature is not None,
        }

    def abort(self, name: str, stream_id: str,
              reason: str = "aborted by client") -> bool:
        with self._lock:
            decoder = self._decoders.get(name)
        if decoder is None:
            return False
        return decoder.abort(stream_id, reason)

    def prewarm(self, name: str) -> int:
        """Restored-cell leg of the durable warm start: capture, before the
        model's first stream, the step graphs of every (S, Tk) cell this
        process restored for its architecture (a no-op without restored
        cells, or for a model that is not a generative LM, or once its
        decoder has pools).  Returns the graphs captured."""
        if not aot_store.restored_cells():
            return 0
        entry = self.service.registry.get(name)
        if not hasattr(entry.estimator, "generate") or not self.cfg.enabled:
            return 0
        return self._decoder_for(name).prewarm(entry)

    def warm_replica(self, name: str, replica) -> None:
        """Decode leg of replica pre-warm: replay every recorded (S, Tk)
        step on the new replica's placed module.  Failures are the
        caller's to log: a replica that cannot warm serves cold."""
        entry = self.service.registry.peek(name)
        if entry is None or not entry.decode_warm:
            return
        self._decoder_for(name).warm_replica(replica, entry)

    # -- lifecycle -----------------------------------------------------------

    def drop_model(self, name: str) -> None:
        """Tear down ``name``'s decoder: its in-flight streams fail, and the
        next ``/generate`` builds against the reloaded artifact."""
        with self._lock:
            decoder = self._decoders.pop(name, None)
        if decoder is not None:
            decoder.close()

    def stats(self) -> dict:
        with self._lock:
            decoders = dict(self._decoders)
        return {
            "enabled": bool(self.cfg.enabled),
            "models": {name: d.stats() for name, d in decoders.items()},
        }

    def close(self) -> None:
        with self._lock:
            self._closed = True
            decoders = list(self._decoders.values())
            self._decoders.clear()
        for decoder in decoders:
            decoder.close()
