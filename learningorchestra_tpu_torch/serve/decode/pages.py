"""KV page pools — resident decode state, bucketed on both axes — port of
``learningorchestra_tpu/serve/decode/pages.py``.

One pool per (model, routed replica, KV-length bucket): a batch of S
decode *slots* over a KV cache of Tk positions per slot.  Both S and Tk
are power-of-two buckets (``serve/bucketing.py``), so a deployment steps
at most ``log2(max_slots)+1`` x ``log2(max_kv)+1`` shapes per
architecture.

The continuous-batching trick is the per-row ``cache_index``: the
attention's decode branch (``ops/layers.py``) takes an (S,) index, so
slots sit at different positions inside one step, and a newly admitted
prompt starts its one-token-per-step prefill in the same step that
extends its neighbours.  A freed slot is zeroed in the token buffer: an
all-pad row masks to an exact-zero attention output (the masked softmax's
double where), so stale KV pages cost nothing and need no scrubbing.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from learningorchestra_tpu_torch.serve.bucketing import bucket_for


def set_index(cache: dict, pos) -> None:
    """Rebind every ``cache_index`` leaf of a decode cache tree to the
    per-slot position vector ``pos`` (S,), in place: the step's one source
    of truth for where each slot writes and how far it may attend."""
    for key, val in cache.items():
        if isinstance(val, dict):
            set_index(val, pos)
        elif key == "cache_index":
            cache[key] = pos


def build_step(module, nslots: int, kv: int):
    """The decode step of one (S, Tk) cell: ``step(cache, buf, pos, t0s,
    live) -> col``, a plain function of eager torch ops over the pool's
    tensors, which it updates in place.

    It is the solo ``GreedyDecodeMixin.generate`` loop's body with
    per-slot positions (S,): the same token gather, key mask, f32 argmax
    and write at ``pos + 1``, so a slot admitted mid-flight decodes what a
    solo generate of its prompt decodes.  ``live`` gates the write: a free
    slot's row stays all pad, and a slot still in its prompt copies the
    next prompt token instead of the model's prediction."""
    device = next(module.parameters()).device
    slots = torch.arange(kv, device=device)[None, :]
    rows = torch.arange(nslots, device=device)

    def step(cache, buf, pos, t0s, live):
        set_index(cache, pos)
        tok = buf.gather(1, pos[:, None])
        kmask = (slots <= pos[:, None]) & (buf != 0)
        logits = module(tok, positions=pos[:, None], key_mask=kmask,
                        cache=cache)
        nxt = logits[:, 0].float().argmax(-1)
        nxt_pos = pos + 1
        prev = buf[rows, nxt_pos]
        col = torch.where(live & (nxt_pos >= t0s), nxt, prev)
        buf[rows, nxt_pos] = col
        return col

    return step


class _PoolGraph:
    """One pool's captured step: the graph, its static input (3, S) int64
    on the card (pos, t0s, live) with the pinned host buffer it is copied
    from, the static output column, what it was captured over, and the
    step function itself: a graph holds no reference to the tensors it
    reads, so the step's own constants (its slot and row ranges) must
    live as long as the graph."""

    __slots__ = ("graph", "inp", "host", "copied", "col", "module", "buf",
                 "step", "capture_s", "pool_bytes")


class DecodeStepProgram:
    """The ``decode_step`` program of one (S, Tk) cell: ``program(module,
    pool, pos, t0s, live) -> col`` steps ``pool`` (host arrays in, the
    (S,) next-token column on the pool's device out).  Shared through the
    program cache by every module of one architecture; each pool keeps
    its own graph (``pool.graph``)."""

    def __init__(self, nslots: int, kv: int):
        self.nslots = int(nslots)
        self.kv = int(kv)

    def __call__(self, module, pool: "PagePool", pos, t0s, live):
        if pool.buf.device.type != "cuda":
            return self.run_eager(module, pool, pos, t0s, live)
        g = pool.graph
        if g is None or g.module is not module or g.buf is not pool.buf:
            return self._capture(module, pool, pos, t0s, live)
        # The host may run one step ahead: the pinned buffer is rewritten
        # only once the previous step's copy has executed.
        g.copied.synchronize()
        _fill(g.host, pos, t0s, live)
        g.inp.copy_(g.host, non_blocking=True)
        g.copied.record()
        g.graph.replay()
        return g.col

    def eager_step(self, module, pool: "PagePool"):
        """The pool's eager step over ``module`` (memoized on the pool)."""
        memo = pool.eager
        if memo is None or memo[0] is not module:
            memo = pool.eager = (module,
                                 build_step(module, self.nslots, self.kv))
        return memo[1]

    def run_eager(self, module, pool: "PagePool", pos, t0s, live):
        """One eager step (the CPU's program; a replica's pre-warm).  The
        positions are a fresh tensor per call: a CPU tensor made from
        ``pool.pos`` would alias host state mutated right after."""
        dev = pool.buf.device
        return self.eager_step(module, pool)(
            pool.cache, pool.buf, torch.tensor(pos, device=dev),
            torch.tensor(t0s, dtype=torch.int64, device=dev),
            torch.tensor(live, dtype=torch.bool, device=dev))

    def _capture(self, module, pool: "PagePool", pos, t0s, live):
        """This call's step runs eagerly on a side stream (it also warms
        the libraries the step uses there), then the same step is
        captured on that stream; the replays run on the current one."""
        t_start = time.perf_counter()
        dev = pool.buf.device
        pool.graph = None
        g = _PoolGraph()
        g.module, g.buf = module, pool.buf
        g.host = torch.empty((3, self.nslots), dtype=torch.int64,
                             pin_memory=True)
        g.inp = torch.empty((3, self.nslots), dtype=torch.int64, device=dev)
        g.copied = torch.cuda.Event()
        _fill(g.host, pos, t0s, live)
        g.inp.copy_(g.host, non_blocking=True)
        g.copied.record()
        step = g.step = build_step(module, self.nslots, self.kv)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            col = step(pool.cache, pool.buf, g.inp[0], g.inp[1],
                       g.inp[2] != 0)
        torch.cuda.current_stream(dev).wait_stream(side)
        col.record_stream(torch.cuda.current_stream(dev))
        reserved = torch.cuda.memory_reserved(dev)
        g.graph = torch.cuda.CUDAGraph()
        # thread_local: other threads (serving batchers, train jobs) keep
        # using the card while this one captures.
        with torch.cuda.graph(g.graph, stream=side,
                              capture_error_mode="thread_local"):
            g.col = step(pool.cache, pool.buf, g.inp[0], g.inp[1],
                         g.inp[2] != 0)
        g.capture_s = time.perf_counter() - t_start
        g.pool_bytes = max(0, torch.cuda.memory_reserved(dev) - reserved)
        pool.graph = g
        return col


def _fill(host, pos, t0s, live) -> None:
    """Write one step's (pos, t0s, live) into the pinned host buffer."""
    # A view of the pinned host buffer, no device transfer:
    # lo-check: disable=jit-host-sync
    view = host.numpy()
    view[0] = pos
    view[1] = t0s
    view[2] = live


def _tree_leaves(tree):
    for val in tree.values():
        if isinstance(val, dict):
            yield from _tree_leaves(val)
        else:
            yield val


def _tree_map(fn, tree):
    return {key: _tree_map(fn, val) if isinstance(val, dict) else fn(val)
            for key, val in tree.items()}


class PagePool:
    """S slots x Tk KV positions of resident decode state for one model.

    Only the owning model's decode worker thread touches a pool, so the
    pool itself is lock-free; the worker's condition variable is the
    synchronization point for admission and abort."""

    __slots__ = ("kv", "nslots", "max_slots", "cache", "buf", "pos",
                 "streams", "steps", "replica_idx", "graph", "eager",
                 "pending")

    def __init__(self, kv: int, max_slots: int,
                 replica_idx: int | None = None):
        self.kv = int(kv)
        # The fleet replica this pool's streams were routed to (None: the
        # registry-resident single path); its pages live on that
        # replica's card and its steps run the replica's module.
        self.replica_idx = replica_idx
        self.nslots = 0
        self.max_slots = int(max_slots)
        self.cache = None  # per-layer KV tensors, allocated on first admit
        self.buf = None    # (S, Tk) int64 token buffer on the device
        self.pos = np.zeros(0, np.int64)  # host positions, one per slot
        self.streams: list = []
        self.steps = 0
        # The step's captured graph on a card (DecodeStepProgram), the
        # eager step memo, and the device intervals of the steps since
        # the last host sync (the device-time ledger's pending share).
        self.graph = None
        self.eager = None
        self.pending: list = []

    # -- capacity ------------------------------------------------------------

    @property
    def live(self) -> int:
        return sum(1 for s in self.streams if s is not None)

    def page_bytes(self) -> int:
        """Resident KV bytes."""
        if self.cache is None:
            return 0
        return sum(t.numel() * t.element_size()
                   for t in _tree_leaves(self.cache))

    def _alloc(self, new_cache, nslots: int) -> None:
        self.cache = new_cache(nslots)
        leaf = next(_tree_leaves(self.cache))
        self.buf = torch.zeros((nslots, self.kv), dtype=torch.int64,
                               device=leaf.device)
        self.pos = np.zeros(nslots, np.int64)
        self.streams = [None] * nslots
        self.nslots = nslots

    def to(self, device) -> None:
        """Move the pool's pages and buffer to ``device`` (a pool whose
        replica was scaled away finishes on the resident module)."""
        if self.buf is not None and self.buf.device != device:
            self.cache = _tree_map(lambda t: t.to(device), self.cache)
            self.buf = self.buf.to(device)
            self.graph = self.eager = None  # captured over the old pages

    def _grow(self, nslots: int) -> None:
        """Pad every per-slot axis up to the next slot bucket; the slots
        already seated keep their pages and positions bit for bit."""
        extra = nslots - self.nslots

        def pad(t):
            return torch.cat([t, t.new_zeros((extra, *t.shape[1:]))])

        self.cache = _tree_map(pad, self.cache)
        self.buf = pad(self.buf)
        self.graph = self.eager = None  # captured over the old pages
        self.pos = np.concatenate([self.pos, np.zeros(extra, np.int64)])
        self.streams.extend([None] * extra)
        self.nslots = nslots

    # -- slot lifecycle ------------------------------------------------------

    def admit(self, stream, new_cache, cell=None) -> int | None:
        """Seat ``stream`` in a free slot (growing to the next slot
        bucket if needed, up to ``max_slots``; ``new_cache(S)`` makes an
        empty cache of S slots, and ``cell(S)``, when given, is told of
        every slot bucket the pool takes, as the JAX admission resolves
        that cell's step); None when full.  The slot's buffer row gets the
        prompt, position 0: prefill runs through the shared step one token
        at a time, as the solo loop does."""
        slot = next((i for i, s in enumerate(self.streams) if s is None),
                    None)
        if slot is None:
            if self.nslots >= self.max_slots:
                return None
            want = bucket_for(self.nslots + 1, self.max_slots)
            if cell is not None:
                cell(want)
            if self.nslots == 0:
                self._alloc(new_cache, want)
            else:
                self._grow(want)
            slot = self.streams.index(None)
        row = np.zeros(self.kv, np.int64)
        row[: stream.t0] = stream.prompt
        self.buf[slot] = torch.from_numpy(row).to(self.buf.device)
        self.pos[slot] = 0
        self.streams[slot] = stream
        return slot

    def release(self, slot: int) -> None:
        """Free the slot and its KV pages: zeroing the buffer row empties
        the slot's attention mask, so whatever K/V the pages still hold is
        unreachable and the next admit needs no scrub."""
        self.streams[slot] = None
        self.pos[slot] = 0
        if self.buf is not None:
            self.buf[slot] = 0
