"""An in-memory ``StageLink`` for the pipeline tests: each rank's schedule
runs in a thread of the test process, hops travel through queues and the
sums meet at a barrier (added in rank order, so every rank gets the same
bits).  It stands in for the process transport of
``learningorchestra_tpu_torch.parallel.pipeline.StageLink`` so the
schedule math is held against the JAX package without a rank process."""

import queue
import threading

import torch


class Hub:
    """The shared state of one world of in-memory ranks."""

    def __init__(self, world: int, pp: int, timeout_s: float = 60.0):
        self.world, self.pp, self.timeout = world, pp, timeout_s
        self.queues = {(a, b): queue.Queue()
                       for a in range(world) for b in range(world)}
        self.barrier = threading.Barrier(world, timeout=timeout_s)
        self.slots = [None] * world

    def links(self) -> list:
        return [MemLink(self, r) for r in range(self.world)]


class MemLink:
    """One rank's side of a :class:`Hub` (the ``StageLink`` surface)."""

    def __init__(self, hub: Hub, rank: int):
        self.hub, self.rank = hub, rank
        self.world = hub.world
        self.n_stages = hub.pp
        self.stage, self.dp_index = rank % hub.pp, rank // hub.pp
        self.dp = hub.world // hub.pp
        self.hop_s: list = []

    def exchange(self, right=None, left=None, from_left=None,
                 from_right=None):
        q = self.hub.queues
        if right is not None:
            q[(self.rank, self.rank + 1)].put(right.detach().clone())
        if left is not None:
            q[(self.rank, self.rank - 1)].put(left.detach().clone())
        got_l = q[(self.rank - 1, self.rank)].get(
            timeout=self.hub.timeout) if from_left is not None else None
        got_r = q[(self.rank + 1, self.rank)].get(
            timeout=self.hub.timeout) if from_right is not None else None
        for got, spec in ((got_l, from_left), (got_r, from_right)):
            if got is not None:
                assert tuple(got.shape) == tuple(spec[0]), (got.shape, spec)
                assert got.dtype == spec[1]
        return got_l, got_r

    def _sum(self, t: torch.Tensor, members) -> torch.Tensor:
        hub = self.hub
        hub.slots[self.rank] = t.detach().clone()
        hub.barrier.wait()
        out = hub.slots[members[0]].clone()
        for r in members[1:]:
            out = out + hub.slots[r]
        hub.barrier.wait()
        return out

    def sum_dp(self, t):
        return self._sum(t, [d * self.n_stages + self.stage
                             for d in range(self.dp)])

    def sum_world(self, t):
        return self._sum(t, list(range(self.world)))

    def agree(self, flag: bool) -> bool:
        return bool(self._sum(torch.tensor([float(bool(flag))]),
                              list(range(self.world))).item())

    def barrier(self) -> None:
        self.hub.barrier.wait()


def run_ranks(hub: Hub, fn) -> list:
    """``fn(rank)`` in one thread per rank of ``hub``; their results in
    rank order (the first exception raised again)."""
    world = hub.world
    out, errors = [None] * world, []

    def body(r):
        try:
            out[r] = fn(r)
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            errors.append(exc)
            hub.barrier.abort()  # free the ranks waiting on this one

    threads = [threading.Thread(target=body, args=(r,)) for r in
               range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors:
        raise errors[0]
    return out
