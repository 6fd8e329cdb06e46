"""Power-of-two-choices routing over replica queue depths — port of
``learningorchestra_tpu/serve/fleet/router.py``.

Per-request least-loaded needs a full scan and herds onto one replica
between depth refreshes; random spreads badly under skew.  Sampling two
replicas and sending to the shallower queue gets exponentially better
max-load than random for one extra depth read.  The router only RANKS
candidates from a depth snapshot; the caller (``ReplicaSet.submit``)
tries them in order and sheds (429) only when every replica refuses.

Determinism: the RNG is a seeded ``random.Random`` making the JAX
router's calls in the same order, so a seed and a depth sequence give
the same candidate orders in both packages.  The JAX router's
``serve.route`` fault probe belongs to the fault plane (ROADMAP A.11).
"""

from __future__ import annotations

import random
from typing import Sequence


class P2CRouter:
    """Rank replica indices for one request from a depth snapshot."""

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)

    def choose(self, depths: Sequence[int]) -> list[int]:
        """Candidate order for ``len(depths)`` replicas: the P2C winner
        first, its pair partner second, the rest by ascending depth."""
        n = len(depths)
        if n <= 1:
            return [0] * n
        if n == 2:
            a, b = 0, 1
        else:
            a = self._rng.randrange(n)
            b = self._rng.randrange(n - 1)
            if b >= a:
                b += 1
        if depths[b] < depths[a] or (
            depths[b] == depths[a] and self._rng.random() < 0.5
        ):
            a, b = b, a
        rest = [i for i in range(n) if i != a and i != b]
        rest.sort(key=depths.__getitem__)
        return [a, b, *rest]
