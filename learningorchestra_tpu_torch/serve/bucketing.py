"""Power-of-two shape buckets + row padding — copy of
``learningorchestra_tpu/serve/bucketing.py``.

Rounding every dispatch up to the next power of two keeps the set of
input shapes a model sees small (at most ``log2(max_batch)+1``), at a
worst case of <2x padded compute.  Shared by the serving path
(MicroBatcher) and ``NeuralEstimator.predict``.
"""

from __future__ import annotations

import numpy as np


def bucket_for(rows: int, max_bucket: int) -> int:
    """Smallest power of two >= ``rows``, capped at ``max_bucket``.

    ``max_bucket`` itself is always a legal bucket even when it is not a
    power of two (the cap wins: dispatches never exceed it).
    """
    if rows <= 0:
        raise ValueError(f"rows must be positive, got {rows}")
    if rows >= max_bucket:
        return max_bucket
    return min(1 << (rows - 1).bit_length(), max_bucket)


def pad_rows(x: np.ndarray, target: int) -> np.ndarray:
    """Pad ``x`` along axis 0 up to ``target`` rows by repeating row 0.

    Row repetition (not zeros) keeps pad rows inside the input
    distribution; callers slice the first ``len(x)`` output rows, and
    rows are independent through the model (no batch statistics).
    """
    n = x.shape[0]
    if n == 0:
        raise ValueError("cannot pad an empty batch")
    if n > target:
        raise ValueError(f"batch of {n} rows exceeds bucket {target}")
    if n == target:
        return x
    pad = np.broadcast_to(x[:1], (target - n, *x.shape[1:]))
    return np.concatenate([x, pad], axis=0)
