"""A small columnar table: what a dataset collection loads as.

The JAX package loads a collection's rows as a ``pandas.DataFrame`` and
the toolkit edge coerces it with ``to_numpy()``; the card's machine has
no pandas, so the port has this instead.  It matches pandas on what the
pipeline uses: columns in order of first appearance in the rows,
``frame[col]`` as a 1-D column with ``to_numpy()``, ``len``,
``columns``, ``np.asarray`` of either, and ``to_numpy()`` dtypes:

- all ints -> ``int64``; ints with floats -> ``float64``;
- a missing value (``None``, or a key absent from a row) in a numeric
  column -> ``float64`` with NaN;
- booleans alone -> ``bool``; any string, or booleans mixed with
  numbers or missing values -> ``object``; a column of ``None`` alone ->
  ``object`` of ``None``, with an absent key -> ``float64`` NaN.  In an
  object column an absent key reads NaN, and an explicit ``None`` reads
  NaN beside strings alone and stays ``None`` otherwise, as pandas'
  record constructor builds them.
"""

from __future__ import annotations

import math

import numpy as np

#: Placeholder of a key absent from a row.
_ABSENT = object()


def _is_missing(v) -> bool:
    return v is None or v is _ABSENT or (
        isinstance(v, float) and math.isnan(v))


def _column_array(values: list) -> np.ndarray:
    kinds = set()
    for v in values:
        if _is_missing(v):
            continue
        if isinstance(v, (bool, np.bool_)):
            kinds.add(bool)
        elif isinstance(v, (int, np.integer)):
            kinds.add(int)
        elif isinstance(v, (float, np.floating)):
            kinds.add(float)
        else:
            kinds.add(object)
    missing = any(_is_missing(v) for v in values)
    if not kinds:
        if any(v is _ABSENT for v in values):
            return np.full(len(values), np.nan)
    elif kinds <= {int, float}:
        if kinds == {int} and not missing:
            return np.asarray(values, dtype=np.int64)
        return np.asarray([np.nan if _is_missing(v) else v for v in values],
                          dtype=np.float64)
    elif kinds == {bool} and not missing:
        return np.asarray(values, dtype=bool)
    # Object column: an absent key reads NaN; an explicit None reads NaN
    # too in a column of strings alone, and stays None otherwise (pandas'
    # record constructor).
    nan_none = kinds == {object}
    out = np.empty(len(values), dtype=object)
    out[:] = [np.nan if v is _ABSENT or (v is None and nan_none) else v
              for v in values]
    return out


class Column:
    """One column of a :class:`Frame`."""

    def __init__(self, name: str, values: list):
        self.name = name
        self._values = values

    def __len__(self) -> int:
        return len(self._values)

    def to_numpy(self) -> np.ndarray:
        return _column_array(self._values)

    def __array__(self, dtype=None, copy=None):
        return _as(self.to_numpy(), dtype)


class Frame:
    """Rows (dicts) as named columns, in order of first appearance."""

    def __init__(self, rows: list[dict]):
        names: dict[str, None] = {}
        for row in rows:
            names.update(dict.fromkeys(row))
        self._cols = {
            name: [row.get(name, _ABSENT) for row in rows] for name in names
        }
        self._len = len(rows)

    @property
    def columns(self) -> list[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, name: str) -> Column:
        return Column(name, self._cols[name])

    def to_numpy(self) -> np.ndarray:
        """(rows, columns), in the common dtype of the columns (pandas'
        ``DataFrame.to_numpy``)."""
        cols = [_column_array(v) for v in self._cols.values()]
        if not cols:
            return np.empty((self._len, 0), dtype=object)
        dtypes = {c.dtype for c in cols}
        if dtypes <= {np.dtype(np.int64), np.dtype(np.float64)}:
            dtype = np.float64 if np.dtype(np.float64) in dtypes \
                else np.int64
        elif dtypes == {np.dtype(bool)}:
            dtype = bool
        else:
            dtype = object
        return np.stack([c.astype(dtype) for c in cols], axis=1)

    def __array__(self, dtype=None, copy=None):
        """``np.asarray(frame)``, as pandas allows: a method that takes
        an array (``generate``'s prompts) gets the table's values."""
        return _as(self.to_numpy(), dtype)


def _as(arr: np.ndarray, dtype) -> np.ndarray:
    return arr if dtype is None else arr.astype(dtype)
