"""Estimator protocol — port of ``learningorchestra_tpu/toolkit/base.py``
(the ``Estimator`` base; the array coercion helpers come with the
training slice)."""

from __future__ import annotations

import inspect


class Estimator:
    """Base class: get_params over __init__ kwargs, repr."""

    def get_params(self) -> dict:
        sig = inspect.signature(type(self).__init__)
        return {
            name: getattr(self, name)
            for name in sig.parameters
            if name != "self" and hasattr(self, name)
        }

    def __repr__(self) -> str:
        params = ", ".join(f"{k}={v!r}" for k, v in self.get_params().items())
        return f"{type(self).__name__}({params})"
