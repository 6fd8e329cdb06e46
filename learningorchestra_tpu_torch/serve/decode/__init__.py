"""Resident streaming-decode engine (continuous batching + SSE) — port of
``learningorchestra_tpu/serve/decode``.

``DecodeEngine`` is the serving service's facade; ``DecodeStream`` is the
per-request lifecycle object the API layer's SSE writer drains;
``pages`` holds the KV page pools and the decode step.
"""

from learningorchestra_tpu_torch.serve.decode.engine import DecodeEngine
from learningorchestra_tpu_torch.serve.decode.pages import PagePool, build_step
from learningorchestra_tpu_torch.serve.decode.streams import DecodeStream

__all__ = ["DecodeEngine", "DecodeStream", "PagePool", "build_step"]
