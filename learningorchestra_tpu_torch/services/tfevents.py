"""Minimal TensorBoard event-file (tfevents) writer — port of
``learningorchestra_tpu/services/tfevents.py``, a copy of its logic (the
module is stdlib-only; the port keeps its own copy).

A managed monitoring session shows training curves because scalars are
written into its logdir as real event files, the record format below.

Format (TFRecord framing + two hand-encoded protos):

    record  := len:uint64le  masked_crc32c(len):uint32le
               data:bytes    masked_crc32c(data):uint32le
    data    := tensorflow.Event   (proto3)
      Event.wall_time    = field 1, double
      Event.step         = field 2, int64 varint
      Event.file_version = field 3, string   (first record only)
      Event.summary      = field 5, message Summary
      Summary.value      = field 1, repeated Summary.Value
      Value.tag          = field 1, string
      Value.simple_value = field 2, float32

CRC is crc32c (Castagnoli) with TFRecord's rotate-and-add mask.  The
bytes equal the JAX package's writer's for the same scalars
(tests/test_torch_tfevents.py).
"""

from __future__ import annotations

import os
import socket
import struct
import time

# -- crc32c (Castagnoli, table-driven) --------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    _CRC_TABLE = table
    return table


def _crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal proto encoding --------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_double(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _pb_float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _pb_varint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _pb_bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _scalar_event(wall_time: float, step: int, tag: str,
                  value: float) -> bytes:
    summary_value = _pb_bytes(1, tag.encode()) + _pb_float(2, value)
    summary = _pb_bytes(1, summary_value)
    return (
        _pb_double(1, wall_time)
        + _pb_varint(2, step)
        + _pb_bytes(5, summary)
    )


def _version_event(wall_time: float) -> bytes:
    return _pb_double(1, wall_time) + _pb_bytes(3, b"brain.Event:2")


def _record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + data
        + struct.pack("<I", _masked_crc(data))
    )


# -- public API --------------------------------------------------------------


def write_scalars(
    logdir: str | os.PathLike,
    history: dict,
    *,
    prefix: str = "",
    wall_time: float | None = None,
) -> str:
    """Write a TrainHistory ({metric: [per-epoch values]}) as one
    tfevents file TensorBoard renders as scalar curves; returns the
    file path.  Tags are ``{prefix}/{metric}`` when a prefix is given.
    """
    os.makedirs(logdir, exist_ok=True)
    t0 = time.time() if wall_time is None else wall_time
    host = socket.gethostname() or "host"
    path = os.path.join(
        logdir, f"events.out.tfevents.{int(t0)}.{host}.{os.getpid()}"
    )
    with open(path, "wb") as fh:
        fh.write(_record(_version_event(t0)))
        n = max((len(v) for v in history.values()), default=0)
        for step in range(n):
            for metric in sorted(history):
                values = history[metric]
                if step >= len(values):
                    continue
                try:
                    value = float(values[step])
                except (TypeError, ValueError):
                    continue
                tag = f"{prefix}/{metric}" if prefix else metric
                fh.write(_record(
                    # Spread wall times so TB's relative-time axis works.
                    _scalar_event(t0 + step * 1e-3, step, tag, value)
                ))
    return path
