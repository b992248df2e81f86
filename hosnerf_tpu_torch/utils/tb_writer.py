"""Dependency-free TensorBoard scalar event writer (a copy of
`hosnerf_tpu/utils/tb_writer.py`: the same bytes for the same events).

The reference logs per-step scalars to TensorBoard through Lightning's
TensorBoardLogger (ref: 1st_State-Conditional_Scene/run.py:101-104 +
`self.log(...)` calls in every model). This module reproduces the
artifact format — `events.out.tfevents.*` TFRecord files of Event
protos — with no tensorflow/tensorboard dependency (neither ships in
this image): the two protos involved are tiny and are hand-encoded, and
the TFRecord framing needs only CRC32C.

Scope: scalar summaries only (what the reference logs). Anything that
reads TB event files (tensorboard, tbparse, wandb importers) can consume
the output; tests/test_tb_writer.py round-trips the encoding with an
independent decoder, tests/test_torch_eval.py holds this copy's bytes to
the JAX package's.
"""

from __future__ import annotations

import os
import socket
import struct
import time

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven — required by TFRecord framing.
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # reflected Castagnoli
        tbl = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            tbl.append(c)
        _CRC_TABLE = tbl
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    tbl = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire encoding for Event / Summary / Summary.Value.
# Field numbers from tensorflow/core/util/event.proto and
# tensorflow/core/framework/summary.proto.
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes_field(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def encode_scalar_event(tag: str, value: float, step: int,
                        wall_time: float) -> bytes:
    # Summary.Value: tag = 1 (string), simple_value = 2 (float)
    sval = (_bytes_field(1, tag.encode("utf-8")) + _float(2, float(value)))
    # Summary: repeated Value value = 1
    summary = _bytes_field(1, sval)
    # Event: wall_time = 1 (double), step = 2 (int64), summary = 5
    return (_double(1, wall_time) + _int64(2, int(step))
            + _bytes_field(5, summary))


def encode_file_version_event(wall_time: float) -> bytes:
    # Event.file_version = 3 (string) — TB requires "brain.Event:2"
    return _double(1, wall_time) + _bytes_field(3, b"brain.Event:2")


def frame_record(data: bytes) -> bytes:
    """TFRecord: len(8B LE) + masked_crc(len)(4B) + data + masked_crc."""
    hdr = struct.pack("<Q", len(data))
    return (hdr + struct.pack("<I", _masked_crc(hdr)) + data
            + struct.pack("<I", _masked_crc(data)))


class TBWriter:
    """Append scalar events to an `events.out.tfevents.*` file."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        host = socket.gethostname() or "host"
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(time.time())}.{host}")
        self._f = open(self.path, "ab")
        self._f.write(frame_record(encode_file_version_event(time.time())))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(frame_record(
            encode_scalar_event(tag, value, step, time.time())))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()
