"""Minimal TensorBoard event-file writer, no tensorboard dependency (a copy
of ``speech2lip_tpu/core/tb_events.py``).

Format: TFRecord framing (uint64 length, masked CRC32C of the length, the
payload, masked CRC32C of the payload) around hand-encoded ``Event``
protobufs, with only the fields scalars need:

    Event:   1 wall_time (double), 2 step (int64),
             3 file_version (string) | 5 summary (Summary)
    Summary: 1 value (repeated Value)
    Value:   1 tag (string), 2 simple_value (float)
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict

# --- CRC32C (Castagnoli), table-driven --------------------------------------

_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (_POLY if _c & 1 else 0)
    _TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- tiny protobuf encoder ---------------------------------------------------

def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _bytes_field(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _double_field(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float_field(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int_field(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def encode_scalar_event(step: int, tag: str, value: float,
                        wall_time: float) -> bytes:
    val = (_bytes_field(1, tag.encode()) + _float_field(2, float(value)))
    summary = _bytes_field(1, val)
    return (_double_field(1, wall_time) + _int_field(2, int(step))
            + _bytes_field(5, summary))


def encode_file_version(wall_time: float) -> bytes:
    return (_double_field(1, wall_time)
            + _bytes_field(3, b"brain.Event:2"))


def frame_record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


def read_records(path: str):
    """Parse a tfevents file back into raw Event payloads (CRC-checked).
    Used by tests and debugging; TensorBoard is the real consumer."""
    out = []
    with open(path, "rb") as f:
        buf = f.read()
    pos = 0
    while pos + 12 <= len(buf):
        (length,) = struct.unpack("<Q", buf[pos:pos + 8])
        (hcrc,) = struct.unpack("<I", buf[pos + 8:pos + 12])
        if hcrc != _masked_crc(buf[pos:pos + 8]):
            raise ValueError("corrupt length crc")
        data = buf[pos + 12:pos + 12 + length]
        (dcrc,) = struct.unpack(
            "<I", buf[pos + 12 + length:pos + 16 + length])
        if dcrc != _masked_crc(data):
            raise ValueError("corrupt data crc")
        out.append(data)
        pos += 16 + length
    return out


def decode_scalar_events(path: str) -> Dict[int, Dict[str, float]]:
    """Best-effort decode of scalar events: {step: {tag: value}}."""
    def read_varint(b, p):
        n = s = 0
        while True:
            c = b[p]
            p += 1
            n |= (c & 0x7F) << s
            if not c & 0x80:
                return n, p
            s += 7

    def parse(b, handlers):
        p = 0
        while p < len(b):
            k, p = read_varint(b, p)
            field, wire = k >> 3, k & 7
            if wire == 0:
                v, p = read_varint(b, p)
            elif wire == 1:
                v = b[p:p + 8]
                p += 8
            elif wire == 5:
                v = b[p:p + 4]
                p += 4
            elif wire == 2:
                ln, p = read_varint(b, p)
                v = b[p:p + ln]
                p += ln
            else:
                raise ValueError(f"wire {wire}")
            handlers.setdefault(field, []).append(v)
        return handlers

    scalars: Dict[int, Dict[str, float]] = {}
    for rec in read_records(path):
        ev = parse(rec, {})
        if 5 not in ev:
            continue
        step = ev.get(2, [0])[0]
        for summary in ev[5]:
            sm = parse(summary, {})
            for val in sm.get(1, []):
                vf = parse(val, {})
                tag = vf.get(1, [b""])[0].decode()
                if 2 in vf:
                    (sv,) = struct.unpack("<f", vf[2][0])
                    scalars.setdefault(int(step), {})[tag] = sv
    return scalars


class EventFileWriter:
    """Append scalar events to an events.out.tfevents.<ts>.<host> file."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}"
                 f".{socket.gethostname()}")
        self.path = os.path.join(out_dir, fname)
        self._f = open(self.path, "ab")
        self._f.write(frame_record(encode_file_version(time.time())))
        self._f.flush()

    def scalar(self, step: int, tag: str, value: float,
               wall_time: float = None):
        wt = time.time() if wall_time is None else wall_time
        self._f.write(frame_record(encode_scalar_event(step, tag, value, wt)))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()
