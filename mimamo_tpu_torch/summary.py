"""TensorBoard event files of scalars, written and read without TensorFlow.

Counterpart of the ``tf.summary`` writer that ``mimamo_tpu.cli train
--tensorboard`` uses; neither ``tensorflow`` nor ``tensorboard`` is needed
(``torch.utils.tensorboard`` imports the latter). A file
``events.out.tfevents.<time>.<host>`` is a sequence of TFRecords: the data
length as a little-endian uint64, the masked CRC32C of those 8 bytes, the
data, the masked CRC32C of the data. Each record holds an ``Event``
protobuf: ``wall_time`` (field 1, double), ``step`` (2, varint) and either
``file_version`` (3, the first record: ``brain.Event:2``) or ``summary``
(5), whose ``value`` entries (1) hold a ``tag`` (1) and a ``simple_value``
(2, float). TensorBoard shows these as scalars, as it shows the TF2 tensor
scalars that the JAX CLI writes.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Iterator, List, Tuple


def _crc32c_table() -> Tuple[int, ...]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return tuple(table)


_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    c = 0xFFFFFFFF
    for b in data:
        c = _TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return ((((c >> 15) | (c << 17)) & 0xFFFFFFFF) + 0xA282EAD8) & 0xFFFFFFFF


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


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited protobuf field."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _event(step: int, wall_time: float, body: bytes) -> bytes:
    return (b"\x09" + struct.pack("<d", wall_time) + b"\x10"
            + _varint(step) + body)


class EventWriter:
    """Appends scalar events to a new event file in ``logdir``; one event
    per scalar, as ``tf.summary.scalar`` writes them."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        now = time.time()
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(now):010d}."
                    f"{socket.gethostname()}")
        self._f = open(self.path, "ab")
        self._write(_event(0, now, _field(3, b"brain.Event:2")))
        self.flush()

    def _write(self, data: bytes) -> None:
        head = struct.pack("<Q", len(data))
        self._f.write(head + struct.pack("<I", _masked_crc(head)) + data
                      + struct.pack("<I", _masked_crc(data)))

    def scalar(self, tag: str, value: float, step: int) -> None:
        value = _field(1, tag.encode()) + b"\x15" + struct.pack("<f", value)
        self._write(_event(step, time.time(),
                           _field(5, _field(1, value))))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "EventWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _read_varint(data: bytes, i: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        b = data[i]
        i += 1
        value |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, i


def _fields(data: bytes) -> Iterator[Tuple[int, object]]:
    """(field number, value) of a protobuf message: an int for varints,
    bytes for the other wire types."""
    i = 0
    while i < len(data):
        key, i = _read_varint(data, i)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(data, i)
        elif wire in (1, 5):
            size = 8 if wire == 1 else 4
            value, i = data[i:i + size], i + size
        elif wire == 2:
            n, i = _read_varint(data, i)
            value, i = data[i:i + n], i + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield number, value


def read_events(path: str) -> List[Dict[str, object]]:
    """The events of an event file, each ``{"wall_time", "step"}`` with
    ``"file_version"`` or ``"values"`` (tag -> simple value); raises
    ``ValueError`` on a record whose checksum does not match."""
    with open(path, "rb") as f:
        raw = f.read()
    events, i = [], 0
    while i < len(raw):
        head = raw[i:i + 8]
        (n,), (crc,) = struct.unpack("<Q", head), struct.unpack(
            "<I", raw[i + 8:i + 12])
        data = raw[i + 12:i + 12 + n]
        (dcrc,) = struct.unpack("<I", raw[i + 12 + n:i + 16 + n])
        if crc != _masked_crc(head) or dcrc != _masked_crc(data):
            raise ValueError(f"{path}: bad checksum in the record at byte "
                             f"{i}")
        i += 16 + n
        ev: Dict[str, object] = {"step": 0}
        for number, value in _fields(data):
            if number == 1:
                ev["wall_time"] = struct.unpack("<d", value)[0]
            elif number == 2:
                ev["step"] = value
            elif number == 3:
                ev["file_version"] = value.decode()
            elif number == 5:
                values = ev.setdefault("values", {})
                for _, entry in _fields(value):
                    item = dict(_fields(entry))
                    values[item[1].decode()] = struct.unpack(
                        "<f", item[2])[0]
        events.append(ev)
    return events
