"""A TensorBoard event writer with no dependency (JAX:
madrona_learn_tpu/utils/tensorboard.py).

``TensorboardWriter`` writes scalar, text and image summaries into an
``events.out.tfevents.*`` file that TensorBoard reads as it reads the JAX
package's, without ``tensorboard`` or ``protobuf``: each record is framed
as TFRecord (length, masked CRC-32C of the length, payload, masked CRC-32C
of the payload) and the few ``Event`` / ``Summary`` protobuf fields are
encoded here. The first record is the ``file_version`` event. Images are
encoded as PNG with ``zlib``. Every event reaches the file when it is
written (the file is unbuffered).

``read_records`` / ``read_events`` read such a file back, checking every
CRC, and decode the same fields.
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import time
import zlib

import numpy as np

__all__ = ["TensorboardWriter", "read_events", "read_records"]

# -- CRC-32C (Castagnoli), as TFRecord frames its records -------------------


def _crc32c_table():
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
        table.append(crc)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _frame(payload: bytes) -> bytes:
    length = struct.pack("<Q", len(payload))
    return (length + struct.pack("<I", _masked_crc(length)) + payload
            + struct.pack("<I", _masked_crc(payload)))


# -- protobuf encoding of the fields used -----------------------------------

_VARINT, _FIXED64, _BYTES, _FIXED32 = 0, 1, 2, 5


def _varint(value: int) -> bytes:
    value &= (1 << 64) - 1  # negative int64s as ten-byte two's complement
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _int(field: int, value: int) -> bytes:
    return _key(field, _VARINT) + _varint(int(value))


def _bytes(field: int, value: bytes) -> bytes:
    return _key(field, _BYTES) + _varint(len(value)) + value


def _double(field: int, value: float) -> bytes:
    return _key(field, _FIXED64) + struct.pack("<d", value)


def _float(field: int, value: float) -> bytes:
    return _key(field, _FIXED32) + struct.pack("<f", value)


# tensorboard/compat/proto: Event, Summary, Summary.Value, Summary.Image,
# SummaryMetadata(.PluginData), TensorProto, TensorShapeProto(.Dim).
_EVENT_WALL_TIME, _EVENT_STEP, _EVENT_FILE_VERSION, _EVENT_SUMMARY = \
    1, 2, 3, 5
_SUMMARY_VALUE = 1
_VALUE_TAG, _VALUE_SIMPLE, _VALUE_IMAGE, _VALUE_TENSOR, _VALUE_METADATA = \
    1, 2, 4, 8, 9
_DT_STRING = 7


def _event(step: int, summary_value: bytes) -> bytes:
    return (_double(_EVENT_WALL_TIME, time.time())
            + _int(_EVENT_STEP, step)
            + _bytes(_EVENT_SUMMARY, _bytes(_SUMMARY_VALUE, summary_value)))


def _png(image: np.ndarray) -> bytes:
    """8-bit PNG of an [H, W] or [H, W, C] uint8 image, C in 1-4."""
    height, width = image.shape[:2]
    channels = 1 if image.ndim == 2 else image.shape[2]
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    rows = np.ascontiguousarray(image, dtype=np.uint8).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8,
                                         color_type, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + chunk(b"IEND", b""))


# Tells apart the files of writers made in the same second.
_FILE_UIDS = itertools.count()


class TensorboardWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(
            logdir, "events.out.tfevents.%010d.%s.%s.%s" % (
                time.time(), socket.gethostname(), os.getpid(),
                next(_FILE_UIDS)))
        self._file = open(self.path, "wb", buffering=0)
        self._file.write(_frame(
            _double(_EVENT_WALL_TIME, time.time())
            + _bytes(_EVENT_FILE_VERSION, b"brain.Event:2")))

    def scalar(self, tag: str, value, step: int):
        self._add(step, _bytes(_VALUE_TAG, tag.encode())
                  + _float(_VALUE_SIMPLE, float(np.asarray(value))))

    def text(self, tag: str, text: str, step: int):
        shape = _bytes(2, _int(1, 1))  # TensorShapeProto{dim: [Dim{size 1}]}
        tensor = (_int(1, _DT_STRING) + _bytes(2, shape)
                  + _bytes(8, text.encode("utf-8")))
        metadata = _bytes(1, _bytes(1, b"text"))  # plugin_data.plugin_name
        self._add(step, _bytes(_VALUE_TAG, (tag + "/text_summary").encode())
                  + _bytes(_VALUE_METADATA, metadata)
                  + _bytes(_VALUE_TENSOR, tensor))

    def image(self, tag: str, image, step: int):
        """image: [H, W, C] uint8 (C in {1, 3, 4})."""
        image = np.asarray(image)
        encoded = (_int(1, image.shape[0]) + _int(2, image.shape[1])
                   + _int(3, image.shape[2] if image.ndim == 3 else 1)
                   + _bytes(4, _png(image)))
        self._add(step, _bytes(_VALUE_TAG, tag.encode())
                  + _bytes(_VALUE_IMAGE, encoded))

    def _add(self, step: int, summary_value: bytes):
        self._file.write(_frame(_event(int(step), summary_value)))

    def flush(self):
        self._file.flush()

    def close(self):
        self._file.close()


# -- reading back -----------------------------------------------------------

def read_records(path: str):
    """The payloads of a TFRecord file, every CRC checked."""
    records = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError(f"{path}: truncated record header at {pos}")
        length_bytes = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", length_bytes)
        (length_crc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        if length_crc != _masked_crc(length_bytes):
            raise ValueError(f"{path}: bad length CRC at {pos}")
        payload = data[pos + 12:pos + 12 + length]
        end = pos + 12 + length
        if end + 4 > len(data):
            raise ValueError(f"{path}: truncated record at {pos}")
        (payload_crc,) = struct.unpack("<I", data[end:end + 4])
        if payload_crc != _masked_crc(payload):
            raise ValueError(f"{path}: bad payload CRC at {pos}")
        records.append(payload)
        pos = end + 4
    return records


def _fields(buf: bytes):
    """(field number, value) pairs of one protobuf message: ints for
    varints, bytes for length-delimited fields, raw bytes for fixed ones."""
    pos, out = 0, []
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == _VARINT:
            value, pos = _read_varint(buf, pos)
        elif wire == _FIXED64:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == _FIXED32:
            value, pos = buf[pos:pos + 4], pos + 4
        elif wire == _BYTES:
            length, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + length], pos + length
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        out.append((field, value))
    return out


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        shift += 7
        if not byte & 0x80:
            return result, pos


def _signed64(value: int) -> int:
    return value - (1 << 64) if value >= 1 << 63 else value


def _decode_value(buf: bytes) -> dict:
    out = {}
    for field, value in _fields(buf):
        if field == _VALUE_TAG:
            out["tag"] = value.decode()
        elif field == _VALUE_SIMPLE:
            out["simple_value"] = struct.unpack("<f", value)[0]
        elif field == _VALUE_IMAGE:
            image = dict(_fields(value))
            out["image"] = {"height": image.get(1, 0),
                            "width": image.get(2, 0),
                            "colorspace": image.get(3, 0),
                            "encoded_image_string": image.get(4, b"")}
        elif field == _VALUE_TENSOR:
            out["string_val"] = [v for f, v in _fields(value) if f == 8]
        elif field == _VALUE_METADATA:
            plugin = dict(_fields(dict(_fields(value)).get(1, b"")))
            out["plugin_name"] = plugin.get(1, b"").decode()
    return out


def read_events(path: str):
    """The events of an event file as dicts: ``wall_time``, ``step``, and
    ``file_version`` or ``values`` (each with its ``tag`` and
    ``simple_value``, ``string_val`` and ``plugin_name``, or ``image``)."""
    events = []
    for record in read_records(path):
        event = {"step": 0}
        for field, value in _fields(record):
            if field == _EVENT_WALL_TIME:
                event["wall_time"] = struct.unpack("<d", value)[0]
            elif field == _EVENT_STEP:
                event["step"] = _signed64(value)
            elif field == _EVENT_FILE_VERSION:
                event["file_version"] = value.decode()
            elif field == _EVENT_SUMMARY:
                event["values"] = [_decode_value(v) for f, v in
                                   _fields(value) if f == _SUMMARY_VALUE]
        events.append(event)
    return events
