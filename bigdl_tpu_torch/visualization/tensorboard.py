"""TensorBoard event files without TensorFlow (the port's copy of
``bigdl_tpu/visualization/tensorboard.py``: host code, no device work).

Reference: visualization/tensorboard/{FileWriter,EventWriter,
RecordWriter}.scala and netty/Crc32c.java, which also write
TFRecord-framed Event protos by hand.  The Event and Summary protos are
hand-encoded (Event: 1 wall_time, 2 step, 5 summary; Summary.Value: 1
tag, 2 simple_value, 4 histo), and the TFRecord framing carries the
masked crc32c TensorFlow requires.  The records are byte for byte the
JAX package's, so each package reads the other's event files.
"""

import os
import struct
import threading
import time


# --------------------------------------------------------------------------- #
# crc32c (Castagnoli) -- table-driven, matching netty/Crc32c.java.
# --------------------------------------------------------------------------- #

_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# --------------------------------------------------------------------------- #
# Tiny protobuf encoder (only what Event/Summary need).
# --------------------------------------------------------------------------- #


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            out += bytes([b7])
            return out


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _double_field(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _int64_field(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(data)) + data


def encode_scalar_event(tag: str, value: float, step: int,
                        wall_time: float) -> bytes:
    # Summary.Value: 1=tag, 2=simple_value
    sval = _bytes_field(1, tag.encode()) + _float_field(2, float(value))
    summary = _bytes_field(1, sval)  # Summary: repeated Value value = 1
    # Event: 1=wall_time(double), 2=step(int64), 5=summary
    return (_double_field(1, wall_time) + _int64_field(2, int(step))
            + _bytes_field(5, summary))


def encode_histogram_event(tag: str, values, step: int,
                           wall_time: float) -> bytes:
    """HistogramProto: 1=min 2=max 3=num 4=sum 5=sum_squares
    6=bucket_limit(packed double) 7=bucket(packed double)."""
    import numpy as np

    v = np.asarray(values, np.float64).reshape(-1)
    counts, edges = np.histogram(v, bins=30)
    hist = (_double_field(1, float(v.min())) + _double_field(2, float(v.max()))
            + _double_field(3, float(v.size)) + _double_field(4, float(v.sum()))
            + _double_field(5, float((v * v).sum())))
    limits = b"".join(struct.pack("<d", e) for e in edges[1:])
    buckets = b"".join(struct.pack("<d", float(c)) for c in counts)
    hist += _bytes_field(6, limits) + _bytes_field(7, buckets)
    sval = _bytes_field(1, tag.encode()) + _bytes_field(4, hist)  # 4=histo
    summary = _bytes_field(1, sval)
    return (_double_field(1, wall_time) + _int64_field(2, int(step))
            + _bytes_field(5, summary))


class FileWriter:
    """TFRecord-framed event writer
    (reference: visualization/tensorboard/FileWriter.scala:31)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.bigdl_tpu_torch"
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._lock = threading.Lock()
        # file-version header event
        version = (_double_field(1, time.time())
                   + _bytes_field(3, b"brain.Event:2"))
        self._write_record(version)

    def _write_record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        with self._lock:
            self._f.write(header)
            self._f.write(struct.pack("<I", _masked_crc(header)))
            self._f.write(payload)
            self._f.write(struct.pack("<I", _masked_crc(payload)))
            self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        self._write_record(
            encode_scalar_event(tag, value, step, time.time()))

    def add_histogram(self, tag: str, values, step: int):
        self._write_record(
            encode_histogram_event(tag, values, step, time.time()))

    def close(self):
        self._f.close()


# --------------------------------------------------------------------------- #
# Read-back (reference: visualization readScalar for notebooks).
# --------------------------------------------------------------------------- #


def read_scalar(log_dir: str, tag: str):
    """-> list of (step, value, wall_time) for a tag, across event files."""
    out = []
    for fname in sorted(os.listdir(log_dir)):
        if "tfevents" not in fname:
            continue
        with open(os.path.join(log_dir, fname), "rb") as f:
            data = f.read()
        off = 0
        while off + 12 <= len(data):
            (length,) = struct.unpack_from("<Q", data, off)
            off += 12  # len + len_crc
            payload = data[off:off + length]
            off += length + 4  # payload + payload_crc
            out.extend(_parse_event_scalar(payload, tag))
    return out


def _read_varint(data, off):
    shift = n = 0
    while True:
        b = data[off]
        off += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, off
        shift += 7


def _parse_fields(data):
    off = 0
    while off < len(data):
        key, off = _read_varint(data, off)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, off = _read_varint(data, off)
        elif wire == 1:
            val = data[off:off + 8]
            off += 8
        elif wire == 2:
            ln, off = _read_varint(data, off)
            val = data[off:off + ln]
            off += ln
        elif wire == 5:
            val = data[off:off + 4]
            off += 4
        else:
            return
        yield field, wire, val


def _parse_event_scalar(payload, want_tag):
    wall = step = None
    results = []
    for field, wire, val in _parse_fields(payload):
        if field == 1 and wire == 1:
            wall = struct.unpack("<d", val)[0]
        elif field == 2 and wire == 0:
            step = val
        elif field == 5 and wire == 2:  # summary
            for f2, w2, v2 in _parse_fields(val):
                if f2 == 1 and w2 == 2:  # Summary.Value
                    tag = None
                    simple = None
                    for f3, w3, v3 in _parse_fields(v2):
                        if f3 == 1 and w3 == 2:
                            tag = v3.decode()
                        elif f3 == 2 and w3 == 5:
                            simple = struct.unpack("<f", v3)[0]
                    if tag == want_tag and simple is not None:
                        results.append((step or 0, simple, wall or 0.0))
    return results
