"""Minimal tf.train.Example wire-format codec (no protobuf/TensorFlow dependency;
counterpart of ``tpudet/data/example_proto.py``).

Only the message shapes the datasets use (tfrecord_voc_utils.py:55-62,
tfrecord_imagenet_utils.py:87-94) are supported:

  Example      { 1: Features }
  Features     { 1: repeated map entry { 1: key(string), 2: Feature } }
  Feature      { 1: BytesList | 2: FloatList | 3: Int64List }
  BytesList    { 1: repeated bytes }
  FloatList    { 1: repeated float  (packed) }
  Int64List    { 1: repeated int64  (packed varint) }

The encoder is byte-for-byte compatible with protobuf's canonical serialization for
these shapes, so records written here parse with TF and vice versa.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Union

FeatureValue = Union[List[bytes], List[float], List[int]]


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


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _encode_feature(value: FeatureValue) -> bytes:
    if not value:
        raise ValueError("empty feature")
    v0 = value[0]
    if isinstance(v0, (bytes, bytearray)):
        inner = b"".join(_len_delim(1, bytes(v)) for v in value)
        return _len_delim(1, inner)  # bytes_list
    if isinstance(v0, float):
        inner = _len_delim(1, struct.pack("<%df" % len(value), *value))
        return _len_delim(2, inner)  # float_list (packed)
    if isinstance(v0, int):
        inner = _len_delim(1, b"".join(_varint(v & 0xFFFFFFFFFFFFFFFF) for v in value))
        return _len_delim(3, inner)  # int64_list (packed varint)
    raise TypeError(type(v0))


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    entries = b""
    for key, value in features.items():
        entry = _len_delim(1, key.encode()) + _len_delim(2, _encode_feature(value))
        entries += _len_delim(1, entry)
    return _len_delim(1, entries)


def _read_varint(buf: bytes, pos: int):
    shift, result = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos, n = 0, len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 2:
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos:pos + ln]
            pos += ln
        elif wire == 0:
            v, pos = _read_varint(buf, pos)
            yield field, wire, v
        elif wire == 5:
            yield field, wire, buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            yield field, wire, buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _decode_feature(buf: bytes) -> FeatureValue:
    for field, _, payload in _fields(buf):
        if field == 1:  # BytesList
            return [v for f, _, v in _fields(payload) if f == 1]
        if field == 2:  # FloatList (packed or repeated)
            out: List[float] = []
            for f, wire, v in _fields(payload):
                if f == 1 and wire == 2:
                    out.extend(struct.unpack("<%df" % (len(v) // 4), v))
                elif f == 1 and wire == 5:
                    out.append(struct.unpack("<f", v)[0])
            return out
        if field == 3:  # Int64List (packed or repeated varint)
            out_i: List[int] = []
            for f, wire, v in _fields(payload):
                if f == 1 and wire == 2:
                    pos = 0
                    while pos < len(v):
                        x, pos = _read_varint(v, pos)
                        out_i.append(x - (1 << 64) if x >= 1 << 63 else x)
                elif f == 1 and wire == 0:
                    out_i.append(v - (1 << 64) if v >= 1 << 63 else v)
            return out_i
    return []


def decode_example(buf: bytes) -> Dict[str, FeatureValue]:
    out: Dict[str, FeatureValue] = {}
    for field, _, features_buf in _fields(buf):
        if field != 1:
            continue
        for f, _, entry in _fields(features_buf):
            if f != 1:
                continue
            key, value = None, None
            for ef, _, ev in _fields(entry):
                if ef == 1:
                    key = ev.decode()
                elif ef == 2:
                    value = _decode_feature(ev)
            if key is not None:
                out[key] = value
    return out
