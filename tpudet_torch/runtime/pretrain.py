"""Pretrained VGG-16 weights (counterpart of ``tpudet/runtime/pretrain.py``).

``load_vgg16(path)`` reads TF-slim's ``vgg_16.ckpt`` as tpudet does: a
``.npz`` export with the original variable names (every array), or a native
TF checkpoint (the ``vgg_16/conv*`` variables), in either format:

  * V1, one SSTable file (TF-slim's published ``vgg_16.ckpt``): the ``""`` key
    holds a ``SavedTensorSlices`` whose ``meta`` lists each tensor's name,
    shape, dtype and slices; the other keys hold ``SavedSlice``s whose
    ``TensorProto`` carries the values (packed ``*_val`` or
    ``tensor_content``);
  * V2, ``path.index`` (an SSTable of ``BundleEntryProto``s under the tensor
    names, after a ``BundleHeaderProto`` under ``""``) and the bytes in
    ``path.data-{shard:05d}-of-{n:05d}``; a partitioned tensor is put together
    from its slices' entries.

The reader is numpy and a small protobuf wire-format decoder: nothing is
fetched and neither TF nor a protobuf package is imported. Where tpudet's TF
reader fails, this one warns and keeps random init, as tpudet does: a file it
cannot parse, a compressed SSTable block, and a V1 tensor stored in several
slices (TF's V1 reader refuses those: "Sliced checkpoints are not supported").

``inject_vgg16`` copies ``vgg_16/convN/convN_M/{weights,biases}`` (HWIO) into
the trunk's ``convN_M.conv.{weight,bias}`` (OIHW). With no weights file,
initialisation stays random, as in tpudet.
"""

from __future__ import annotations

import os
import struct
import warnings
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

_VGG_BLOCKS = {"conv1": 2, "conv2": 2, "conv3": 3, "conv4": 3, "conv5": 3}


def load_vgg16(path: Optional[str]) -> Optional[Dict[str, np.ndarray]]:
    """Read vgg_16 variables into ``{tf_name: array}``; None (with a warning)
    if there is no file or it cannot be read."""
    if path is None:
        return None
    if not os.path.exists(path) and not os.path.exists(path + ".index"):
        warnings.warn(f"pretraining weight {path!r} not found; using random init")
        return None
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    try:
        return read_tf_checkpoint(path, lambda name: name.startswith("vgg_16/conv"))
    except (OSError, ValueError) as e:
        warnings.warn(f"could not read TF checkpoint {path!r}: {e}; using random init")
        return None


def read_tf_checkpoint(path: str, wanted=lambda name: True) -> Dict[str, np.ndarray]:
    """Every tensor of the TF checkpoint ``path`` (V2 where ``path.index``
    exists, else V1) whose name ``wanted`` accepts. Raises ``ValueError`` on
    anything it cannot parse."""
    if os.path.exists(path + ".index"):
        return _read_v2(path, wanted)
    with open(path, "rb") as f:
        return _read_v1(f.read(), wanted)


# ------------------------------------------------------------ protobuf wire format
def _varint(buf, pos: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(buf) or shift > 63:
            raise ValueError("truncated or overlong varint")
        byte = buf[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        shift += 7
        if byte < 0x80:
            return value, pos


def _take(buf, pos: int, n: int):
    if n < 0 or pos + n > len(buf):
        raise ValueError("field runs past the end of its message")
    return buf[pos:pos + n], pos + n


def _message(buf) -> Dict[int, list]:
    """``{field number: [values]}``: ints for varint fields, bytes for the
    fixed-width and length-delimited ones (packed repeated fields stay bytes
    until :func:`_packed` reads them)."""
    fields: Dict[int, list] = {}
    pos = 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        number, wire = tag >> 3, tag & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, pos = _take(buf, pos, 8)
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = _take(buf, pos, n)
        elif wire == 5:
            value, pos = _take(buf, pos, 4)
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(number, []).append(value)
    return fields


def _first(fields, number, default=None):
    return fields.get(number, [default])[0]


def _signed(v: int) -> int:
    """An int64 sent as a varint (two's complement in 64 bits)."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _packed(values: list, kind: str, dtype) -> np.ndarray:
    """A repeated numeric field, packed (bytes) or not, in order, as ``dtype``.
    ``kind``: "varint" (two's complement in 64 bits), or the struct code of
    a little-endian fixed-width type."""
    parts = []
    for v in values:
        if isinstance(v, int):
            parts.append(np.asarray([_signed(v)]))
        elif kind == "varint":
            vals, pos = [], 0
            while pos < len(v):
                x, pos = _varint(v, pos)
                vals.append(_signed(x))
            parts.append(np.asarray(vals, np.int64))
        else:
            if len(v) % struct.calcsize(kind):
                raise ValueError("packed field of a wrong length")
            parts.append(np.frombuffer(v, "<" + kind))
    return np.concatenate(parts).astype(dtype) if parts else np.zeros(0, dtype)


# TF DataType enum -> numpy dtype and the TensorProto field of its values: the
# types of TF-slim's checkpoints (float weights, an int64 global step)
_DTYPES = {1: (np.float32, 5, "f"), 2: (np.float64, 6, "d"), 3: (np.int32, 7, "varint"),
           9: (np.int64, 10, "varint")}


def _dtype(code: int):
    if code not in _DTYPES:
        raise ValueError(f"tensor dtype {code} is not read")
    return _DTYPES[code]


def _shape(buf) -> Tuple[int, ...]:
    """TensorShapeProto -> dims."""
    return tuple(_signed(_first(_message(d), 1, 0)) for d in _message(buf).get(2, []))


def _extents(buf) -> List[Tuple[int, Optional[int]]]:
    """TensorSliceProto -> ``(start, length)`` per stated dim; None for a
    missing length, which is the rest of the dim."""
    out = []
    for e in _message(buf).get(1, []):
        e = _message(e)
        out.append((_signed(_first(e, 1, 0)), _signed(e[2][0]) if 2 in e else None))
    return out


def _ranges(extents, shape) -> List[Tuple[int, int]]:
    """``(start, length)`` of every dim of ``shape`` that ``extents`` cut."""
    out = [(st, d - st if ln is None else ln) for (st, ln), d in zip(extents, shape)]
    return out + [(0, d) for d in shape[len(out):]]


def _tensor_proto(buf, code: int, shape) -> np.ndarray:
    """The values of a V1 slice's TensorProto, of the dtype ``code`` and
    ``shape`` its tensor's meta gives: ``tensor_content`` or the typed
    ``*_val`` field."""
    t = _message(buf)
    dtype, field, kind = _dtype(code)
    if 4 in t:
        arr = np.frombuffer(t[4][0], np.dtype(dtype).newbyteorder("<"))
    else:
        arr = _packed(t.get(field, []), kind, dtype)
    if arr.size != int(np.prod(shape)):
        raise ValueError(f"tensor of shape {shape} holds {arr.size} values")
    return arr.astype(dtype).reshape(shape)


# ------------------------------------------------------------ SSTable
_TABLE_MAGIC = 0xDB4775248B80FB57
_FOOTER = 48


def _handle(buf, pos: int = 0) -> Tuple[int, int]:
    offset, pos = _varint(buf, pos)
    size, _ = _varint(buf, pos)
    return offset, size


def _block(data, offset: int, size: int) -> Iterator[Tuple[bytes, memoryview]]:
    """The ``(key, value)`` entries of one block: shared-prefix keys, then the
    restart array and its count; a 5-byte trailer follows (type byte, crc)."""
    if offset + size + 5 > len(data):
        raise ValueError("block runs past the end of the table")
    if data[offset + size] != 0:
        raise ValueError("compressed SSTable blocks are not read")
    block = data[offset:offset + size]
    if size < 4:
        raise ValueError("block too short")
    (n_restarts,) = struct.unpack_from("<I", block, size - 4)
    end = size - 4 - 4 * n_restarts
    if end < 0:
        raise ValueError("bad restart count")
    key, pos = b"", 0
    while pos < end:
        shared, pos = _varint(block, pos)
        fresh, pos = _varint(block, pos)
        vlen, pos = _varint(block, pos)
        if shared > len(key):
            raise ValueError("bad key prefix")
        suffix, pos = _take(block, pos, fresh)
        key = key[:shared] + bytes(suffix)
        value, pos = _take(block, pos, vlen)
        yield key, value


def _sstable(data) -> Dict[bytes, memoryview]:
    """Every entry of an SSTable (the footer's index block -> data blocks)."""
    data = memoryview(data)
    if len(data) < _FOOTER or struct.unpack_from("<Q", data, len(data) - 8)[0] != _TABLE_MAGIC:
        raise ValueError("not an SSTable (no table magic)")
    footer = data[len(data) - _FOOTER:]
    _, pos = _varint(footer, _varint(footer, 0)[1])  # skip the metaindex handle
    index = _handle(footer, pos)
    return {k: v for _, h in _block(data, *index) for k, v in _block(data, *_handle(h))}


# ------------------------------------------------------------ V1 and V2
def _read_v1(data: bytes, wanted) -> Dict[str, np.ndarray]:
    table = _sstable(data)
    if b"" not in table:
        raise ValueError("no SavedTensorSlices header")
    meta = _message(_first(_message(table[b""]), 1, b""))
    metas = {}
    for tensor in meta.get(1, []):  # SavedSliceMeta: name, shape, type, slices
        m = _message(tensor)
        name = bytes(_first(m, 1, b"")).decode()
        if not wanted(name):
            continue
        shape = _shape(_first(m, 2, b""))
        slices = [_ranges(_extents(s), shape) for s in m.get(4, [])]
        if slices != [[(0, d) for d in shape]]:
            raise ValueError("Sliced checkpoints are not supported")  # TF's V1 reader
        metas[name] = (_first(m, 3, 0), shape)
    out = {}
    for value in table.values():
        saved = _first(_message(value), 2)  # SavedTensorSlices.data: a SavedSlice
        if saved is None:
            continue
        s = _message(saved)
        name = bytes(_first(s, 1, b"")).decode()
        if name in metas:
            out[name] = _tensor_proto(_first(s, 3, b""), *metas[name])
    missing = sorted(metas.keys() - out.keys())
    if missing:
        raise ValueError(f"no data for {missing}")
    return out


def _ordered_num(n: int) -> bytes:
    """OrderedCode's ``WriteNumIncreasing``: a length byte, then big-endian."""
    body = n.to_bytes((n.bit_length() + 7) // 8, "big") if n else b""
    return bytes([len(body)]) + body


def _ordered_signed(v: int) -> bytes:
    """OrderedCode's ``WriteSignedNumIncreasing``."""
    x = ~v if v < 0 else v
    if x < 64:
        return bytes([(0x80 ^ v) & 0xFF])
    # n bytes: n leading 1 bits, then the value sign-extended to 7n - 1 bits
    n = (x.bit_length() + 1 + 6) // 7
    raw = bytearray((v & ((1 << 80) - 1)).to_bytes(10, "big")[10 - n:])
    raw[0] ^= (0xFF << (8 - min(n, 8))) & 0xFF
    if n > 8:
        raw[1] ^= (0xFF << (16 - n)) & 0xFF
    return bytes(raw)


def _slice_key(name: str, extents) -> bytes:
    """The index key of one slice of ``name`` (``EncodeTensorNameSlice``; a
    whole dim's length is -1)."""
    escaped = name.encode().replace(b"\xff", b"\xff\x00").replace(b"\x00", b"\x00\xff")
    key = _ordered_num(0) + escaped + b"\x00\x01" + _ordered_num(len(extents))
    for start, length in extents:
        key += _ordered_signed(start) + _ordered_signed(-1 if length is None else length)
    return key


def _read_v2(path: str, wanted) -> Dict[str, np.ndarray]:
    with open(path + ".index", "rb") as f:
        table = _sstable(f.read())
    if b"" not in table:
        raise ValueError("no BundleHeaderProto")
    num_shards = _first(_message(table[b""]), 1, 1)
    shards: Dict[int, bytes] = {}

    def entry_bytes(e):
        shard = _first(e, 3, 0)
        if shard not in shards:
            with open(f"{path}.data-{shard:05d}-of-{num_shards:05d}", "rb") as f:
                shards[shard] = f.read()
        offset, size = _first(e, 4, 0), _first(e, 5, 0)
        if offset + size > len(shards[shard]):
            raise ValueError("tensor runs past the end of its data file")
        return shards[shard][offset:offset + size]

    def array(e, shape):
        dtype = _dtype(_first(e, 1, 0))[0]
        arr = np.frombuffer(entry_bytes(e), dtype=np.dtype(dtype).newbyteorder("<"))
        if arr.size != int(np.prod(shape)):
            raise ValueError(f"tensor of shape {shape} holds {arr.size} values")
        return arr.astype(dtype).reshape(shape)

    out = {}
    for key, value in table.items():
        if not key or key.startswith(b"\x00"):  # the header, and slices' entries
            continue
        name = key.decode()
        if not wanted(name):
            continue
        e = _message(value)
        shape = _shape(_first(e, 2, b""))
        if 7 not in e:
            out[name] = array(e, shape)
            continue
        full = np.zeros(shape, _dtype(_first(e, 1, 0))[0])
        for s in e[7]:
            extents = _extents(s)
            part = table.get(_slice_key(name, extents))
            if part is None:
                raise ValueError(f"a slice of {name} has no entry")
            ranges = _ranges(extents, shape)
            full[tuple(slice(st, st + ln) for st, ln in ranges)] = array(
                _message(part), tuple(ln for _, ln in ranges))
        out[name] = full
    return out


def inject_vgg16(trunk: torch.nn.Module, weights: Optional[Dict[str, np.ndarray]]):
    """Copy checkpoint tensors into a :class:`VGG16Trunk` in place."""
    if weights is None:
        return trunk
    with torch.no_grad():
        for block, reps in _VGG_BLOCKS.items():
            for i in range(1, reps + 1):
                layer = f"{block}_{i}"
                w = weights.get(f"vgg_16/{block}/{layer}/weights")
                b = weights.get(f"vgg_16/{block}/{layer}/biases")
                if w is None or b is None:
                    warnings.warn(f"vgg_16 tensor for {layer} missing; left at random init")
                    continue
                conv = getattr(trunk, layer).conv
                w = torch.from_numpy(np.ascontiguousarray(
                    np.asarray(w, np.float32).transpose(3, 2, 0, 1)))
                if conv.weight.shape != w.shape:
                    raise ValueError(f"{layer}: kernel {tuple(w.shape)} does not fit "
                                     f"{tuple(conv.weight.shape)}")
                conv.weight.copy_(w)
                conv.bias.copy_(torch.from_numpy(np.asarray(b, np.float32)))
    return trunk
