"""Checkpoints (counterpart of ``tpudet/runtime/checkpoint.py``): the port's
own ``.pt`` files, and a reader of tpudet's ``.tpudet`` files.

``save_state(path, state, step)`` writes ``{path}-{step}.pt`` (tf.train.Saver's
``path-{global_step}`` convention). The models' state holds the net's
``state_dict``, the optimizer's ``opt_state`` (Momentum's ``velocity`` or
Adam's ``count``, ``mu`` and ``nu``, keyed like ``named_parameters()``) and
``global_step``.

``load_state(path)`` takes an exact file path, a ``path-step`` prefix, or a bare
prefix, which resolves to the newest step of either kind (:func:`resolve`,
tpudet's ``_resolve`` over both suffixes), and reads it by its suffix. A
``.tpudet`` file is the msgpack blob of flax's ``msgpack_serialize``; it comes
back as flax's ``msgpack_restore`` returns it: nested dicts of numpy arrays,
with ``bfloat16`` arrays (numpy has no such type) as ``torch.bfloat16``
tensors. The msgpack decoder is the port's own (:func:`unpackb`): the port
imports neither msgpack nor flax.
"""

from __future__ import annotations

import glob
import os
import re
import struct
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

SUFFIX = ".pt"
TPUDET_SUFFIX = ".tpudet"
_SUFFIXES = (SUFFIX, TPUDET_SUFFIX)


def save_state(path: str, state: Dict[str, Any], step: int) -> str:
    d = os.path.dirname(path)
    if d and not os.path.exists(d):
        os.makedirs(d, exist_ok=True)
        print(d, "does not exist, create it done")
    fname = f"{path}-{step}{SUFFIX}"
    torch.save(state, fname)
    return fname


def resolve(path: str) -> str:
    """The checkpoint file ``path`` names: the file itself, ``path`` plus a
    suffix, or else the newest ``{path}-{step}`` file of either suffix (the
    port's on a tie)."""
    if os.path.isfile(path):
        return path
    for suffix in _SUFFIXES:
        if os.path.isfile(path + suffix):
            return path + suffix
    cands = [c for suffix in _SUFFIXES
             for c in glob.glob(glob.escape(path) + "-*" + suffix)]
    if not cands:
        raise FileNotFoundError(f"no checkpoint matching {path!r}")

    def rank(p):
        m = re.search(r"-(\d+)(" + "|".join(map(re.escape, _SUFFIXES)) + r")$", p)
        return (int(m.group(1)) if m else -1, p.endswith(SUFFIX))

    return max(cands, key=rank)


def load_state(path: str, map_location: Any = "cpu") -> Dict[str, Any]:
    """Load a checkpoint: a ``.tpudet`` file through :func:`msgpack_restore`
    (on the CPU), anything else as a state written by :func:`save_state`
    (tensors only, no pickled code)."""
    fname = resolve(path)
    if fname.endswith(TPUDET_SUFFIX):
        with open(fname, "rb") as f:
            return msgpack_restore(f.read())
    return torch.load(fname, map_location=map_location, weights_only=True)


# ------------------------------------------------------------ tpudet's files

_NDARRAY_EXT = 1   # flax's _MsgpackExtType.ndarray
_NPSCALAR_EXT = 3  # flax's _MsgpackExtType.npscalar
_CHUNKED = "__msgpack_chunked_array__"


def _ndarray(data: bytes):
    """flax's ``_ndarray_from_bytes``: a msgpack array ``(shape, dtype name,
    C-order bytes)``."""
    shape, name, buf = unpackb(data)
    name = name.decode() if isinstance(name, bytes) else name
    shape = tuple(shape)
    if name == "bfloat16":
        flat = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
        return flat.reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _flax_ext(code: int, data: bytes):
    if code == _NDARRAY_EXT:
        return _ndarray(data)
    if code == _NPSCALAR_EXT:
        arr = _ndarray(data)
        return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
    raise ValueError(f"msgpack ext type {code} is not one that tpudet's checkpoints "
                     f"hold (1: ndarray, 3: numpy scalar)")


def _unchunk(d: Dict[str, Any]):
    """flax's ``_unchunk``: ``{"shape": {"0": ..}, "chunks": {"0": ..}}`` -> array."""
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if any(isinstance(c, torch.Tensor) for c in chunks):
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            return _unchunk(tree)
        return {k: _unchunk_tree(v) for k, v in tree.items()}
    return tree


def msgpack_restore(blob: bytes):
    """flax's ``msgpack_restore``: decode, map ext types 1 and 3 to arrays and
    scalars (any other ext type raises), and reassemble chunked arrays."""
    return _unchunk_tree(unpackb(blob, ext_hook=_flax_ext))


# ------------------------------------------------------------ msgpack
def _no_ext(code: int, data: bytes):
    raise ValueError(f"msgpack ext type {code} found and no ext_hook given")


class _Reader:
    def __init__(self, blob: bytes, ext_hook: Callable[[int, bytes], Any]):
        self.buf = memoryview(blob)
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def array(self, n: int):
        return [self.value() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        return self.ext_hook(code, bytes(self.take(n)))

    def value(self):
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if t <= 0x8F:
            return self.map(t & 0x0F)
        if t <= 0x9F:
            return self.array(t & 0x0F)
        if t <= 0xBF:
            return str(self.take(t & 0x1F), "utf-8")
        if t in _FIXED:
            return _FIXED[t]
        if t in _SCALARS:
            return self.unpack(_SCALARS[t])
        if t in _SIZED:
            kind, fmt = _SIZED[t]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            return getattr(self, kind)(n)
        if t in _FIXEXT:
            return self.ext(_FIXEXT[t])
        raise ValueError(f"invalid msgpack type byte 0x{t:02x}")


_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def unpackb(blob: bytes, ext_hook: Optional[Callable[[int, bytes], Any]] = None):
    """Decode one msgpack object: nil, bool, every int and float width, str
    (to ``str``), bin (to ``bytes``), array (to ``list``), map (to ``dict``)
    and ext (through ``ext_hook(code, data)``; without one, ext raises).
    Trailing bytes raise, as msgpack's ``unpackb`` does."""
    reader = _Reader(blob, ext_hook or _no_ext)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes of extra data after "
                         f"the msgpack object")
    return out
