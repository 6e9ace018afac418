"""TFRecord container IO without TensorFlow (counterpart of
``tpudet/data/tfrecord.py``).

Wire format (what tf.python_io.TFRecordWriter emits, tfrecord_voc_utils.py:81):
  uint64 length | uint32 masked_crc32c(length) | bytes data | uint32 masked_crc32c(data)
with ``masked_crc = rotr(crc32c(x), 15) + 0xa282ead8``.

crc32c runs in a small C library (``csrc/crc32c.c``), built at first use with the
host's ``g++`` into ``build/native/`` at the root of the checkout, named by a hash
of its source, and loaded with ctypes; a NumPy table keeps everything working on a
machine without a compiler. Readers can skip checksum verification (default) for
speed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

CSRC = Path(__file__).resolve().parent / "csrc" / "crc32c.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CC_FLAGS = ("-O3", "-fPIC", "-shared")

_native = None
_native_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of ``csrc/crc32c.c`` goes: keyed by source and flags."""
    digest = hashlib.sha256(CSRC.read_bytes())
    digest.update(" ".join(CC_FLAGS).encode())
    return BUILD_DIR / f"crc32c-{digest.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    """Compile ``csrc/crc32c.c`` unless its library exists; None without a
    working ``g++``."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: concurrent processes (parallel
    # pytest, loader threads) never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CC_FLAGS, str(CSRC), "-o", tmp],
                              capture_output=True)
        if proc.returncode != 0:
            return None
        os.replace(tmp, out)
    except OSError:  # no g++ on this machine
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _open_native():
    """The C library, built if need be and loaded; False where it cannot be."""
    path = _build()
    if path is None:
        return False
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return False
    lib.tpudet_crc32c.restype = ctypes.c_uint32
    lib.tpudet_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32]
    return lib


def _load_native():
    """The C library, built and loaded once per process (False where it cannot
    be); callers in several threads wait for one build."""
    global _native
    with _native_lock:
        if _native is None:
            _native = _open_native()
    return _native


_PY_TABLE: Optional[np.ndarray] = None


def _py_table() -> np.ndarray:
    global _PY_TABLE
    if _PY_TABLE is None:
        poly = np.uint32(0x82F63B78)
        t = np.zeros(256, np.uint32)
        for i in range(256):
            crc = np.uint32(i)
            for _ in range(8):
                crc = (crc >> np.uint32(1)) ^ (poly if crc & np.uint32(1) else np.uint32(0))
            t[i] = crc
        _PY_TABLE = t
    return _PY_TABLE


def crc32c(data: bytes, seed: int = 0) -> int:
    lib = _load_native()
    if lib:
        return lib.tpudet_crc32c(data, len(data), seed)
    t = _py_table()
    crc = np.uint32(seed ^ 0xFFFFFFFF)
    arr = np.frombuffer(data, np.uint8)
    for b in arr:
        crc = t[(crc ^ b) & np.uint32(0xFF)] ^ (crc >> np.uint32(8))
    return int(crc ^ np.uint32(0xFFFFFFFF))


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


class TFRecordWriter:
    """Context-managed writer mirroring tf.python_io.TFRecordWriter."""

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, record: bytes):
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", _masked_crc(record)))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(path: str, verify: bool = False) -> Iterator[bytes]:
    """Yield raw record payloads from one TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            if verify:
                if _masked_crc(header) != hcrc or _masked_crc(data) != dcrc:
                    raise IOError(f"corrupt TFRecord in {path}")
            yield data


def index_records(path: str) -> List[tuple]:
    """Byte offsets/lengths of every record — enables O(1) random access reads
    (the pipeline shuffles indices instead of maintaining a shuffle buffer)."""
    out = []
    with open(path, "rb") as f:
        pos = 0
        while True:
            header = f.read(8)
            if len(header) < 8:
                return out
            (length,) = struct.unpack("<Q", header)
            out.append((pos + 12, length))
            pos += 16 + length
            f.seek(pos)


def read_record_at(path_handle, offset: int, length: int) -> bytes:
    path_handle.seek(offset)
    return path_handle.read(length)
