"""TensorBoard-format scalar summary writer, no TensorFlow dependency (counterpart of
``tpudet/runtime/summary.py``).

The reference merges a ``loss`` scalar summary and (only in YOLOv2) accepts an
optional writer (YOLOv2.py:305-316). This writes real TensorBoard event files using
the port's own protobuf encoder (the wire helpers of ``tpudet_torch.data.example_proto``)
and the TFRecord framing crc32c; :func:`read_events` reads them back.

Event wire format (tensorboard.compat.proto.event_pb2.Event):
  Event { 1: wall_time(double), 2: step(int64), 5: Summary }
  Summary { 1: repeated Value { 1: tag(string), 2: simple_value(float) } }
written as TFRecord-framed records into ``events.out.tfevents.<ts>.<host>``.
"""

from __future__ import annotations

import os
import socket
import struct
import time

from tpudet_torch.data.example_proto import _fields, _len_delim, _tag, _varint
from tpudet_torch.data.tfrecord import TFRecordWriter, read_records


def _double_field(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _varint_field(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _event(step: int, tag: str | None = None, value: float | None = None,
           file_version: str | None = None) -> bytes:
    msg = _double_field(1, time.time()) + _varint_field(2, step)
    if file_version is not None:
        msg += _len_delim(3, file_version.encode())
    if tag is not None:
        v = _len_delim(1, tag.encode()) + _float_field(2, float(value))
        msg += _len_delim(5, _len_delim(1, v))
    return msg


class SummaryWriter:
    """Append scalar summaries to a TensorBoard event file under ``logdir``."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = "events.out.tfevents.%d.%s" % (int(time.time()), socket.gethostname())
        self._writer = TFRecordWriter(os.path.join(logdir, fname))
        self._writer.write(_event(0, file_version="brain.Event:2"))

    def add_scalar(self, tag: str, value: float, step: int):
        self._writer.write(_event(step, tag, value))

    # reference-compatible alias (writer.add_summary(loss, global_step=...))
    def add_summary(self, value: float, global_step: int, tag: str = "loss"):
        self.add_scalar(tag, float(value), int(global_step))

    def flush(self):
        self._writer.flush()

    def close(self):
        self._writer.close()


def read_events(path: str):
    """The events of one event file as dicts: ``wall_time``, ``step`` and either
    ``file_version`` or the scalar's ``tag`` and ``value``. Every record's
    checksums are verified."""
    out = []
    for record in read_records(path, verify=True):
        event = {"step": 0}
        for field, _, v in _fields(record):
            if field == 1:
                event["wall_time"] = struct.unpack("<d", v)[0]
            elif field == 2:
                event["step"] = v - (1 << 64) if v >= 1 << 63 else v
            elif field == 3:
                event["file_version"] = v.decode()
            elif field == 5:
                for _, _, value in _fields(v):
                    for f, _, x in _fields(value):
                        if f == 1:
                            event["tag"] = x.decode()
                        elif f == 2:
                            event["value"] = struct.unpack("<f", x)[0]
        out.append(event)
    return out
