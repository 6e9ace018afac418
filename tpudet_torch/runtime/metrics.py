"""Observability: step timing, throughput meters, and torch.profiler trace hooks
(counterpart of ``tpudet/runtime/metrics.py``).

``StepTimer`` (wall-clock per step; call ``mark`` after a synchronised step),
``Throughput`` (images/sec), ``trace`` (a context manager around
``torch.profiler`` that writes a Chrome trace, viewable in Perfetto or
``chrome://tracing``; tpudet's hook wraps ``jax.profiler``) and
``block_until_ready`` (waits for the devices of a tree's tensors).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch


class StepTimer:
    """Wall-clock timing with percentile summaries; call mark() after each synced step."""

    def __init__(self):
        self._times = []
        self._last = None

    def start(self):
        self._last = time.perf_counter()

    def mark(self):
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
        self._last = now

    def summary(self):
        if not self._times:
            return {}
        t = np.asarray(self._times)
        return {
            "steps": len(t),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p90_s": float(np.percentile(t, 90)),
            "total_s": float(t.sum()),
        }


class Throughput:
    def __init__(self, items_per_step: int):
        self.items_per_step = items_per_step
        self.timer = StepTimer()

    def start(self):
        self.timer.start()

    def mark(self):
        self.timer.mark()

    def items_per_sec(self) -> Optional[float]:
        s = self.timer.summary()
        if not s:
            return None
        return self.items_per_step / s["p50_s"]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a block with ``torch.profiler`` (the CPU, and CUDA where a card
    is present) and write ``logdir/trace.<pid>.json``, a Chrome trace. Yields
    the profiler, whose ``key_averages()`` sums the time by operation."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace.{os.getpid()}.json"))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block_until_ready(tree):
    """Wait until the work that produces ``tree``'s tensors (nested dicts,
    lists and tuples) is done on every CUDA device they lie on; returns
    ``tree``."""
    for device in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)
    return tree
