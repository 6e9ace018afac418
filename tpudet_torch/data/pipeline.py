"""Host-side input pipeline feeding the device (counterpart of
``tpudet/data/pipeline.py``: with the same seed it yields the same batches).

Replaces the reference's ``tf.data`` generator (tfrecord_voc_utils.py:115-120:
map(parse+augment) -> shuffle -> batch(drop_remainder) -> repeat, consumed via a
reinitializable iterator). Key differences, TPU-first:

  * records are index-shuffled per epoch (O(1) random access into the shard files via
    a byte-offset index) instead of a streaming shuffle buffer — strictly stronger
    shuffling with no buffer memory;
  * an optional background thread decodes/augments ahead so the accelerator step
    overlaps host preprocessing;
  * per-host sharding for multi-process SPMD: pass ``shard_index/num_shards`` and each
    host reads a disjoint slice of the global index (SURVEY.md §2.5 input sharding).

``get_generator`` keeps the reference's return shape ``(initializer, iterator)`` so
driver scripts port verbatim: ``initializer()`` restarts an epoch, ``next(iterator)``
yields ``(images [B,H,W,3] f32, gt [B,pad,5] f32)`` host arrays.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpudet_torch.data import tfrecord, voc
from tpudet_torch.data.augment import image_augmentor


class _RecordIndex:
    def __init__(self, paths: Sequence[str]):
        self.entries: List[Tuple[str, int, int]] = []
        for p in paths:
            for off, ln in tfrecord.index_records(p):
                self.entries.append((p, off, ln))
        self._local = threading.local()  # per-thread handles: seek/read must not race

    def read(self, i: int) -> bytes:
        path, off, ln = self.entries[i]
        handles = getattr(self._local, "handles", None)
        if handles is None:
            handles = self._local.handles = {}
        h = handles.get(path)
        if h is None:
            h = handles[path] = open(path, "rb")
        h.seek(off)
        return h.read(ln)

    def __len__(self):
        return len(self.entries)


class _ProducerError:
    """Sentinel carrying a producer-thread exception to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class VOCLoader:
    """Iterator of augmented (images, gt) batches; infinite (``repeat()``), with
    ``reset()`` reshuffling and restarting like the reference's initializer."""

    def __init__(self, tfrecords: Sequence[str], batch_size: int, buffer_size: int,
                 image_preprocess_config: Dict, seed: int = 0,
                 shard_index: int = 0, num_shards: int = 1,
                 prefetch: int = 2, num_workers: int = 0):
        del buffer_size  # full index shuffle supersedes the reference's buffer
        self.index = _RecordIndex(tfrecords)
        self.batch_size = batch_size
        self.aug_config = dict(image_preprocess_config)
        self.rng = np.random.default_rng(seed)
        ids = np.arange(len(self.index))
        self.local_ids = ids[shard_index::num_shards]
        self.prefetch = prefetch
        self.num_workers = num_workers
        self._pool = None
        if num_workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=num_workers)
        self._thread: Optional[threading.Thread] = None
        self._queue: Optional[queue.Queue] = None
        self._stop = threading.Event()
        self.reset()

    def _epoch_order(self):
        order = self.local_ids.copy()
        self.rng.shuffle(order)
        return order

    def _one(self, i, seed):
        image, shape, gt = voc.parse_voc_record(self.index.read(int(i)))
        return image_augmentor(image=image, input_shape=shape, ground_truth=gt,
                               rng=np.random.default_rng(seed), **self.aug_config)

    def _make_batch(self, ids):
        seeds = self.rng.integers(0, 2**63, size=len(ids))
        if self._pool is not None:
            results = list(self._pool.map(self._one, ids, seeds))
        else:
            results = [self._one(i, s) for i, s in zip(ids, seeds)]
        images = [r[0] for r in results]
        gts = [r[1] for r in results]
        return np.stack(images), np.stack(gts)

    def _producer(self, stop: threading.Event, out: queue.Queue):
        # stop/out are captured at thread start: if reset() times out joining this
        # thread and spawns a replacement, the orphan keeps honoring ITS OWN stop
        # event and never produces into the new queue
        try:
            while not stop.is_set():
                order = self._epoch_order()
                nb = len(order) // self.batch_size
                for b in range(nb):
                    if stop.is_set():
                        return
                    batch = self._make_batch(
                        order[b * self.batch_size:(b + 1) * self.batch_size])
                    while not stop.is_set():
                        try:
                            out.put(batch, timeout=0.5)
                            break
                        except queue.Full:
                            continue
        except BaseException as exc:  # surface decode/augment errors to __next__
            while not stop.is_set():
                try:
                    out.put(_ProducerError(exc), timeout=0.5)
                    return
                except queue.Full:
                    continue

    def reset(self):
        """Restart (reference: rerun the iterator initializer per epoch)."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5)
        self._stop = threading.Event()
        self._queue = queue.Queue(maxsize=max(1, self.prefetch))
        self._thread = threading.Thread(
            target=self._producer, args=(self._stop, self._queue), daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                item = self._queue.get(timeout=5.0)
            except queue.Empty:
                if self._thread is not None and not self._thread.is_alive():
                    raise RuntimeError(
                        "input pipeline producer thread died without an error")
                continue
            if isinstance(item, _ProducerError):
                raise RuntimeError("input pipeline producer failed") from item.exc
            return item

    def close(self):
        self._stop.set()


def get_generator(tfrecords, batch_size, buffer_size, image_preprocess_config,
                  **kwargs):
    """Reference-compatible factory (tfrecord_voc_utils.py:115-120):
    returns ``(initializer, iterator)``."""
    loader = VOCLoader(tfrecords, batch_size, buffer_size, image_preprocess_config,
                       **kwargs)
    return loader.reset, loader
