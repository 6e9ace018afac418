"""A training set held in device memory (counterpart of
``tpudet/data/device_dataset.py``).

The images are uploaded once as uint8; each batch is gathered on the device
from an index vector, so a step moves ``[B]`` indices instead of a batch of
pixels. With ``device_augment`` in the model's config the flips and colour
jitter run inside the step as well (``device_augment.py``), and nothing of
the host's augmentor is left on the training path.

Index streams are tpudet's: the same ``numpy.random.default_rng`` calls in
the same order, so a seed gives tpudet's batches.

Two residencies:

  * plain: the whole set, or a ``max_bytes`` subset drawn from the seed,
    staged on the host until first use, then one upload;
  * chunked (``chunk_bytes``): the resident set as K chunks of
    ``chunk_bytes``, one pinned at a time and visited in a reshuffled cycle;
    with ``rotate_every`` one chunk is refreshed from the non-resident rest
    every N-th pin, the upload started early on a thread that copies from
    pinned host memory on its own CUDA stream, so a dataset larger than the
    budget is covered over time.

``distribute`` and ``make_gather`` (tpudet's sharding over a device mesh)
are not ported yet: ROADMAP.md queue 1 item 8, data parallelism.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from tpudet_torch import device as device_lib

_MESH = "ROADMAP.md queue 1 item 8, data parallelism"


class DeviceDataset:
    """Infinite ``(images, gt)`` iterator over a dataset resident on
    ``device`` (``None``: the card).

    Args:
      images: ``[N, H, W, 3]`` uint8 (an array or a memmap).
      gt: ``[N, P, 5]`` float32 padded ground truth.
      batch: batch size.
      seed: shuffle seed.
      max_bytes: the device budget of the images; past it a seeded subset
        is kept (plain) or the resident chunks are capped (chunked).
      chunk_bytes: chunked residency, chunks of this many image bytes.
      rotate_every: with ``chunk_bytes``, refresh one chunk from the
        non-resident rows every N-th pin; None never does.

    Batches are NHWC uint8 images and float32 gt on the dataset's device.
    Chunked, three logs: ``pin_log`` records each pin's slot and its
    rotation (None, ``"sync"``: refreshed there, or ``"joined"``: a
    background refresh joined there); ``joins`` each join of a background
    refresh (at a pin, a ``reset`` or ``close``): its slot, whether it had finished
    before it was joined, the seconds waited; ``uploads`` each chunk
    upload's slot, seconds and whether it ran in the background.
    """

    def __init__(self, images, gt, batch: int, seed: int = 0,
                 max_bytes: Optional[int] = None,
                 chunk_bytes: Optional[int] = None,
                 rotate_every: Optional[int] = None,
                 device: str | torch.device | None = None):
        self.device = device_lib.resolve(device)
        n = images.shape[0]
        self.rng = np.random.default_rng(seed)
        self._chunked = chunk_bytes is not None
        self._rotate_every = rotate_every
        self.pin_log = []
        self.joins = []
        self.uploads = []
        per = int(np.prod(images.shape[1:]))  # uint8 bytes per image
        if self._chunked:
            self._init_chunked(images, gt, batch, per, max_bytes, chunk_bytes)
            return
        if max_bytes is not None:
            cap = max(batch, int(max_bytes // per))
            if cap < n:
                keep = np.sort(self.rng.choice(n, size=cap, replace=False))
                print(f"[DeviceDataset] caching {cap}/{n} images "
                      f"({cap * per / 1e9:.2f} GB) to fit the device budget", flush=True)
                images, gt = images[keep], gt[keep]
                n = cap
        self.n, self.batch = n, batch
        # staged on the host until the first batch
        self._host_images = np.ascontiguousarray(images, np.uint8)
        self._host_gt = np.ascontiguousarray(gt, np.float32)
        self._images = None
        self._gt = None
        self._order = np.arange(self.n)
        self._pos = self.n  # shuffle on the first batch

    # ------------------------------------------------------ chunked residency
    def _init_chunked(self, images, gt, batch, per, max_bytes, chunk_bytes):
        n = images.shape[0]
        self.batch = batch
        self._full_images, self._full_gt = images, gt  # memmaps stay on disk
        resident_cap = n if max_bytes is None else max(batch, int(max_bytes // per))
        self.chunk_rows = min(max(batch, int(chunk_bytes // per)), min(n, resident_cap))
        self.k_chunks = max(1, min(n, resident_cap) // self.chunk_rows)
        resident = self.k_chunks * self.chunk_rows
        self.n = resident  # rows addressable per epoch-slice
        perm = self.rng.permutation(n)
        self._slot_rows = [np.sort(perm[c * self.chunk_rows:(c + 1) * self.chunk_rows])
                           for c in range(self.k_chunks)]
        self._pool = list(perm[resident:])  # non-resident rows (FIFO)
        print(f"[DeviceDataset] chunked residency: {self.k_chunks} x "
              f"{self.chunk_rows} rows ({resident}/{n} resident, "
              f"{self.chunk_rows * per / 1e9:.2f} GB/chunk"
              + (f", rotate every {self._rotate_every} pins"
                 if self._rotate_every and self._pool else "") + ")", flush=True)
        self._dev_chunks = None  # uploaded on first use
        self._ready = {}  # slot -> the CUDA event its background upload recorded
        self._slot_order = [np.arange(self.chunk_rows) for _ in range(self.k_chunks)]
        self._slot_pos = [self.chunk_rows] * self.k_chunks  # shuffle on 1st draw
        self._cycle = self.rng.permutation(self.k_chunks)
        self._cycle_pos = 0
        self._pin = None
        self._pin_count = 0
        self._pin_draws = 0  # batches drawn from the current pin (per-step path)
        self._prefetch = None  # (slot, Thread) refreshing a later pin's chunk

    def _chunk_host_arrays(self, rows):
        return (np.ascontiguousarray(self._full_images[rows], dtype=np.uint8),
                np.ascontiguousarray(self._full_gt[rows], dtype=np.float32))

    def _upload(self, arrays, slot: int, background: bool):
        """The host arrays on the device. In the background on a card: from
        pinned memory on a stream of the thread's own, with an event the pin
        waits on before the chunk is read."""
        t = time.perf_counter()
        event = None
        if background and self.device.type == "cuda":
            stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(stream):
                out = tuple(torch.from_numpy(a).pin_memory().to(self.device,
                                                                non_blocking=True)
                            for a in arrays)
                event = torch.cuda.Event()
                event.record(stream)
            event.synchronize()  # the thread's own wait: the upload's time
        else:
            out = tuple(torch.from_numpy(a).to(self.device) for a in arrays)
        self.uploads.append(dict(slot=slot, seconds=time.perf_counter() - t,
                                 background=background))
        return out, event

    def _ensure_chunks_resident(self):
        if self._dev_chunks is None:
            self._dev_chunks = [
                self._upload(self._chunk_host_arrays(rows), s, False)[0]
                for s, rows in enumerate(self._slot_rows)]

    def _refresh_slot(self, s: int, background: bool = False):
        """Swap part of slot ``s`` with rows from the non-resident pool (one
        chunk-sized upload); the replaced rows rejoin the pool.

        ``background=True`` does the pool's bookkeeping here and the upload on
        a thread, returned for the caller to join before the slot is pinned,
        so the upload for a later pin overlaps the steps of the current one."""
        m = min(len(self._pool), self.chunk_rows)
        if m == 0:
            return None
        new_ids = np.asarray(self._pool[:m])
        del self._pool[:m]
        old = self._slot_rows[s]
        self._pool.extend(old[:m].tolist())
        self._slot_rows[s] = np.sort(np.concatenate([new_ids, old[m:]]))

        def upload():
            chunk, event = self._upload(self._chunk_host_arrays(self._slot_rows[s]), s,
                                        background)
            self._dev_chunks[s] = chunk
            if event is not None:
                self._ready[s] = event
            self._slot_pos[s] = self.chunk_rows  # fresh rows: reshuffle the stream

        if background:
            t = threading.Thread(target=upload, daemon=True)
            t.start()
            return t
        upload()
        return None

    def _next_cycle_slot(self) -> int:
        """Peek (and if needed re-deal) the cycle at ``_cycle_pos``."""
        if self._cycle_pos >= self.k_chunks:
            self._cycle = self.rng.permutation(self.k_chunks)
            self._cycle_pos = 0
        return int(self._cycle[self._cycle_pos])

    def _advance_pin(self):
        self._ensure_chunks_resident()
        s = self._next_cycle_slot()
        self._cycle_pos += 1
        self._pin_count += 1
        rotation_due = bool(self._rotate_every
                            and self._pin_count % self._rotate_every == 0)
        record = dict(pin=self._pin_count, slot=s, refresh=None)
        if self._prefetch is not None and (rotation_due or self._prefetch[0] == s):
            # join only when the refreshed slot is needed (pinned now, or its
            # rotation pin arrived): joining earlier would forfeit the overlap
            self._join_prefetch("pin")
            record["refresh"] = "joined"
            # a joined prefetch is this period's rotation, whichever slot it
            # landed on
            rotation_due = False
        if rotation_due and self._pool:
            self._refresh_slot(s)
            record["refresh"] = "sync"
        event = self._ready.pop(s, None)
        if event is not None:
            # the chunk was written on the upload thread's stream: this
            # stream waits for it, and the allocator keeps its memory until
            # this stream's work on it is done
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for tensor in self._dev_chunks[s]:
                tensor.record_stream(stream)
        self._pin = s
        self._pin_draws = 0
        self.pin_log.append(record)
        # the double buffer, started early: the slot of the next rotation pin
        # is known while that pin is still inside the current cycle round, so
        # its refresh starts up to rotate_every - 1 pins ahead
        if (self._prefetch is None and self._rotate_every and self._pool
                and self.k_chunks > 1):
            nxt = ((self._pin_count // self._rotate_every) + 1) * self._rotate_every
            ahead = nxt - self._pin_count  # pins until the next rotation pin
            look = self._cycle_pos + ahead - 1
            if look < self.k_chunks:  # the rotation pin is in the current round
                ns = int(self._cycle[look])
                if ns != s:
                    t = self._refresh_slot(ns, background=True)
                    if t is not None:
                        self._prefetch = (ns, t)

    def _join_prefetch(self, at: str):
        slot, t = self._prefetch
        finished = not t.is_alive()
        w = time.perf_counter()
        t.join()
        self.joins.append(dict(slot=slot, at=at, finished=finished,
                               wait_s=time.perf_counter() - w))
        self._prefetch = None

    def _draw_from_pinned(self, k: int) -> np.ndarray:
        s = self._pin
        order, pos = self._slot_order[s], self._slot_pos[s]
        out = np.empty((k, self.batch), np.int32)
        for i in range(k):
            if pos + self.batch > self.chunk_rows:
                self.rng.shuffle(order)
                pos = 0
            out[i] = order[pos:pos + self.batch]
            pos += self.batch
        self._slot_pos[s] = pos
        self._pin_draws += k
        return out

    # --------------------------------------------------------------- residency
    @property
    def images(self) -> torch.Tensor:
        """The resident images (chunked: the pinned chunk), NHWC uint8."""
        if self._chunked:
            if self._pin is None:
                self._advance_pin()
            return self._dev_chunks[self._pin][0]
        self._ensure_resident()
        return self._images

    @property
    def gt(self) -> torch.Tensor:
        """The resident gt (chunked: the pinned chunk's), float32."""
        if self._chunked:
            if self._pin is None:
                self._advance_pin()
            return self._dev_chunks[self._pin][1]
        self._ensure_resident()
        return self._gt

    @property
    def slot_rows(self) -> np.ndarray:
        """Chunked: the dataset rows of the pinned chunk, in its order."""
        return self._slot_rows[self._pin]

    def _ensure_resident(self):
        if self._images is None:
            (self._images, self._gt), _ = self._upload(
                (self._host_images, self._host_gt), 0, False)
            self._host_images = self._host_gt = None

    def distribute(self, mesh, device_batch: int):
        raise NotImplementedError(f"sharding a DeviceDataset is not ported yet ({_MESH})")

    def make_gather(self):
        raise NotImplementedError(f"sharding a DeviceDataset is not ported yet ({_MESH})")

    # ------------------------------------------------------------- index feed
    def next_indices(self, k: int) -> np.ndarray:
        """Advance the shuffle stream by ``k`` batches: ``[k, batch]`` int32
        row ids (chunked: offsets into the chunk pinned last)."""
        if self._chunked:
            if self._pin is None:
                self._advance_pin()
            return self._draw_from_pinned(k)
        out = np.empty((k, self.batch), np.int32)
        for i in range(k):
            if self._pos + self.batch > self.n:
                self.rng.shuffle(self._order)
                self._pos = 0
            out[i] = self._order[self._pos:self._pos + self.batch]
            self._pos += self.batch
        return out

    def scan_indices(self, k: int) -> torch.Tensor:
        """``next_indices(k)`` on the dataset's device, for an epoch of ``k``
        steps. Chunked: pins the next chunk of the cycle first (a rotation may
        refresh it), so read ``images``/``gt`` after this call."""
        if self._chunked:
            self._advance_pin()
            idx = self._draw_from_pinned(k)
        else:
            idx = self.next_indices(k)
        return torch.from_numpy(idx).to(self.device, non_blocking=True)

    def gather(self, idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The batch of rows ``idx`` (a tensor on the dataset's device) of
        the resident images and gt."""
        return (torch.index_select(self.images, 0, idx),
                torch.index_select(self.gt, 0, idx))

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._chunked:
            # the per-step path: advance the pin after a full pass over the chunk
            if self._pin is None or self._pin_draws * self.batch >= self.chunk_rows:
                self._advance_pin()
            idx = self._draw_from_pinned(1)[0]
        else:
            idx = self.next_indices(1)[0]
        return self.gather(torch.from_numpy(idx).to(self.device, non_blocking=True))

    def reset(self):
        """Reshuffle and restart (tpudet's initializer contract)."""
        if self._chunked:
            if self._prefetch is not None:  # settle the refresh in flight
                self._join_prefetch("reset")
            self._slot_pos = [self.chunk_rows] * self.k_chunks
            self._cycle_pos = self.k_chunks  # re-deal the chunk cycle
            self._pin = None
            return
        self._pos = self.n

    def close(self):
        """Settle a refresh in flight."""
        if self._chunked and self._prefetch is not None:
            self._join_prefetch("close")
