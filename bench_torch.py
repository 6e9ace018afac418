"""Benchmark of the port: SSD300 train-step throughput on one NVIDIA GPU (the
counterpart of ``bench.py``, with its protocol).

One fixed seeded batch of 32 images of 300x300 with the same two boxes each,
SSD300 at bf16 from seeded random weights (``pretraining_weight`` None):

  * per step: the batch sent to the card once, 2 warm-up ``train_step``s at
    lr 0.001, then ``BENCH_STEPS`` (default 30) timed steps, synced on the
    last loss;
  * scanned: a ``DeviceDataset`` over the same rows with ``batch`` rows, so
    the model's scanned epoch is what gets timed: one warm epoch, then one
    timed epoch of ``max(BENCH_STEPS, 20)`` steps. A failure there is
    printed and reported as null.

Both kernels of the step (the assignment and the mining NMS) must launch
once a step: the bench raises unless each launch counter moved by exactly the
number of timed steps (on the CPU, where the wrappers run their plain
versions, by none).

Run from the root of a checkout:  python bench_torch.py
The last line of standard output is one JSON object:
  {"metric": ..., "value": images/s/chip, "unit": "images/sec/chip",
   "scan_epoch_imgs_per_sec": ..., "device": "<name>, <power limit>"}
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from tpudet_torch import device as device_lib  # noqa: E402
from tpudet_torch.ops.cuda import assign_kernel, nms_kernel  # noqa: E402

BATCH = int(os.environ.get("BENCH_BATCH", 32))
STEPS = int(os.environ.get("BENCH_STEPS", 30))
LR = 0.001


def _build_model(batch, device=None):
    from tpudet_torch.models.ssd import SSD300

    size = SSD300.input_size
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 255, (batch, size, size, 3)).astype(np.float32)
    gt = -np.ones((batch, 60, 5), np.float32)
    gt[:, 0] = [150, 150, 120, 90, 7]
    gt[:, 1] = [60, 200, 50, 70, 2]

    def batches():
        while True:
            yield images, gt

    config = {
        "mode": "train",
        "data_format": "channels_last",
        "num_classes": 20,
        "weight_decay": 1e-4,
        "keep_prob": 1.0,
        "batch_size": batch,
        "nms_score_threshold": 0.5,
        "nms_max_boxes": 20,
        "nms_iou_threshold": 0.5,
        "pretraining_weight": None,
        "compute_dtype": "bfloat16",
    }
    provider = {
        "data_shape": [size, size, 3],
        "num_train": batch * 10**9,
        "num_val": 0,
        "train_generator": (lambda: None, batches()),
        "val_generator": None,
    }
    return SSD300(config, provider, device=device), images, gt


def _launches():
    return nms_kernel.launches, assign_kernel.launches


def _check_launches(model, before, steps):
    """Each kernel launched once a step on the card (none on the CPU)."""
    want = steps if model.device.type == "cuda" else 0
    moved = tuple(a - b for a, b in zip(_launches(), before))
    if moved != (want, want):
        raise RuntimeError(f"{steps} timed steps moved the NMS and assignment launch "
                           f"counters by {moved}; each should move by {want}")


def _time_steps(model, images, gt, steps, warmup=2):
    dimages, dgt = model._to_device(images, gt)
    for _ in range(warmup):
        loss = model.train_step(dimages, dgt, LR)
    loss.item()
    before = _launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = model.train_step(dimages, dgt, LR)
    loss.item()  # the steps run in order on one stream: the last loss syncs all
    dt = time.perf_counter() - t0
    _check_launches(model, before, steps)
    return images.shape[0] * steps / dt


def _time_scan(model, images, gt, steps):
    """The port's scanned epoch (``train_one_epoch`` over a resident
    ``DeviceDataset`` of the same rows, as uint8) of ``steps`` steps, after one
    warm epoch. The epochs' progress lines go to standard error."""
    from tpudet_torch.data.device_dataset import DeviceDataset

    ds = DeviceDataset(images.astype(np.uint8), gt, images.shape[0], device=model.device)
    model.train_initializer, model.train_iterator = None, ds
    model.num_train = steps * images.shape[0]
    with contextlib.redirect_stdout(sys.stderr):
        model.train_one_epoch(LR)  # warm
        before = _launches()
        t0 = time.perf_counter()
        model.train_one_epoch(LR)  # returns the epoch's mean loss: a sync
        dt = time.perf_counter() - t0
    _check_launches(model, before, steps)
    return images.shape[0] * steps / dt


def main(batch=BATCH, steps=STEPS, device=None):
    dev = device_lib.resolve(device)
    model, images, gt = _build_model(batch, device=dev)
    rate = _time_steps(model, images, gt, steps)
    try:
        scan_rate = _time_scan(model, images, gt, max(steps, 20))
    except Exception:
        # visible failure: the scanned epoch is the path convergence runs use
        import traceback

        traceback.print_exc()
        scan_rate = None
    result = {
        "metric": "ssd300_train_imgs_per_sec_per_chip_bs%d_bf16" % batch,
        "value": round(rate, 2),
        "unit": "images/sec/chip",
        "scan_epoch_imgs_per_sec": round(scan_rate, 2) if scan_rate else None,
        "device": device_lib.card_line(dev),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
