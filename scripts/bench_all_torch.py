"""Per-model benchmarks of the port on one NVIDIA GPU: train images/s at each
family's driver batch and shape, the train step's FLOPs with an MFU column,
and p50 single-image serve latency (the counterpart of ``scripts/bench_all.py``,
with its specs and protocol).

For each family: one seeded batch of ``spec["batch"]`` images with the same
two boxes each, sent to the card once; the model from seeded random weights
at the spec's config (bfloat16); 2 warm-up ``train_step``s at lr 1e-3, then
``train_steps`` timed steps synced on the last loss; one more, untimed step
under ``torch.utils.flop_counter.FlopCounterMode``; then ``latency_runs``
batch-1 ``test_one_image`` calls on integral pixels with the spec's config in
``mode: "test"``.

Fields (tpudet's names): ``compile_plus_warmup_s`` (for the port: building
the model, the kernels' first build and the 2 warm-up steps),
``train_step_ms``, ``train_imgs_per_sec``, ``loss_finite``,
``train_step_tflop`` and ``mfu_pct`` (against ``PEAK_BF16_FLOPS``),
``infer_p50_ms``, the kernels' launches in the timed steps and ``device``
(the card's name and power limit).

The FLOP count is PyTorch's: it counts convolutions and matrix products
(forward and backward) only, not the hand-written NMS and assignment kernels
nor elementwise work, so it is not XLA's ``cost_analysis`` figure that
tpudet's script reports.

Each kernel's launch counter must move as by design in the timed steps
(``KERNELS_A_STEP``; on the CPU, where the wrappers run their plain versions,
not at all), or the family records an error. Full-width per-pick reruns of an
NMS pool that ran out are reported apart. A family that fails records its
error and the rest go on; the script then exits 1.

Run from the root of a checkout:  python scripts/bench_all_torch.py [model ...]
(all ten families when none is named). Writes BENCH_DETAILS_TORCH.json at the
root of the checkout, merged into what is there.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from tpudet_torch import device as device_lib  # noqa: E402
from tpudet_torch.ops.cuda import assign_kernel, nms_kernel  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "BENCH_DETAILS_TORCH.json")
LR = 1e-3
WARMUP_STEPS = 2
# NVIDIA's data sheet, H100 SXM5: dense bfloat16 tensor-core peak at the 700 W limit
PEAK_BF16_FLOPS = 989.4e12
FLOP_COUNT_NOTE = ("torch.utils.flop_counter.FlopCounterMode over one untimed train "
                   "step: convolutions and matrix products, forward and backward; not "
                   "the hand-written kernels nor elementwise work, so not XLA's "
                   "cost_analysis figure")
# the assignment kernel's launches and the NMS kernel's sorted scans a training
# step by design; a family not named launches neither
KERNELS_A_STEP = {
    "SSD300": (1, 1), "SSD512": (1, 1), "RetinaNet": (1, 0), "RefineDet320": (1, 1),
    "PFPNetR": (1, 1), "LHRCNN": (0, 2),
}


def _specs():
    return {
        "SSD300": dict(batch=32, shape=(300, 300), config={
            "mode": "train", "data_format": "channels_last", "num_classes": 20,
            "weight_decay": 1e-4, "keep_prob": 0.5, "batch_size": 32,
            "nms_score_threshold": 0.5, "nms_max_boxes": 20,
            "nms_iou_threshold": 0.5, "pretraining_weight": None,
            "compute_dtype": "bfloat16"}),
        "YOLOv3": dict(batch=12, shape=(448, 448), config={
            "mode": "train", "data_shape": [448, 448, 3], "num_classes": 20,
            "weight_decay": 5e-4, "keep_prob": 0.5, "data_format": "channels_last",
            "batch_size": 12, "coord_scale": 1, "noobj_scale": 1, "obj_scale": 5.0,
            "class_scale": 1.0, "num_priors": 3,
            "nms_score_threshold": 0.5, "nms_max_boxes": 10,
            "nms_iou_threshold": 0.5, "compute_dtype": "bfloat16",
            "priors": [[[10.0, 13.0], [16, 30.0], [33.0, 23.0]],
                       [[30.0, 61.0], [62.0, 45.0], [59.0, 119.0]],
                       [[116.0, 90.0], [156.0, 198.0], [373.0, 326.0]]]}),
        "RetinaNet": dict(batch=32, shape=(500, 500), config={
            "is_bottleneck": True, "residual_block_list": [3, 4, 6, 3],
            "init_conv_filters": 16, "mode": "train", "is_pretraining": False,
            "data_shape": [500, 500, 3], "num_classes": 20, "weight_decay": 1e-4,
            "keep_prob": 0.5, "data_format": "channels_last", "batch_size": 32,
            "gamma": 2.0, "alpha": 0.25, "nms_score_threshold": 0.8,
            "nms_max_boxes": 10, "nms_iou_threshold": 0.45,
            "compute_dtype": "bfloat16"}),
        "CenterNet": dict(batch=15, shape=(384, 384), config={
            "mode": "train", "input_size": 384, "data_format": "channels_last",
            "num_classes": 20, "weight_decay": 1e-4, "keep_prob": 0.5,
            "batch_size": 15, "score_threshold": 0.1, "top_k_results_output": 100,
            "compute_dtype": "bfloat16"}),
        "FCOS": dict(batch=8, shape=(800, 1200), config={
            "mode": "train", "data_shape": [800, 1200, 3],
            "data_format": "channels_last", "num_classes": 20,
            "weight_decay": 1e-4, "keep_prob": 0.5, "batch_size": 8,
            "nms_score_threshold": 0.5, "nms_max_boxes": 10,
            "nms_iou_threshold": 0.45, "compute_dtype": "bfloat16"}),
        "RefineDet320": dict(batch=32, shape=(320, 320), config={
            "mode": "train", "input_size": 320, "data_format": "channels_last",
            "num_classes": 20, "weight_decay": 1e-4, "keep_prob": 0.5,
            "batch_size": 32, "nms_score_threshold": 0.1, "nms_max_boxes": 20,
            "nms_iou_threshold": 0.45, "pretraining_weight": None,
            "compute_dtype": "bfloat16"}),
        "YOLOv2": dict(batch=32, shape=(480, 480), config={
            "mode": "train", "data_shape": [480, 480, 3], "num_classes": 20,
            "weight_decay": 1e-4, "keep_prob": 0.5, "data_format": "channels_last",
            "batch_size": 32, "coord_scale": 1, "noobj_scale": 1, "obj_scale": 5.0,
            "class_scale": 1.0, "nms_score_threshold": 0.5, "nms_max_boxes": 10,
            "nms_iou_threshold": 0.5, "rescore_confidence": False,
            "priors": [[1.08, 1.19], [3.42, 4.41], [6.63, 11.38], [9.42, 5.11],
                       [16.62, 10.52]], "compute_dtype": "bfloat16"}),
        "PFPNetR": dict(batch=32, shape=(320, 320), config={
            "mode": "train", "input_size": 320, "data_format": "channels_last",
            "num_classes": 20, "weight_decay": 1e-4, "keep_prob": 0.5,
            "batch_size": 32, "nms_score_threshold": 0.1, "nms_max_boxes": 20,
            "nms_iou_threshold": 0.45, "pretraining_weight": None,
            "compute_dtype": "bfloat16"}),
        "LHRCNN": dict(batch=8, shape=(700, 1100), config={
            "data_shape": [700, 1100, 3], "mode": "train", "is_pretraining": False,
            "data_format": "channels_last", "num_classes": 20, "weight_decay": 1e-4,
            "keep_prob": 0.5, "batch_size": 8, "rpn_first_step": 60000,
            "rcnn_first_step": 100000, "rpn_second_step": 160000,
            "nms_score_threshold": 0.5, "nms_max_boxes": 20,
            "nms_iou_threshold": 0.45, "post_nms_proposal": 500,
            "compute_dtype": "bfloat16"}),
        "SSD512": dict(batch=32, shape=(512, 512), config={
            "mode": "train", "data_format": "channels_last", "num_classes": 20,
            "weight_decay": 1e-4, "keep_prob": 0.5, "batch_size": 32,
            "nms_score_threshold": 0.5, "nms_max_boxes": 20,
            "nms_iou_threshold": 0.5, "pretraining_weight": None,
            "compute_dtype": "bfloat16"}),
    }


def seeded_batch(spec):
    """tpudet's bench batch for ``spec``: ``spec["batch"]`` images of uniform
    pixels from seed 0 (float32 NHWC), each with the same two boxes in gt
    padded to 60 rows with -1."""
    h, w = spec["shape"]
    batch = spec["batch"]
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 255, (batch, h, w, 3)).astype(np.float32)
    gt = -np.ones((batch, 60, 5), np.float32)
    gt[:, 0] = [h * 0.5, w * 0.5, h * 0.3, w * 0.25, 7]
    gt[:, 1] = [h * 0.2, w * 0.7, h * 0.15, w * 0.2, 2]
    return images, gt


def fixed_provider(images, gt):
    """A data provider that yields ``(images, gt)`` for ever."""
    def batches():
        while True:
            yield images, gt

    h, w = images.shape[1:3]
    return {"data_shape": [h, w, 3], "num_train": images.shape[0] * 10**9, "num_val": 0,
            "train_generator": (lambda: None, batches()), "val_generator": None}


def _counts():
    return {"assign": assign_kernel.launches, **nms_kernel.launches_by_path}


def _launches(name, dev, before, steps):
    """The kernels' launches since ``before``: the assignments and the NMS
    pools (one sorted scan each) must be ``KERNELS_A_STEP``'s a step on the
    card and none on the CPU; the pools' continuation launches (one for each
    pool narrower than its rows) are counted apart."""
    moved = {k: v - before[k] for k, v in _counts().items()}
    assigns, scans = KERNELS_A_STEP.get(name, (0, 0)) if dev.type == "cuda" else (0, 0)
    if (moved["assign"], moved["scan"]) != (assigns * steps, scans * steps) or (
            not scans and moved["continue"]):
        raise RuntimeError(f"{name}: {steps} timed steps launched {moved}; by design "
                           f"{assigns} assignments and {scans} sorted scans a step")
    return {"steps": steps, "assign": moved["assign"], "nms_scan": moved["scan"],
            "nms_continue": moved["continue"]}


def _sync(dev):
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def step_flops(model, images, gt, lr=LR) -> int:
    """FLOPs of one ``train_step`` on ``images``/``gt`` (device tensors) as
    ``FlopCounterMode`` counts them; the step is taken."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        model.train_step(images, gt, lr)
    return int(counter.get_total_flops())


def bench_model(name, spec, train_steps=6, latency_runs=15, device=None):
    """One family's figures (module docstring); ``device=None`` is the card."""
    import torch

    from tpudet_torch import models

    dev = device_lib.resolve(device)
    cls = getattr(models, name)
    batch = spec["batch"]
    images, gt = seeded_batch(spec)
    result = {}

    t0 = time.time()
    model = cls(dict(spec["config"]), fixed_provider(images, gt), device=dev)
    dimages, dgt = model._to_device(images, gt)
    for _ in range(WARMUP_STEPS):
        loss = model.train_step(dimages, dgt, LR)
    float(loss)
    result["compile_plus_warmup_s"] = round(time.time() - t0, 1)
    before = _counts()
    t0 = time.perf_counter()
    for _ in range(train_steps):
        loss = model.train_step(dimages, dgt, LR)
    loss = float(loss)  # the steps run in order on one stream: the last loss syncs all
    dt = (time.perf_counter() - t0) / train_steps
    result["train_step_ms"] = round(dt * 1000, 1)
    result["train_imgs_per_sec"] = round(batch / dt, 1)
    result["loss_finite"] = bool(math.isfinite(loss))
    result["kernel_launches"] = _launches(name, dev, before, train_steps)

    flops = step_flops(model, dimages, dgt)
    _sync(dev)
    result["train_step_tflop"] = round(flops / 1e12, 3)
    result["mfu_pct"] = round(flops / dt / PEAK_BF16_FLOPS * 100.0, 2)
    result["mfu_peak_tflops"] = PEAK_BF16_FLOPS / 1e12
    result["flop_count"] = FLOP_COUNT_NOTE
    del model, dimages, dgt

    # p50 serve latency (test mode, batch 1, the decode and its NMS on the
    # device) on integral 0..255 pixels, what a decoded image holds
    test_cfg = dict(spec["config"])
    test_cfg["mode"] = "test"
    tm = cls(test_cfg, None, device=dev)
    img1 = np.floor(images[:1])
    tm.test_one_image(img1)  # warm: the first call's allocations and builds
    times = []
    for _ in range(latency_runs):
        t0 = time.perf_counter()
        tm.test_one_image(img1)  # returns host arrays: a sync
        times.append(time.perf_counter() - t0)
    result["infer_p50_ms"] = round(float(np.percentile(times, 50)) * 1000, 2)
    result["device"] = device_lib.card_line(dev)
    del tm
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return result


def main(argv=None, out=OUT, device=None) -> int:
    names = list(sys.argv[1:] if argv is None else argv) or list(_specs())
    results = {}
    if os.path.exists(out):
        with open(out) as f:
            results = json.load(f)
    failed = []
    for name in names:
        print("=== bench", name, flush=True)
        try:
            results[name] = bench_model(name, _specs()[name], device=device)
        except Exception as e:  # keep going; record the failure
            import traceback

            traceback.print_exc()
            results[name] = {"error": repr(e)[:500]}
            failed.append(name)
        print(name, "->", results[name], flush=True)
        with open(out, "w") as f:
            json.dump(results, f, indent=1)
    print("wrote", out)
    if failed:
        print("failed:", ", ".join(failed), file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
