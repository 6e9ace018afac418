"""Drive the PyTorch/CUDA port (tpudet_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each raising on failure (nothing is caught):
  1. card and build: the card's name and power limit, then nvcc builds every
     kernel (NMS, anchor assignment) from the checkout's sources, one nvcc
     per source, all started together;
  2. each kernel against its plain PyTorch version, on the card, on the shapes
     the system gives it, with exact equality of the outputs: the NMS kernel's
     two designs (the sorted bitmask scan for rows up to 1024 candidates, one
     block per row beyond) on every case, a row holding a NaN included; the
     assignment kernel on eight cases, in one launch a call, with its scratch
     left at zero and back-to-back calls of other shapes; kernel times with
     CUDA events;
  3. serve: SSD300 at full width (300x300, 20 classes + background, 8828
     anchors) from seeded random weights answers requests through
     ``test_one_image``; the kernels' launch counts show the path went through
     them; outputs are checked against the plain versions on the same card and
     the network against the same weights on the CPU;
  4. train: SSD300 at full width, the SSD300 training config (batch 32,
     bfloat16, weight decay 1e-4, lr 0.01, hard-negative cap 384), trains on
     one fixed seeded batch through ``train_one_epoch``; the launch counts show
     every step ran the assignment kernel and the NMS kernel; the loss must be
     finite and fall; the loss with both kernels equals the loss with both
     plain versions on the same head outputs; then images/s and device time in
     bf16 and fp32, a profiler breakdown of one step, and the NMS kernel's two
     designs timed in turns on that step's own mining pool (and on a request's
     decode pool), the per-pick design at full width;
  5. RetinaNet serve: the RetinaNet training driver's config
     (``drivers/testretinanet.py``: 500x500, bottleneck [3, 4, 6, 3], 20
     classes, 47961 anchors) in test mode, fp32, score threshold 0.01, with
     BatchNorm statistics taken from 4 seeded images, answers 10 requests;
     decode with the kernel == with the plain version, the network against the
     CPU, launches by design;
  6. RetinaNet train: the same config (batch 32, bf16, focal loss) on one fixed
     batch through ``train_one_epoch``: one assignment launch and no NMS launch
     a step, a finite and falling loss, ``retina_loss`` with the kernel == with
     the plain version, images/s, ms/step, a profiled step, peak memory;
  7. RetinaNet's ImageNet pretraining mode: 3 steps at batch 32;
  8. both kernels at RetinaNet's shapes against their plain versions, timed:
     the assignment at [32, 60, 47961], the decode pool at [20, 47961], and a
     decode whose pool runs out, rerun at full width by the per-pick kernel;
  9. RefineDet320 and PFPNet-R at their training scripts' config
     (``drivers/testrefinedet.py``, ``drivers/testpfpnet.py``: 320x320, 20
     classes, 6375 anchors), each in turn: serve 10 fp32 requests at score
     threshold 0.01 (decode with the kernel == with the plain version, the
     network against the CPU, one NMS launch and no assignment a request);
     train 12 bf16 steps at batch 32 (2 warm-up, then ``train_one_epoch``; lr
     1e-4 and 1e-3) on one fixed batch: a finite, falling loss, one
     assignment and one or two NMS launches a step, ``refine_loss`` with the
     kernels == with the plain versions on one step's head outputs; then both
     kernels at the family's shapes, timed: the assignment at [32, 60, 6375],
     the mining pool [32, 768] of [32, 6375] and the decode pool [20, 512] of
     [20, 6375];
 10. SSD512 at its training script's config (``drivers/testSSD512.py``:
     512x512, 24912 anchors): serve 10 fp32 requests at score threshold 0.01
     and train 12 bf16 steps at batch 32 as phase 9 does, then both kernels
     timed at its shapes: the assignment at [32, 60, 24912], the mining pool
     [32, 768] of [32, 24912] and the decode pool [20, 512] of [20, 24912];
 11. YOLOv2 (``drivers/testYOLOv2.py``: 480x480, 5 priors, 1125 decode rows)
     and 12. YOLOv3 (``drivers/testYOLOv3.py``: 448x448, 3 heads of 3 priors,
     12348 decode rows), each in turn: serve 10 fp32 requests (BatchNorm
     statistics from 4 seeded images where the initial ones let the head
     outputs run away; the script's score threshold 0.5 where a class row
     then holds more than the pool's 512 candidates, else 0.01), exactly one
     NMS launch and no assignment a request, decode with the kernel == with
     the plain version, the network against the CPU; train 12 bf16 steps
     (batch 32 and 12, lr 0.005 and 0.001) with no kernel launch at all, a
     finite and falling loss, a profiled step and peak memory; then the NMS
     kernel's two designs and the whole pool call timed on a request's decode
     pool, [20, 512] of [20, 1125] and of [20, 12348];
 13. FCOS at its training script's config (``drivers/testfcos.py``: 800x1200,
     20 classes, the GroupNorm ResNet, 20017 locations): serve 10 fp32
     requests at a score threshold chosen and logged from one probe image
     (the prior bias puts both sigmoids near 0.01, so the script's 0.5
     selects nothing on random weights), exactly one NMS launch (the sorted
     scan on the pool [19, 512] of [19, 20017]: Q9 emits 19 classes) and no
     assignment a request, decode with the kernel == with the plain version,
     the network against the CPU; train 12 bf16 steps at batch 8 at lr 1e-3
     (tpudet's warm-up lr: at the script's 0.01 the loss of random weights
     runs away) with no kernel launch, a finite and falling loss, a profiled
     step and peak memory; then the NMS kernel's two designs and the whole
     pool call timed on a request's pool, and one decode forced to run out
     of its pool, rerun at full width by the per-pick kernel == the plain
     version;
 14. CenterNet at its training script's config (``drivers/testcenternet.py``:
     384x384, 20 classes, DLA, TF-style Adam): serve 10 fp32 requests at the
     script's score threshold 0.1 and top-k 100 (BatchNorm statistics from 4
     seeded images where the initial ones let the heads run away), no kernel
     launch, the decode on the card == the decode on the CPU on the same
     head outputs, the network against the CPU; train 12 bf16 steps at batch
     15, lr 0.001, with no kernel launch, a finite and falling loss, a
     profiled step and peak memory; one Adam update on the card against the
     CPU's on the same gradients; out-of-range labels leave the loss finite
     and the context usable;
 15. LH-RCNN at its training script's config (``drivers/testlhrcnn.py``:
     700x1100, 20 classes, 6818 anchors, post_nms_proposal 500): serve 10
     fp32 requests at a score threshold chosen and logged from one probe
     image (BatchNorm statistics from 4 seeded images where the initial ones
     let the RPN's ``phw`` run away or vanish): two sorted scans a request (the
     proposal pool [1, 1000] of [1, 6818], the class rows [20, 500]), a
     per-pick rerun only where the proposal pool runs out (counted), no
     assignment, decode with the kernel == with the plain version, the
     network and the RoI head against the CPU; train 12 bf16 steps at batch
     32, lr 0.003, on one fixed batch: 2 warm-up and 4 measured steps of
     the RPN phase from global_step 0, then the same in the RCNN phase from
     the script's ``rpn_first_step`` 60000; two NMS launches a step (the
     positive pool [32, 512] of [32, 6878] per-row boxes, the negative pool
     [32, 512] of [32, 6818]), no assignment, a finite loss that falls in
     each phase, the other phase's parameters and velocities bit for bit;
     ``rpn_loss_and_sample`` and ``rcnn_losses`` with the kernel == with the
     plain version; then the NMS kernel timed on the four pools and on the
     negative pool forced to run out, rerun at [32, 6818] by the per-pick
     kernel;
 16. the feed: drivers/testSSD300.py's path at full width. The mini VOC set
     (``tests/torch_data/voc_mini``, 8 images) replicated to 64 records,
     written by the port's ``voc.dataset2tfrecord`` into 2 shards and read
     back with every checksum verified; ``get_generator(shards, 32, 1024,
     cfg)`` with the training script's augmentor config, 3 batches timed on the host
     clock (and again with 4 worker threads), shapes and padding checked;
     SSD300 at the script's config (bf16, batch 32, lr 0.01, no pretrained
     weights) behind ``drivers/_common.py``'s provider: a warm-up epoch of 1 step, then
     ``train_one_epoch`` over 3 steps with the port's ``SummaryWriter``,
     finite losses, one assignment and one mining pool a step, the event
     file read back (one event a step), images/s, the busy share of one
     profiled step and peak memory beside phase 4's; then ``save_weight``,
     ``load_weight`` into a test-mode SSD300 and ``evaluate_model`` (VOC07
     mAP) on the 8 records at phase 3's score threshold: a finite mAP in
     [0, 1], one decode pool per image, one image's decode with the kernel ==
     with the plain version, seconds per image;
 17. the resident feed: the mini VOC set's 8 JPEGs decoded and resized once
     to 300x300 uint8, replicated to 5,000 images (1.35 GB; each replica's
     row id in its top-left pixel) and uploaded once into a ``DeviceDataset``
     on the card; SSD300 at drivers/testSSD300.py's config with
     ``device_augment`` (flips 0.5/0.5, colour jitter 0.5): 2 warm-up steps,
     then scanned and per-step epochs of 10 steps in turns (scanned,
     per-step, per-step, scanned), each with finite losses, one assignment and one mining pool a step, images/s, the busy
     share of one profiled step, the gather's and the augment's device time
     and peak memory beside phases 4 and 16; the augment on the card == on
     the CPU with the same draws (flips exactly, colour within 2e-3); then
     chunked residency (chunks of 1000, 4000 resident, a rotation every 2nd
     pin) over 4 scanned epochs of 10 steps: pins, rotations and indices
     equal a CPU dataset's on the same calls, each pinned chunk read back as
     its rows, pool rows on the card after a rotation, each pin's upload and
     wait logged.

The last lines are a JSON record of the kernels, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. float32 convolutions and matmuls
run without TF32 here (both switches are set off below), so the card's
network agrees with the CPU's to float32 accumulation-order error.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

F32_PEAK_FLOPS = 67e12   # H100 SXM float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
NEG = -1e30
IOU_FLOPS = 18  # per candidate per pick: 4 min/max, 4 sub, 2 clamp, 2 mul, add, sub, div, 2 cmp
# per (valid gt, anchor) pair: 4 min/max, 2 sub, 2 clamp, mul, add, sub, clamp,
# div, and the two running-argmax compares
ASSIGN_PAIR_FLOPS = 15
TRAIN_BATCH = 32
PROFILE_PAD_S = 0.01  # host pause at each end of a kernel's profiler session
PROFILE_SESSIONS = 3  # profiler sessions tried before a device time is "not measured"


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------- NMS cases
def nms_cases(anchor_corners):
    """(name, boxes, scores, num_select, max_out, iou_threshold) on numpy: the
    serving and training shapes, then the edge cases the CPU tests use."""
    import numpy as np
    from torch_nms_cases import corners, nms_case

    rng = np.random.default_rng(0)
    cases = []
    # decode pool: 20 classes x the 512-candidate pool, shared boxes
    scores = rng.uniform(0, 1, (20, 512)).astype(np.float32)
    scores[rng.uniform(size=scores.shape) < 0.3] = NEG
    cases.append(("decode_pool", corners(rng, (512,), 0, 300, 4, 120), scores,
                  np.full(20, 20, np.int32), 20, 0.5))
    # full width: 20 classes x 8828 SSD300 anchors
    scores = rng.uniform(0, 1, (20, 8828)).astype(np.float32)
    scores[rng.uniform(size=scores.shape) < 0.5] = NEG
    cases.append(("full_width", anchor_corners, scores, np.full(20, 20, np.int32),
                  20, 0.5))
    # training-mining shape: 32 images x 8828 shared anchors, cap 384, IoU 0.7
    scores = rng.exponential(1.0, (32, 8828)).astype(np.float32)
    scores[rng.uniform(size=scores.shape) < 0.05] = NEG  # positives are not mined
    cases.append(("mining", anchor_corners, scores,
                  rng.integers(0, 400, 32).astype(np.int32), 384, 0.7))
    # the mining shape with a NaN score in image 0: through the pool, that row
    # selects nothing, and the pool's check reruns the batch at full width
    scores = scores.copy()
    scores[0, int(np.argmax(scores[0]))] = np.nan
    ns = rng.integers(0, 400, 32).astype(np.int32)
    ns[0] = 300
    cases.append(("nan_pool", anchor_corners, scores, ns, 384, 0.7))
    # per-row boxes [5, 300, 4] (tpudet's per-image kernel case), zero-area
    # boxes (NaN IoU: each box still picked once), tied scores, a NaN row
    for name in ("per_row_boxes", "zero_area", "ties", "nan_row"):
        cases.append((name, *nms_case(name)))
    return cases


def nms_work(boxes, scores, sel, valid, iou_threshold):
    """Bytes and float32 operations the NMS of these inputs needs: every input
    read once, every output written once, and for each pick the IoU test of
    every candidate still alive at that pick."""
    import torch

    from tpudet_torch.ops import boxes as box_ops

    b, n = scores.shape
    k = sel.shape[1]
    bx = boxes if boxes.dim() == 3 else boxes[None].expand(b, n, 4)
    picked = torch.gather(bx, 1, sel.long()[..., None].expand(b, k, 4))   # [B, K, 4]
    iou = box_ops.iou_corner(picked[:, :, None, :], bx[:, None, :, :])   # [B, K, N]
    cols = torch.arange(n, device=scores.device)
    kills = ((iou > iou_threshold) | (cols == sel.long()[..., None])) & valid[..., None]
    killed_before = torch.cumsum(kills.int(), dim=1) - kills.int()       # picks < k
    alive = (scores > NEG / 2)[:, None, :] & (killed_before == 0) & valid[..., None]
    flops = IOU_FLOPS * int(alive.sum()) + 2 * b * n  # + the first argmax scan
    nbytes = (scores.numel() * 4 + boxes.numel() * 4 + b * 4
              + sel.numel() * 4 + valid.numel())
    return nbytes, flops


def device_events(fn, reps=1, sessions=PROFILE_SESSIONS) -> list:
    """``(name, us)`` of every device operation (kernel, memset, copy) that
    ``reps`` calls of ``fn`` put on the stream, from torch.profiler (CUPTI),
    after one call outside the profile.

    The profiler drops device operations that fall outside its capture
    window, and it has returned none at all for sessions shorter than a
    millisecond (one 12 us assignment call; twenty 10 us NMS scans). So the
    calls sit between two host pauses of ``PROFILE_PAD_S`` inside the
    session, and a session that records no device operation is run again, up
    to ``sessions`` times; an empty list means every session came back
    empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return events
        log(f"profiler: a session of {reps} calls recorded no device operation")
    return []


def device_ms(fn, reps=20) -> float | None:
    """Device time of one call of ``fn``: its device operations' summed
    durations, mean over ``reps`` calls; None ("not measured") when every
    profiler session came back empty. Unlike ``event_ms`` it leaves out the
    gaps between launches, so it does not rise to the host's launch rate for
    short kernels."""
    us = sum(t for _, t in device_events(fn, reps))
    return us / 1e3 / reps if us > 0 else None


def fmt_ms(ms, digits=5) -> str:
    """A time for the log; "not measured" for None."""
    return "not measured" if ms is None else f"{ms:.{digits}f}"


def mean_ms(*ms):
    """The mean of measured times; None if any was not measured."""
    return None if None in ms else sum(ms) / len(ms)


def per_pick_launch(boxes, scores, ns, max_out, thr):
    """One launch of the per-pick NMS kernel (one block per row) through the C
    entry with preallocated outputs, so the wrapper's Python work stays out of
    its time."""
    import torch

    from tpudet_torch.ops.cuda import nms_kernel

    fn = nms_kernel._library("tpudet_nms_rows")
    b, n = scores.shape
    sel = torch.empty((b, max_out), dtype=torch.int32, device=scores.device)
    valid = torch.empty((b, max_out), dtype=torch.bool, device=scores.device)
    work = torch.empty((b, n), dtype=torch.float32, device=scores.device)
    stride = 0 if boxes.dim() == 2 else n * 4
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (scores.data_ptr(), work.data_ptr(), boxes.data_ptr(), stride,
            ns.data_ptr(), b, n, max_out, thr, sel.data_ptr(), valid.data_ptr(), stream)

    def launch():
        if fn(*ptrs) != 0:
            raise RuntimeError("NMS kernel launch failed")

    return launch


def sorted_launch(boxes, scores, ns, max_out, thr, order):
    """One call of the sorted bitmask scan (its mask and scan launches) over a
    given order, through the C entry."""
    import torch

    from tpudet_torch.ops.cuda import nms_kernel

    fn = nms_kernel._library("tpudet_nms_sorted")
    b, n = scores.shape
    p = order.shape[1]
    sel = torch.empty((b, max_out), dtype=torch.int32, device=scores.device)
    valid = torch.empty((b, max_out), dtype=torch.bool, device=scores.device)
    mask = torch.empty((b, p, nms_kernel.mask_stride(p)), dtype=torch.int64,
                       device=scores.device)
    stride = 0 if boxes.dim() == 2 else n * 4
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (scores.data_ptr(), boxes.data_ptr(), stride, order.data_ptr(), ns.data_ptr(),
            b, n, p, max_out, thr, mask.data_ptr(), sel.data_ptr(), valid.data_ptr(),
            stream)

    def launch():
        if fn(*ptrs) != 0:
            raise RuntimeError("NMS kernel launch failed")

    return launch


@contextlib.contextmanager
def per_pick_only():
    """Within it, the NMS wrapper takes the per-pick design at every width."""
    from tpudet_torch.ops.cuda import nms_kernel

    limit = nms_kernel.SORTED_SCAN_MAX_WIDTH
    nms_kernel.SORTED_SCAN_MAX_WIDTH = 0
    try:
        yield
    finally:
        nms_kernel.SORTED_SCAN_MAX_WIDTH = limit


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nms_equal(got, want) -> bool:
    import torch

    return torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def phase_kernels(dev, anchor_corners):
    """The NMS kernel == its plain version on every case, through nms_rows in
    both designs and through the pool; times of the synthetic pools."""
    import torch
    from torch_nms_cases import nms_case

    from tpudet_torch.ops import nms as nms_ops
    from tpudet_torch.ops.cuda import nms_kernel

    timings = {}
    for name, boxes, scores, ns, max_out, thr in nms_cases(anchor_corners):
        args = [torch.from_numpy(a).to(dev) for a in (boxes, scores, ns)]
        want = nms_ops.batched_greedy_nms(*args, max_out, thr)
        before = dict(nms_kernel.launches_by_path)
        auto = nms_kernel.nms_rows(*args, max_out, thr)
        with per_pick_only():
            per_pick = nms_kernel.nms_rows(*args, max_out, thr)
        pool = nms_kernel.batched_greedy_nms_pretopk(*args, max_out, thr)
        torch.cuda.synchronize()
        used = {k: v - before[k] for k, v in nms_kernel.launches_by_path.items()}
        for how, got in (("nms_rows", auto), ("per-pick", per_pick), ("pool", pool)):
            if not nms_equal(got, want):
                raise AssertionError(f"NMS kernel ({how}) != plain version on {name}")
        n_picks = want[1].sum(-1)
        if name == "zero_area" and int(n_picks.sum()) != 4:
            raise AssertionError("zero-area boxes: expected 4 distinct picks")
        if name.startswith("nan") and int(n_picks[{"nan_row": 1, "nan_pool": 0}[name]]):
            raise AssertionError(f"{name}: the row holding a NaN selected boxes")
        log(f"nms {name}: scores {tuple(scores.shape)} max_out {max_out} thr {thr}: "
            f"kernel == plain through nms_rows ({nms_kernel.scan_path(scores.shape[1])}), "
            f"the per-pick design and the pool; launches by design {used}; "
            f"{int(n_picks.sum())} picks")
        if name in ("decode_pool", "mining", "per_row_boxes"):
            per_pick = per_pick_launch(*args, max_out, thr)
            ms, pp_device = event_ms(per_pick, 200), device_ms(per_pick)
            sorted_ms = sorted_device = None
            if nms_kernel.scan_path(scores.shape[1]) == "sorted_scan":
                order = nms_kernel.stable_order(args[1])
                scan = sorted_launch(*args, max_out, thr, order)
                sorted_ms, sorted_device = event_ms(scan, 200), device_ms(scan)
            wrapped = event_ms(lambda: nms_kernel.nms_rows(*args, max_out, thr), 50)
            plain = event_ms(lambda: nms_ops.batched_greedy_nms(*args, max_out, thr), 3)
            nbytes, flops = nms_work(*args[:2], *want, thr)
            b_ms, b_by = bound(nbytes, flops)
            timings[name] = dict(per_pick_ms=ms, per_pick_device_ms=pp_device,
                                 sorted_ms=sorted_ms, sorted_device_ms=sorted_device,
                                 wrapper_ms=wrapped, plain_ms=plain, bound_ms=b_ms,
                                 bound_by=b_by, shape=[*boxes.shape])
            log(f"nms {name} timing: per-pick kernel {ms:.4f} ms (device "
                f"{fmt_ms(pp_device, 4)}),"
                f" sorted scan {sorted_ms if sorted_ms is None else round(sorted_ms, 4)} "
                f"ms (device {sorted_device}; order given), through the wrapper "
                f"{wrapped:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.6f} ms ({b_by}: "
                f"{nbytes} B, {flops} flop)")

    boxes, scores, ns, max_out, thr = nms_case("exhaustion")  # one cluster fills the pool
    args = [torch.from_numpy(a).to(dev) for a in (boxes, scores, ns)]
    before = dict(nms_kernel.launches_by_path)
    sel, val = nms_kernel.batched_greedy_nms_pretopk(*args, max_out, thr)
    reran = {k: v - before[k] for k, v in nms_kernel.launches_by_path.items()}
    fsel, fval = nms_kernel.nms_rows(*args, max_out, thr)
    psel, pval = nms_ops.batched_greedy_nms(*args, max_out, thr)
    torch.cuda.synchronize()
    if reran != {"sorted_scan": 1, "per_pick": 1}:
        raise AssertionError(f"exhaustion scene: expected the pool's sorted scan, then "
                             f"the full-width rerun, got {reran}")
    for s2, v2 in ((fsel, fval), (psel, pval)):
        if not (torch.equal(val, v2) and torch.equal(sel, s2)):
            raise AssertionError("exhaustion scene: pretopk != full width")
    if int(val.sum()) != 60:
        raise AssertionError(f"exhaustion scene: {int(val.sum())} picks, expected 60")
    log("nms exhaustion: pool exhausted, full-width rerun through the per-pick kernel, "
        "== full width == plain (60 picks)")
    return timings


# --------------------------------------------------------------- assignment
def assign_inputs(dev, gt, ay1, ay2):
    """Kernel inputs of an assignment case: gt corners, validity, anchors."""
    import torch

    from tpudet_torch.ops import matching

    g = matching.unpack_gt(torch.from_numpy(gt).to(dev))
    return [g.y1x1.contiguous(), g.y2x2.contiguous(), g.valid,
            torch.from_numpy(ay1).to(dev), torch.from_numpy(ay2).to(dev)]


def assign_equal(got, want) -> bool:
    """All four products equal; best_iou bit for bit."""
    import torch

    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if g.dtype != w.dtype or not torch.equal(g, w):
            return False
    return True


def assign_work(args, out):
    """Bytes and float32 operations the assignment of these inputs needs:
    inputs read once, outputs written once, and the IoU and both argmax
    compares of every (valid gt, anchor) pair plus each box's area."""
    gy1, gy2, valid, ay1, ay2 = args
    b, g = valid.shape
    a = ay1.shape[-2]
    n_anchor_sets = 1 if ay1.dim() == 2 else b
    flops = (ASSIGN_PAIR_FLOPS * int(valid.sum()) * a
             + 3 * a * n_anchor_sets + 3 * b * g)
    nbytes = (sum(t.numel() * t.element_size() for t in args)
              + sum(t.numel() * t.element_size() for t in out))
    return nbytes, flops


def assign_launch(args):
    """One launch of the assignment kernel through the C entry, with
    preallocated outputs and the wrapper's scratch."""
    import torch

    from tpudet_torch.ops.cuda import assign_kernel

    fn = assign_kernel._library()
    gy1, gy2, valid, ay1, ay2 = args
    b, g = valid.shape
    a = ay1.shape[-2]
    dev = valid.device
    outs = [torch.empty((b, g), dtype=torch.int32, device=dev),
            torch.empty((b, a), dtype=torch.float32, device=dev),
            torch.empty((b, a), dtype=torch.int32, device=dev),
            torch.empty((b, a), dtype=torch.bool, device=dev)]
    keys, arrivals = assign_kernel.scratch(dev, b, g)
    stride = 0 if ay1.dim() == 2 else a * 2
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (gy1.data_ptr(), gy2.data_ptr(), valid.data_ptr(), ay1.data_ptr(),
            ay2.data_ptr(), stride, b, g, a, keys.data_ptr(), arrivals.data_ptr(),
            outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
            outs[3].data_ptr(), stream)

    def launch():
        if fn(*ptrs) != 0:
            raise RuntimeError("assignment kernel launch failed")

    return launch


def assign_ops(args, reps=5) -> list:
    """The device operations ``reps`` assignment calls put on the stream:
    nothing but the kernel, and at most one a call. The profiler may drop
    some kernels of a session, so fewer than ``reps`` pass. When every
    session comes back empty the check is logged as not made."""
    from tpudet_torch.ops.cuda import assign_kernel

    ops = [name for name, _ in
           device_events(lambda: assign_kernel.assign_anchors(*args), reps)]
    if not ops:
        log(f"assign: the profiler recorded nothing in {PROFILE_SESSIONS} sessions; "
            f"one operation a call not checked")
        return ops
    if len(ops) > reps or not all("assign_kernel" in op for op in ops):
        raise AssertionError(f"{reps} assignment calls put {ops} on the stream, "
                             f"expected the kernel alone, once a call")
    return ops


def scratch_is_zero(dev) -> bool:
    from tpudet_torch.ops.cuda import assign_kernel

    keys, arrivals = assign_kernel.scratch(dev, 1, 1)
    return not (bool(keys.any()) or bool(arrivals.any()))


def phase_assign(dev, ssd_anchors):
    """The assignment kernel == its plain version on every case, in one launch
    a call, with its scratch at zero after each call and across back-to-back
    calls of other shapes; timed at SSD300's training shape."""
    import numpy as np
    import torch
    from torch_assign_cases import CASES, assign_case, rand_gt, voc_like_gt

    from tpudet_torch.ops import matching
    from tpudet_torch.ops.cuda import assign_kernel

    ay1, ay2 = (a.numpy() for a in ssd_anchors)
    cases = [("ssd300_voc_like", voc_like_gt(0, b=TRAIN_BATCH), ay1, ay2),
             ("ssd300_dense60", rand_gt(np.random.default_rng(1), TRAIN_BATCH, 60, 60,
                                        n_valid_min=60), ay1, ay2)]
    cases += [(name, *assign_case(name)) for name in CASES]
    timing = None
    for name, gt, a1, a2 in cases:
        args = assign_inputs(dev, gt, a1, a2)
        got = assign_kernel.assign_anchors(*args)
        want = matching.assign_plain(*args)
        torch.cuda.synchronize()
        if not assign_equal(got, want):
            raise AssertionError(f"assignment kernel != plain version on {name}")
        if not scratch_is_zero(args[2].device):
            raise AssertionError(f"assignment kernel left its scratch non-zero on {name}")
        log(f"assign {name}: gt {tuple(gt.shape)} ({int(args[2].sum())} valid), anchors "
            f"{tuple(a1.shape)}: kernel == plain (best_iou bit for bit), scratch zero "
            f"after, {int(got.best_set.sum())} best-set anchors")
        if name == "ssd300_voc_like":
            ms = event_ms(assign_launch(args), 200)
            wrapped = event_ms(lambda: assign_kernel.assign_anchors(*args), 50)
            plain = event_ms(lambda: matching.assign_plain(*args), 5)
            nbytes, flops = assign_work(args, got)
            b_ms, b_by = bound(nbytes, flops)
            timing = dict(ms=ms, wrapper_ms=wrapped, plain_ms=plain, bound_ms=b_ms,
                          bound_by=b_by)
            log(f"assign {name} timing: kernel {ms:.4f} ms, through the wrapper "
                f"{wrapped:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.6f} ms "
                f"({b_by}: {nbytes} B, {flops} flop)")
            ops = assign_ops(args)
            if ops:
                log(f"assign: five calls put {len(ops)} operations on the stream, each "
                    f"{ops[0][:60]}")

    # back to back, no sync between: three shapes of [B, G], then the first again
    names = ("ssd300_voc_like", "random_shared", "ties", "ssd300_voc_like")
    inputs = [assign_inputs(dev, *next(c[1:] for c in cases if c[0] == n)) for n in names]
    got = [assign_kernel.assign_anchors(*args) for args in inputs]
    for name, args, out in zip(names, inputs, got):
        if not assign_equal(out, matching.assign_plain(*args)):
            raise AssertionError(f"back-to-back assignment calls: {name} != plain")
    if not scratch_is_zero(inputs[0][2].device):
        raise AssertionError("assignment kernel left its scratch non-zero")
    log(f"assign back to back, {[tuple(a[2].shape) for a in inputs]}: each == plain, "
        f"scratch zero after")
    return timing


# --------------------------------------------------------------- serving
def phase_serve(dev, n_requests=10):
    """SSD300 at full width answers requests."""
    from tpudet_torch.models.ssd import SSD300

    config = {"mode": "test", "data_format": "channels_last", "num_classes": 20,
              "batch_size": 1, "weight_decay": 5e-4, "nms_score_threshold": 0.01,
              "nms_max_boxes": 20, "nms_iou_threshold": 0.5,
              "pretraining_weight": None, "seed": 0}
    t0 = time.perf_counter()
    model = SSD300(config)
    log(f"SSD300 built on {model.device} in {time.perf_counter() - t0:.2f} s: "
        f"{sum(p.numel() for p in model.net.parameters())} parameters, "
        f"{model.anchors.yx.shape[0]} anchors")
    if model.device.type != dev.type or model.anchors.yx.shape[0] != 8828:
        raise AssertionError("SSD300 must default to the card with 8828 anchors")
    return serve_requests(dev, model, 300, n_requests)


def leaves(outputs):
    """The tensors of a net's output, nested lists and tuples flattened."""
    if isinstance(outputs, (tuple, list)):
        return [t for item in outputs for t in leaves(item)]
    return [outputs]


def network_vs_cpu(model, x, outputs):
    """The net's outputs on the card within 1e-4 of the same weights on the
    CPU (max |diff| / max |value| per output: float32 sums in another order,
    no TF32)."""
    dev = x.device
    cpu_net = model.net.to("cpu")
    try:
        want = cpu_net(model._preprocess(x).cpu())
    finally:
        model.net.to(dev)
    worst = max(float((g.cpu() - w).abs().max() / w.abs().max())
                for g, w in zip(leaves(outputs), leaves(want)))
    if worst > 1e-4:
        raise AssertionError(f"network on the card vs the CPU: rel err {worst}")
    log(f"network on the card vs the CPU, same weights: max |diff| / max |value| "
        f"over outputs {worst:.2e}")


def timed_requests(model, images):
    """``images`` through ``test_one_image`` after two warm-up requests (cuDNN
    handles, the kernel library), with the kernels' counts set to 0 just
    before and read just after: latencies (ms), results, counts."""
    import torch

    from tpudet_torch.ops.cuda import assign_kernel, nms_kernel

    for img in images[:2]:
        model.test_one_image(img)
    torch.cuda.synchronize()
    reset_nms_counts()
    assign_kernel.launches = 0
    latencies, results = [], []
    for img in images:
        t = time.perf_counter()
        results.append(model.test_one_image(img))
        latencies.append((time.perf_counter() - t) * 1e3)
    counts = {"nms_rows": nms_kernel.launches, **nms_kernel.launches_by_path,
              "assign": assign_kernel.launches}
    log(f"served {len(images)} requests; kernel launches {counts}")
    return latencies, results, counts


def check_detections(results, latencies, n_classes):
    """Every request's detections finite and well formed, class ids in
    ``[0, n_classes)``, some request with detections; logs and returns the
    latency p50."""
    import numpy as np

    n_dets = [len(r[0]) for r in results]
    for scores, boxes, cid in results:
        if not (np.isfinite(scores).all() and np.isfinite(boxes).all()):
            raise AssertionError("non-finite detections")
        if boxes.shape != (len(scores), 4) or cid.shape != scores.shape:
            raise AssertionError("malformed detections")
        if len(cid) and not (cid.min() >= 0 and cid.max() < n_classes):
            raise AssertionError("class id out of range")
    if max(n_dets) == 0:
        raise AssertionError("no request returned detections")
    p50 = statistics.median(latencies)
    log(f"detections per request {n_dets}; latency p50 {p50:.3f} ms, "
        f"min {min(latencies):.3f} ms, max {max(latencies):.3f} ms")
    return p50


def serve_requests(dev, model, size, n_requests, check_network=None):
    """``n_requests`` seeded ``size`` (a side, or ``(h, w)``) images through
    ``test_one_image``, with the NMS counts set to 0 just before and read
    just after; then one request's decode with the kernel == with the plain
    version on the card,
    the network against the same weights on the CPU (``check_network``,
    default :func:`network_vs_cpu`), and a profile."""
    import numpy as np
    import torch

    rng = np.random.default_rng(1)
    images = [rng.uniform(0, 255, (1, *hw_of(size), 3)).astype(np.float32)
              for _ in range(n_requests)]
    latencies, results, counts = timed_requests(model, images)
    if (counts["nms_rows"] < n_requests or counts["sorted_scan"] < n_requests
            or counts["assign"]):
        raise AssertionError("the serving path must launch the NMS kernel's sorted scan "
                             "once per request and no assignment")
    p50 = check_detections(results, latencies,
                           getattr(model, "raw_classes", model.num_classes - 1))

    # one request's head outputs through decode with the kernel and with the
    # plain version, both on the card
    x = torch.from_numpy(images[0].transpose(0, 3, 1, 2).copy()).to(dev)
    with torch.inference_mode():
        outputs = model.net(model._preprocess(x))

        def decode():
            return model._decode_outputs(outputs)

        with_kernel, captured = decode_kernel_vs_plain(model, outputs)
        log(f"decode of one request: kernel == plain on the card "
            f"({int(with_kernel[3].sum())} detections)")

        fwd_ms = event_ms(lambda: model.net(model._preprocess(x)), 10)
        dec_ms = event_ms(decode, 10)
        log(f"request breakdown (device, CUDA events): network {fwd_ms:.3f} ms, "
            f"decode {dec_ms:.3f} ms")

        net_check = (check_network or network_vs_cpu)(model, x, outputs)

    profile_requests(model, images[:3])
    boxes, scores, ns, max_out, thr, order = captured["args"]
    log(f"main-path NMS input: scores {tuple(scores.shape)}, boxes "
        f"{tuple(boxes.shape)}, the pool's order {tuple(order.shape)}, max_out "
        f"{max_out}, thr {thr}")
    return dict(latencies=latencies, p50=p50, counts=counts, network_ms=fwd_ms,
                decode_ms=dec_ms, network_vs_cpu=net_check, kernel_args=captured["args"])


def decode_kernel_vs_plain(model, outputs):
    """``model._decode_outputs(outputs)`` with the NMS kernel == with its plain
    version, exactly, on the card. Returns the decode and the kernel wrapper's
    arguments in it: ``captured["args"]`` of its first call and, where a pool
    ran out, ``captured["rerun"]`` of the full-width rerun."""
    import torch

    from tpudet_torch.ops.cuda import nms_kernel

    captured = {}
    real_rows = nms_kernel.nms_rows

    def capture(*a):
        captured.setdefault("rerun" if "args" in captured else "args", a)
        return real_rows(*a)

    nms_kernel.nms_rows = capture
    try:
        with_kernel = model._decode_outputs(outputs)
        nms_kernel.nms_rows = nms_kernel.plain_rows
        with_plain = model._decode_outputs(outputs)
    finally:
        nms_kernel.nms_rows = real_rows
    torch.cuda.synchronize()
    for a, b in zip(with_kernel, with_plain):
        if not torch.equal(a, b):
            raise AssertionError("decode with the NMS kernel != with the plain version")
    return with_kernel, captured


def hw_of(size):
    """``(h, w)`` of a side or an ``(h, w)`` pair."""
    return (size, size) if isinstance(size, int) else tuple(size)


def reset_nms_counts():
    from tpudet_torch.ops.cuda import nms_kernel

    nms_kernel.launches = 0
    for path in nms_kernel.launches_by_path:
        nms_kernel.launches_by_path[path] = 0


def profile_requests(model, images):
    """Device time by kernel over a few requests, from torch.profiler (CUPTI).
    The profiler's own host cost inflates the wall time, so the busy share it
    gives is a lower bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for img in images:
            model.test_one_image(img)
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e3
    if not by_name:
        log("profiler: no device events recorded")
        return
    busy = sum(by_name.values())
    log(f"profiler over {len(images)} requests: wall {wall_ms:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}%), {len(by_name)} distinct kernels")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"  {ms / len(images):8.4f} ms/request  {100 * ms / busy:5.1f}%  {name[:90]}")


# --------------------------------------------------------------- training
class StepLog:
    """A ``train_one_epoch`` writer: each step's loss, kept on the device."""

    def __init__(self):
        self.losses = []

    def add_summary(self, loss, global_step):
        self.losses.append(loss)


def feed(batch, n_steps, b):
    """A data provider that yields ``batch`` for an epoch of ``n_steps``."""
    def batches():
        while True:
            yield batch

    return {"num_train": b * n_steps, "train_generator": (lambda: None, batches())}


def train_model(dev, compute_dtype, images, gt, n_steps):
    from tpudet_torch.models.ssd import SSD300

    config = {"mode": "train", "data_format": "channels_last", "num_classes": 20,
              "batch_size": TRAIN_BATCH, "weight_decay": 1e-4, "keep_prob": 1.0,
              "nms_score_threshold": 0.5, "nms_max_boxes": 20,
              "nms_iou_threshold": 0.5, "pretraining_weight": None,
              "compute_dtype": compute_dtype, "hard_neg_cap": 384, "seed": 0}
    model = SSD300(config, feed((images, gt), n_steps, TRAIN_BATCH))
    if model.device.type != dev.type:
        raise AssertionError("SSD300 must default to the card")
    return model


def run_epoch(model, images, gt, warmup: int, lr: float = 0.01):
    """``warmup`` steps through ``train_step``, then one ``train_one_epoch``
    with the kernels' counts set to 0 just before it and read just after.
    Returns the losses (warm-up first), the counts, host images/s over the
    epoch, and the mean device time of a step by CUDA events."""
    import torch

    from tpudet_torch.ops.cuda import assign_kernel, nms_kernel

    warm = [float(model.train_step(*model._to_device(images, gt), lr))
            for _ in range(warmup)]
    torch.cuda.synchronize()
    writer = StepLog()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    assign_kernel.launches = 0
    reset_nms_counts()
    t = time.perf_counter()
    start.record()
    mean = model.train_one_epoch(lr, writer)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = {"assign": assign_kernel.launches, "nms_rows": nms_kernel.launches,
              **nms_kernel.launches_by_path}
    steps = len(writer.losses)
    losses = warm + [float(x) for x in writer.losses]
    return dict(losses=losses, mean=mean, counts=counts, steps=steps,
                images_per_s=model.batch_size * steps / wall,
                step_ms=start.elapsed_time(end) / steps)


def loss_kernels_vs_plain(what, loss):
    """``loss()`` with both kernels == with both plain versions, exactly, on
    the card. Returns the kernels' inputs in the first call: ``assign`` (the
    assignment's) and, where the loss mines, ``full`` (the pool call) and
    ``pool`` (the ``nms_rows`` call that takes the pool's order)."""
    import torch

    from tpudet_torch.ops import matching
    from tpudet_torch.ops.cuda import assign_kernel, nms_kernel

    captured = {}
    real = {"assign": assign_kernel.assign_anchors, "rows": nms_kernel.nms_rows,
            "pretopk": nms_kernel.batched_greedy_nms_pretopk}

    def spy(key, fn):
        def call(*a):
            captured.setdefault(key, a)
            return fn(*a)
        return call

    try:
        nms_kernel.batched_greedy_nms_pretopk = spy("full", real["pretopk"])
        nms_kernel.nms_rows = spy("pool", real["rows"])
        assign_kernel.assign_anchors = spy("assign", real["assign"])
        with_kernels = loss()
        nms_kernel.nms_rows = nms_kernel.plain_rows
        assign_kernel.assign_anchors = matching.assign_plain
        with_plain = loss()
    finally:
        nms_kernel.batched_greedy_nms_pretopk = real["pretopk"]
        nms_kernel.nms_rows = real["rows"]
        assign_kernel.assign_anchors = real["assign"]
    torch.cuda.synchronize()
    if not torch.equal(with_kernels, with_plain):
        raise AssertionError(f"{what} with the kernels {float(with_kernels)} != with the "
                             f"plain versions {float(with_plain)}")
    log(f"{what} on one step's head outputs: kernels == plain versions on the card "
        f"({float(with_kernels):.6f})")
    return captured


def train_heads(model, images, gt, flatten):
    """One train-mode forward of ``model`` on the batch, flattened, without
    grad, and the gt on the card."""
    import torch

    x, g = model._to_device(images, gt)
    model.net.train()
    with torch.no_grad():
        return flatten(model.net(model._preprocess(x))), g


def loss_kernel_vs_plain(model, images, gt):
    """ssd_loss with both kernels == with both plain versions on one step's
    head outputs; the kernels' inputs on that step."""
    from tpudet_torch.heads import ssd as ssd_head

    heads, g = train_heads(model, images, gt, lambda o: ssd_head.flatten_preds(o, 21))
    return loss_kernels_vs_plain("ssd_loss", lambda: ssd_head.ssd_loss(
        *heads, model.anchors, g, 21, neg_sel_cap=384))


def profile_step(model, images, gt, lr=0.01):
    """Device time by kernel over one train step, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x, g = model._to_device(images, gt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        model.train_step(x, g, lr)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e3
    if not by_name:
        log("profiler: no device events recorded")
        return dict(wall_ms=wall_ms, busy_ms=None)
    busy = sum(by_name.values())
    log(f"profiler over one train step: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.1f}%), {len(by_name)} distinct kernels")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        log(f"  {ms:8.4f} ms/step  {100 * ms / busy:5.1f}%  {name[:90]}")
    for part in ("assign_kernel", "nms_mask_kernel", "nms_scan_kernel", "nms_rows_kernel"):
        ms = sum(v for k, v in by_name.items() if part in k)
        log(f"  {part}: {ms:.4f} ms/step ({100 * ms / busy:.2f}% of device busy)")
    return dict(wall_ms=wall_ms, busy_ms=busy)


def phase_train(dev, n_steps=10, warmup=2):
    import numpy as np
    import torch
    from torch_assign_cases import voc_like_gt

    rng = np.random.default_rng(2)
    images = rng.uniform(0, 255, (TRAIN_BATCH, 300, 300, 3)).astype(np.float32)
    gt = voc_like_gt(3, b=TRAIN_BATCH)
    log(f"train batch: images {images.shape}, gt {gt.shape} with "
        f"{int((gt[..., 0] >= 0).sum())} objects")

    t0 = time.perf_counter()
    model = train_model(dev, "bfloat16", images, gt, n_steps)
    log(f"SSD300 (train, bf16) built on {model.device} in {time.perf_counter() - t0:.2f} s")
    bf16 = run_epoch(model, images, gt, warmup)
    counts, steps, losses = bf16["counts"], bf16["steps"], bf16["losses"]
    log(f"bf16: {warmup} warm-up steps + {steps} in train_one_epoch; kernel launches "
        f"in the epoch {counts}; losses {[round(x, 4) for x in losses]}")
    if (steps != n_steps or counts["assign"] != steps or counts["nms_rows"] < steps
            or counts["sorted_scan"] < steps):
        raise AssertionError(f"the train path must launch the assignment kernel once "
                             f"and the NMS kernel's sorted scan at least once per step: "
                             f"{counts}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall on one batch: {losses}")
    log(f"bf16 train: {bf16['images_per_s']:.1f} images/s by the host clock, "
        f"{bf16['step_ms']:.3f} ms/step by CUDA events, epoch mean {bf16['mean']:.4f}")

    mining = loss_kernel_vs_plain(model, images, gt)
    bf16["profile"] = profile_step(model, images, gt)
    max_mem = torch.cuda.max_memory_allocated() / 2 ** 30
    del model
    torch.cuda.empty_cache()

    model = train_model(dev, "float32", images, gt, 4)
    fp32 = run_epoch(model, images, gt, 1)
    if not all(np.isfinite(fp32["losses"])) or fp32["counts"]["assign"] != fp32["steps"]:
        raise AssertionError(f"fp32 training failed: {fp32}")
    log(f"fp32 train (TF32 off): {fp32['images_per_s']:.1f} images/s by the host clock, "
        f"{fp32['step_ms']:.3f} ms/step by CUDA events, losses "
        f"{[round(x, 4) for x in fp32['losses']]}")
    del model
    torch.cuda.empty_cache()
    log(f"peak device memory {max_mem:.2f} GiB (bf16 training)")
    bf16["peak_gib"] = max_mem
    return dict(bf16=bf16, fp32=fp32, mining=mining)


def nms_pool_timing(args, plain_reps=5):
    """The NMS kernel's two designs on one main-path pool (a captured nms_rows
    call with the pool's order), timed in turns: per-pick, sorted scan, sorted
    scan, per-pick. The sorted scan walks the full rows through the order; the
    per-pick kernel runs on the pool's gathered copies, as it did before the
    scan existed. Both == plain. The plain time and the bound are those of the
    gathered pool."""
    import torch

    from tpudet_torch.ops import nms as nms_ops
    from tpudet_torch.ops.cuda import nms_kernel

    boxes, scores, ns, max_out, thr, order = args
    idx = order.long()
    top_s = torch.gather(scores, 1, idx).contiguous()
    top_b = (boxes[idx] if boxes.dim() == 2
             else torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))).contiguous()
    want = nms_kernel.plain_rows(*args)
    new = nms_kernel.nms_rows(*args)
    with per_pick_only():
        psel, pval = nms_kernel.nms_rows(top_b, top_s, ns, max_out, thr)
    old = (torch.where(pval, torch.gather(order, 1, psel.long()), 0), pval)
    torch.cuda.synchronize()
    if not (nms_equal(new, want) and nms_equal(old, want)):
        raise AssertionError("NMS kernel != plain version on a main-path pool")
    old_launch = per_pick_launch(top_b, top_s, ns, max_out, thr)
    new_launch = sorted_launch(boxes, scores, ns, max_out, thr, order)
    turns = [event_ms(old_launch, 200), event_ms(new_launch, 200),
             event_ms(new_launch, 200), event_ms(old_launch, 200)]
    device_turns = [device_ms(old_launch), device_ms(new_launch),
                    device_ms(new_launch), device_ms(old_launch)]
    pool_call = event_ms(
        lambda: nms_kernel.batched_greedy_nms_pretopk(boxes, scores, ns, max_out, thr), 50)
    plain = event_ms(lambda: nms_ops.batched_greedy_nms(top_b, top_s, ns, max_out, thr),
                     plain_reps)
    nbytes, flops = nms_work(top_b, top_s, psel, pval, thr)
    b_ms, b_by = bound(nbytes, flops)
    return dict(ms=(turns[1] + turns[2]) / 2, per_pick_ms=(turns[0] + turns[3]) / 2,
                turns_ms=turns, device_ms=mean_ms(device_turns[1], device_turns[2]),
                per_pick_device_ms=mean_ms(device_turns[0], device_turns[3]),
                device_turns_ms=device_turns, pool_call_ms=pool_call, plain_ms=plain,
                bound_ms=b_ms,
                bound_by=b_by, picks=int(pval.sum()), shape=list(top_s.shape),
                full_shape=list(scores.shape))


def nms_full_timing(args, plain_reps=2):
    """The per-pick design on one main-path call at full width (wider than the
    sorted scan takes), timed twice: == plain, kernel ms, plain ms, bound."""
    import torch

    from tpudet_torch.ops import nms as nms_ops
    from tpudet_torch.ops.cuda import nms_kernel

    boxes, scores, ns, max_out, thr = args
    if nms_kernel.scan_path(scores.shape[1]) != "per_pick":
        raise AssertionError(f"full width {tuple(scores.shape)} is not on the wide path")
    sel, val = nms_kernel.nms_rows(boxes, scores, ns, max_out, thr)
    want = nms_ops.batched_greedy_nms(boxes, scores, ns, max_out, thr)
    torch.cuda.synchronize()
    if not nms_equal((sel, val), want):
        raise AssertionError("NMS kernel != plain version at full width")
    launch = per_pick_launch(boxes, scores, ns, max_out, thr)
    turns = [event_ms(launch, 200) for _ in range(2)]
    plain = event_ms(lambda: nms_ops.batched_greedy_nms(boxes, scores, ns, max_out, thr),
                     plain_reps)
    nbytes, flops = nms_work(boxes, scores, sel, val, thr)
    b_ms, b_by = bound(nbytes, flops)
    return dict(ms=sum(turns) / 2, turns_ms=turns, device_ms=device_ms(launch, 5),
                plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, picks=int(val.sum()), shape=list(scores.shape))


def run_out_args(args, pool=512, top=3.0):
    """A pool's NMS input (a captured ``nms_rows`` call) with row 0's top
    ``pool + 8`` candidates made near-copies of one box, scored from ``top``
    down to ``top - 1`` (above every other score of the row), so the pool
    runs out after its first pick and the rows rerun at full width."""
    import numpy as np
    import torch

    boxes, scores, ns, max_out, thr, _ = args
    rng = np.random.default_rng(19)
    idx = torch.from_numpy(rng.permutation(boxes.shape[0])[:pool + 8]).to(boxes.device)
    ramp = torch.linspace(0, 0.5, pool + 8, device=boxes.device)
    boxes, scores = boxes.clone(), scores.clone()
    copy = torch.tensor([100.0, 100.0, 200.0, 220.0], device=boxes.device)
    boxes[idx] = copy + ramp[:, None]
    scores[0, idx] = top - 2.0 * ramp
    return [boxes, scores, ns, max_out, thr]


def pool_run_out(what, args):
    """One decode pool call whose pool runs out (``args``: boxes, scores,
    budgets, max_out, IoU threshold): the pool's sorted scan, then the
    per-pick kernel at full width, == the plain version; the per-pick design
    timed at full width."""
    import torch

    from tpudet_torch.ops import nms as nms_ops
    from tpudet_torch.ops.cuda import nms_kernel

    before = dict(nms_kernel.launches_by_path)
    sel, val = nms_kernel.batched_greedy_nms_pretopk(*args)
    reran = {k: v - before[k] for k, v in nms_kernel.launches_by_path.items()}
    want = nms_ops.batched_greedy_nms(*args)
    torch.cuda.synchronize()
    if reran != {"sorted_scan": 1, "per_pick": 1}:
        raise AssertionError(f"{what} run-out case: expected the pool's sorted scan, then "
                             f"the full-width rerun, got {reran}")
    if not nms_equal((sel, val), want):
        raise AssertionError(f"{what} run-out case: pool with its rerun != plain version")
    if int(val[0].sum()) < 2:
        raise AssertionError(f"{what} run-out case: row 0 must pick beyond its pool")
    full = nms_full_timing(args)
    log(f"{what} NMS run-out case {tuple(args[1].shape)}: the pool ran out in row 0, the "
        f"per-pick kernel reran at full width, == plain ({int(val.sum())} picks, row 0 "
        f"{int(val[0].sum())}); per-pick at full width "
        f"{[round(x, 4) for x in full['turns_ms']]} ms (device time "
        f"{fmt_ms(full['device_ms'], 4)} ms), plain {full['plain_ms']:.4f} ms, bound "
        f"{full['bound_ms']:.6f} ms ({full['bound_by']})")
    return full


def log_pool(what, t):
    log(f"NMS on {what} {t['shape']} of {t['full_shape']} ({t['picks']} picks), in turns "
        f"per-pick/sorted/sorted/per-pick {[round(x, 5) for x in t['turns_ms']]} ms: "
        f"sorted scan {t['ms']:.5f} ms, per-pick {t['per_pick_ms']:.5f} ms "
        f"({t['per_pick_ms'] / t['ms']:.1f}x); device time (profiler) in turns "
        f"[{', '.join(fmt_ms(x) for x in t['device_turns_ms'])}] ms: sorted "
        f"{fmt_ms(t['device_ms'])}, per-pick {fmt_ms(t['per_pick_device_ms'])}; the whole "
        f"pool call (sort, scan, "
        f"check) {t['pool_call_ms']:.4f} ms; plain {t['plain_ms']:.4f} ms; bound "
        f"{t['bound_ms']:.6f} ms ({t['bound_by']})")


def assign_timing(args):
    """The assignment kernel on the train step's own input."""
    import torch

    from tpudet_torch.ops import matching
    from tpudet_torch.ops.cuda import assign_kernel

    got = assign_kernel.assign_anchors(*args)
    want = matching.assign_plain(*args)
    torch.cuda.synchronize()
    if not assign_equal(got, want):
        raise AssertionError("assignment kernel != plain version on the train step's input")
    launch = assign_launch(args)
    ms = event_ms(launch, 200)
    plain = event_ms(lambda: matching.assign_plain(*args), 5)
    nbytes, flops = assign_work(args, got)
    b_ms, b_by = bound(nbytes, flops)
    return dict(ms=ms, device_ms=device_ms(launch), plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by)


# --------------------------------------------------------------- RetinaNet
# the RetinaNet training driver's config (drivers/testretinanet.py)
RETINA_CONFIG = {
    "is_bottleneck": True, "residual_block_list": [3, 4, 6, 3],
    "init_conv_filters": 16, "mode": "train", "is_pretraining": False,
    "data_shape": [500, 500, 3], "num_classes": 20, "weight_decay": 1e-4,
    "keep_prob": 0.5, "data_format": "channels_last", "batch_size": 32,
    "gamma": 2.0, "alpha": 0.25, "nms_score_threshold": 0.8, "nms_max_boxes": 10,
    "nms_iou_threshold": 0.45, "compute_dtype": "bfloat16", "seed": 0}
RETINA_SIZE = 500
RETINA_ANCHORS = 47961
RETINA_PARAMS = 31273138
PRETRAIN_SIZE = 224  # ImageNet crops
PRETRAIN_CLASSES = 224  # the last stage's width: the pretraining logits


def retina_model(dev, provider=None, **overrides):
    from tpudet_torch.models import RetinaNet

    t0 = time.perf_counter()
    model = RetinaNet(dict(RETINA_CONFIG, **overrides), provider)
    if model.device.type != dev.type:
        raise AssertionError("RetinaNet must default to the card")
    n_params = sum(p.numel() for p in model.net.parameters())
    what = "pretraining" if model.is_pretraining else f"{model.anchors.yx.shape[0]} anchors"
    dtype = overrides.get("compute_dtype", RETINA_CONFIG["compute_dtype"])
    log(f"RetinaNet ({model.mode}, {dtype}) built on {model.device} in "
        f"{time.perf_counter() - t0:.2f} s: {n_params} parameters, {what}")
    if not model.is_pretraining and RETINA_SIZE == 500 and (
            n_params != RETINA_PARAMS or model.anchors.yx.shape[0] != RETINA_ANCHORS):
        raise AssertionError("RetinaNet at the driver's config must have "
                             f"{RETINA_PARAMS} parameters and {RETINA_ANCHORS} anchors")
    return model


def calibrate_batchnorm(model, images):
    """Set every BatchNorm's running statistics to those of one batch of
    ``images``, as training leaves them. With random weights and the initial
    statistics (mean 0, var 1) the 16 pre-activation residual units add up:
    RetinaNet's eval-mode head outputs reach ~5e4, the softmax is 0 or 1 and
    the decoded boxes overflow."""
    import torch

    from tpudet_torch.nn.layers import BatchNorm

    def take_stats(bn, args):
        x = args[0].float()
        dims = [0, *range(2, x.dim())]
        mean = torch.mean(x, dims)
        bn.mean.copy_(mean)
        bn.var.copy_(torch.clamp(torch.mean(x * x, dims) - mean * mean, min=0.0))

    hooks = [m.register_forward_pre_hook(take_stats) for m in model.net.modules()
             if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            model.net.eval()(model._preprocess(model._images_to_device(images)))
    finally:
        for h in hooks:
            h.remove()


def retina_network_vs_cpu(model, x, outputs):
    """RetinaNet's net on the card against the same weights on the CPU.

    With random weights the eval-mode net amplifies a perturbation ~1.25x a
    convolution, over ~75 of them: two summation orders on the CPU itself
    (oneDNN's convolutions and PyTorch's own) differ by ~1.5e-3 at the heads.
    So the backbone's stride-8 output C3 (20 convolutions deep) is held to
    1e-4, and the heads to 4x the CPU's own difference between its two
    orders, both normwise (|diff|_2 / |value|_2)."""
    import torch

    def rel(got, want):
        return float(torch.linalg.vector_norm(got.cpu() - want)
                     / torch.linalg.vector_norm(want))

    dev = x.device
    xin = model._preprocess(x)
    c3_card = model.net.feature_extractor.backbone(xin)[0]
    cpu_net = model.net.to("cpu")
    try:
        c3_cpu = cpu_net.feature_extractor.backbone(xin.cpu())[0]
        want = leaves(cpu_net(xin.cpu()))
        with torch.backends.mkldnn.flags(enabled=False):
            other = leaves(cpu_net(xin.cpu()))
    finally:
        model.net.to(dev)
    c3_err = rel(c3_card, c3_cpu)
    card_err = max(rel(g, w) for g, w in zip(leaves(outputs), want))
    cpu_err = max(rel(g, w) for g, w in zip(other, want))
    log(f"network on the card vs the CPU, same weights, normwise: C3 {c3_err:.2e}; "
        f"heads {card_err:.2e}, against {cpu_err:.2e} between the CPU's two "
        f"summation orders")
    if c3_err > 1e-4 or card_err > max(1e-4, 4 * cpu_err):
        raise AssertionError(f"network on the card vs the CPU: C3 {c3_err}, heads "
                             f"{card_err} (CPU orders {cpu_err})")
    return dict(c3=c3_err, heads=card_err, cpu_orders=cpu_err)


def phase_retina_serve(dev, n_requests=10):
    """RetinaNet at the driver's config, fp32 (TF32 off), score threshold 0.01
    (random weights put the softmax near 1/21, under the driver's 0.8), with
    the BatchNorm statistics of 4 seeded images."""
    import numpy as np

    model = retina_model(dev, mode="test", compute_dtype="float32",
                         nms_score_threshold=0.01)
    rng = np.random.default_rng(9)
    calibrate_batchnorm(model, rng.uniform(0, 255, (4, RETINA_SIZE, RETINA_SIZE, 3))
                        .astype(np.float32))
    return serve_requests(dev, model, RETINA_SIZE, n_requests, retina_network_vs_cpu)


def retina_batch(seed, b, size):
    """One fixed batch: seeded uniform images of ``size`` (a side, or ``(h,
    w)``), 1-10 VOC-like boxes an image (inside the ``min(h, w)`` square)
    padded to 60 rows."""
    import numpy as np
    from torch_assign_cases import rand_gt

    rng = np.random.default_rng(seed)
    h, w = hw_of(size)
    images = rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)
    return images, rand_gt(rng, b, 60, 10, size=float(min(h, w)), n_valid_min=1)


def retina_loss_kernel_vs_plain(model, images, gt):
    """retina_loss with the assignment kernel == with its plain version on
    one step's head outputs. Returns the kernel's input."""
    from tpudet_torch.heads import retina as retina_head

    heads, g = train_heads(model, images, gt, lambda o: retina_head.flatten_preds(
        o, model.num_classes))
    return loss_kernels_vs_plain("retina_loss", lambda: retina_head.retina_loss(
        *heads, model.anchors, g, model.num_classes, model.alpha, model.gamma))["assign"]


def phase_retina_train(dev, n_steps=10, warmup=2):
    """The driver's config: batch 32, bf16, trained through train_one_epoch on
    one fixed batch; one assignment launch and no NMS launch a step."""
    import numpy as np
    import torch

    images, gt = retina_batch(4, TRAIN_BATCH, RETINA_SIZE)
    log(f"RetinaNet train batch: images {images.shape}, gt {gt.shape} with "
        f"{int((gt[..., 0] >= 0).sum())} objects")
    torch.cuda.reset_peak_memory_stats()
    model = retina_model(dev, feed((images, gt), n_steps, TRAIN_BATCH),
                         batch_size=TRAIN_BATCH)
    run = run_epoch(model, images, gt, warmup)
    counts, steps, losses = run["counts"], run["steps"], run["losses"]
    log(f"RetinaNet bf16: {warmup} warm-up steps + {steps} in train_one_epoch; kernel "
        f"launches in the epoch {counts}; losses {[round(x, 4) for x in losses]}")
    if steps != n_steps or counts["assign"] != steps or counts["nms_rows"] != 0:
        raise AssertionError(f"the RetinaNet train path must launch the assignment kernel "
                             f"once a step and no NMS: {counts}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    # the focal loss starts near 1.7e3 here (every class at ~1/21, ~47k
    # negatives over a few dozen positives): the first step takes it to tens,
    # then the momentum of that first gradient carries the weights on at lr
    # 0.01 and the loss climbs again, as tpudet's does
    # (tests/torch_retina_trajectory.py)
    if not (losses[1] < losses[0] and losses[-1] < losses[0]):
        raise AssertionError(f"the loss did not fall on one batch: {losses}")
    log(f"RetinaNet bf16 train: {run['images_per_s']:.1f} images/s by the host clock, "
        f"{run['step_ms']:.3f} ms/step by CUDA events, epoch mean {run['mean']:.4f}")
    assign_args = retina_loss_kernel_vs_plain(model, images, gt)
    prof = profile_step(model, images, gt)
    run["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    run["profile"] = prof
    log(f"RetinaNet peak device memory {run['peak_gib']:.2f} GiB (bf16 training)")
    del model
    torch.cuda.empty_cache()
    return dict(run=run, assign_args=assign_args)


def phase_retina_pretrain(dev, n_steps=3):
    """The ImageNet pretraining mode: batch 32 of 224x224 crops, integer
    labels below the last stage's width."""
    import numpy as np
    import torch

    rng = np.random.default_rng(5)
    images = rng.uniform(0, 255, (TRAIN_BATCH, PRETRAIN_SIZE, PRETRAIN_SIZE, 3)).astype(
        np.float32)
    labels = rng.integers(0, PRETRAIN_CLASSES, TRAIN_BATCH)
    model = retina_model(dev, feed((images, labels), n_steps, TRAIN_BATCH),
                         batch_size=TRAIN_BATCH, is_pretraining=True,
                         data_shape=[PRETRAIN_SIZE, PRETRAIN_SIZE, 3])
    writer = StepLog()
    loss, acc = model.train_one_epoch(0.01, writer)
    losses = [float(x) for x in writer.losses]
    if len(losses) != n_steps or not all(np.isfinite(losses)):
        raise AssertionError(f"pretraining losses: {losses}")
    pred = model.test_one_image(images[:1])
    if pred.shape != (1,) or not 0 <= int(pred[0]) < PRETRAIN_CLASSES:
        raise AssertionError(f"pretraining prediction {pred}")
    log(f"RetinaNet pretraining: {n_steps} steps at batch {TRAIN_BATCH}, losses "
        f"{[round(x, 4) for x in losses]}, mean accuracy {acc:.4f}; "
        f"test_one_image -> class {int(pred[0])}")
    del model
    torch.cuda.empty_cache()
    return dict(losses=losses, acc=acc)


def phase_retina_kernels(dev, serve_args, assign_args):
    """Both kernels at RetinaNet's shapes against their plain versions, timed:
    the assignment at [32, 60, 47961], the decode pool at [20, 47961], and a
    decode whose pool runs out (``torch_nms_cases.retina_decode_case``: row
    0's top 512 are near-copies of one box, the quota is 10) and reruns the
    rows at full width."""
    import torch
    from torch_nms_cases import retina_decode_case

    out = {}
    assign = assign_timing(assign_args)
    if not scratch_is_zero(dev):
        raise AssertionError("assignment kernel left its scratch non-zero at RetinaNet's "
                             "shape")
    assign_ops(assign_args)
    log(f"assign at RetinaNet's shape {tuple(assign_args[2].shape)} x "
        f"{assign_args[3].shape[0]} anchors: kernel == plain (best_iou bit for bit), "
        f"one device operation, scratch zero; kernel {assign['ms']:.4f} ms (device time "
        f"{fmt_ms(assign['device_ms'], 4)} ms), plain {assign['plain_ms']:.4f} ms, bound "
        f"{assign['bound_ms']:.6f} ms ({assign['bound_by']})")
    out["assign"] = assign

    pool = nms_pool_timing(serve_args)
    log_pool("RetinaNet's decode pool", pool)
    out["decode_pool"] = pool

    anchors = torch.cat([assign_args[3], assign_args[4]], -1).cpu().numpy()
    case = retina_decode_case(anchors, run_out=True)
    full = pool_run_out("RetinaNet", [torch.from_numpy(a).to(dev) for a in case[:3]]
                        + list(case[3:]))
    out["full_width"] = full
    return out


# --------------------------------------------------------------- RefineDet / PFPNet
# the training scripts' config (drivers/testrefinedet.py, drivers/testpfpnet.py);
# no VGG-16 file: seeded random weights
REFINE_CONFIG = {
    "mode": "train", "input_size": 320, "data_format": "channels_last",
    "num_classes": 20, "weight_decay": 1e-4, "keep_prob": 0.5, "batch_size": 32,
    "nms_score_threshold": 0.1, "nms_max_boxes": 20, "nms_iou_threshold": 0.45,
    "pretraining_weight": None, "compute_dtype": "bfloat16", "hard_neg_cap": 384,
    "seed": 0}
REFINE_SIZE = 320
REFINE_ANCHORS = 6375
REFINE_FAMILIES = {  # name: (the training script's lr, parameters, key in records)
    "RefineDet320": (1e-4, 55136414, "refinedet"),
    "PFPNetR": (1e-3, 52723348, "pfpnet")}


def refine_model(name, dev, provider=None, **overrides):
    from tpudet_torch import models

    t0 = time.perf_counter()
    model = getattr(models, name)(dict(REFINE_CONFIG, **overrides), provider)
    n_params = sum(p.numel() for p in model.net.parameters())
    log(f"{name} ({model.mode}, {model.compute_dtype}) built on {model.device} in "
        f"{time.perf_counter() - t0:.2f} s: {n_params} parameters, "
        f"{model.anchors.yx.shape[0]} anchors")
    if model.device.type != dev.type:
        raise AssertionError(f"{name} must default to the card")
    if REFINE_SIZE == 320 and (n_params != REFINE_FAMILIES[name][1]
                               or model.anchors.yx.shape[0] != REFINE_ANCHORS):
        raise AssertionError(f"{name} at its training script's config must have "
                             f"{REFINE_FAMILIES[name][1]} parameters and "
                             f"{REFINE_ANCHORS} anchors")
    return model


def network_vs_cpu_normwise(model, x, outputs):
    """The net on the card against the same weights on the CPU, normwise per
    output (|diff|_2 / |value|_2), held to 1e-4 or to 4x the CPU's own
    difference between its two summation orders (oneDNN's and PyTorch's
    convolutions), whichever is larger."""
    import torch

    def rel(got, want):
        return float(torch.linalg.vector_norm(got.float().cpu() - want.float())
                     / torch.linalg.vector_norm(want.float()))

    dev = x.device
    xin = model._preprocess(x).cpu()
    cpu_net = model.net.to("cpu")
    try:
        want = leaves(cpu_net(xin))
        with torch.backends.mkldnn.flags(enabled=False):
            other = leaves(cpu_net(xin))
    finally:
        model.net.to(dev)
    card_err = max(rel(g, w) for g, w in zip(leaves(outputs), want))
    cpu_err = max(rel(g, w) for g, w in zip(other, want))
    log(f"network on the card vs the CPU, same weights, normwise over "
        f"{len(want)} outputs: {card_err:.2e}, against {cpu_err:.2e} between the "
        f"CPU's two summation orders")
    if card_err > max(1e-4, 4 * cpu_err):
        raise AssertionError(f"network on the card vs the CPU: {card_err} (CPU orders "
                             f"{cpu_err})")
    return dict(card=card_err, cpu_orders=cpu_err)


def phase_refine_serve(dev, name, n_requests=10):
    """``name`` at its training script's config in test mode, fp32, score
    threshold 0.01 (random weights put the ODM softmax near 1/21, under the
    script's 0.1): one NMS launch (the sorted scan on the decode pool) and no
    assignment a request."""
    import torch

    model = refine_model(name, dev, mode="test", compute_dtype="float32",
                         nms_score_threshold=0.01)
    out = serve_requests(dev, model, REFINE_SIZE, n_requests, network_vs_cpu_normwise)
    counts = out["counts"]
    if (counts["sorted_scan"] != n_requests or counts["assign"]
            or not n_requests <= counts["nms_rows"] <= 2 * n_requests):
        raise AssertionError(f"{name} serving: expected one sorted scan (and a "
                             f"full-width rerun when a pool runs out) and no assignment "
                             f"a request, got {counts}")
    del model
    torch.cuda.empty_cache()
    return out


def phase_refine_train(dev, name, n_steps=10, warmup=2):
    """The training script's config: batch 32, bf16, its lr, on one fixed
    batch through train_one_epoch; one assignment and one NMS launch a step
    (two when the mining pool runs out)."""
    import numpy as np
    import torch

    from tpudet_torch.heads import refine as refine_head

    lr, _, _ = REFINE_FAMILIES[name]
    images, gt = retina_batch(6, TRAIN_BATCH, REFINE_SIZE)
    log(f"{name} train batch: images {images.shape}, gt {gt.shape} with "
        f"{int((gt[..., 0] >= 0).sum())} objects")
    torch.cuda.reset_peak_memory_stats()
    model = refine_model(name, dev, feed((images, gt), n_steps, TRAIN_BATCH),
                         batch_size=TRAIN_BATCH)
    run = run_epoch(model, images, gt, warmup, lr)
    counts, steps, losses = run["counts"], run["steps"], run["losses"]
    log(f"{name} bf16: {warmup} warm-up steps + {steps} in train_one_epoch at lr {lr}; "
        f"kernel launches in the epoch {counts}; losses {[round(x, 4) for x in losses]}")
    if (steps != n_steps or counts["assign"] != steps
            or not steps <= counts["nms_rows"] <= 2 * steps
            or counts["sorted_scan"] != steps):
        raise AssertionError(f"the {name} train path must launch the assignment kernel "
                             f"once a step and the NMS kernel's sorted scan once a step "
                             f"(and the per-pick kernel when a pool runs out): {counts}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall on one batch: {losses}")
    log(f"{name} bf16 train: {run['images_per_s']:.1f} images/s by the host clock, "
        f"{run['step_ms']:.3f} ms/step by CUDA events, epoch mean {run['mean']:.4f}")
    heads, g = train_heads(model, images, gt, lambda o: refine_head.flatten_preds(
        *o, model.num_classes))
    captured = loss_kernels_vs_plain("refine_loss", lambda: refine_head.refine_loss(
        *heads, model.anchors, g, model.num_classes, neg_sel_cap=384))
    run["profile"] = profile_step(model, images, gt, lr)
    run["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{name} peak device memory {run['peak_gib']:.2f} GiB (bf16 training)")
    del model
    torch.cuda.empty_cache()
    return dict(run=run, captured=captured)


def phase_family_kernels(name, serve_args, captured):
    """Both kernels at a family's shapes against their plain versions,
    timed: the assignment (RefineDet/PFPNet [32, 60, 6375], SSD512 [32, 60,
    24912]) and the mining pool ([32, 768] of the anchors) on a train step's
    inputs, the decode pool ([20, 512] of the anchors) on a request's."""
    assign = assign_timing(captured["assign"])
    log(f"{name} assign {tuple(captured['assign'][2].shape)} x "
        f"{captured['assign'][3].shape[0]} anchors: kernel == plain, "
        f"{assign['ms']:.4f} ms (device {fmt_ms(assign['device_ms'], 4)} ms), plain "
        f"{assign['plain_ms']:.4f} ms, bound {assign['bound_ms']:.6f} ms "
        f"({assign['bound_by']})")
    mining = nms_pool_timing(captured["pool"])
    log_pool(f"{name}'s mining pool (cap 384, IoU 0.7)", mining)
    decode = nms_pool_timing(serve_args)
    log_pool(f"{name}'s decode pool", decode)
    return dict(assign=assign, mining_pool=mining, decode_pool=decode)


def family_records(serve, train, kern, n_requests):
    """A family's entries of the kernels' JSON record (families with the
    assignment, mining and a decode pool)."""
    s_counts, t_counts = serve["counts"], train["run"]["counts"]
    steps = train["run"]["steps"]
    pool_keys = ("ms", "device_ms", "per_pick_ms", "per_pick_device_ms", "pool_call_ms",
                 "plain_ms", "bound_ms", "bound_by", "picks", "shape", "full_shape")
    nms = {"launches": s_counts["nms_rows"] + t_counts["nms_rows"],
           "launches_per_request": s_counts["nms_rows"] / n_requests,
           "launches_per_step": t_counts["nms_rows"] / steps,
           "launches_by_path": {k: s_counts[k] + t_counts[k]
                                for k in ("sorted_scan", "per_pick")},
           "decode_pool": {k: kern["decode_pool"][k] for k in pool_keys},
           "mining_pool": {k: kern["mining_pool"][k] for k in pool_keys}}
    assign = {"launches": t_counts["assign"] + s_counts["assign"],
              "launches_per_step": t_counts["assign"] / steps,
              "launches_per_request": s_counts["assign"] / n_requests,
              **{k: kern["assign"][k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                "bound_by")}}
    return nms, assign


# --------------------------------------------------------------- SSD512
# the SSD512 training script's config (drivers/testSSD512.py); no VGG-16 file
SSD512_CONFIG = {
    "mode": "train", "data_format": "channels_last", "num_classes": 20,
    "weight_decay": 1e-4, "keep_prob": 0.5, "batch_size": 32,
    "nms_score_threshold": 0.5, "nms_max_boxes": 20, "nms_iou_threshold": 0.5,
    "pretraining_weight": None, "compute_dtype": "bfloat16", "hard_neg_cap": 384,
    "seed": 0}
SSD512_SIZE = 512
SSD512_ANCHORS = 24912


def ssd512_model(dev, provider=None, **overrides):
    from tpudet_torch.models import SSD512

    t0 = time.perf_counter()
    model = SSD512(dict(SSD512_CONFIG, **overrides), provider)
    n_params = sum(p.numel() for p in model.net.parameters())
    log(f"SSD512 ({model.mode}, {model.compute_dtype}) built on {model.device} in "
        f"{time.perf_counter() - t0:.2f} s: {n_params} parameters, "
        f"{model.anchors.yx.shape[0]} anchors")
    if model.device.type != dev.type:
        raise AssertionError("SSD512 must default to the card")
    if SSD512_SIZE == 512 and model.anchors.yx.shape[0] != SSD512_ANCHORS:
        raise AssertionError(f"SSD512 must have {SSD512_ANCHORS} anchors")
    return model


def phase_ssd512(dev, n_requests=10, n_steps=10, warmup=2):
    """SSD512 at its training script's config: serve ``n_requests`` fp32
    requests at score threshold 0.01 (the softmax of random weights sits near
    1/21, under the script's 0.5): one NMS launch (the sorted scan on the
    decode pool) and no assignment a request; train 12 bf16 steps at batch
    32, lr 0.01, on one fixed batch: a finite, falling loss, one assignment
    and one or two NMS launches a step, ``ssd_loss`` with the kernels == with
    the plain versions; then both kernels at its shapes, timed."""
    import numpy as np
    import torch

    model = ssd512_model(dev, mode="test", compute_dtype="float32",
                         nms_score_threshold=0.01)
    serve = serve_requests(dev, model, SSD512_SIZE, n_requests, network_vs_cpu_normwise)
    counts = serve["counts"]
    if (counts["sorted_scan"] != n_requests or counts["assign"]
            or not n_requests <= counts["nms_rows"] <= 2 * n_requests):
        raise AssertionError(f"SSD512 serving: expected one sorted scan (and a full-width "
                             f"rerun when a pool runs out) and no assignment a request, "
                             f"got {counts}")
    del model
    torch.cuda.empty_cache()

    images, gt = retina_batch(7, TRAIN_BATCH, SSD512_SIZE)
    log(f"SSD512 train batch: images {images.shape}, gt {gt.shape} with "
        f"{int((gt[..., 0] >= 0).sum())} objects")
    torch.cuda.reset_peak_memory_stats()
    model = ssd512_model(dev, feed((images, gt), n_steps, TRAIN_BATCH),
                         batch_size=TRAIN_BATCH)
    run = run_epoch(model, images, gt, warmup)
    counts, steps, losses = run["counts"], run["steps"], run["losses"]
    log(f"SSD512 bf16: {warmup} warm-up steps + {steps} in train_one_epoch; kernel "
        f"launches in the epoch {counts}; losses {[round(x, 4) for x in losses]}")
    if (steps != n_steps or counts["assign"] != steps
            or not steps <= counts["nms_rows"] <= 2 * steps
            or counts["sorted_scan"] != steps):
        raise AssertionError(f"the SSD512 train path must launch the assignment kernel "
                             f"once a step and the NMS kernel's sorted scan once a step "
                             f"(and the per-pick kernel when a pool runs out): {counts}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall on one batch: {losses}")
    log(f"SSD512 bf16 train: {run['images_per_s']:.1f} images/s by the host clock, "
        f"{run['step_ms']:.3f} ms/step by CUDA events, epoch mean {run['mean']:.4f}")
    captured = loss_kernel_vs_plain(model, images, gt)
    run["profile"] = profile_step(model, images, gt)
    run["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"SSD512 peak device memory {run['peak_gib']:.2f} GiB (bf16 training)")
    del model
    torch.cuda.empty_cache()
    train = dict(run=run, captured=captured)
    kern = phase_family_kernels("SSD512", serve["kernel_args"], captured)
    return dict(serve=serve, train=train, kernels=kern,
                records=family_records(serve, train, kern, n_requests))


# --------------------------------------------------------------- YOLOv2 / YOLOv3
# the training scripts' config (drivers/testYOLOv2.py, drivers/testYOLOv3.py)
YOLO_CONFIGS = {
    "YOLOv2": {
        "mode": "train", "is_pretraining": False, "data_shape": [480, 480, 3],
        "num_classes": 20, "weight_decay": 1e-4, "keep_prob": 0.5,
        "data_format": "channels_last", "batch_size": 32, "coord_scale": 1,
        "noobj_scale": 1, "obj_scale": 5.0, "class_scale": 1.0,
        "nms_score_threshold": 0.5, "nms_max_boxes": 10, "nms_iou_threshold": 0.5,
        "rescore_confidence": False,
        "priors": [[1.08, 1.19], [3.42, 4.41], [6.63, 11.38], [9.42, 5.11],
                   [16.62, 10.52]],
        "compute_dtype": "bfloat16", "seed": 0},
    "YOLOv3": {
        "mode": "train", "data_shape": [448, 448, 3], "num_classes": 20,
        "weight_decay": 5e-4, "keep_prob": 0.5, "data_format": "channels_last",
        "batch_size": 12, "coord_scale": 1, "noobj_scale": 1, "obj_scale": 5.0,
        "class_scale": 1.0, "num_priors": 3,
        "nms_score_threshold": 0.5, "nms_max_boxes": 10, "nms_iou_threshold": 0.5,
        "priors": [[[10.0, 13.0], [16, 30.0], [33.0, 23.0]],
                   [[30.0, 61.0], [62.0, 45.0], [59.0, 119.0]],
                   [[116.0, 90.0], [156.0, 198.0], [373.0, 326.0]]],
        "compute_dtype": "bfloat16", "seed": 0}}
YOLO_RUNS = {  # name: (the script's lr, batch, input size, decode rows, key)
    "YOLOv2": (0.005, TRAIN_BATCH, 480, 1125, "yolov2"),
    "YOLOv3": (0.001, 12, 448, 12348, "yolov3")}
YOLO_POOL = 512  # the decode pool: max(2 * nms_max_boxes, 512)
YOLO_RUNAWAY = 20.0  # |head output| past which exp(hw) and the boxes run away


def yolo_model(name, dev, provider=None, **overrides):
    from tpudet_torch import models

    t0 = time.perf_counter()
    model = getattr(models, name)(dict(YOLO_CONFIGS[name], **overrides), provider)
    n_params = sum(p.numel() for p in model.net.parameters())
    log(f"{name} ({model.mode}, {model.compute_dtype}) built on {model.device} in "
        f"{time.perf_counter() - t0:.2f} s: {n_params} parameters, input "
        f"{model.data_shape_hw}")
    if model.device.type != dev.type:
        raise AssertionError(f"{name} must default to the card")
    return model


def yolo_candidates(model, outputs, threshold):
    """Candidates a class row holds at ``threshold``: decoded confidences of
    one image's head outputs, ``conf >= threshold`` counted per class."""
    import torch

    from tpudet_torch.heads import yolo as yolo_head

    heads = [o[0] for o in leaves(outputs)]
    priors = ([model.priors_hw] if hasattr(model, "priors_hw")
              else model.priors_per_head)
    conf = torch.cat([yolo_head._decode_boxes(h, p, model.raw_classes, 1.0,
                                              model.consistent)[1]
                      for h, p in zip(heads, priors)], 0)
    return (conf >= threshold).sum(0)


def phase_yolo_serve(dev, name, n_requests=10):
    """``name`` at its training script's config in test mode, fp32. The
    BatchNorm statistics come from 4 seeded images where the initial ones
    (mean 0, var 1) let the eval-mode head outputs run away. The script's
    score threshold 0.5 is kept if a class row then holds more than the
    512-wide pool's candidates; otherwise 0.01, so that the pool and its
    exhaustion check really run. One NMS launch (the sorted scan) and no
    assignment a request."""
    import numpy as np
    import torch

    _, _, size, rows, _ = YOLO_RUNS[name]
    model = yolo_model(name, dev, mode="test", compute_dtype="float32")
    rng = np.random.default_rng(11)
    probe = model._images_to_device(rng.uniform(0, 255, (1, size, size, 3))
                                    .astype(np.float32))
    with torch.inference_mode():
        peak = max(float(o.abs().max()) for o in leaves(model.net.eval()(
            model._preprocess(probe))))
    calibrated = peak > YOLO_RUNAWAY
    if calibrated:
        calibrate_batchnorm(model, rng.uniform(0, 255, (4, size, size, 3))
                            .astype(np.float32))
    with torch.inference_mode():
        outputs = model.net(model._preprocess(probe))
        after = max(float(o.abs().max()) for o in leaves(outputs))
        at_half = yolo_candidates(model, outputs, 0.5)
        if int(at_half.max()) <= YOLO_POOL:
            model.nms_score_threshold = 0.01
        chosen = yolo_candidates(model, outputs, model.nms_score_threshold)
    log(f"{name} serve: max |head output| {peak:.3g} with the initial BatchNorm "
        f"statistics{f', {after:.3g} after taking them from 4 images' if calibrated else ''}"
        f"; candidates a class row holds of {rows}: at 0.5 max {int(at_half.max())}, "
        f"min {int(at_half.min())}; score threshold {model.nms_score_threshold}: "
        f"{chosen.tolist()}")
    out = serve_requests(dev, model, size, n_requests, network_vs_cpu_normwise)
    counts = out["counts"]
    if (counts["nms_rows"] != n_requests or counts["sorted_scan"] != n_requests
            or counts["assign"]):
        raise AssertionError(f"{name} serving: expected exactly one NMS launch (the "
                             f"sorted scan) and no assignment a request, got {counts}")
    boxes, scores = out["kernel_args"][:2]
    if tuple(scores.shape) != (20, rows):
        raise AssertionError(f"{name} decode rows {tuple(scores.shape)}, expected "
                             f"(20, {rows})")
    out.update(score_threshold=model.nms_score_threshold, calibrated=calibrated,
               head_peak=peak, head_peak_after=after, candidates=chosen.tolist(),
               candidates_at_half=at_half.tolist())
    del model
    torch.cuda.empty_cache()
    return out


def train_without_kernels(name, model, images, gt, n_steps, warmup, lr):
    """``warmup`` steps, then ``train_one_epoch`` of ``n_steps`` on one fixed
    batch: no kernel launch at all, a finite and falling loss, a profiled
    step and peak memory."""
    import numpy as np
    import torch

    run = run_epoch(model, images, gt, warmup, lr)
    counts, steps, losses = run["counts"], run["steps"], run["losses"]
    log(f"{name} {model.compute_dtype}: {warmup} warm-up steps + {steps} in "
        f"train_one_epoch at lr {lr}, batch {model.batch_size}; kernel launches in the "
        f"epoch {counts}; losses {[round(x, 4) for x in losses]}")
    if steps != n_steps or counts["assign"] or counts["nms_rows"]:
        raise AssertionError(f"the {name} train path launches no kernel: {counts}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall on one batch: {losses}")
    log(f"{name} bf16 train: {run['images_per_s']:.1f} images/s by the host clock, "
        f"{run['step_ms']:.3f} ms/step by CUDA events, epoch mean {run['mean']:.4f}")
    run["profile"] = profile_step(model, images, gt, lr)
    run["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{name} peak device memory {run['peak_gib']:.2f} GiB (bf16 training)")
    return run


def phase_yolo_train(dev, name, n_steps=10, warmup=2):
    """The training script's config: its batch (32 / 12), bf16, its lr, on
    one fixed batch through train_one_epoch; no assignment and no NMS launch
    a step."""
    import torch

    lr, batch, size, _, _ = YOLO_RUNS[name]
    images, gt = retina_batch(12, batch, size)
    log(f"{name} train batch: images {images.shape}, gt {gt.shape} with "
        f"{int((gt[..., 0] >= 0).sum())} objects")
    torch.cuda.reset_peak_memory_stats()
    model = yolo_model(name, dev, feed((images, gt), n_steps, batch), batch_size=batch)
    run = train_without_kernels(name, model, images, gt, n_steps, warmup, lr)
    del model
    torch.cuda.empty_cache()
    return run


def yolo_records(serve, run, pool, n_requests):
    """A YOLO family's entries of the kernels' JSON record: the decode pool's
    NMS, and no assignment."""
    s_counts, t_counts = serve["counts"], run["counts"]
    pool_keys = ("ms", "device_ms", "per_pick_ms", "per_pick_device_ms", "pool_call_ms",
                 "plain_ms", "bound_ms", "bound_by", "picks", "shape", "full_shape")
    nms = {"launches": s_counts["nms_rows"] + t_counts["nms_rows"],
           "launches_per_request": s_counts["nms_rows"] / n_requests,
           "launches_per_step": t_counts["nms_rows"] / run["steps"],
           "launches_by_path": {k: s_counts[k] + t_counts[k]
                                for k in ("sorted_scan", "per_pick")},
           "score_threshold": serve["score_threshold"],
           "decode_pool": {k: pool[k] for k in pool_keys}}
    assign = {"launches": s_counts["assign"] + t_counts["assign"],
              "launches_per_request": s_counts["assign"] / n_requests,
              "launches_per_step": t_counts["assign"] / run["steps"]}
    return nms, assign


# --------------------------------------------------------------- FCOS
# the FCOS training script's config (drivers/testfcos.py)
FCOS_CONFIG = {
    "mode": "train", "data_shape": [800, 1200, 3], "data_format": "channels_last",
    "num_classes": 20, "weight_decay": 1e-4, "keep_prob": 0.5, "batch_size": 8,
    "nms_score_threshold": 0.5, "nms_max_boxes": 10, "nms_iou_threshold": 0.45,
    "compute_dtype": "bfloat16", "seed": 0}
# tpudet's own warm-up lr at the script's 0.01 (the first segment of
# scripts/train_convergence.py's FCOS schedules is 0.1x): at 0.01 from random
# weights the loss runs away within a few steps (to NaN at 256x384, batch 4),
# in the port and, step for step, in tpudet
FCOS_LR = 1e-3
FCOS_ROWS = 20017  # 100x150 + 50x75 + 25x38 + 13x19 + 7x10 locations
FCOS_QUANTILE = 0.9  # the serving threshold: this quantile of a probe's scores


def fcos_model(dev, provider=None, **overrides):
    from tpudet_torch.models import FCOS

    t0 = time.perf_counter()
    model = FCOS(dict(FCOS_CONFIG, **overrides), provider)
    n_params = sum(p.numel() for p in model.net.parameters())
    log(f"FCOS ({model.mode}, {model.compute_dtype}) built on {model.device} in "
        f"{time.perf_counter() - t0:.2f} s: {n_params} parameters, input "
        f"{model.data_shape_hw}")
    if model.device.type != dev.type:
        raise AssertionError("FCOS must default to the card")
    return model


def fcos_scores(model, outputs):
    """The decode's scores ``[C - 1, locations]`` of one image's outputs."""
    import torch

    return torch.cat([(torch.sigmoid(c[0]) * torch.sigmoid(p[0])).reshape(c.shape[1], -1)
                      for c, _, p in outputs], 1)[:model.raw_classes - 1]


def phase_fcos_serve(dev, n_requests=10):
    """FCOS at its training script's config in test mode, fp32, at a score
    threshold of the ``FCOS_QUANTILE`` quantile of a probe image's scores
    (the prior bias puts both sigmoids near 0.01: the script's 0.5 selects
    nothing). Exactly one NMS launch (the sorted scan on the pool) and no
    assignment a request."""
    import numpy as np
    import torch

    model = fcos_model(dev, mode="test", compute_dtype="float32")
    hw = model.data_shape_hw
    probe = model._images_to_device(np.random.default_rng(11).uniform(
        0, 255, (1, *hw, 3)).astype(np.float32))
    with torch.inference_mode():
        conf = fcos_scores(model, model.net.eval()(model._preprocess(probe)))
        thr = float(f"{float(torch.quantile(conf.flatten(), FCOS_QUANTILE)):.3g}")
        at_half = int((conf >= 0.5).sum())
        chosen = (conf >= thr).sum(1)
    model.nms_score_threshold = thr
    log(f"FCOS serve: the probe's scores span [{float(conf.min()):.3g}, "
        f"{float(conf.max()):.3g}]; {at_half} candidates at the script's 0.5; score "
        f"threshold {thr} (quantile {FCOS_QUANTILE}): candidates a class row holds of "
        f"{conf.shape[1]}: {chosen.tolist()}")
    out = serve_requests(dev, model, hw, n_requests, network_vs_cpu_normwise)
    counts = out["counts"]
    if (counts["nms_rows"] != n_requests or counts["sorted_scan"] != n_requests
            or counts["assign"]):
        raise AssertionError(f"FCOS serving: expected exactly one NMS launch (the sorted "
                             f"scan) and no assignment a request, got {counts}")
    scores = out["kernel_args"][1]
    if tuple(scores.shape) != (model.raw_classes - 1, FCOS_ROWS):
        raise AssertionError(f"FCOS decode rows {tuple(scores.shape)}, expected "
                             f"({model.raw_classes - 1}, {FCOS_ROWS}) (Q9)")
    out.update(score_threshold=thr, candidates=chosen.tolist(), candidates_at_half=at_half)
    del model
    torch.cuda.empty_cache()
    return out


def phase_fcos_train(dev, n_steps=10, warmup=2):
    import torch

    b = FCOS_CONFIG["batch_size"]
    images, gt = retina_batch(13, b, FCOS_CONFIG["data_shape"][:2])
    log(f"FCOS train batch: images {images.shape}, gt {gt.shape} with "
        f"{int((gt[..., 0] >= 0).sum())} objects")
    torch.cuda.reset_peak_memory_stats()
    model = fcos_model(dev, feed((images, gt), n_steps, b))
    run = train_without_kernels("FCOS", model, images, gt, n_steps, warmup, FCOS_LR)
    del model
    torch.cuda.empty_cache()
    return run


# --------------------------------------------------------------- CenterNet
# the CenterNet training script's config (drivers/testcenternet.py)
CENTERNET_CONFIG = {
    "mode": "train", "input_size": 384, "data_format": "channels_last",
    "num_classes": 20, "weight_decay": 1e-4, "keep_prob": 0.5, "batch_size": 15,
    "score_threshold": 0.1, "top_k_results_output": 100, "compute_dtype": "bfloat16",
    "seed": 0}
CENTERNET_LR = 0.001


def centernet_model(dev, provider=None, **overrides):
    from tpudet_torch.models import CenterNet

    t0 = time.perf_counter()
    model = CenterNet(dict(CENTERNET_CONFIG, **overrides), provider)
    n_params = sum(p.numel() for p in model.net.parameters())
    log(f"CenterNet ({model.mode}, {model.compute_dtype}) built on {model.device} in "
        f"{time.perf_counter() - t0:.2f} s: {n_params} parameters, input "
        f"{model.input_size}")
    if model.device.type != dev.type:
        raise AssertionError("CenterNet must default to the card")
    return model


def phase_centernet_serve(dev, n_requests=10):
    """CenterNet at its training script's config in test mode, fp32, at its
    score threshold 0.1 and top-k 100: no kernel launch a request; one
    request's decode on the card == on the CPU on the same head outputs;
    the network against the CPU; a profile."""
    import numpy as np
    import torch

    from tpudet_torch.heads import centernet as center_head

    model = centernet_model(dev, mode="test", compute_dtype="float32")
    size = model.input_size
    rng = np.random.default_rng(11)
    probe = model._images_to_device(rng.uniform(0, 255, (1, size, size, 3))
                                    .astype(np.float32))
    with torch.inference_mode():
        peak = max(float(o.abs().max()) for o in model.net.eval()(model._preprocess(probe)))
    calibrated = peak > YOLO_RUNAWAY
    if calibrated:
        calibrate_batchnorm(model, rng.uniform(0, 255, (4, size, size, 3))
                            .astype(np.float32))
    with torch.inference_mode():
        after = max(float(o.abs().max()) for o in model.net(model._preprocess(probe)))
    taken = f", {after:.3g} after taking them from 4 images" if calibrated else ""
    log(f"CenterNet serve: max |head output| {peak:.3g} with the initial BatchNorm "
        f"statistics{taken}")

    rng = np.random.default_rng(1)
    images = [rng.uniform(0, 255, (1, size, size, 3)).astype(np.float32)
              for _ in range(n_requests)]
    latencies, results, counts = timed_requests(model, images)
    if counts["nms_rows"] or counts["assign"]:
        raise AssertionError(f"the CenterNet serving path launches no kernel: {counts}")
    for scores, _, _ in results:
        if (len(scores) > model.top_k_results_output
                or (scores <= model.score_threshold).any()):
            raise AssertionError("detections beyond top-k or at most the threshold")
    p50 = check_detections(results, latencies, model.raw_classes)

    x = torch.from_numpy(images[0].transpose(0, 3, 1, 2).copy()).to(dev)
    with torch.inference_mode():
        outputs = model.net(model._preprocess(x))

        def decode():
            return model._decode_outputs(outputs)

        on_card = [t.cpu() for t in decode()]
        on_cpu = center_head.centernet_decode(
            *(t[0].cpu() for t in outputs), model.score_threshold,
            model.top_k_results_output)
        torch.cuda.synchronize()
        # the picks, their order, boxes and classes exactly; the scores are
        # sigmoids, which the two devices' libraries may round an ulp apart
        for what, a, b in zip(("boxes", "class_id", "valid"), on_card[1:], on_cpu[1:]):
            if not torch.equal(a, b):
                raise AssertionError(f"CenterNet decode on the card != on the CPU: {what}")
        score_err = float((on_card[0] - on_cpu[0]).abs().max())
        if score_err > 2.0 ** -22 * float(on_cpu[0].abs().max()):
            raise AssertionError(f"CenterNet decode scores on the card vs the CPU: "
                                 f"{score_err}")
        log(f"decode of one request: the card == the CPU on the same head outputs "
            f"({int(on_card[3].sum())} detections of {on_card[0].shape[0]}: picks, "
            f"boxes and classes exactly, scores within {score_err:.2e})")
        fwd_ms = event_ms(lambda: model.net(model._preprocess(x)), 10)
        dec_ms = event_ms(decode, 10)
        log(f"request breakdown (device, CUDA events): network {fwd_ms:.3f} ms, "
            f"decode {dec_ms:.3f} ms")
        net_check = network_vs_cpu_normwise(model, x, outputs)
    profile_requests(model, images[:3])
    del model
    torch.cuda.empty_cache()
    return dict(latencies=latencies, p50=p50, counts=counts, network_ms=fwd_ms,
                decode_ms=dec_ms, network_vs_cpu=net_check, calibrated=calibrated,
                head_peak=peak, head_peak_after=after)


def adam_card_vs_cpu(model):
    """Two TF-style Adam updates of the model's parameters on the card and on
    the CPU, from the same state and the same seeded gradients: the largest
    difference of parameters and moments, held to 1e-6 of each tensor's
    largest entry (``b^t`` is a float32 ``pow``, which the two devices'
    libraries may round apart by an ulp)."""
    import torch

    from tpudet_torch.runtime import optim

    gen = torch.Generator().manual_seed(5)
    cpu = {k: p.detach().cpu().clone() for k, p in model.net.named_parameters()}
    grads = [{k: torch.randn(p.shape, generator=gen) * 10.0 ** (2 * torch.rand(
        (), generator=gen) - 4) for k, p in cpu.items()} for _ in range(2)]
    card = {k: p.to(model.device) for k, p in cpu.items()}
    adam = optim.Adam()
    s_cpu, s_card = adam.init(cpu), adam.init(card)
    for g in grads:
        adam.update(g, s_cpu, cpu, CENTERNET_LR)
        adam.update({k: v.to(model.device) for k, v in g.items()}, s_card, card,
                    CENTERNET_LR)
    torch.cuda.synchronize()
    worst = 0.0
    for got, want in ((card, cpu), (s_card["mu"], s_cpu["mu"]),
                      (s_card["nu"], s_cpu["nu"])):
        for k in want:
            scale = float(want[k].abs().max()) or 1.0
            worst = max(worst, float((got[k].cpu() - want[k]).abs().max()) / scale)
    exact = all(torch.equal(card[k].cpu(), cpu[k]) for k in cpu)
    log(f"Adam, two updates of {len(cpu)} tensors on the card vs the CPU, same "
        f"gradients: max |diff| / max |value| {worst:.3e}; parameters bit for bit: {exact}")
    if worst > 1e-6 or int(s_card["count"]) != 2:
        raise AssertionError(f"Adam on the card vs the CPU: {worst}")
    return dict(max_rel_err=worst, bit_for_bit=exact)


def centernet_bad_labels(dev, model, images, gt):
    """Valid gts labelled -1, 20 and -21 (tpudet wraps the first and drops the
    others at the center cells): ``centernet_loss`` on one step's head
    outputs stays finite on the card and equals the CPU's, and the context
    stays usable."""
    import numpy as np
    import torch

    from tpudet_torch.heads import centernet as center_head

    bad = gt.copy()
    bad[0, :3, 4] = [-1, 20, -21]
    heads, g = train_heads(model, images, bad, lambda o: o)
    on_card = center_head.centernet_loss(*heads, g, model.raw_classes)
    on_cpu = center_head.centernet_loss(*(h.cpu() for h in heads), g.cpu(),
                                        model.raw_classes)
    if not bool(torch.isfinite(on_card)):
        raise AssertionError(f"out-of-range labels: loss {float(on_card)} on the card")
    x = torch.arange(8.0, device=dev)
    if float((x * 2).sum()) != 56.0:
        raise AssertionError("the context is not usable after out-of-range labels")
    rel = abs(float(on_card) - float(on_cpu)) / abs(float(on_cpu))
    log(f"CenterNet loss with labels -1, 20, -21: {float(on_card):.6f} on the card, "
        f"{float(on_cpu):.6f} on the CPU (rel {rel:.2e}); the context is usable after")
    if rel > 1e-5 or not np.isfinite(float(on_cpu)):
        raise AssertionError(f"out-of-range labels: card {float(on_card)} vs CPU "
                             f"{float(on_cpu)}")
    return dict(card=float(on_card), cpu=float(on_cpu))


def phase_centernet_train(dev, n_steps=10, warmup=2):
    import torch

    b, size = CENTERNET_CONFIG["batch_size"], CENTERNET_CONFIG["input_size"]
    images, gt = retina_batch(14, b, size)
    log(f"CenterNet train batch: images {images.shape}, gt {gt.shape} with "
        f"{int((gt[..., 0] >= 0).sum())} objects")
    torch.cuda.reset_peak_memory_stats()
    model = centernet_model(dev, feed((images, gt), n_steps, b))
    run = train_without_kernels("CenterNet", model, images, gt, n_steps, warmup,
                                CENTERNET_LR)
    if int(model.opt_state["count"]) != model.global_step:
        raise AssertionError(f"Adam's count {int(model.opt_state['count'])} after "
                             f"{model.global_step} steps")
    run["adam"] = adam_card_vs_cpu(model)
    run["bad_labels"] = centernet_bad_labels(dev, model, images, gt)
    del model
    torch.cuda.empty_cache()
    return run


def no_kernel_records(serve, run, n_requests):
    """A family's entries for a kernel that neither its steps nor its
    requests launch."""
    return {"launches": 0, "launches_per_request": 0.0, "launches_per_step": 0.0,
            "request_counts": serve["counts"], "step_counts": run["counts"],
            "steps": run["steps"], "requests": n_requests}



# --------------------------------------------------------------- LH-RCNN
# the LH-RCNN training script's config (drivers/testlhrcnn.py)
LHRCNN_CONFIG = {
    "data_shape": [700, 1100, 3], "mode": "train", "is_pretraining": False,
    "data_format": "channels_last", "num_classes": 20, "weight_decay": 1e-4,
    "keep_prob": 0.5, "batch_size": 32, "rpn_first_step": 60000,
    "rcnn_first_step": 100000, "rpn_second_step": 160000,
    "nms_score_threshold": 0.5, "nms_max_boxes": 20, "nms_iou_threshold": 0.45,
    "post_nms_proposal": 500, "compute_dtype": "bfloat16", "seed": 0}
# tpudet's own warm-up lr at batch 32 (scripts/train_convergence.py's
# LHRCNN-long2: 6e-4, its first segment 0.1x). At the script's 0.003 from
# random weights, six bf16 RPN steps on an H100 left two centre coordinates
# of sampled positive proposals exactly 0 (a bf16 pyx can make a_hw * pyx +
# a_yx exactly 0), and quirk Q12 divides the RCNN box target by the centre:
# the first RCNN step's loss was inf (lhrcnn_losses_vs_plain logs the count)
LHRCNN_LR = 6e-5
LHRCNN_ANCHORS = 6818  # of 11,550 on the 22x35 grid: the static border filter
LHRCNN_PARAMS = 54920159
# the eval-mode RPN's max |phw| must lie in this range with the initial
# BatchNorm statistics, else they are taken from 4 seeded images: past 5,
# exp(phw) blows the proposals up; under 0.05 the activations have vanished
# through the ~40 eval-mode layers and every class score is 1/21
LHRCNN_PHW_RANGE = (0.05, 5.0)
LHRCNN_STEPS = 4  # measured steps a phase, after 2 warm-up steps


def lhrcnn_model(dev, provider=None, **overrides):
    from tpudet_torch.models import LHRCNN

    t0 = time.perf_counter()
    model = LHRCNN(dict(LHRCNN_CONFIG, **overrides), provider)
    n_params = sum(p.numel() for p in model.net.parameters())
    log(f"LHRCNN ({model.mode}, {model.compute_dtype}) built on {model.device} in "
        f"{time.perf_counter() - t0:.2f} s: {n_params} parameters, "
        f"{model.anchors.yx.shape[0]} anchors, input {model.data_shape_hw}")
    if model.device.type != dev.type:
        raise AssertionError("LHRCNN must default to the card")
    if LHRCNN_CONFIG["data_shape"] == [700, 1100, 3] and (
            n_params != LHRCNN_PARAMS or model.anchors.yx.shape[0] != LHRCNN_ANCHORS):
        raise AssertionError(f"LHRCNN at the driver's config must have {LHRCNN_PARAMS} "
                             f"parameters and {LHRCNN_ANCHORS} anchors")
    return model


def record_nms_calls(fn):
    """``fn()`` with every ``nms_rows`` call's arguments recorded (the
    sorted scan's order computed where the wrapper computes it). Returns
    the result and the calls."""
    from tpudet_torch.ops.cuda import nms_kernel

    calls, real = [], nms_kernel.nms_rows

    def spy(boxes, scores, ns, max_out, thr, order=None):
        if order is None and nms_kernel.scan_path(scores.shape[1]) == "sorted_scan":
            order = nms_kernel.stable_order(scores)
        calls.append((boxes, scores, ns, max_out, thr, order))
        return real(boxes, scores, ns, max_out, thr, order)

    nms_kernel.nms_rows = spy
    try:
        out = fn()
    finally:
        nms_kernel.nms_rows = real
    return out, calls


def lhrcnn_network_vs_cpu(model, x, outputs):
    """The net's three maps on the card against the CPU's, as
    ``network_vs_cpu_normwise``, and the RoI head on 64 crops of the card's
    thin map, held the same way."""
    import torch

    from tpudet_torch.heads import lhrcnn as lh
    from tpudet_torch.ops import roi

    out = network_vs_cpu_normwise(model, x, outputs)
    gen = torch.Generator().manual_seed(23)
    y1x1 = torch.rand((1, 64, 2), generator=gen) * 0.7
    boxes = torch.cat([y1x1, y1x1 + 0.05 + torch.rand((1, 64, 2), generator=gen) * 0.3], -1)
    crops = roi.crop_and_resize(outputs[2], boxes.to(x.device), lh.CROP)[0]
    card = model.net.roi_head(crops)
    head = model.net.rcnn.head.to("cpu")
    try:
        want = head(crops.cpu())
        with torch.backends.mkldnn.flags(enabled=False):
            other = head(crops.cpu())
    finally:
        head.to(x.device)

    def rel(got, ref):
        return float(torch.linalg.vector_norm(got.cpu() - ref)
                     / torch.linalg.vector_norm(ref))

    card_err = max(rel(g, w) for g, w in zip(card, want))
    cpu_err = max(rel(g, w) for g, w in zip(other, want))
    log(f"RoI head on 64 crops of the card's thin map, card vs CPU, normwise: "
        f"{card_err:.2e}, against {cpu_err:.2e} between the CPU's two orders")
    if card_err > max(1e-4, 4 * cpu_err):
        raise AssertionError(f"RoI head on the card vs the CPU: {card_err}")
    return dict(out, roi_head=card_err, roi_head_cpu_orders=cpu_err)


def phase_lhrcnn_serve(dev, n_requests=10):
    """LH-RCNN at its training script's config in test mode, fp32. The
    BatchNorm statistics come from 4 seeded images where the initial ones
    put the RPN's max ``|phw|`` outside ``LHRCNN_PHW_RANGE``; the score threshold is
    the ``FCOS_QUANTILE`` quantile of a probe image's class scores over its
    500 proposals (a 21-way softmax of random weights sits near 1/21, under
    the script's 0.5). Per request: the sorted scan on the proposal pool [1,
    1000] of [1, 6818] and on the class rows [20, 500], a per-pick rerun at
    [1, 6818] only when the proposal pool runs out (counted), no
    assignment."""
    import numpy as np
    import torch

    from tpudet_torch.heads import lhrcnn as lh

    model = lhrcnn_model(dev, mode="test", compute_dtype="float32")
    h, w = model.data_shape_hw
    rng = np.random.default_rng(11)
    probe = model._images_to_device(rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32))

    def phw_peak():
        with torch.inference_mode():
            out = model.net.eval()(model._preprocess(probe))
            return out, float(model._split_rpn(out[0], out[1])[1].abs().max())

    _, peak = phw_peak()
    calibrated = not LHRCNN_PHW_RANGE[0] <= peak <= LHRCNN_PHW_RANGE[1]
    if calibrated:
        calibrate_batchnorm(model, rng.uniform(0, 255, (4, h, w, 3)).astype(np.float32))
    outputs, after = phw_peak()
    with torch.inference_mode():
        pyx, phw, pconf = model._split_rpn(outputs[0], outputs[1])
        _, sel_valid, rconf, _ = lh.lhrcnn_rois(
            model.net.roi_head, outputs[2][0], pyx[0], phw[0], pconf[0], model.anchors,
            float(h), float(w), model.post_nms_proposal)
        conf = torch.softmax(rconf, -1)
        keep = sel_valid & (torch.argmax(conf, -1) < 20)
        scores = conf[keep][:, :20]
        thr = float(f"{float(torch.quantile(scores.flatten(), FCOS_QUANTILE)):.3g}")
        at_half = int((scores >= 0.5).sum())
        chosen = (scores >= thr).sum(0)
    model.nms_score_threshold = thr
    log(f"LHRCNN serve: max |phw| {peak:.3g} with the initial BatchNorm statistics"
        f"{f', {after:.3g} after taking them from 4 images' if calibrated else ''}; the "
        f"probe's proposal NMS kept {int(sel_valid.sum())} of 500, {int(keep.sum())} not "
        f"background; class scores span [{float(scores.min()):.3g}, "
        f"{float(scores.max()):.3g}], {at_half} at the script's 0.5; score threshold "
        f"{thr} (quantile {FCOS_QUANTILE}): candidates a class row holds of 500: "
        f"{chosen.tolist()}")
    out = serve_requests(dev, model, (h, w), n_requests, lhrcnn_network_vs_cpu)
    counts = out["counts"]
    reruns = counts["per_pick"]
    if (counts["sorted_scan"] != 2 * n_requests or counts["assign"]
            or counts["nms_rows"] != 2 * n_requests + reruns or reruns > n_requests):
        raise AssertionError(f"LHRCNN serving: expected two sorted scans (and a per-pick "
                             f"rerun when the proposal pool runs out) and no assignment "
                             f"a request, got {counts}")
    pool_args = out["kernel_args"]
    if (tuple(pool_args[1].shape) != (1, LHRCNN_ANCHORS)
            or tuple(pool_args[5].shape) != (1, 1000)):
        raise AssertionError(f"LHRCNN proposal pool {tuple(pool_args[5].shape)} of "
                             f"{tuple(pool_args[1].shape)}")
    x = model._images_to_device(np.random.default_rng(1).uniform(
        0, 255, (1, h, w, 3)).astype(np.float32))
    with torch.inference_mode():
        outputs = model.net(model._preprocess(x))
        _, calls = record_nms_calls(lambda: model._decode_outputs(outputs))
    class_args = calls[-1]
    if tuple(class_args[1].shape) != (20, 500):
        raise AssertionError(f"LHRCNN class rows {tuple(class_args[1].shape)}")
    log(f"LHRCNN serving: {reruns} of {n_requests} requests ran out of the proposal pool "
        f"and reran at full width; class rows {tuple(class_args[1].shape)}")
    out.update(score_threshold=thr, calibrated=calibrated, head_peak=peak,
               head_peak_after=after, candidates=chosen.tolist(),
               candidates_at_half=at_half, pool_reruns=reruns, class_args=class_args)
    del model
    torch.cuda.empty_cache()
    return out


def snapshot(model, scopes):
    """Copies of the parameters and Momentum velocities under ``scopes``."""
    keep = [k for k, _ in model.net.named_parameters() if k.split(".", 1)[0] in scopes]
    params = dict(model.net.named_parameters())
    return ({k: params[k].detach().clone() for k in keep},
            {k: model.velocity[k].clone() for k in keep})


def unchanged(model, before) -> bool:
    """Whether the parameters and velocities of ``before`` are bit for bit."""
    import torch

    params = dict(model.net.named_parameters())
    return (all(torch.equal(params[k], v) for k, v in before[0].items())
            and all(torch.equal(model.velocity[k], v) for k, v in before[1].items()))


def lhrcnn_image_losses(model, images, gt, phase):
    """Each image's loss of ``phase`` (without weight decay) on one
    train-mode forward of the batch, without an update: the RPN loss of
    ``rpn_loss_and_sample``, or ``rcnn_losses`` over the image's own 384
    sampled proposals."""
    import torch

    from tpudet_torch.heads import lhrcnn as lh

    outputs, g = train_heads(model, images, gt, lambda o: o)
    h, w = model.data_shape_hw
    with torch.no_grad():
        sample = lh.rpn_loss_and_sample(*model._split_rpn(outputs[0], outputs[1]),
                                        model.anchors, g)
        if phase == "rpn":
            return sample.rpn_loss.float().cpu()
        return torch.stack([lh.rcnn_losses(
            model.net.roi_head, outputs[2][i:i + 1],
            lh.RPNSample(*(t[i:i + 1] for t in sample)), float(h), float(w),
            model.num_classes) for i in range(len(images))]).float().cpu()


def lhrcnn_phase_run(model, images, gt, phase, warmup=2):
    """``warmup`` steps and a ``train_one_epoch`` of ``LHRCNN_STEPS`` in one
    phase, from the model's ``global_step``: two NMS launches a step (the
    sorted scans of the positive and negative pools; a per-pick rerun when
    a pool runs out, counted), no assignment, a finite loss every step, the
    other phase's parameters and velocities bit for bit; a profiled step and
    peak memory.

    The loss must fall over the phase as the median of the 32 images'
    losses (:func:`lhrcnn_image_losses`, before the first step and after
    the last), not as the batch loss of single steps: the reference averages
    each image's RPN coordinate loss over its own positives (times 10), so
    an image with one positive puts one anchor's regression at full weight,
    and from random weights those few regressions swing while the rest fall
    (on the CPU at batch 32, float32, lr 0.003: the median image 22.6 ->
    13.9 over the RPN phase, three one-positive images 47, 29 and 8 -> 220,
    226 and 152, the batch loss 24.4 ... 24.5)."""
    import numpy as np
    import torch

    from tpudet_torch.models.lhrcnn import RCNN_SCOPES, RPN_SCOPES

    if model.is_rpn_step(model.global_step) != (phase == "rpn"):
        raise AssertionError(f"global_step {model.global_step} is not in the {phase} phase")
    torch.cuda.reset_peak_memory_stats()
    before = snapshot(model, RCNN_SCOPES if phase == "rpn" else RPN_SCOPES)
    start = model.global_step
    first = lhrcnn_image_losses(model, images, gt, phase)
    run = run_epoch(model, images, gt, warmup, LHRCNN_LR)
    last = lhrcnn_image_losses(model, images, gt, phase)
    counts, steps, losses = run["counts"], run["steps"], run["losses"]
    log(f"LHRCNN {phase} phase, bf16, global_step {start}..{model.global_step - 1}: "
        f"{warmup} warm-up steps + {steps} in train_one_epoch at lr {LHRCNN_LR}; kernel "
        f"launches in the epoch {counts}; losses {[round(x, 4) for x in losses]}")
    if (steps != LHRCNN_STEPS or counts["assign"] or counts["sorted_scan"] != 2 * steps
            or counts["nms_rows"] != 2 * steps + counts["per_pick"]):
        raise AssertionError(f"the LHRCNN {phase} step must launch the NMS kernel's sorted "
                             f"scan twice (and the per-pick kernel when a pool runs out) "
                             f"and no assignment: {counts}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    median = [float(first.median()), float(last.median())]
    run["image_loss_median"], run["images_fell"] = median, int((last < first).sum())
    log(f"LHRCNN {phase} phase: the median image's loss {median[0]:.4f} -> "
        f"{median[1]:.4f} ({run['images_fell']} of {len(first)} images fell; the "
        f"largest {float(first.max()):.4f} -> {float(last.max()):.4f}); the batch loss "
        f"of the last step {'below' if losses[-1] < losses[0] else 'not below'} the first")
    if not median[1] < median[0]:
        raise AssertionError(f"the median image's {phase} loss did not fall: {median}")
    if not unchanged(model, before):
        raise AssertionError(f"the {phase} phase moved the other phase's parameters or "
                             f"velocities")
    log(f"LHRCNN {phase} phase: the other phase's {len(before[0])} parameters and their "
        f"velocities bit for bit; {run['images_per_s']:.1f} images/s by the host clock, "
        f"{run['step_ms']:.3f} ms/step by CUDA events, epoch mean {run['mean']:.4f}")
    run["profile"] = profile_step(model, images, gt, LHRCNN_LR)
    run["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"LHRCNN {phase} phase peak device memory {run['peak_gib']:.2f} GiB")
    return run


def lhrcnn_losses_vs_plain(model, images, gt):
    """``rpn_loss_and_sample`` and ``rcnn_losses`` with the NMS kernel ==
    with its plain version, exactly, on one train-mode forward's outputs;
    the two sampling pools' ``nms_rows`` inputs."""
    import torch

    from tpudet_torch.heads import lhrcnn as lh
    from tpudet_torch.ops.cuda import nms_kernel

    outputs, g = train_heads(model, images, gt, lambda o: o)
    heads = model._split_rpn(outputs[0], outputs[1])
    h, w = model.data_shape_hw

    def sample():
        return lh.rpn_loss_and_sample(*heads, model.anchors, g)

    with torch.no_grad():
        with_kernel, calls = record_nms_calls(sample)
        box = with_kernel.pos_proposal
        centre = (box[..., :2] + box[..., 2:]) / 2.0
        real = nms_kernel.nms_rows
        nms_kernel.nms_rows = nms_kernel.plain_rows
        try:
            with_plain = sample()
        finally:
            nms_kernel.nms_rows = real
        torch.cuda.synchronize()
        for name, got, want in zip(with_kernel._fields, with_kernel, with_plain):
            if not torch.equal(got, want):
                raise AssertionError(f"rpn_loss_and_sample's {name} with the NMS kernel != "
                                     f"with the plain version")
        valid = with_kernel.pos_valid[..., None]
        bad = (~torch.isfinite(with_kernel.pos_truth) & valid).sum((0, 1)).tolist()
        log(f"rpn_loss_and_sample on one step's head outputs: kernel == plain version on "
            f"the card, every field ({int(with_kernel.pos_valid.sum())} positives and "
            f"{int(with_kernel.neg_valid.sum())} negatives sampled, mean rpn_loss "
            f"{float(with_kernel.rpn_loss.mean()):.6f}); max |phw| over the anchors "
            f"{float(heads[1].abs().max()):.4g}; non-finite RCNN box targets of the valid "
            f"positives (y, x, h, w): {bad}; their centre coordinates exactly 0 "
            f"(Q12 divides by the centre): "
            f"{int(((centre == 0) & valid).sum())}")
        loss_kernels_vs_plain("rcnn_losses", lambda: lh.rcnn_losses(
            model.net.roi_head, outputs[2], sample(), float(h), float(w),
            model.num_classes))
    pos, neg = [c for c in calls if c[5] is not None][:2]  # not the full-width reruns
    if (tuple(pos[0].shape) != (TRAIN_BATCH, LHRCNN_ANCHORS + 60, 4)
            or tuple(neg[0].shape) != (LHRCNN_ANCHORS, 4)
            or tuple(pos[5].shape) != (TRAIN_BATCH, 512)
            or tuple(neg[5].shape) != (TRAIN_BATCH, 512)):
        raise AssertionError(f"LHRCNN sampling pools: {tuple(pos[5].shape)} of "
                             f"{tuple(pos[0].shape)}, {tuple(neg[5].shape)} of "
                             f"{tuple(neg[0].shape)}")
    return pos, neg


def phase_lhrcnn_train(dev):
    """The training script's config (batch 32, bf16, lr 0.003, its phase
    schedule as it is) on one fixed batch: the RPN phase from global_step 0,
    then the RCNN phase from ``rpn_first_step`` (60000), each 2 warm-up
    steps and a ``train_one_epoch`` of 4; the losses with the kernel == with
    the plain version."""
    import torch

    images, gt = retina_batch(15, TRAIN_BATCH, LHRCNN_CONFIG["data_shape"][:2])
    log(f"LHRCNN train batch: images {images.shape}, gt {gt.shape} with "
        f"{int((gt[..., 0] >= 0).sum())} objects")
    model = lhrcnn_model(dev, feed((images, gt), LHRCNN_STEPS, TRAIN_BATCH))
    rpn = lhrcnn_phase_run(model, images, gt, "rpn")
    pos, neg = lhrcnn_losses_vs_plain(model, images, gt)
    model.global_step = model.rpn_first_step
    rcnn = lhrcnn_phase_run(model, images, gt, "rcnn")
    del model
    torch.cuda.empty_cache()
    return dict(rpn=rpn, rcnn=rcnn, pos_args=pos, neg_args=neg)


def phase_lhrcnn_kernels(serve, train):
    """The NMS kernel at LH-RCNN's shapes against its plain version, timed:
    the two sampling pools ([32, 512] of [32, 6878] per-row boxes, of [32,
    6818] shared anchors), the decode's two sorted scans ([1, 1000] of [1,
    6818]; [20, 500]) and the negative pool forced to run out, rerun at
    full width by the per-pick kernel ([32, 6818], 256 picks)."""
    out = {}
    for key, what, args in (
            ("positive_pool", "LHRCNN's positive pool (per-row boxes, cap 128)",
             train["pos_args"]),
            ("negative_pool", "LHRCNN's negative pool (cap 256)", train["neg_args"]),
            ("proposal_pool", "LHRCNN's proposal pool (500 picks)", serve["kernel_args"]),
            ("class_rows", "LHRCNN's class rows", serve["class_args"])):
        out[key] = nms_pool_timing(args)
        log_pool(what, out[key])
    neg_scores = train["neg_args"][1]
    out["run_out_full_width"] = pool_run_out("LHRCNN negatives", run_out_args(
        train["neg_args"], top=float(neg_scores[0].max()) + 3.0))
    return out


def lhrcnn_records(serve, train, kern, n_requests):
    """LH-RCNN's entries of the kernels' JSON record."""
    s_counts = serve["counts"]
    t_counts = {k: train["rpn"]["counts"][k] + train["rcnn"]["counts"][k]
                for k in s_counts}
    steps = train["rpn"]["steps"] + train["rcnn"]["steps"]
    pool_keys = ("ms", "device_ms", "per_pick_ms", "per_pick_device_ms", "pool_call_ms",
                 "plain_ms", "bound_ms", "bound_by", "picks", "shape", "full_shape")
    nms = {"launches": s_counts["nms_rows"] + t_counts["nms_rows"],
           "launches_per_request": s_counts["nms_rows"] / n_requests,
           "launches_per_step": t_counts["nms_rows"] / steps,
           "launches_by_path": {k: s_counts[k] + t_counts[k]
                                for k in ("sorted_scan", "per_pick")},
           "proposal_pool_reruns": serve["pool_reruns"],
           "score_threshold": serve["score_threshold"],
           **{key: {k: kern[key][k] for k in pool_keys} for key in (
               "positive_pool", "negative_pool", "proposal_pool", "class_rows")},
           "run_out_full_width": {k: kern["run_out_full_width"][k] for k in (
               "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "picks", "shape")}}
    assign = {"launches": s_counts["assign"] + t_counts["assign"],
              "launches_per_request": s_counts["assign"] / n_requests,
              "launches_per_step": t_counts["assign"] / steps}
    return nms, assign


# --------------------------------------------------------------- the feed
# drivers/testSSD300.py:33-44, copied: this script must not import that one,
# which imports tpudet
SSD300_AUGMENTOR = {
    "data_format": "channels_last",
    "output_shape": [300, 300],
    "crop_method": "random",
    "flip_prob": [0.0, 0.5],
    "fill_mode": "BILINEAR",
    "keep_aspect_ratios": False,
    "constant_values": 0.0,
    "color_jitter_prob": 0.5,
    "rotate": [0.5, -5.0, -5.0],
    "pad_truth_to": 60,
}
FEED_RECORDS = 64  # the mini set's 8 annotations, replicated under new names
FEED_SHARDS = 2
FEED_BATCHES = 3  # batches timed from the feed alone
FEED_STEPS = 3  # steps of train_one_epoch on the feed
FEED_WORKERS = 4  # the loader's decode/augment threads in the second feed timing
EVAL_SCORE_THRESHOLD = 0.01  # phase 3's


def voc_mini() -> Path:
    return Path(__file__).resolve().parent / "tests" / "torch_data" / "voc_mini"


def feed_records(tmp: Path):
    """``FEED_RECORDS`` records from the mini set through the port's
    ``voc.dataset2tfrecord`` into ``FEED_SHARDS`` shards, all read back with
    their checksums verified."""
    from tpudet_torch.data import tfrecord, voc

    xmls = sorted((voc_mini() / "Annotations").glob("*.xml"))
    if len(xmls) != 8:
        raise AssertionError(f"the mini VOC set must hold 8 annotations: {xmls}")
    xml_dir = tmp / "Annotations"
    xml_dir.mkdir()
    for i in range(FEED_RECORDS):
        (xml_dir / f"rep_{i:04d}.xml").write_bytes(xmls[i % len(xmls)].read_bytes())
    t = time.perf_counter()
    shards = voc.dataset2tfrecord(str(xml_dir), str(voc_mini() / "JPEGImages"),
                                  str(tmp / "records"), "voc", FEED_SHARDS)
    write_s = time.perf_counter() - t
    t = time.perf_counter()
    per_shard = [sum(1 for _ in tfrecord.read_records(path, verify=True))
                 for path in shards]
    read_s = time.perf_counter() - t
    if sum(per_shard) != FEED_RECORDS:
        raise AssertionError(f"read back {per_shard} records, wrote {FEED_RECORDS}")
    sizes = [Path(path).stat().st_size for path in shards]
    crcs = [f"{tfrecord.crc32c(Path(path).read_bytes()):08x}" for path in shards]
    native = bool(tfrecord._load_native())
    log(f"feed records: {FEED_RECORDS} written into {FEED_SHARDS} shards in "
        f"{write_s:.3f} s and read back with every checksum verified in "
        f"{read_s:.3f} s: records {per_shard}, bytes {sizes}, crc32c of each shard "
        f"{crcs} (crc32c from {'the C library' if native else 'the numpy table'})")
    return shards, dict(records=per_shard, bytes=sizes, shard_crc32c=crcs,
                        write_s=write_s, read_verify_s=read_s, native_crc32c=native)


def check_feed_batch(images, gt):
    """A batch of the training script's feed: [32, 300, 300, 3] images and [32, 60, 5]
    ground truth, padding rows all -1, at least one real box per image."""
    import numpy as np

    if images.shape != (TRAIN_BATCH, 300, 300, 3) or gt.shape != (TRAIN_BATCH, 60, 5):
        raise AssertionError(f"feed batch shapes {images.shape}, {gt.shape}")
    if images.dtype != np.float32 or gt.dtype != np.float32:
        raise AssertionError(f"feed batch dtypes {images.dtype}, {gt.dtype}")
    if not np.isfinite(images).all():
        raise AssertionError("non-finite pixels in the feed")
    real = gt[..., 0] >= 0
    if not (gt[~real] == -1).all():
        raise AssertionError("padding rows must be -1")
    if not real.any(-1).all():
        raise AssertionError("an image of the feed has no box")
    return int(real.sum())


def feed_alone(shards, num_workers):
    """``FEED_BATCHES`` batches of ``get_generator(shards, 32, 1024, cfg)``
    timed on the host clock from the loader's construction."""
    from tpudet_torch.data import pipeline

    t = time.perf_counter()
    _, it = pipeline.get_generator(shards, TRAIN_BATCH, 1024, SSD300_AUGMENTOR,
                                   num_workers=num_workers)
    try:
        boxes = [check_feed_batch(*next(it)) for _ in range(FEED_BATCHES)]
    finally:
        it.close()
    wall = time.perf_counter() - t
    rate = FEED_BATCHES * TRAIN_BATCH / wall
    log(f"the feed alone, {num_workers} worker threads: {FEED_BATCHES} batches of "
        f"[{TRAIN_BATCH}, 300, 300, 3] in {wall:.3f} s on the host clock, {rate:.1f} "
        f"images/s; real boxes per batch {boxes}")
    return dict(images_per_s=rate, wall_s=wall, boxes=boxes)


def feed_breakdown(shards, n=TRAIN_BATCH):
    """Host milliseconds an image of the feed takes in each stage, one thread:
    the record's read and JPEG decode, then the augmentor."""
    import numpy as np

    from tpudet_torch.data import tfrecord, voc
    from tpudet_torch.data.augment import image_augmentor

    raw = [r for _, r in zip(range(n), tfrecord.read_records(shards[0]))]
    t = time.perf_counter()
    parsed = [voc.parse_voc_record(r) for r in raw]
    decode_ms = (time.perf_counter() - t) * 1e3 / n
    rng = np.random.default_rng(0)
    t = time.perf_counter()
    for image, shape, gt in parsed:
        image_augmentor(image=image, input_shape=shape, ground_truth=gt, rng=rng,
                        **SSD300_AUGMENTOR)
    augment_ms = (time.perf_counter() - t) * 1e3 / n
    log(f"the feed per image, one thread: read and decode {decode_ms:.3f} ms, "
        f"augment {augment_ms:.3f} ms")
    return dict(decode_ms=decode_ms, augment_ms=augment_ms)


def feed_model(dev, shards):
    """SSD300 at drivers/testSSD300.py's config (bf16, batch 32, no
    pretrained weights) behind drivers/_common.py's provider around the
    port's loader."""
    from tpudet_torch.data import pipeline
    from tpudet_torch.models.ssd import SSD300

    config = {"mode": "train", "data_format": "channels_last", "num_classes": 20,
              "weight_decay": 1e-4, "keep_prob": 0.5, "batch_size": TRAIN_BATCH,
              "nms_score_threshold": 0.5, "nms_max_boxes": 20,
              "nms_iou_threshold": 0.5, "compute_dtype": "bfloat16"}
    provider = {
        "data_shape": [300, 300, 3],
        "num_train": TRAIN_BATCH,
        "num_val": 0,
        "train_generator": pipeline.get_generator(shards, TRAIN_BATCH, 1024,
                                                  SSD300_AUGMENTOR),
        "val_generator": None,
    }
    model = SSD300(config, provider)
    if model.device.type != dev.type:
        raise AssertionError("SSD300 must default to the card")
    return model


def profile_feed_step(model, lr):
    """Device busy share of one ``train_one_epoch`` step on the feed, from
    torch.profiler: the epoch restarts the loader, so the step waits for one
    whole batch of the feed, then runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    model.num_train = TRAIN_BATCH
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        model.train_one_epoch(lr)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    busy = sum(evt.time_range.elapsed_us() / 1e3 for evt in prof.events()
               if evt.device_type == torch.autograd.DeviceType.CUDA)
    if not busy:
        log("profiler: no device events recorded over the feed's step")
        return dict(wall_ms=wall_ms, busy_ms=None, busy_share=None)
    log(f"profiler over one step on the feed: wall {wall_ms:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}%)")
    return dict(wall_ms=wall_ms, busy_ms=busy, busy_share=busy / wall_ms)


def phase_feed_train(dev, shards, tmp: Path, lr=0.01):
    """One warm-up epoch of 1 step, then ``train_one_epoch`` over
    ``FEED_STEPS`` steps on the feed with the port's ``SummaryWriter``, the
    kernels' counts set to 0 just before it and read just after; then one
    profiled step. The event file must hold one event a step."""
    import math

    import torch

    from tpudet_torch.ops.cuda import assign_kernel, nms_kernel
    from tpudet_torch.runtime import summary

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = feed_model(dev, shards)
    log(f"SSD300 (train, bf16) on the feed built in {time.perf_counter() - t0:.2f} s")
    try:
        warm = model.train_one_epoch(lr)
        model.num_train = FEED_STEPS * TRAIN_BATCH
        writer = summary.SummaryWriter(str(tmp / "events"))
        torch.cuda.synchronize()
        assign_kernel.launches = 0
        reset_nms_counts()
        t = time.perf_counter()
        mean = model.train_one_epoch(lr, writer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = {"assign": assign_kernel.launches, "nms_rows": nms_kernel.launches,
                  **nms_kernel.launches_by_path}
        writer.close()
        profile = profile_feed_step(model, lr)
    finally:
        model.train_iterator.close()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    (events_file,) = (tmp / "events").iterdir()
    events = summary.read_events(str(events_file))
    losses = [e["value"] for e in events[1:]]
    log(f"bf16 on the feed: warm-up epoch of 1 step (loss {warm:.4f}), then "
        f"{FEED_STEPS} steps in train_one_epoch: kernel launches {counts}, losses "
        f"{[round(x, 4) for x in losses]} from the event file, epoch mean {mean:.4f}")
    if events[0].get("file_version") != "brain.Event:2" or len(events) != 1 + FEED_STEPS:
        raise AssertionError(f"the event file must hold the version event and one event "
                             f"a step: {events}")
    if [e["step"] for e in events[1:]] != list(range(2, 2 + FEED_STEPS)):
        raise AssertionError(f"event steps {[e['step'] for e in events]}")
    if not all(math.isfinite(x) for x in [warm, mean, *losses]):
        raise AssertionError(f"non-finite loss on the feed: {warm}, {losses}")
    if counts["assign"] != FEED_STEPS or counts["sorted_scan"] != FEED_STEPS:
        raise AssertionError(f"each step on the feed must launch the assignment kernel "
                             f"once and the mining pool once: {counts}")
    rate = FEED_STEPS * TRAIN_BATCH / wall
    log(f"bf16 train on the feed: {rate:.1f} images/s by the host clock over the epoch "
        f"(the loader restarts with it), peak device memory {peak:.2f} GiB; "
        f"{len(events)} events read back")
    return model, dict(images_per_s=rate, wall_s=wall, losses=losses, warmup_loss=warm,
                       counts=counts, profile=profile, peak_gib=peak, events=len(events))


def feed_eval_records():
    """The mini set's 8 records as the port's ``voc`` parses them: (image,
    gt corner rows)."""
    from tpudet_torch.data import example_proto, voc

    records = []
    for xml in sorted((voc_mini() / "Annotations").glob("*.xml")):
        feats = voc.xml_to_features(str(xml), str(voc_mini() / "JPEGImages"))
        image, _, gt = voc.parse_voc_record(example_proto.encode_example(feats))
        records.append((image, gt))
    return records


def phase_feed_eval(dev, trained, tmp: Path):
    """``save_weight``, ``load_weight`` into a test-mode SSD300, then
    ``evaluate_model`` on the mini set's records with the training script's preprocess
    config and phase 3's score threshold: one decode pool per image, a
    finite mAP in [0, 1]; one image's decode with the kernel == plain."""
    import math

    import torch

    from tpudet_torch.models.ssd import SSD300
    from tpudet_torch.ops.cuda import assign_kernel, nms_kernel
    from tpudet_torch.runtime import evaluate

    prefix = str(tmp / "ckpt" / "ssd300")
    trained.save_weight("latest", prefix)
    config = {"mode": "test", "data_format": "channels_last", "num_classes": 20,
              "batch_size": 1, "weight_decay": 1e-4, "nms_score_threshold":
              EVAL_SCORE_THRESHOLD, "nms_max_boxes": 20, "nms_iou_threshold": 0.5,
              "seed": 1}
    model = SSD300(config)
    model.load_weight(prefix)
    if model.global_step != trained.global_step or model.device.type != dev.type:
        raise AssertionError("load_weight must restore the trained step on the card")
    records = feed_eval_records()
    evaluate.evaluate_model(model, records[:1], preprocess_config=SSD300_AUGMENTOR)
    torch.cuda.synchronize()
    assign_kernel.launches = 0
    reset_nms_counts()
    t = time.perf_counter()
    mAP, aps = evaluate.evaluate_model(model, records, preprocess_config=SSD300_AUGMENTOR)
    torch.cuda.synchronize()
    s_per_image = (time.perf_counter() - t) / len(records)
    counts = {"nms_rows": nms_kernel.launches, **nms_kernel.launches_by_path,
              "assign": assign_kernel.launches}
    log(f"evaluate_model on {len(records)} mini-set records: VOC07 mAP {mAP:.6f} over "
        f"{len(aps)} classes, {s_per_image:.4f} s/image on the host clock; kernel "
        f"launches {counts}")
    if not (math.isfinite(mAP) and 0.0 <= mAP <= 1.0):
        raise AssertionError(f"mAP {mAP} must be finite and in [0, 1]")
    if counts["sorted_scan"] != len(records) or counts["assign"]:
        raise AssertionError(f"evaluation must launch one decode pool per image and no "
                             f"assignment: {counts}")
    image, _ = records[0]
    inp, _ = evaluate.eval_preprocess(image, 300, 300)
    x = torch.from_numpy(inp.transpose(2, 0, 1)[None].copy()).to(dev)
    with torch.inference_mode():
        outputs = model.net(model._preprocess(x))
        with_kernel, captured = decode_kernel_vs_plain(model, outputs)
    log(f"evaluation's decode of one image: kernel == plain on the card "
        f"({int(with_kernel[3].sum())} detections, the pool "
        f"{'ran out' if 'rerun' in captured else 'held'})")
    pool = nms_pool_timing(captured["args"])
    log_pool("the evaluation's decode pool", pool)
    full = None
    if "rerun" in captured:
        full = nms_full_timing(captured["rerun"])
        log(f"the evaluation's full-width rerun {full['shape']} ({full['picks']} picks), "
            f"per-pick: {[round(x, 4) for x in full['turns_ms']]} ms (device time "
            f"{fmt_ms(full['device_ms'], 4)} ms), plain {full['plain_ms']:.4f} ms, bound "
            f"{full['bound_ms']:.6f} ms ({full['bound_by']})")
    return dict(mAP=mAP, classes=len(aps), s_per_image=s_per_image, counts=counts,
                images=len(records), decode_pool=pool, full_width=full)


def phase_feed(dev, phase4):
    """16. the feed: records, the feed alone, training on it, evaluation."""
    import tempfile

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        tmp = Path(tmp)
        shards, records = feed_records(tmp)
        alone = feed_alone(shards, 0)
        threads = feed_alone(shards, FEED_WORKERS)
        per_image = feed_breakdown(shards)
        model, train = phase_feed_train(dev, shards, tmp)
        evaluation = phase_feed_eval(dev, model, tmp)
        del model
    import torch

    torch.cuda.empty_cache()
    p4 = phase4["bf16"]
    p4_share = (p4["profile"]["busy_ms"] / p4["profile"]["wall_ms"]
                if p4["profile"].get("busy_ms") else None)
    log(f"the feed's cost, bf16 SSD300 at batch {TRAIN_BATCH}: "
        f"{train['images_per_s']:.1f} images/s on the feed vs "
        f"{p4['images_per_s']:.1f} on phase 4's fixed arrays; device busy over a "
        f"profiled step {fmt_share(train['profile']['busy_share'])} vs "
        f"{fmt_share(p4_share)}; peak {train['peak_gib']:.2f} GiB vs "
        f"{p4['peak_gib']:.2f} GiB; phase 16 took {time.perf_counter() - t0:.1f} s")
    return dict(records=records, feed_alone=alone, feed_threads=threads,
                per_image=per_image, train=train, eval=evaluation,
                phase4={"images_per_s": p4["images_per_s"], "busy_share": p4_share,
                        "peak_gib": p4["peak_gib"]})


# ------------------------------------------------------ the resident feed
RESIDENT_IMAGES = 5000  # tpudet's convergence dataset (tpudet/data/device_dataset.py:6-9)
RESIDENT_PAD = 60
RESIDENT_AUGMENT = {"flip_prob": [0.5, 0.5], "color_jitter_prob": 0.5}
RESIDENT_WARMUP = 2  # scanned steps before the measured epochs
RESIDENT_STEPS = 10  # steps of each measured epoch (scanned, then per step)
CHUNK_ROWS = 1000  # chunked residency: chunks of 1000 images,
CHUNK_BUDGET_ROWS = 4000  # 4000 resident of the 5000,
CHUNK_ROTATE = 2  # a refresh from the other 1000 every 2nd pin,
CHUNK_EPOCHS = 4  # 4 scanned epochs of RESIDENT_STEPS steps
AUGMENT_ATOL = 2e-3  # the colour's tolerance in tests/test_torch_device_feed.py


def resident_arrays():
    """The mini VOC set's 8 JPEGs decoded by ``voc.decode_jpeg`` (through
    ``parse_voc_record``), resized once to 300x300 by ``image_augmentor``
    with every random op off, rounded to uint8, boxes padded to 60 rows;
    replicated to ``RESIDENT_IMAGES``, each replica's row id written into
    its top-left pixel (red: the low byte, green: the high byte) so a chunk
    on the card can be read back as the rows it holds."""
    import numpy as np

    from tpudet_torch.data import example_proto, voc
    from tpudet_torch.data.augment import image_augmentor

    base_images, base_gt = [], []
    for xml in sorted((voc_mini() / "Annotations").glob("*.xml")):
        feats = voc.xml_to_features(str(xml), str(voc_mini() / "JPEGImages"))
        image, shape, gt = voc.parse_voc_record(example_proto.encode_example(feats))
        image, gt = image_augmentor(image=image, input_shape=shape,
                                    data_format="channels_last", output_shape=[300, 300],
                                    ground_truth=gt, pad_truth_to=RESIDENT_PAD)
        base_images.append(np.clip(np.round(image), 0, 255).astype(np.uint8))
        base_gt.append(gt)
    reps = np.arange(RESIDENT_IMAGES) % len(base_images)
    images, gt = np.stack(base_images)[reps], np.stack(base_gt)[reps]
    rows = np.arange(RESIDENT_IMAGES)
    images[:, 0, 0, 0], images[:, 0, 0, 1] = rows & 255, rows >> 8
    return images, gt


def stamped_rows(chunk):
    """The row ids written into the top-left pixels of ``chunk``'s images."""
    px = chunk[:, 0, 0, :2].long().cpu().numpy()
    return px[:, 0] + 256 * px[:, 1]


def resident_model(dev, ds):
    """SSD300 at drivers/testSSD300.py's config (bf16, batch 32, lr 0.01, no
    pretrained weights) with ``device_augment``, fed by ``ds``."""
    from tpudet_torch.models.ssd import SSD300

    config = {"mode": "train", "data_format": "channels_last", "num_classes": 20,
              "weight_decay": 1e-4, "keep_prob": 0.5, "batch_size": TRAIN_BATCH,
              "nms_score_threshold": 0.5, "nms_max_boxes": 20,
              "nms_iou_threshold": 0.5, "compute_dtype": "bfloat16",
              "device_augment": RESIDENT_AUGMENT}
    model = SSD300(config, {"data_shape": [300, 300, 3], "num_train": TRAIN_BATCH,
                            "num_val": 0, "train_generator": ds, "val_generator": None})
    if model.device.type != dev.type:
        raise AssertionError("SSD300 must default to the card")
    return model


def resident_epoch(model, what, lr=0.01):
    """One ``train_one_epoch`` of ``RESIDENT_STEPS`` steps with the kernels'
    counts set to 0 just before it and read just after: finite losses, one
    assignment and one mining pool a step."""
    import math

    import torch

    from tpudet_torch.ops.cuda import assign_kernel, nms_kernel

    model.num_train = RESIDENT_STEPS * TRAIN_BATCH
    writer = StepLog()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    assign_kernel.launches = 0
    reset_nms_counts()
    t = time.perf_counter()
    start.record()
    mean = model.train_one_epoch(lr, writer)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = {"assign": assign_kernel.launches, "nms_rows": nms_kernel.launches,
              **nms_kernel.launches_by_path}
    losses = [float(x) for x in writer.losses]
    rate = RESIDENT_STEPS * TRAIN_BATCH / wall
    log(f"bf16 on the resident set, {what}: {RESIDENT_STEPS} steps, kernel launches "
        f"{counts}, losses {[round(x, 4) for x in losses]}, {rate:.1f} images/s by the "
        f"host clock, {start.elapsed_time(end) / RESIDENT_STEPS:.3f} ms/step by CUDA events")
    if len(losses) != RESIDENT_STEPS or not all(math.isfinite(x) for x in [mean, *losses]):
        raise AssertionError(f"the {what} epoch's losses: {losses}")
    if counts["assign"] != RESIDENT_STEPS or counts["sorted_scan"] != RESIDENT_STEPS:
        raise AssertionError(f"each {what} step must launch the assignment kernel once and "
                             f"the mining pool once: {counts}")
    return dict(images_per_s=rate, wall_s=wall, losses=losses, counts=counts,
                step_ms=start.elapsed_time(end) / RESIDENT_STEPS)


def augment_card_vs_cpu(model, x, g, step):
    """``apply_draws`` of one step's draws on the card == on the CPU: the
    flips (and the gt) exactly, the colour within ``AUGMENT_ATOL``."""
    import torch

    from tpudet_torch.data import device_augment, prng

    d = device_augment.draws(prng.fold_in(model._augment_key, step), x.shape[0],
                             RESIDENT_AUGMENT)
    out = {}
    for name, cfg in (("flips", {"flip_prob": RESIDENT_AUGMENT["flip_prob"]}),
                      ("both", RESIDENT_AUGMENT)):
        card = device_augment.apply_draws(x, g, device_augment.to_device(d, x.device), cfg)
        cpu = device_augment.apply_draws(x.cpu(), g.cpu(),
                                         device_augment.to_device(d, "cpu"), cfg)
        err = float(torch.max(torch.abs(card[0].cpu() - cpu[0])))
        if not torch.equal(card[1].cpu(), cpu[1]):
            raise AssertionError(f"the augment's gt on the card != on the CPU ({name})")
        if (name == "flips" and err) or err > AUGMENT_ATOL:
            raise AssertionError(f"the augment's images on the card differ from the CPU's "
                                 f"by {err} ({name})")
        out[name] = err
    log(f"device augment on the card == on the CPU with the same draws (flipped "
        f"{int(d['td'].sum())} top-down and {int(d['lr'].sum())} left-right of "
        f"{x.shape[0]}): flips and gt exactly, colour max |diff| {out['both']:.3g} "
        f"(tolerance {AUGMENT_ATOL})")
    return dict(flip_err=out["flips"], colour_max_abs_err=out["both"])


def chunk_stream(n, seed):
    """A CPU dataset with the chunked run's rows and budgets, one byte an
    image: the index stream, pins and rotations the card's run must show."""
    import numpy as np

    from tpudet_torch.data.device_dataset import DeviceDataset

    return DeviceDataset(np.zeros((n, 1, 1, 1), np.uint8),
                         np.zeros((n, 1, 5), np.float32), TRAIN_BATCH, seed=seed,
                         max_bytes=CHUNK_BUDGET_ROWS, chunk_bytes=CHUNK_ROWS,
                         rotate_every=CHUNK_ROTATE, device="cpu")


def phase_resident_chunked(model, images, gt, lr=0.01):
    """``CHUNK_EPOCHS`` scanned epochs on chunked residency: the pins,
    rotations and index streams equal a CPU dataset's on the same calls,
    each pinned chunk holds its slot's rows, and at the end every chunk on
    the card holds its slot's rows, rows of the initial pool among them;
    finite losses; each pin, upload and join of a refresh logged."""
    import math

    import numpy as np

    from tpudet_torch.data.device_dataset import DeviceDataset

    per = int(np.prod(images.shape[1:]))
    t = time.perf_counter()
    ds = DeviceDataset(images, gt, TRAIN_BATCH, seed=1, max_bytes=CHUNK_BUDGET_ROWS * per,
                       chunk_bytes=CHUNK_ROWS * per, rotate_every=CHUNK_ROTATE)
    shadow = chunk_stream(images.shape[0], 1)
    resident = set(np.concatenate(ds._slot_rows).tolist())
    model.train_iterator, model.train_initializer = ds, ds.reset
    model.num_train = RESIDENT_STEPS * TRAIN_BATCH
    drawn = []
    scan_indices = ds.scan_indices
    ds.scan_indices = lambda k: drawn.append(scan_indices(k)) or drawn[-1]
    writer = StepLog()
    pool_rows = set()
    try:
        for epoch in range(CHUNK_EPOCHS):
            model.train_one_epoch(lr, writer)
            shadow.reset()
            want = shadow.scan_indices(RESIDENT_STEPS).numpy()
            if len(drawn) != epoch + 1 or not np.array_equal(drawn[-1].cpu().numpy(), want):
                raise AssertionError(f"epoch {epoch}'s indices differ from the stream's")
            if not np.array_equal(stamped_rows(ds.images), ds.slot_rows):
                raise AssertionError("the pinned chunk on the card does not hold its rows")
    finally:
        ds.close()
    wall = time.perf_counter() - t
    for slot, (chunk, _) in enumerate(ds._dev_chunks):  # refreshes settled by close
        rows = stamped_rows(chunk)
        if not np.array_equal(rows, ds._slot_rows[slot]):
            raise AssertionError(f"chunk {slot} on the card does not hold its rows")
        pool_rows.update(set(rows.tolist()) - resident)
    shadow.close()
    got = [(r["pin"], r["slot"], r["refresh"]) for r in ds.pin_log]
    if got != [(r["pin"], r["slot"], r["refresh"]) for r in shadow.pin_log]:
        raise AssertionError(f"the card's pins {got} != the stream's "
                             f"{[(r['pin'], r['slot'], r['refresh']) for r in shadow.pin_log]}")
    if ds._pool != shadow._pool or any(not np.array_equal(a, b) for a, b in
                                      zip(ds._slot_rows, shadow._slot_rows)):
        raise AssertionError("the chunked rows on the card differ from the stream's")
    losses = [float(x) for x in writer.losses]
    if len(losses) != CHUNK_EPOCHS * RESIDENT_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"chunked residency's losses: {losses}")
    rotations = sum(r["refresh"] is not None for r in ds.pin_log)
    if not rotations or not pool_rows:
        raise AssertionError(f"no rotation brought pool rows to the card: {ds.pin_log}")
    for r in ds.pin_log:
        log(f"  pin {r['pin']}: slot {r['slot']}, rotation {r['refresh']}")
    for u in ds.uploads:
        log(f"  upload of slot {u['slot']}: {u['seconds']:.3f} s "
            f"({'background: pinned memory, its own stream' if u['background'] else 'in line'})")
    for j in ds.joins:
        log(f"  background refresh of slot {j['slot']} joined at a {j['at']}: "
            f"{'finished before' if j['finished'] else 'still running'}, waited "
            f"{j['wait_s']:.4f} s")
    log(f"chunked residency: {ds.k_chunks} x {ds.chunk_rows} rows resident of "
        f"{images.shape[0]}, {CHUNK_EPOCHS} scanned epochs of {RESIDENT_STEPS} steps in "
        f"{wall:.2f} s; pins and rotations equal the CPU stream's; {rotations} rotations "
        f"brought {len(pool_rows)} pool rows to the card; losses finite")
    return dict(pins=ds.pin_log, joins=ds.joins, uploads=ds.uploads, rotations=rotations,
                pool_rows_on_card=len(pool_rows), losses=losses, wall_s=wall)


def phase_resident(dev, phase4, phase16):
    """17. SSD300 trains from a dataset resident on the card, with tpudet's
    device augmentation, on the scanned and the per-step epoch; the augment
    on the card against the CPU; chunked residency with rotation."""
    import numpy as np
    import torch

    from tpudet_torch.data.device_dataset import DeviceDataset

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    images, gt = resident_arrays()
    log(f"resident set: {images.shape[0]} images {images.shape[1:]} uint8 "
        f"({images.nbytes / 1e9:.3f} GB), gt {gt.shape}, made in "
        f"{time.perf_counter() - t0:.2f} s on the host")
    ds = DeviceDataset(images, gt, TRAIN_BATCH, seed=0)
    if ds.device.type != dev.type:
        raise AssertionError("a DeviceDataset must default to the card")
    t = time.perf_counter()
    resident = ds.images
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t
    if not np.array_equal(stamped_rows(resident[::997]), np.arange(0, images.shape[0], 997)):
        raise AssertionError("the resident set on the card does not hold its rows in order")
    log(f"uploaded once in {upload_s:.3f} s ({images.nbytes / upload_s / 1e9:.2f} GB/s, "
        f"pageable host memory)")
    model = resident_model(dev, ds)
    model.num_train = RESIDENT_WARMUP * TRAIN_BATCH
    model.train_one_epoch(0.01)
    runs = {"scan": [], "per_step": []}
    for path in ("scan", "per_step", "per_step", "scan"):  # in turns
        model.config["no_scan_epoch"] = path == "per_step"
        runs[path].append(resident_epoch(model, path.replace("_", "-") + " epoch"))
    profile = profile_feed_step(model, 0.01)
    model.config["no_scan_epoch"] = False
    scan, per_step = ({"images_per_s": statistics.mean(r["images_per_s"] for r in rs),
                       "step_ms": statistics.mean(r["step_ms"] for r in rs),
                       "counts": {k: sum(r["counts"][k] for r in rs) for k in rs[0]["counts"]},
                       "epochs": rs} for rs in (runs["scan"], runs["per_step"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    idx = torch.from_numpy((np.arange(TRAIN_BATCH) * 97 % images.shape[0])
                           .astype(np.int32)).to(dev)
    batch = ds.gather(idx)
    x, g = model._to_device(*batch)
    gather_ms = device_ms(lambda: ds.gather(idx))
    nchw_ms = device_ms(lambda: model._to_device(*batch))
    augment_ms = device_ms(lambda: model._device_augment(x, g, 3))
    augment = augment_card_vs_cpu(model, x, g, 3)
    log(f"per step on the card: gather {fmt_ms(gather_ms)} ms (index_select of "
        f"[{TRAIN_BATCH}, 300, 300, 3] uint8 and the gt), to float32 NCHW "
        f"{fmt_ms(nchw_ms)} ms, device augment {fmt_ms(augment_ms)} ms (profiler device "
        f"time)")
    del batch, x, g, resident
    model.train_iterator = model.train_initializer = None
    del ds
    torch.cuda.empty_cache()
    chunked = phase_resident_chunked(model, images, gt)
    del model
    torch.cuda.empty_cache()

    p4, p16 = phase4["bf16"], phase16["train"]
    p4_share = (p4["profile"]["busy_ms"] / p4["profile"]["wall_ms"]
                if p4["profile"].get("busy_ms") else None)
    log(f"bf16 SSD300 at batch {TRAIN_BATCH}: {scan['images_per_s']:.1f} images/s on the "
        f"resident set's scanned epochs and {per_step['images_per_s']:.1f} on its per-step "
        f"epochs (means of two in turns), vs "
        f"{p4['images_per_s']:.1f} on phase 4's fixed arrays and "
        f"{p16['images_per_s']:.1f} on phase 16's host feed; device busy over a profiled "
        f"step {fmt_share(profile['busy_share'])} vs {fmt_share(p4_share)} and "
        f"{fmt_share(p16['profile']['busy_share'])}; peak {peak:.2f} GiB vs "
        f"{p4['peak_gib']:.2f} and {p16['peak_gib']:.2f} GiB; phase 17 took "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(upload_s=upload_s, gigabytes=images.nbytes / 1e9, scan=scan,
                per_step=per_step, profile=profile, peak_gib=peak, gather_ms=gather_ms,
                to_nchw_ms=nchw_ms, augment_ms=augment_ms, augment_vs_cpu=augment,
                chunked=chunked,
                phase4={"images_per_s": p4["images_per_s"], "busy_share": p4_share,
                        "peak_gib": p4["peak_gib"]},
                phase16={"images_per_s": p16["images_per_s"],
                         "busy_share": p16["profile"]["busy_share"],
                         "peak_gib": p16["peak_gib"]})


def fmt_share(share) -> str:
    return "not measured" if share is None else f"{100 * share:.1f}%"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    if not (repo / "tpudet_torch").is_dir():
        print(f"chip_smoke: no tpudet_torch package beside {__file__}", file=sys.stderr)
        return 1
    sys.path[:0] = [str(repo), str(repo / "tests")]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("TF32 off for float32 convolutions and matmuls")
    dev = torch.device("cuda")

    # 1. card and build: one nvcc per source, all started together
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    from tpudet_torch.ops.cuda import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(build.build, ("nms", "assign")))
    log(f"built {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.2f} s "
        f"({' '.join(build.NVCC_FLAGS)})")

    # 2. kernels against their plain versions
    from tpudet_torch.heads import ssd as ssd_head
    from tpudet_torch.models.ssd import SSD300, _ssd_feat_shapes

    anc = ssd_head.build_anchors(300, _ssd_feat_shapes(300, SSD300.extra_strides))
    anchor_corners = torch.cat([anc.y1x1, anc.y2x2], -1).numpy()
    timings = phase_kernels(dev, anchor_corners)
    timings["assign_ssd300"] = phase_assign(dev, (anc.y1x1, anc.y2x2))

    # 3. serve
    n_requests = 10
    serve = phase_serve(dev, n_requests)
    serve_nms = nms_pool_timing(serve["kernel_args"])
    log_pool("the serving path's decode pool", serve_nms)

    # 4. train
    train = phase_train(dev)
    n_steps = train["bf16"]["steps"]
    counts = train["bf16"]["counts"]
    mining = train["mining"]
    mine_pool = nms_pool_timing(mining["pool"])
    log_pool("the train step's mining pool (cap 384, IoU 0.7)", mine_pool)
    mine_full = nms_full_timing(mining["full"])
    log(f"NMS per-pick design on the same mining scores at full width "
        f"{mine_full['shape']} ({mine_full['picks']} picks): "
        f"{[round(x, 4) for x in mine_full['turns_ms']]} ms (device time "
        f"{fmt_ms(mine_full['device_ms'], 4)} ms), plain "
        f"{mine_full['plain_ms']:.4f} ms, bound {mine_full['bound_ms']:.6f} ms "
        f"({mine_full['bound_by']})")
    assign = assign_timing(mining["assign"])
    log(f"assign on the train step's input: kernel {assign['ms']:.4f} ms (device time "
        f"{fmt_ms(assign['device_ms'], 4)} ms), plain "
        f"{assign['plain_ms']:.4f} ms, bound {assign['bound_ms']:.6f} ms "
        f"({assign['bound_by']})")

    # 5-8. RetinaNet: serve, train, pretrain, both kernels at its shapes
    r_serve = phase_retina_serve(dev, n_requests)
    r_train = phase_retina_train(dev)
    r_pre = phase_retina_pretrain(dev)
    r_kern = phase_retina_kernels(dev, r_serve["kernel_args"], r_train["assign_args"])
    r_run, r_counts = r_train["run"], r_train["run"]["counts"]
    r_steps = r_run["steps"]

    # 9. RefineDet320 and PFPNet-R: serve, train, both kernels at their shapes
    refine = {}
    for name, (_, _, key) in REFINE_FAMILIES.items():
        f_serve = phase_refine_serve(dev, name, n_requests)
        f_train = phase_refine_train(dev, name)
        f_kern = phase_family_kernels(name, f_serve["kernel_args"], f_train["captured"])
        refine[key] = dict(serve=f_serve, train=f_train, kernels=f_kern,
                           records=family_records(f_serve, f_train, f_kern, n_requests))
    # 10. SSD512: serve, train, both kernels at its shapes
    ssd512 = phase_ssd512(dev, n_requests)

    # 11-12. YOLOv2 and YOLOv3: serve, train, the NMS kernel on the decode pool
    yolo = {}
    for name, (_, _, _, _, key) in YOLO_RUNS.items():
        y_serve = phase_yolo_serve(dev, name, n_requests)
        y_run = phase_yolo_train(dev, name)
        y_pool = nms_pool_timing(y_serve["kernel_args"])
        log_pool(f"{name}'s decode pool", y_pool)
        yolo[key] = dict(serve=y_serve, run=y_run, pool=y_pool,
                         records=yolo_records(y_serve, y_run, y_pool, n_requests))
    # 13. FCOS: serve, train, the NMS kernel on the decode pool and at full width
    fcos_serve = phase_fcos_serve(dev, n_requests)
    fcos_run = phase_fcos_train(dev)
    fcos_pool = nms_pool_timing(fcos_serve["kernel_args"])
    log_pool("FCOS's decode pool", fcos_pool)
    fcos_full = pool_run_out("FCOS", run_out_args(fcos_serve["kernel_args"]))
    fcos_nms = yolo_records(fcos_serve, fcos_run, fcos_pool, n_requests)[0]
    fcos_nms["run_out_full_width"] = {k: fcos_full[k] for k in (
        "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "picks", "shape")}
    fcos_assign = no_kernel_records(fcos_serve, fcos_run, n_requests)

    # 14. CenterNet: serve, train, Adam on the card, out-of-range labels
    cn_serve = phase_centernet_serve(dev, n_requests)
    cn_run = phase_centernet_train(dev)
    cn_records = no_kernel_records(cn_serve, cn_run, n_requests)
    # 15. LH-RCNN: serve, both training phases, the NMS kernel at its shapes
    lh_serve = phase_lhrcnn_serve(dev, n_requests)
    lh_train = phase_lhrcnn_train(dev)
    lh_kern = phase_lhrcnn_kernels(lh_serve, lh_train)
    lh_nms, lh_assign = lhrcnn_records(lh_serve, lh_train, lh_kern, n_requests)
    # 16. the feed: VOC records, the loader, training on it, VOC07 evaluation
    feed = phase_feed(dev, train)
    f_train, f_eval = feed["train"], feed["eval"]
    log(json.dumps({"feed": feed}))
    # 17. the resident feed: SSD300 from a dataset on the card, augmented there
    resident = phase_resident(dev, train, feed)
    log(json.dumps({"resident": resident}))
    res_counts = [resident[k]["counts"] for k in ("scan", "per_step")]
    res_steps = 2 * RESIDENT_STEPS  # each path's steps: two epochs
    log(json.dumps({"lhrcnn": {
        "serve_p50_ms": lh_serve["p50"], "serve_ms": lh_serve["latencies"],
        "serve_counts": lh_serve["counts"], "network_ms": lh_serve["network_ms"],
        "decode_ms": lh_serve["decode_ms"], "network_vs_cpu": lh_serve["network_vs_cpu"],
        **{k: lh_serve[k] for k in ("score_threshold", "candidates", "calibrated",
                                     "head_peak", "head_peak_after", "pool_reruns")},
        **{f"train_bf16_{phase}": {k: lh_train[phase][k] for k in (
            "images_per_s", "step_ms", "losses", "counts", "peak_gib", "profile")}
           for phase in ("rpn", "rcnn")},
        "kernels": lh_kern}}))
    for key, serve_f, run_f in (("fcos", fcos_serve, fcos_run),
                                ("centernet", cn_serve, cn_run)):
        log(json.dumps({key: {
            "serve_p50_ms": serve_f["p50"], "serve_ms": serve_f["latencies"],
            "serve_counts": serve_f["counts"], "network_ms": serve_f["network_ms"],
            "decode_ms": serve_f["decode_ms"], "network_vs_cpu": serve_f["network_vs_cpu"],
            **{k: serve_f[k] for k in ("score_threshold", "candidates", "calibrated",
                                       "head_peak", "head_peak_after") if k in serve_f},
            "train_bf16": {k: run_f[k] for k in (
                "images_per_s", "step_ms", "losses", "counts", "peak_gib", "profile",
                "adam", "bad_labels") if k in run_f},
            **({"decode_pool": fcos_pool, "run_out_full_width": fcos_full}
               if key == "fcos" else {})}}))

    log(json.dumps({key: {
        "serve_p50_ms": f["serve"]["p50"], "serve_ms": f["serve"]["latencies"],
        "serve_counts": f["serve"]["counts"], "network_ms": f["serve"]["network_ms"],
        "decode_ms": f["serve"]["decode_ms"],
        "network_vs_cpu": f["serve"]["network_vs_cpu"],
        **{k: f["serve"][k] for k in ("score_threshold", "calibrated", "head_peak",
                                      "head_peak_after", "candidates")},
        "train_bf16": {k: f["run"][k] for k in (
            "images_per_s", "step_ms", "losses", "counts", "peak_gib", "profile")},
        "decode_pool": f["pool"]} for key, f in yolo.items()}))
    log(json.dumps({"ssd512": {
        "serve_p50_ms": ssd512["serve"]["p50"], "serve_ms": ssd512["serve"]["latencies"],
        "serve_counts": ssd512["serve"]["counts"],
        "network_ms": ssd512["serve"]["network_ms"],
        "decode_ms": ssd512["serve"]["decode_ms"],
        "network_vs_cpu": ssd512["serve"]["network_vs_cpu"],
        "train_bf16": {k: ssd512["train"]["run"][k] for k in (
            "images_per_s", "step_ms", "losses", "counts", "peak_gib", "profile")},
        "kernels": ssd512["kernels"]}}))

    log(json.dumps({key: {
        "serve_p50_ms": f["serve"]["p50"], "serve_ms": f["serve"]["latencies"],
        "serve_counts": f["serve"]["counts"], "network_ms": f["serve"]["network_ms"],
        "decode_ms": f["serve"]["decode_ms"],
        "network_vs_cpu": f["serve"]["network_vs_cpu"],
        "train_bf16": {k: f["train"]["run"][k] for k in (
            "images_per_s", "step_ms", "losses", "counts", "peak_gib", "profile")},
        "kernels": f["kernels"]} for key, f in refine.items()}))

    log(json.dumps({"retinanet": {
        "serve_p50_ms": r_serve["p50"], "serve_ms": r_serve["latencies"],
        "serve_counts": r_serve["counts"], "network_ms": r_serve["network_ms"],
        "decode_ms": r_serve["decode_ms"], "network_vs_cpu": r_serve["network_vs_cpu"],
        "train_bf16": {k: r_run[k] for k in ("images_per_s", "step_ms", "losses",
                                             "counts", "peak_gib", "profile")},
        "pretrain_losses": r_pre["losses"], "kernels": r_kern}}))
    log(json.dumps({"shapes": timings, "serve_p50_ms": serve["p50"],
                    "serve_ms": serve["latencies"],
                    "train_bf16": {k: train["bf16"][k] for k in
                                   ("images_per_s", "step_ms", "losses", "counts")},
                    "train_fp32": {k: train["fp32"][k] for k in
                                   ("images_per_s", "step_ms", "losses", "counts")},
                    "serve_pool": serve_nms, "mining_pool": mine_pool,
                    "mining_full_width": mine_full}))
    records = [
        {"name": "nms_rows", "route": "cuda", "source": "tpudet_torch/ops/cuda/csrc/nms.cu",
         "replaces": "tpudet/ops/pallas/nms_kernel.py:86",
         "launches": (serve["counts"]["nms_rows"] + counts["nms_rows"]
                      + r_serve["counts"]["nms_rows"] + r_counts["nms_rows"]
                      + sum(f["records"][0]["launches"] for f in refine.values())
                      + ssd512["records"][0]["launches"]
                      + sum(f["records"][0]["launches"] for f in yolo.values())
                      + fcos_nms["launches"] + lh_nms["launches"]
                      + f_train["counts"]["nms_rows"] + f_eval["counts"]["nms_rows"]
                      + sum(c["nms_rows"] for c in res_counts)),
         "launches_per_request": serve["counts"]["nms_rows"] / n_requests,
         "launches_per_step": counts["nms_rows"] / n_steps,
         "max_abs_err": 0.0,  # indices and flags, equal exactly
         # the main path's design, the sorted bitmask scan, on the decode pool
         "ms": serve_nms["ms"], "plain_ms": serve_nms["plain_ms"],
         "bound_ms": serve_nms["bound_ms"], "bound_by": serve_nms["bound_by"],
         "library_ms": None,
         "paths": {
             "sorted_scan": {
                 "launches": serve["counts"]["sorted_scan"] + counts["sorted_scan"],
                 "ms": serve_nms["ms"], "device_ms": serve_nms["device_ms"],
                 "plain_ms": serve_nms["plain_ms"],
                 "bound_ms": serve_nms["bound_ms"], "bound_by": serve_nms["bound_by"],
                 "library_ms": None, "mining_ms": mine_pool["ms"],
                 "mining_device_ms": mine_pool["device_ms"],
                 "mining_plain_ms": mine_pool["plain_ms"],
                 "mining_bound_ms": mine_pool["bound_ms"],
                 "mining_bound_by": mine_pool["bound_by"]},
             "per_pick": {
                 "launches": serve["counts"]["per_pick"] + counts["per_pick"],
                 "ms": serve_nms["per_pick_ms"],
                 "device_ms": serve_nms["per_pick_device_ms"],
                 "plain_ms": serve_nms["plain_ms"],
                 "bound_ms": serve_nms["bound_ms"], "bound_by": serve_nms["bound_by"],
                 "library_ms": None, "mining_ms": mine_pool["per_pick_ms"],
                 "mining_device_ms": mine_pool["per_pick_device_ms"],
                 "full_width_ms": mine_full["ms"],
                 "full_width_device_ms": mine_full["device_ms"],
                 "full_width_plain_ms": mine_full["plain_ms"],
                 "full_width_bound_ms": mine_full["bound_ms"],
                 "full_width_bound_by": mine_full["bound_by"]}},
         "retinanet": {
             "launches": r_serve["counts"]["nms_rows"] + r_counts["nms_rows"],
             "launches_per_request": r_serve["counts"]["nms_rows"] / n_requests,
             "launches_per_step": r_counts["nms_rows"] / r_steps,
             "launches_by_path": {k: r_serve["counts"][k]
                                  for k in ("sorted_scan", "per_pick")},
             "decode_pool": {k: r_kern["decode_pool"][k] for k in (
                 "ms", "device_ms", "per_pick_ms", "per_pick_device_ms", "pool_call_ms",
                 "plain_ms", "bound_ms", "bound_by", "picks", "shape", "full_shape")},
             "run_out_full_width": {k: r_kern["full_width"][k] for k in (
                 "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "picks",
                 "shape")}},
         # tpudet's per-image kernel's case: per-row boxes [5, 300, 4]
         "per_row_boxes": timings["per_row_boxes"],
         **{key: f["records"][0] for key, f in refine.items()},
         "ssd512": ssd512["records"][0],
         **{key: f["records"][0] for key, f in yolo.items()},
         "fcos": fcos_nms, "centernet": cn_records, "lhrcnn": lh_nms,
         "feed": {"launches": (f_train["counts"]["nms_rows"]
                               + f_eval["counts"]["nms_rows"]),
                  "launches_per_step": f_train["counts"]["nms_rows"] / FEED_STEPS,
                  "launches_per_image": f_eval["counts"]["nms_rows"] / f_eval["images"],
                  "launches_by_path": {k: f_train["counts"][k] + f_eval["counts"][k]
                                       for k in ("sorted_scan", "per_pick")},
                  "eval_decode_pool": {k: f_eval["decode_pool"][k] for k in (
                      "ms", "device_ms", "per_pick_ms", "pool_call_ms", "plain_ms",
                      "bound_ms", "bound_by", "picks", "shape", "full_shape")},
                  "eval_full_width": f_eval["full_width"] and {
                      k: f_eval["full_width"][k] for k in (
                          "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "picks",
                          "shape")}},
         "resident": {"launches": sum(c["nms_rows"] for c in res_counts),
                      "launches_per_step": [c["nms_rows"] / res_steps
                                            for c in res_counts],
                      "launches_by_path": {k: sum(c[k] for c in res_counts)
                                           for k in ("sorted_scan", "per_pick")}}},
        {"name": "assign", "route": "cuda", "source": "tpudet_torch/ops/cuda/csrc/assign.cu",
         "replaces": "tpudet/ops/pallas/assign_kernel.py:43",
         "launches": (counts["assign"] + r_counts["assign"]
                      + sum(f["records"][1]["launches"] for f in refine.values())
                      + ssd512["records"][1]["launches"] + f_train["counts"]["assign"]
                      + sum(c["assign"] for c in res_counts)),
         "launches_per_request": serve["counts"]["assign"] / n_requests,
         "launches_per_step": counts["assign"] / n_steps,
         "max_abs_err": 0.0,  # best_iou equal bit for bit, the rest exactly
         "ms": assign["ms"], "device_ms": assign["device_ms"],
         "plain_ms": assign["plain_ms"],
         "bound_ms": assign["bound_ms"], "bound_by": assign["bound_by"],
         "library_ms": None,
         "retinanet": {
             "launches": r_counts["assign"], "launches_per_step": r_counts["assign"] / r_steps,
             "launches_per_request": r_serve["counts"]["assign"] / n_requests,
             **{k: r_kern["assign"][k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                 "bound_by")}},
         **{key: f["records"][1] for key, f in refine.items()},
         "ssd512": ssd512["records"][1],
         **{key: f["records"][1] for key, f in yolo.items()},
         "fcos": fcos_assign, "centernet": cn_records, "lhrcnn": lh_assign,
         "feed": {"launches": f_train["counts"]["assign"] + f_eval["counts"]["assign"],
                  "launches_per_step": f_train["counts"]["assign"] / FEED_STEPS,
                  "launches_per_image": f_eval["counts"]["assign"] / f_eval["images"]},
         "resident": {"launches": sum(c["assign"] for c in res_counts),
                      "launches_per_step": [c["assign"] / res_steps
                                            for c in res_counts]}},
    ]
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
