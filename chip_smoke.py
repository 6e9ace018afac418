"""Drive the PyTorch/CUDA port (tpudet_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py [--old-nms NMS_CU]

``--old-nms`` builds an earlier ``csrc/nms.cu`` with the same C entries
beside the package's, holds its pool == plain at every site, and times its
select and continuation in turns with the package's on the same inputs
(phase 24 prints them as one table).

Phases, each raising on failure (nothing is caught):
  1. card and build: the card's name and power limit, then nvcc builds every
     kernel (NMS, anchor assignment) from the checkout's sources, one nvcc
     per source, all started together;
  2. each kernel against its plain PyTorch version, on the card, on the shapes
     the system gives it, with exact equality of the outputs: the NMS pool's
     four kernels (select, mask, scan, continuation) through ``nms_rows``,
     through it with 8-wide pools and 16-wide tiles (continuations across
     tiles) and through tpudet's pool, on every case, a row holding a NaN
     included, and a scene whose pool runs out (one row continued); the
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
     bf16 and fp32, a profiler breakdown of one step, the step's synchronising
     calls under the sync debug mode, and the pool (``pool_site``) on that
     step's own mining pool and on a request's decode pool: the select kernel
     == the stable order's head, no host sync, a CUDA graph's replay == plain,
     the old pool call (sort, scan, host check) and the new one in turns, each
     kernel's time;
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
     decode whose pool runs out, its row continued on the card;
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
     of its pool, its row continued on the card == the plain version;
 14. CenterNet at its training script's config (``drivers/testcenternet.py``:
     384x384, 20 classes, DLA, TF-style Adam): serve 10 fp32 requests at the
     script's score threshold 0.1 and top-k 100 (BatchNorm statistics from 4
     seeded images where the initial ones let the heads run away), one select
     launch a request (the top K), the decode on the card == on the CPU on the same
     head outputs, the top K's select timed as a site of its own (== the stable
     order's head, beside ``torch.topk``), the network against the CPU; train
     12 bf16 steps at batch
     15, lr 0.001, with no kernel launch, a finite and falling loss, a
     profiled step and peak memory; one Adam update on the card against the
     CPU's on the same gradients; out-of-range labels leave the loss finite
     and the context usable;
 15. LH-RCNN at its training script's config (``drivers/testlhrcnn.py``:
     700x1100, 20 classes, 6818 anchors, post_nms_proposal 500): serve 10
     fp32 requests at a score threshold chosen and logged from one probe
     image (BatchNorm statistics from 4 seeded images where the initial ones
     let the RPN's ``phw`` run away or vanish): two NMS pools a request (the
     proposal pool [1, 1000] of [1, 6818], the class rows [20, 500]), the
     proposal pool's row continued on the card where it runs out (counted), no
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
     negative pool forced to run out, its row continued on the card;
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
     wait logged;
 18. the user's entry points: ``entry_torch.entry()`` on the card, on its
     example args and on a seeded image, within 1e-4 of the same net on the
     CPU; ``bench_torch.main()`` at its protocol (SSD300 bf16, batch 32: 2
     warm-up and 30 timed steps, then a warm and a timed scanned epoch of 30),
     its JSON on a line of its own, both kernels launched once a step; the
     mini VOC set through ``drivers_torch/test_voc_utils.py``, then one epoch
     of ``drivers_torch/_common.run`` at ``drivers_torch/testSSD300.py``'s
     config at batch 2: one assignment and one mining pool a step, a finite
     epoch loss, a ``.pt`` checkpoint;
 19. data parallelism (``tpudet_torch/runtime/mesh.py``) at phase 4's config
     and seeded batch (bf16, batch 32, lr 0.01, cap 384): (a) the step
     without a process group, then ``mesh.initialize`` with one rank on NCCL
     and the same model through the group: 2 steps equal bit for bit
     (losses, parameters, BatchNorm statistics, velocities), then epochs of
     30 timed steps in turns without and with the group, a profiled step of
     each, the flat gradient reduction's and one BatchNorm reduction's time;
     (b) two ranks spawned on this one card over gloo (NCCL refuses two
     ranks on one device), 16 rows each, 2 steps: the first step's loss
     within 2e-4 of (a)'s and the parameters after it within 5e-4 (tpudet's
     own tolerances), the second loss within 1e-2 (a bf16 step's), the
     ranks' states bitwise equal, each rank's one assignment and one mining
     pool a step held exactly against the plain versions on its inputs, then
     batch 31 padded to 32 with the mask; (c) phase 17's set cut to 1000 rows in a
     ``DeviceDataset`` distributed over two ranks, 4 scanned steps with the
     device augmentation, then 2 per step: each rank's gathered rows equal
     those a CPU dataset of the same seed assigns it, finite losses. The kernels are
     built before the ranks are spawned; a rank that fails fails the run.
 20. the convergence protocol's machinery (``scripts/train_convergence_torch.py``):
     ``run_model("RefineDet320")``, the spec that joins ``host_feed`` and
     ``gt_pad`` 24, on 256 train and 16 held-out synthvoc scenes rendered at
     320x320, its schedule scaled to 60 steps, ``--eval-every`` 10 and a
     periodic checkpoint every 40 steps: one assignment at G = 24 and one
     mining pool a step, each training call's kernels == the plain versions
     on its inputs, evaluations at steps 45 and 57 with no assignment;
     then a resume from the step-45 checkpoint (a copy of the run cut there)
     whose loaded parameters, BatchNorm statistics, velocity and
     ``global_step`` equal those saved bit for bit and whose appended curve
     equals the run's; ``eval_from_checkpoint`` with the run's mAP; the host
     feed's images/s alone and a profiled step on it.
 21. the protocol of the last four families: ``run_model`` of LHRCNN
     (700x1100, batch 8, the host feed), YOLOv3-consistent (448x448, batch
     12, resident), CenterNet (384x384, batch 15, Adam, resident) and FCOS
     (800x1200, batch 8, the host feed at ``gt_pad`` 24), each on 32 train
     and 8 held-out scenes rendered at its input size, its schedule scaled to
     6 steps and one evaluation: finite losses; launches by design (LH-RCNN's
     two NMS pools a step, the others none; in the evaluation two NMS pools
     an image for LH-RCNN, one for YOLOv3 and FCOS, one top-K select for
     CenterNet, a row that runs out of its pool continued on the card); no
     assignment; every call of either kernel, training's and the
     evaluation's, == its plain version on its inputs.
 22. the carry copy and the remaining specs' protocol paths: CenterNet through
     ``run_model`` (384x384, batch 15, 4 steps), then
     ``scripts/convergence_variants_torch.py::carry_state`` of its net
     (kernels rounded to bfloat16, the 1-D leaves float32) written, read
     back into a freshly built CenterNet, whose decodes of 8 held-out scenes
     equal the trained net's bit for bit; then ``run_model`` of YOLOv3 (the
     quirk-faithful decode, 448x448, batch 12), YOLOv2-consistent (480x480,
     batch 32), both resident, and RefineDet320-pad60 (320x320, batch 32,
     the host feed at the full gt width 60, the split augmentation), as
     phase 21 runs its four: launches by design (RefineDet320-pad60 one
     assignment at G = 60 and one mining pool a step; in the evaluation one
     sorted scan an image), every call == its plain version.
 23. tpudet's per-model bench (``scripts/bench_all_torch.py::bench_model``)
     of SSD300 (batch 32, 300x300) and LH-RCNN (batch 8, 700x1100, its RPN
     phase) at tpudet's bench specs: 2 warm-up and 6 timed bf16 steps, one
     more under the FLOP counter, 16 bf16 requests; the timed steps launch
     by design or the bench raises (SSD300 one assignment and one mining
     pool a step, LH-RCNN two NMS pools), and so does the whole call; the
     first call of each kernel == its plain version.
 24. the NMS pool with no host sync: ``ssd_loss`` forward and backward at
     SSD300's training shapes, LH-RCNN's ``rpn_select`` at 700x1100 and
     ``per_class_nms`` under ``torch.cuda.set_sync_debug_mode("error")``;
     the main-path pools' old and new pool calls as one table.
 25. tpudet's last public functions on the card: ``greedy_nms`` and
     ``topk_then_nms`` of one SSD300 class row (8828 candidates, the
     driver's 20 picks at IoU 0.45, tpudet's default ``nms_pre_topk`` 200,
     a row with more than 200 candidates (truncated) and one with 150), each
     once under ``torch.cuda.set_sync_debug_mode("error")`` with its
     kernels' launches counted by design and its outputs == its plain
     version's on the same card; each call's ms beside the plain version's;
     the three loss primitives and the four per-image losses (YOLOv2 at 480,
     YOLOv3 at 448, FCOS at 800x1200, CenterNet at 384) on the card within
     1e-5 of the CPU's.
 26. tpudet's two per-model profilers (``scripts/profile_model_torch.py``,
     ``scripts/profile_decode_torch.py``) for SSD300 (batch 32, 300x300) and
     LH-RCNN (batch 8, 700x1100, both phases) at tpudet's bench specs, 3
     timed calls a phase after 1: every figure finite and positive; launches
     a call by design (SSD300 ``fwd`` none, ``fwd+loss``, ``grad`` and
     ``step`` one assignment and one mining pool; LH-RCNN two NMS pools in
     ``+rpn`` and every phase after it; a request's decode one pool on
     SSD300, two on LH-RCNN), and the whole call's those of its phases'
     calls; SSD300's four train phases with no synchronising call; the first
     captured call of each kernel == its plain version.

The last lines are a JSON record of the kernels, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. float32 convolutions and matmuls
run without TF32 here (both switches are set off below), so the card's
network agrees with the CPU's to float32 accumulation-order error.
"""

from __future__ import annotations

import contextlib
import json
import math
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
OLD_NMS = {}  # "lib": an earlier csrc/nms.cu (``--old-nms``), timed in turns with the package's


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
    # selects nothing (it looks run out; the continuation leaves it empty)
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


NMS_KERNELS = ("select", "mask", "scan", "continue")
NMS_COUNT_KEYS = (*NMS_KERNELS, "continued")  # a counts dict's NMS entries
POOL_KEYS = ("pool_call_ms", "old_pool_call_ms", "device_ms", "kernels", "plain_ms",
             "bound_ms", "bound_by", "picks", "shape", "full_shape")  # of pool_site's
RUN_OUT_KEYS = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "picks", "shape",
                "pool_call_ms")  # of pool_run_out's


def nms_counts() -> dict:
    """The NMS wrapper's counts: its calls (``nms_rows``), each kernel's
    launches, and the rows its continuation took past their pool
    (``continued``, read from the card)."""
    from tpudet_torch.ops.cuda import nms_kernel

    return {"nms_rows": nms_kernel.launches, **nms_kernel.launches_by_path,
            "continued": int(nms_kernel.continued_rows("cuda"))}


def raw_select(scores, p, lib=None):
    """The select kernel on ``scores`` through its C entry (of the library
    ``lib``, else the package's), buffers allocated once: ``{"select":
    launcher, "order": [B, p], "live": [B]}``."""
    import torch

    from tpudet_torch.ops.cuda import nms_kernel

    b, n = scores.shape
    i32 = dict(dtype=torch.int32, device=scores.device)
    order, live = torch.empty((b, p), **i32), torch.empty((b,), **i32)
    fn = (lib.tpudet_nms_select if lib is not None
          else nms_kernel._library("tpudet_nms_select", scores.device))
    args = (scores.data_ptr(), b, n, p, order.data_ptr(), live.data_ptr(),
            torch.cuda.current_stream().cuda_stream)

    def launch():
        if fn(*args) != 0:
            raise RuntimeError("NMS select kernel launch failed")
    return {"select": launch, "order": order, "live": live}


def topk_times(scores, p) -> dict:
    """``torch.topk`` of the same rows (the library call the select stands
    beside; the port never calls it): events and device time."""
    import torch

    def lib():
        return torch.topk(scores, p, dim=1)
    return dict(library_ms=event_ms(lib, 200), library_device_ms=device_ms(lib))


def select_site(scores, p):
    """The select kernel alone on a main-path input (CenterNet's top K): ==
    the stable order's head; its time (events around raw launches), device
    time, the plain version's (the stable sort's head), ``torch.topk``'s on
    the same rows, its bound (the scores read once, the order and the live
    counts written once), and with ``--old-nms`` the earlier select in turns
    (``old``)."""
    import torch

    from tpudet_torch.ops.cuda import nms_kernel

    b, n = scores.shape
    raw = raw_select(scores, p)
    raw["select"]()
    torch.cuda.synchronize()
    head = nms_kernel.stable_order(scores)[:, :p]
    err = float((raw["order"].long() - head.long()).abs().max())
    if err:
        raise AssertionError("the select kernel != the stable order's head")
    b_ms, b_by = bound(b * n * 4 + b * p * 4 + b * 4, 0)
    out = dict(ms=event_ms(raw["select"], 200), device_ms=device_ms(raw["select"]),
               plain_ms=event_ms(lambda: nms_kernel.stable_order(scores)[:, :p], 20),
               **topk_times(scores, p), bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
               shape=[b, p], full_shape=[b, n])
    if OLD_NMS:
        old = raw_select(scores, p, OLD_NMS["lib"])
        old["select"]()
        torch.cuda.synchronize()
        if not torch.equal(old["order"].long(), head.long()):
            raise AssertionError("the earlier select != the stable order's head")
        out["old"] = old_vs_new(old["select"], raw["select"], 200)
    return out


def old_nms_build(source, name="old_nms") -> Path:
    """``source``, an earlier ``csrc/nms.cu`` with the same C entries, built
    with the package's nvcc flags into ``build/old_nms/{name}.so``."""
    from tpudet_torch.ops.cuda import build

    out = build.BUILD_DIR.parent / "old_nms" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    return out


def old_nms_load(path):
    """The earlier library at ``path``, loaded beside the package's, its C
    entries typed as the package's and its ``tpudet_nms_init`` run."""
    import ctypes

    from tpudet_torch.ops.cuda import nms_kernel

    lib = ctypes.CDLL(str(path))
    for name, argtypes in nms_kernel._ARGTYPES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    if lib.tpudet_nms_init() != 0:
        raise RuntimeError(f"tpudet_nms_init failed in {path}")
    return lib


def old_vs_new(old, new, reps):
    """One kernel of the earlier library (``old``, a raw launcher) and the
    package's (``new``) on the same inputs, in turns (old, new, new, old):
    CUDA events around ``reps`` launches each, then profiler device time in
    the same order."""
    ev = [event_ms(f, reps) for f in (old, new, new, old)]
    dev = [device_ms(f, min(reps, 20)) for f in (old, new, new, old)]
    mean = (lambda a, b: None if a is None or b is None else (a + b) / 2)
    return dict(old_ms=(ev[0] + ev[3]) / 2, new_ms=(ev[1] + ev[2]) / 2, turns_ms=ev,
                old_device_ms=mean(dev[0], dev[3]), new_device_ms=mean(dev[1], dev[2]),
                device_turns_ms=dev)


def pool_call_args(args):
    """``(boxes, scores, num_select, max_out, iou_threshold, pool)`` of a
    captured ``nms_rows`` call of a pool (the card takes no order) or of a
    ``batched_greedy_nms_pretopk`` call (tpudet's pool)."""
    from tpudet_torch.ops.cuda import nms_kernel

    boxes, scores, ns, max_out, thr = args[:5]
    pool = args[6] if len(args) > 6 else nms_kernel.pretopk_pool(max_out)
    return boxes, scores, ns, max_out, thr, pool


def raw_pool(boxes, scores, ns, max_out, thr, pool=None, tile=None, lib=None):
    """The pool's kernels on these inputs through their C entries (of the
    library ``lib``, else the package's), with buffers allocated once, so the
    wrapper's Python work stays out of their times: ``{kernel: launcher}``
    for ``NMS_KERNELS`` (``continue`` where the pool is narrower than the
    rows), ``"all"`` (each in order), ``"p"`` and ``"out"`` (sel, valid,
    order, live, row state after ``all``)."""
    import torch

    from tpudet_torch.ops.cuda import nms_kernel

    b, n = scores.shape
    dev = scores.device
    p = nms_kernel.pool_width(n, pool)
    tile = nms_kernel.TILE if tile is None else tile
    i32 = dict(dtype=torch.int32, device=dev)
    order, live, state = (torch.empty((b, p), **i32), torch.empty((b,), **i32),
                          torch.empty((b, 2), **i32))
    mask = torch.empty((b, p, nms_kernel.mask_stride(p)), dtype=torch.int64, device=dev)
    sel = torch.empty((b, max_out), **i32)
    valid = torch.empty((b, max_out), dtype=torch.bool, device=dev)
    continued = torch.zeros(1, **i32)
    stride = 0 if boxes.dim() == 2 else n * 4
    stream = torch.cuda.current_stream().cuda_stream
    cont = p < n
    ptrs = {
        "select": (scores.data_ptr(), b, n, p, order.data_ptr(), live.data_ptr(), stream),
        "mask": (scores.data_ptr(), boxes.data_ptr(), stride, order.data_ptr(), b, n, p, thr,
                 mask.data_ptr(), stream),
        "scan": (scores.data_ptr(), order.data_ptr(), ns.data_ptr(), live.data_ptr(), b, n,
                 p, max_out, mask.data_ptr(), sel.data_ptr(), valid.data_ptr(),
                 state.data_ptr() if cont else None, stream),
        "continue": (scores.data_ptr(), boxes.data_ptr(), stride, order.data_ptr(),
                     ns.data_ptr(), state.data_ptr(), b, n, p, tile, max_out, thr,
                     sel.data_ptr(), valid.data_ptr(), continued.data_ptr(), stream)}
    # every buffer stays referenced while the launchers live: they hold raw pointers
    out = {"p": p, "out": (sel, valid, order, live, state), "buffers": (mask, continued)}
    for k in NMS_KERNELS if cont else NMS_KERNELS[:3]:
        fn = (getattr(lib, f"tpudet_nms_{k}") if lib is not None
              else nms_kernel._library(f"tpudet_nms_{k}", dev))

        def launch(fn=fn, a=ptrs[k], k=k):
            if fn(*a) != 0:
                raise RuntimeError(f"NMS {k} kernel launch failed")
        out[k] = launch
    kernels = [out[k] for k in NMS_KERNELS if k in out]
    out["all"] = lambda: [launch() for launch in kernels]
    return out


def old_pool_call(raw, boxes, scores, ns, max_out, pool):
    """The pool as it ran before the select kernel and the continuation: a
    stable sort of the full rows, the mask and scan kernels over its head
    (``raw``'s launchers, its select run once before so the scan's live
    counts are set), and the run-out check read on the host. Returns
    ``(sel, valid, ran out)``; the full-width rerun a pool that ran out took
    is gone."""
    import torch

    from tpudet_torch.ops.cuda import nms_kernel

    sel, valid, order = raw["out"][:3]
    p = raw["p"]
    order.copy_(nms_kernel.stable_order(scores)[:, :p])
    raw["mask"]()
    raw["scan"]()
    n_active = torch.sum(scores > NEG / 2, dim=-1)
    quota = torch.minimum(torch.clamp(ns.long(), max=max_out), n_active)
    return sel, valid, bool(torch.any((valid.sum(-1) < quota) & (n_active > p)))


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def walked_prefix(scores, ns, max_out, sel, valid, p, ran):
    """``(rank [B, N], prefix [B])``: each candidate's position in its row's
    stable descending order, and how many positions of that order the greedy
    walk of the pool call must reach: the pool's ``p``, and for a row that
    ran out (``ran``, its first score not NaN) its last pick's position + 1
    when it filled its quota, else its live count."""
    import torch

    from tpudet_torch.ops.cuda import nms_kernel

    b, n = scores.shape
    order = nms_kernel.stable_order(scores).long()
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(n, device=scores.device).expand(b, n).contiguous())
    live = torch.sum(scores > NEG / 2, dim=-1)
    picks = valid.sum(-1)
    last = torch.where(valid, torch.gather(rank, 1, sel.long()), -1).amax(-1)
    filled = picks >= torch.minimum(torch.clamp(ns.long(), max=max_out), live)
    walked = torch.where(filled, last + 1, live)
    first_nan = torch.isnan(torch.gather(scores, 1, order[:, :1]))[:, 0]
    prefix = torch.where(ran & ~first_nan, torch.clamp(walked, min=p), p)
    return rank, prefix


def pool_call_work(boxes, scores, ns, max_out, thr, sel, valid, p, ran):
    """Bytes and float32 operations of a pool call's function, greedy NMS of
    the full rows through pools of ``p`` (``sel``, ``valid`` its result,
    ``ran`` the rows that ran out): every score read once (the pool's
    selection must see each), the boxes of the candidates the walk reaches
    (:func:`walked_prefix`) read once, the budgets read and the picks
    written once; and :func:`nms_work`'s IoU tests over those candidates
    only, so none past a row's pool but where it ran out."""
    import torch

    b, n = scores.shape
    rank, prefix = walked_prefix(scores, ns, max_out, sel, valid, p, ran)
    reached = rank < prefix[:, None]
    flops = nms_work(boxes, torch.where(reached, scores, NEG), sel, valid, thr)[1]
    boxes_read = int(reached.any(0).sum() if boxes.dim() == 2 else reached.sum())
    nbytes = b * n * 4 + boxes_read * 16 + b * 4 + b * max_out * 5
    return nbytes, flops


def pool_kernel_work(boxes, scores, ns, max_out, thr, raw):
    """Bytes and float32 operations each of the pool's kernels needs on these
    inputs (each input read once, each output written once; for the mask the
    IoU of every live position's pairs ahead of it, for the continuation the
    IoU tests its rows need between the pool's end and the end of their
    walk, :func:`walked_prefix`), and under ``"call"`` the whole pool call's
    (:func:`pool_call_work`)."""
    import torch

    from tpudet_torch.ops.cuda import nms_kernel

    b, n = scores.shape
    sel, valid, order, live, state = raw["out"]
    p = raw["p"]
    words = nms_kernel.mask_stride(p)
    live_pos = torch.clamp(live.long(), max=p)
    pairs = int(torch.sum(live_pos * (p - 1) - live_pos * (live_pos - 1) // 2))
    ran = (state[:, 1] > 0 if "continue" in raw
           else torch.zeros(b, dtype=torch.bool, device=scores.device))
    work = {  # order, score and box of a position read, mask words written
        "select": (b * n * 4 + b * p * 4 + b * 4, 0),
        "mask": (b * p * (4 + 4 + 16) + b * p * words * 8, IOU_FLOPS * pairs),
        "scan": (b * p * words * 8 + b * p * 4 + b * 4 * 2 + b * max_out * 5 + b * 8, 0),
        "call": pool_call_work(boxes, scores, ns, max_out, thr, sel, valid, p, ran)}
    if "continue" in raw:
        rank, prefix = walked_prefix(scores, ns, max_out, sel, valid, p, ran)
        went_on = ran & (prefix > p)
        rows, flops, past = int(went_on.sum()), 0, 0
        if rows:
            bx = boxes if boxes.dim() == 2 else boxes[went_on]
            sc, rk, picks = scores[went_on], rank[went_on], (sel[went_on], valid[went_on])
            walk = rk < prefix[went_on][:, None]
            flops = (nms_work(bx, torch.where(walk, sc, NEG), *picks, thr)[1]
                     - nms_work(bx, torch.where(rk < p, sc, NEG), *picks, thr)[1])
            past = int((prefix[went_on] - p).sum())
        work["continue"] = (b * (8 + 4) + rows * (n - p) * 4 + past * 16
                            + int(valid[went_on].sum()) * (4 + 16) + rows * max_out * 5,
                            max(flops, 0))
    return work


def nms_equal(got, want) -> bool:
    import torch

    return torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def pool_in_graph(boxes, scores, ns, max_out, thr, pool) -> bool:
    """One pool call captured in a CUDA graph and replayed on the scores with
    their columns permuted: == plain."""
    import torch

    from tpudet_torch.ops import nms as nms_ops
    from tpudet_torch.ops.cuda import nms_kernel

    static = scores.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        nms_kernel.nms_rows(boxes, static, ns, max_out, thr, None, pool)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = nms_kernel.nms_rows(boxes, static, ns, max_out, thr, None, pool)
    perm = torch.from_numpy(__import__("numpy").random.default_rng(3).permutation(
        scores.shape[1])).to(scores.device)
    other = scores[:, perm].contiguous()
    static.copy_(other)
    graph.replay()
    torch.cuda.synchronize()
    ok = nms_equal(out, nms_ops.batched_greedy_nms(boxes, other, ns, max_out, thr))
    del graph
    return ok


def pool_site(args, plain_reps=5):
    """One main-path pool (a captured call of it) on the card: the select
    kernel == the stable order's head; the pool call == the plain full-width
    NMS (the rows it continued counted); no host sync under
    ``torch.cuda.set_sync_debug_mode("error")``; captured in a CUDA graph and
    replayed on other scores, == plain. Then the old pool call (sort, scan,
    host check) and the new one timed in turns (old, new, new, old; CUDA
    events around the calls as callers make them), each kernel's time
    (events around raw launches) and device time (profiler), plain time and
    bound, and beside the select ``torch.topk`` on the same rows. With
    ``--old-nms`` the earlier library's pool == plain too, and its select
    and continuation timed in turns with the package's (``old``)."""
    import torch

    from tpudet_torch.ops import nms as nms_ops
    from tpudet_torch.ops.cuda import nms_kernel

    boxes, scores, ns, max_out, thr, pool = pool_call_args(args)
    want = nms_ops.batched_greedy_nms(boxes, scores, ns, max_out, thr)
    counter = nms_kernel.continued_rows("cuda")
    counter.zero_()
    new = nms_kernel.nms_rows(boxes, scores, ns, max_out, thr, None, pool)
    torch.cuda.synchronize()
    continued = int(counter)
    if not nms_equal(new, want):
        raise AssertionError("NMS pool != plain version on a main-path pool")
    raw = raw_pool(boxes, scores, ns, max_out, thr, pool)
    raw["all"]()
    p = raw["p"]
    head = nms_kernel.stable_order(scores)[:, :p]
    order = raw["out"][2]
    select_err = float((order.long() - head.long()).abs().max())
    if select_err or not nms_equal(raw["out"][:2], want):
        raise AssertionError("the select kernel != the stable order's head, or the raw "
                             "launches != plain")
    torch.cuda.set_sync_debug_mode("error")
    try:
        nms_kernel.nms_rows(boxes, scores, ns, max_out, thr, None, pool)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not pool_in_graph(boxes, scores, ns, max_out, thr, pool):
        raise AssertionError("a pool call replayed from a CUDA graph != plain")
    new_call = (lambda: nms_kernel.nms_rows(boxes, scores, ns, max_out, thr, None, pool))
    work = pool_kernel_work(boxes, scores, ns, max_out, thr, raw)
    old_call = (lambda: old_pool_call(raw, boxes, scores, ns, max_out, pool))
    *old, ran_out = old_call()
    if ran_out != bool(continued) or not (ran_out or nms_equal(old, want)):
        raise AssertionError("the old pool != plain, or it ran out where no row "
                             "continued")
    turns = [event_ms(old_call, 50), event_ms(new_call, 50), event_ms(new_call, 50),
             event_ms(old_call, 50)]
    orders = torch.zeros_like(scores, dtype=torch.bool).scatter_(1, head.long(), True)
    full_plain = event_ms(lambda: nms_ops.batched_greedy_nms(boxes, scores, ns, max_out,
                                                             thr), plain_reps)
    plain = {"select": event_ms(lambda: nms_kernel.stable_order(scores)[:, :p], 20),
             "mask": event_ms(lambda: pool_mask_plain(boxes, head, thr), 5),
             "scan": event_ms(lambda: nms_ops.batched_greedy_nms(
                 boxes, scores, ns, max_out, thr, active=orders), plain_reps),
             "continue": full_plain}  # the pool with its continuation: the full rows
    kernels = {}
    for k in NMS_KERNELS:
        if k not in raw:
            continue
        b_ms, b_by = bound(*work[k])
        kernels[k] = dict(ms=event_ms(raw[k], 200), device_ms=device_ms(raw[k]),
                          plain_ms=plain[k], bound_ms=b_ms, bound_by=b_by,
                          max_abs_err=select_err if k == "select" else 0.0,
                          **(topk_times(scores, p) if k == "select" else {}))
    if OLD_NMS:
        old_raw = raw_pool(boxes, scores, ns, max_out, thr, pool, lib=OLD_NMS["lib"])
        old_raw["all"]()
        torch.cuda.synchronize()
        if not (torch.equal(old_raw["out"][2].long(), head.long())
                and nms_equal(old_raw["out"][:2], want)):
            raise AssertionError("the earlier library's pool != plain")
        for k in ("select", "continue"):
            if k in raw:
                kernels[k]["old"] = old_vs_new(old_raw[k], raw[k], 200)
    b_ms, b_by = bound(*work["call"])
    return dict(pool_call_ms=(turns[1] + turns[2]) / 2,
                old_pool_call_ms=(turns[0] + turns[3]) / 2, turns_ms=turns,
                device_ms=device_ms(raw["all"]), kernels=kernels, plain_ms=full_plain,
                bound_ms=b_ms, bound_by=b_by, picks=int(want[1].sum()), shape=[
                    scores.shape[0], p], full_shape=list(scores.shape),
                continued=continued, sync_free=True, graph_replay=True)


def pool_mask_plain(boxes, order, thr):
    """The plain version of the mask: ``[B, P, P]`` bool, IoU of the later
    position's candidate against the earlier's > thr, upper triangle, in the
    plain NMS's order of operations."""
    import torch

    idx = order.long()
    b, p = idx.shape
    bx = (boxes[idx] if boxes.dim() == 2
          else torch.gather(boxes, 1, idx[..., None].expand(b, p, 4)))
    y1, x1, y2, x2 = bx.unbind(-1)
    area = (y2 - y1) * (x2 - x1)
    inter = (torch.clamp(torch.minimum(y2[:, None, :], y2[:, :, None])
                         - torch.maximum(y1[:, None, :], y1[:, :, None]), min=0.0)
             * torch.clamp(torch.minimum(x2[:, None, :], x2[:, :, None])
                           - torch.maximum(x1[:, None, :], x1[:, :, None]), min=0.0))
    iou = inter / (area[:, None, :] + area[:, :, None] - inter)
    return (iou > thr) & torch.ones(p, p, dtype=torch.bool, device=boxes.device).triu(1)


@contextlib.contextmanager
def small_pool(pool=8, tile=16):
    """Within it, every pool on the card takes ``pool`` positions and the
    continuation tiles of ``tile``: most rows run out and cross tiles."""
    from tpudet_torch.ops.cuda import nms_kernel

    saved = nms_kernel.SORTED_SCAN_MAX_WIDTH, nms_kernel.TILE
    nms_kernel.SORTED_SCAN_MAX_WIDTH, nms_kernel.TILE = pool, tile
    try:
        yield
    finally:
        nms_kernel.SORTED_SCAN_MAX_WIDTH, nms_kernel.TILE = saved


def phase_kernels(dev, anchor_corners):
    """The NMS kernels == the plain version on every case, through nms_rows,
    through it with 8-wide pools and 16-wide tiles (continuations across
    tiles), and through tpudet's pool; the pools of three cases measured
    (``pool_site``); a forced run-out continued on the card."""
    import torch
    from torch_nms_cases import nms_case

    from tpudet_torch.ops import nms as nms_ops
    from tpudet_torch.ops.cuda import nms_kernel

    timings = {}
    for name, boxes, scores, ns, max_out, thr in nms_cases(anchor_corners):
        args = [torch.from_numpy(a).to(dev) for a in (boxes, scores, ns)]
        want = nms_ops.batched_greedy_nms(*args, max_out, thr)
        reset_nms_counts()
        auto = nms_kernel.nms_rows(*args, max_out, thr)
        with small_pool():
            small = nms_kernel.nms_rows(*args, max_out, thr)
        pool = nms_kernel.batched_greedy_nms_pretopk(*args, max_out, thr)
        torch.cuda.synchronize()
        used = nms_counts()
        for how, got in (("nms_rows", auto), ("small pools", small), ("pool", pool)):
            if not nms_equal(got, want):
                raise AssertionError(f"NMS kernels ({how}) != plain version on {name}")
        n_picks = want[1].sum(-1)
        if name == "zero_area" and int(n_picks.sum()) != 4:
            raise AssertionError("zero-area boxes: expected 4 distinct picks")
        if name.startswith("nan") and int(n_picks[{"nan_row": 1, "nan_pool": 0}[name]]):
            raise AssertionError(f"{name}: the row holding a NaN selected boxes")
        log(f"nms {name}: scores {tuple(scores.shape)} max_out {max_out} thr {thr}: "
            f"kernels == plain through nms_rows, with small pools and through the pool; "
            f"launches {used}; {int(n_picks.sum())} picks")
        if name in ("decode_pool", "mining", "per_row_boxes"):
            t = timings[name] = pool_site((*args, max_out, thr, None,
                                           nms_kernel.pretopk_pool(max_out)))
            log_pool(f"case {name}", t)

    boxes, scores, ns, max_out, thr = nms_case("exhaustion")  # one cluster fills the pool
    args = [torch.from_numpy(a).to(dev) for a in (boxes, scores, ns)]
    full = pool_run_out("exhaustion scene", [*args, max_out, thr])
    if full["picks"] != 60:
        raise AssertionError(f"exhaustion scene: {full['picks']} picks, expected 60")
    timings["exhaustion"] = full
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

    launch.outs = outs  # the outputs live as long as the launcher, which holds their pointers
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
    counts = {**nms_counts(),
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
    if (counts["nms_rows"] < n_requests or counts["scan"] < n_requests
            or counts["select"] != counts["scan"] or counts["assign"]):
        raise AssertionError("the serving path must launch the NMS pool (select, mask, "
                             "scan) at least once per request and no assignment")
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
    boxes, scores, ns, max_out, thr, pool = pool_call_args(captured["args"])
    log(f"main-path NMS input: scores {tuple(scores.shape)}, boxes "
        f"{tuple(boxes.shape)}, the pool {pool}, max_out {max_out}, thr {thr}")
    return dict(latencies=latencies, p50=p50, counts=counts, network_ms=fwd_ms,
                decode_ms=dec_ms, network_vs_cpu=net_check, kernel_args=captured["args"])


def decode_kernel_vs_plain(model, outputs):
    """``model._decode_outputs(outputs)`` with the NMS kernels == with their
    plain version, exactly, on the card. Returns the decode and the kernel
    wrapper's arguments in it: ``captured["args"]`` of its first call."""
    import torch

    from tpudet_torch.ops.cuda import nms_kernel

    captured = {}
    real_rows = nms_kernel.nms_rows

    def capture(*a):
        captured.setdefault("args", a)
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
    nms_kernel.continued_rows("cuda").zero_()


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


def train_config(compute_dtype, batch=TRAIN_BATCH):
    """drivers/testSSD300.py's training config at ``batch`` (phase 4's)."""
    return {"mode": "train", "data_format": "channels_last", "num_classes": 20,
            "batch_size": batch, "weight_decay": 1e-4, "keep_prob": 1.0,
            "nms_score_threshold": 0.5, "nms_max_boxes": 20,
            "nms_iou_threshold": 0.5, "pretraining_weight": None,
            "compute_dtype": compute_dtype, "hard_neg_cap": 384, "seed": 0}


def train_batch():
    """Phase 4's seeded batch: 32 images of uniform noise and VOC-like gt."""
    import numpy as np
    from torch_assign_cases import voc_like_gt

    rng = np.random.default_rng(2)
    images = rng.uniform(0, 255, (TRAIN_BATCH, 300, 300, 3)).astype(np.float32)
    return images, voc_like_gt(3, b=TRAIN_BATCH)


def train_model(dev, compute_dtype, images, gt, n_steps):
    from tpudet_torch.models.ssd import SSD300

    model = SSD300(train_config(compute_dtype), feed((images, gt), n_steps, TRAIN_BATCH))
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
    counts = {"assign": assign_kernel.launches, **nms_counts()}
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
    for part in ("assign_kernel", "nms_select_kernel", "nms_mask_kernel", "nms_scan_kernel",
                 "nms_continue_kernel"):
        ms = sum(v for k, v in by_name.items() if part in k)
        log(f"  {part}: {ms:.4f} ms/step ({100 * ms / busy:.2f}% of device busy)")
    return dict(wall_ms=wall_ms, busy_ms=busy)


def step_host_syncs(model, images, gt, lr=0.01) -> list:
    """The synchronising CUDA calls of one train step (its batch already on
    the card), as ``torch.cuda.set_sync_debug_mode("warn")`` reports them
    (``scripts/profile_model_torch.py::host_syncs``)."""
    x, g = model._to_device(images, gt)
    model.train_step(x, g, lr)
    syncs = load_script("profile_model_torch").host_syncs(
        lambda: model.train_step(x, g, lr), x.device)
    log(f"one train step under the sync debug mode: {len(syncs)} synchronising "
        f"calls {syncs[:4]}")
    return syncs


def phase_train(dev, n_steps=10, warmup=2):
    import numpy as np
    import torch

    images, gt = train_batch()
    log(f"train batch: images {images.shape}, gt {gt.shape} with "
        f"{int((gt[..., 0] >= 0).sum())} objects")

    t0 = time.perf_counter()
    model = train_model(dev, "bfloat16", images, gt, n_steps)
    log(f"SSD300 (train, bf16) built on {model.device} in {time.perf_counter() - t0:.2f} s")
    bf16 = run_epoch(model, images, gt, warmup)
    counts, steps, losses = bf16["counts"], bf16["steps"], bf16["losses"]
    log(f"bf16: {warmup} warm-up steps + {steps} in train_one_epoch; kernel launches "
        f"in the epoch {counts}; losses {[round(x, 4) for x in losses]}")
    if (steps != n_steps or counts["assign"] != steps or counts["nms_rows"] != steps
            or any(counts[k] != steps for k in NMS_KERNELS) or counts["continued"]):
        raise AssertionError(f"the train path must launch the assignment kernel and "
                             f"the mining pool's four NMS kernels once per step, with no "
                             f"row continued: {counts}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall on one batch: {losses}")
    log(f"bf16 train: {bf16['images_per_s']:.1f} images/s by the host clock, "
        f"{bf16['step_ms']:.3f} ms/step by CUDA events, epoch mean {bf16['mean']:.4f}")

    mining = loss_kernel_vs_plain(model, images, gt)
    bf16["profile"] = profile_step(model, images, gt)
    bf16["host_syncs"] = step_host_syncs(model, images, gt)
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


def run_out_args(args, pool=512, top=3.0):
    """A pool's NMS input (a captured call) with row 0's top ``pool + 8``
    candidates made near-copies of one box, scored from ``top`` down to
    ``top - 1`` (above every other score of the row), so the pool runs out
    after its first pick and the continuation takes row 0 on."""
    import numpy as np
    import torch

    boxes, scores, ns, max_out, thr = args[:5]
    rng = np.random.default_rng(19)
    idx = torch.from_numpy(rng.permutation(boxes.shape[0])[:pool + 8]).to(boxes.device)
    ramp = torch.linspace(0, 0.5, pool + 8, device=boxes.device)
    boxes, scores = boxes.clone(), scores.clone()
    copy = torch.tensor([100.0, 100.0, 200.0, 220.0], device=boxes.device)
    boxes[idx] = copy + ramp[:, None]
    scores[0, idx] = top - 2.0 * ramp
    return [boxes, scores, ns, max_out, thr]


def pool_run_out(what, args):
    """One pool call whose pool runs out in row 0 (``args``: boxes, scores,
    budgets, max_out, IoU threshold, through ``batched_greedy_nms_pretopk``):
    one launch of each of the four kernels, exactly one row continued, ==
    the plain full-width version; the continuation timed (events around raw
    launches, profiler device time) beside its plain version (the plain
    full-width NMS) and its bound, and the whole pool call. With
    ``--old-nms`` the earlier library's continuation, after its own select,
    mask and scan, == plain and timed in turns with the package's
    (``old``)."""
    import torch

    from tpudet_torch.ops import nms as nms_ops
    from tpudet_torch.ops.cuda import nms_kernel

    boxes, scores, ns, max_out, thr = args
    pool = nms_kernel.pretopk_pool(max_out)
    reset_nms_counts()
    sel, val = nms_kernel.batched_greedy_nms_pretopk(*args)
    torch.cuda.synchronize()
    used = nms_counts()
    want = nms_ops.batched_greedy_nms(*args)
    if used != {"nms_rows": 1, **dict.fromkeys(NMS_KERNELS, 1), "continued": 1}:
        raise AssertionError(f"{what} run-out case: expected one launch of each kernel "
                             f"and one row continued, got {used}")
    if not nms_equal((sel, val), want):
        raise AssertionError(f"{what} run-out case: the pool and its continuation != "
                             f"plain version")
    if int(val[0].sum()) < 2:
        raise AssertionError(f"{what} run-out case: row 0 must pick beyond its pool")
    raw = raw_pool(boxes, scores, ns, max_out, thr, pool)
    raw["all"]()
    torch.cuda.synchronize()
    if not nms_equal(raw["out"][:2], want):
        raise AssertionError(f"{what} run-out case: raw launches != plain")
    turns = [event_ms(raw["continue"], 20) for _ in range(2)]
    call_ms = event_ms(lambda: nms_kernel.batched_greedy_nms_pretopk(*args), 20)
    plain = event_ms(lambda: nms_ops.batched_greedy_nms(*args), 2)
    work = pool_kernel_work(boxes, scores, ns, max_out, thr, raw)
    b_ms, b_by = bound(*work["continue"])
    full = dict(ms=sum(turns) / 2, turns_ms=turns, device_ms=device_ms(raw["continue"], 5),
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by, picks=int(val.sum()),
                shape=list(scores.shape), pool_call_ms=call_ms,
                pool_call_bound_ms=bound(*work["call"])[0], continued=1)
    if OLD_NMS:
        old_raw = raw_pool(boxes, scores, ns, max_out, thr, pool, lib=OLD_NMS["lib"])
        old_raw["all"]()
        torch.cuda.synchronize()
        if not nms_equal(old_raw["out"][:2], want):
            raise AssertionError(f"{what} run-out case: the earlier library's != plain")
        full["old"] = old_vs_new(old_raw["continue"], raw["continue"], 20)
    log(f"{what} NMS run-out case {tuple(scores.shape)}: row 0 ran out of its pool and "
        f"the continuation took it on, == plain ({int(val.sum())} picks, row 0 "
        f"{int(val[0].sum())}); the continuation {[round(x, 4) for x in turns]} ms "
        f"(device time {fmt_ms(full['device_ms'], 4)} ms), the whole pool call "
        f"{call_ms:.4f} ms (bound {full['pool_call_bound_ms']:.6f} ms), plain {plain:.4f} "
        f"ms, the continuation's bound {b_ms:.6f} ms ({b_by})")
    return full


def log_pool(what, t):
    kern = "; ".join(f"{k} {v['ms']:.5f} ms (device {fmt_ms(v['device_ms'])}, plain "
                     f"{v['plain_ms']:.4f}, bound {v['bound_ms']:.6f} {v['bound_by']}"
                     + (f", torch.topk {v['library_ms']:.5f} (device "
                        f"{fmt_ms(v['library_device_ms'])})" if "library_ms" in v else "")
                     + ")" for k, v in t["kernels"].items())
    log(f"NMS on {what} {t['shape']} of {t['full_shape']} ({t['picks']} picks): == plain, "
        f"select == the stable order's head, {t['continued']} rows continued, no host "
        f"sync, a CUDA "
        f"graph's replay == plain; the pool call in turns old/new/new/old "
        f"{[round(x, 5) for x in t['turns_ms']]} ms: new {t['pool_call_ms']:.5f} ms "
        f"(device {fmt_ms(t['device_ms'])}), old (sort, scan, host check) "
        f"{t['old_pool_call_ms']:.5f} ms ({t['old_pool_call_ms'] / t['pool_call_ms']:.1f}x); "
        f"{kern}; plain full width {t['plain_ms']:.4f} ms; bound {t['bound_ms']:.6f} ms "
        f"({t['bound_by']})")


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
    0's top 512 are near-copies of one box, the quota is 10) and continues
    row 0 on the card."""
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

    pool = pool_site(serve_args)
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
    if (counts["scan"] != n_requests or counts["assign"]
            or counts["nms_rows"] != n_requests):
        raise AssertionError(f"{name} serving: expected one NMS pool (a "
                             f"pool that runs out continues on the card) and no "
                             f"assignment a request, got {counts}")
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
            or counts["nms_rows"] != steps
            or counts["scan"] != steps):
        raise AssertionError(f"the {name} train path must launch the assignment kernel "
                             f"once a step and the NMS kernel's sorted scan once a step "
                             f"(a pool that runs out continues on the card): {counts}")
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
    mining = pool_site(captured["pool"])
    log_pool(f"{name}'s mining pool (cap 384, IoU 0.7)", mining)
    decode = pool_site(serve_args)
    log_pool(f"{name}'s decode pool", decode)
    return dict(assign=assign, mining_pool=mining, decode_pool=decode)


def family_records(serve, train, kern, n_requests):
    """A family's entries of the kernels' JSON record (families with the
    assignment, mining and a decode pool)."""
    s_counts, t_counts = serve["counts"], train["run"]["counts"]
    steps = train["run"]["steps"]
    pool_keys = POOL_KEYS
    nms = {"launches": s_counts["nms_rows"] + t_counts["nms_rows"],
           "launches_per_request": s_counts["nms_rows"] / n_requests,
           "launches_per_step": t_counts["nms_rows"] / steps,
           "launches_by_path": {k: s_counts[k] + t_counts[k]
                                for k in NMS_COUNT_KEYS},
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
    if (counts["scan"] != n_requests or counts["assign"]
            or counts["nms_rows"] != n_requests):
        raise AssertionError(f"SSD512 serving: expected one NMS pool (a pool that runs "
                             f"out continues on the card) and no assignment a request, "
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
            or counts["nms_rows"] != steps
            or counts["scan"] != steps):
        raise AssertionError(f"the SSD512 train path must launch the assignment kernel "
                             f"once a step and the NMS kernel's sorted scan once a step "
                             f"(a pool that runs out continues on the card): {counts}")
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
    if (counts["nms_rows"] != n_requests or counts["scan"] != n_requests
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
    pool_keys = POOL_KEYS
    nms = {"launches": s_counts["nms_rows"] + t_counts["nms_rows"],
           "launches_per_request": s_counts["nms_rows"] / n_requests,
           "launches_per_step": t_counts["nms_rows"] / run["steps"],
           "launches_by_path": {k: s_counts[k] + t_counts[k]
                                for k in NMS_COUNT_KEYS},
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
    if (counts["nms_rows"] != n_requests or counts["scan"] != n_requests
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
    score threshold 0.1 and top-k 100: one launch a request, the select
    kernel's (the decode's top K), and no other kernel; one request's decode
    on the card == on the CPU on the same head outputs (the CPU's top K is
    the stable sort's head);
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
    if (counts["nms_rows"] != n_requests or counts["select"] != n_requests
            or any(counts[k] for k in ("mask", "scan", "continue", "assign"))):
        raise AssertionError(f"the CenterNet serving path launches the select kernel once "
                             f"a request and no other kernel: {counts}")
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
        # the decode's top K (the select kernel's main-path site) on its own input
        peaks = center_head.peak_scores(outputs[0][0])[0]
        top_k = select_site(peaks[None].to(torch.float32).contiguous(),
                            min(int(model.top_k_results_output), peaks.numel()))
    log(f"CenterNet's top K {top_k['shape']} of {top_k['full_shape']}: the select kernel "
        f"== the stable order's head, {top_k['ms']:.5f} ms (device "
        f"{fmt_ms(top_k['device_ms'])}), plain {top_k['plain_ms']:.4f} ms, torch.topk "
        f"{top_k['library_ms']:.5f} ms (device {fmt_ms(top_k['library_device_ms'])}), "
        f"bound {top_k['bound_ms']:.6f} ms ({top_k['bound_by']})")
    profile_requests(model, images[:3])
    del model
    torch.cuda.empty_cache()
    return dict(latencies=latencies, p50=p50, counts=counts, network_ms=fwd_ms,
                decode_ms=dec_ms, network_vs_cpu=net_check, calibrated=calibrated,
                head_peak=peak, head_peak_after=after, top_k=top_k)


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
    """``fn()`` with every ``nms_rows`` call's arguments recorded. Returns
    the result and the calls."""
    from tpudet_torch.ops.cuda import nms_kernel

    calls, real = [], nms_kernel.nms_rows

    def spy(*a):
        calls.append(a)
        return real(*a)

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
    1000] of [1, 6818] (its continuation launched each time, a row continued
    only when the pool runs out: counted) and on the class rows [20, 500], no
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
    reruns = counts["continued"]
    if (any(counts[k] != 2 * n_requests for k in ("nms_rows", "select", "mask", "scan"))
            or counts["continue"] != n_requests or counts["assign"]
            or reruns > n_requests):
        raise AssertionError(f"LHRCNN serving: expected two NMS pools a request (the "
                             f"proposal pool's row continued on the card when it runs "
                             f"out) and no assignment, got {counts}")
    pool_args = out["kernel_args"]
    if (tuple(pool_args[1].shape) != (1, LHRCNN_ANCHORS)
            or pool_call_args(pool_args)[5] != 1000):
        raise AssertionError(f"LHRCNN proposal pool {pool_call_args(pool_args)[5]} of "
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
        f"and continued on the card; class rows {tuple(class_args[1].shape)}")
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
    phase, from the model's ``global_step``: two NMS pools a step (the
    positive and negative pools, each select, mask, scan and continuation;
    rows that ran out counted), no assignment, a finite loss every step, the
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
    if (steps != LHRCNN_STEPS or counts["assign"]
            or any(counts[k] != 2 * steps for k in ("nms_rows", *NMS_KERNELS))):
        raise AssertionError(f"the LHRCNN {phase} step must launch the NMS kernel's sorted "
                             f"scan twice (a pool that runs out continues on the card) "
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
    pos, neg = calls[:2]
    if (tuple(pos[0].shape) != (TRAIN_BATCH, LHRCNN_ANCHORS + 60, 4)
            or tuple(neg[0].shape) != (LHRCNN_ANCHORS, 4)
            or pool_call_args(pos)[5] != 512 or pool_call_args(neg)[5] != 512):
        raise AssertionError(f"LHRCNN sampling pools: {pool_call_args(pos)[5]} of "
                             f"{tuple(pos[0].shape)}, {pool_call_args(neg)[5]} of "
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
    6818]; [20, 500]) and the negative pool forced to run out, its row 0
    continued on the card ([32, 6818], 256 picks)."""
    out = {}
    for key, what, args in (
            ("positive_pool", "LHRCNN's positive pool (per-row boxes, cap 128)",
             train["pos_args"]),
            ("negative_pool", "LHRCNN's negative pool (cap 256)", train["neg_args"]),
            ("proposal_pool", "LHRCNN's proposal pool (500 picks)", serve["kernel_args"]),
            ("class_rows", "LHRCNN's class rows", serve["class_args"])):
        out[key] = pool_site(args)
        log_pool(what, out[key])
    neg_scores = train["neg_args"][1]
    out["run_out_continuation"] = pool_run_out("LHRCNN negatives", run_out_args(
        train["neg_args"], top=float(neg_scores[0].max()) + 3.0))
    return out


def lhrcnn_records(serve, train, kern, n_requests):
    """LH-RCNN's entries of the kernels' JSON record."""
    s_counts = serve["counts"]
    t_counts = {k: train["rpn"]["counts"][k] + train["rcnn"]["counts"][k]
                for k in s_counts}
    steps = train["rpn"]["steps"] + train["rcnn"]["steps"]
    pool_keys = POOL_KEYS
    nms = {"launches": s_counts["nms_rows"] + t_counts["nms_rows"],
           "launches_per_request": s_counts["nms_rows"] / n_requests,
           "launches_per_step": t_counts["nms_rows"] / steps,
           "launches_by_path": {k: s_counts[k] + t_counts[k]
                                for k in NMS_COUNT_KEYS},
           "proposal_pool_reruns": serve["pool_reruns"],
           "score_threshold": serve["score_threshold"],
           **{key: {k: kern[key][k] for k in pool_keys} for key in (
               "positive_pool", "negative_pool", "proposal_pool", "class_rows")},
           "run_out_continuation": {k: kern["run_out_continuation"][k]
                                    for k in RUN_OUT_KEYS}}
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
        counts = {"assign": assign_kernel.launches, **nms_counts()}
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
    if (counts["assign"] != FEED_STEPS
            or any(counts[k] != FEED_STEPS for k in ("nms_rows", *NMS_KERNELS))):
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
    counts = {**nms_counts(),
              "assign": assign_kernel.launches}
    log(f"evaluate_model on {len(records)} mini-set records: VOC07 mAP {mAP:.6f} over "
        f"{len(aps)} classes, {s_per_image:.4f} s/image on the host clock; kernel "
        f"launches {counts}")
    if not (math.isfinite(mAP) and 0.0 <= mAP <= 1.0):
        raise AssertionError(f"mAP {mAP} must be finite and in [0, 1]")
    if (any(counts[k] != len(records) for k in ("nms_rows", *NMS_KERNELS))
            or counts["assign"]):
        raise AssertionError(f"evaluation must launch one decode pool per image (rows "
                             f"that run out continue on the card) and no assignment: "
                             f"{counts}")
    image, _ = records[0]
    inp, _ = evaluate.eval_preprocess(image, 300, 300)
    x = torch.from_numpy(inp.transpose(2, 0, 1)[None].copy()).to(dev)
    with torch.inference_mode():
        outputs = model.net(model._preprocess(x))
        with_kernel, captured = decode_kernel_vs_plain(model, outputs)
    log(f"evaluation's decode of one image: kernel == plain on the card "
        f"({int(with_kernel[3].sum())} detections)")
    pool = pool_site(captured["args"])
    log_pool("the evaluation's decode pool", pool)
    return dict(mAP=mAP, classes=len(aps), s_per_image=s_per_image, counts=counts,
                images=len(records), decode_pool=pool)


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
    counts = {"assign": assign_kernel.launches, **nms_counts()}
    losses = [float(x) for x in writer.losses]
    rate = RESIDENT_STEPS * TRAIN_BATCH / wall
    log(f"bf16 on the resident set, {what}: {RESIDENT_STEPS} steps, kernel launches "
        f"{counts}, losses {[round(x, 4) for x in losses]}, {rate:.1f} images/s by the "
        f"host clock, {start.elapsed_time(end) / RESIDENT_STEPS:.3f} ms/step by CUDA events")
    if len(losses) != RESIDENT_STEPS or not all(math.isfinite(x) for x in [mean, *losses]):
        raise AssertionError(f"the {what} epoch's losses: {losses}")
    if counts["assign"] != RESIDENT_STEPS or counts["scan"] != RESIDENT_STEPS:
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


# ------------------------------------------------------ data parallelism
DP_WORLD = 2  # ranks sharing the card in (b) and (c)
DP_STEPS = 2  # steps of (a) and (b): the first held at tpudet's bounds, the second at bf16's
DP_TIMED_STEPS = 30
DP_TIMED_REDUCE = 10  # timed flat reductions
DP_PADDED_BATCH = 31  # 31 rows over 2 ranks: padded to 32, the last row masked out
DP_RESIDENT_ROWS = 1000  # phase 17's set cut to 1000 rows
DP_SCAN_STEPS = 4  # (c)'s scanned epoch, then a per-step epoch of
DP_PER_STEP_STEPS = 2  # this many steps from the same distributed set
DP_RESIDENT_SEED = 4
DP_LOSS_RTOL = 2e-4  # tpudet's own tolerances for its 8-device step against
DP_PARAM_ATOL = 5e-4  # its 1-device step (tests/test_distributed.py), after one step
# the second step's loss: the repo's bound for a whole bf16 step
# (tests/test_torch_train.py). Each rank's weight gradients leave its bf16
# convolutions rounded to bf16 before the ranks sum them, where one rank rounds
# the whole batch's sum once, so the ranks' first update differs from one
# rank's by bf16 rounding, and the second loss with it (0.26% on an H100 at
# this config; in float32 on the CPU at batch 4, 2e-5)
DP_BF16_STEP_RTOL = 1e-2
DP_TIMEOUT_S = 900


def tf32_off():
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def dp_model(batch, images, gt, n_steps):
    """SSD300 at the training config (bf16) at ``batch``, fed ``(images, gt)``."""
    from tpudet_torch.models.ssd import SSD300

    return SSD300(train_config("bfloat16", batch), feed((images, gt), n_steps, batch))


def dp_steps(model, n_steps, lr=0.01):
    """``n_steps`` steps through ``train_one_epoch``: each step's loss."""
    model.num_train = n_steps * model.batch_size
    writer = StepLog()
    model.train_one_epoch(lr, writer)
    return [float(x) for x in writer.losses]


def dp_state(model):
    """The net's parameters and BatchNorm statistics and the velocities, on
    the CPU."""
    return {**{k: v.detach().to("cpu", copy=True) for k, v in model.net.state_dict().items()},
            **{f"velocity/{k}": v.to("cpu", copy=True) for k, v in model.velocity.items()}}


def dp_digest(state) -> str:
    """A digest of the state's bytes (float32 tensors)."""
    import hashlib

    digest = hashlib.sha256()
    for k in sorted(state):
        digest.update(state[k].numpy().tobytes())
    return digest.hexdigest()


def host_ms(fn, reps):
    """Host ms a call of ``fn()`` over ``reps`` calls, ended by a sync."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps


def reduce_ms(model, reps=DP_TIMED_REDUCE):
    """The step's reductions alone: the flat one (the gradients, one buffer
    like the parameters, and the loss), by CUDA events and by the host
    clock, and the floats it sums; and one BatchNorm's ([2, 512]: Σx and Σx²
    of its widest layer), by the host clock over 100 calls, with the number
    of BatchNorms (each reduces once forward and once backward)."""
    import torch

    from tpudet_torch.nn.layers import BatchNorm
    from tpudet_torch.runtime import mesh as mesh_lib

    like = [torch.zeros_like(p) for p in model.net.parameters()] + [
        torch.zeros((), device=model.device)]
    stats = torch.zeros((2, 512), device=model.device)
    with mesh_lib.over(model.mesh):
        bn_ms = host_ms(lambda: mesh_lib.all_reduce_sum(stats), 100)
    return dict(ms=event_ms(lambda: mesh_lib.reduce_flat(model.mesh, like), reps),
                host_ms=host_ms(lambda: mesh_lib.reduce_flat(model.mesh, like), reps),
                floats=sum(t.numel() for t in like), batchnorm_host_ms=bn_ms,
                batchnorms=sum(isinstance(m, BatchNorm) for m in model.net.modules()))


def dp_one_rank(dev, images, gt, phase4):
    """19 (a). The step without a process group, then ``mesh.initialize`` with
    one rank on NCCL and the same model through the group: ``DP_STEPS``
    steps equal bit for bit (losses, parameters, BatchNorm statistics,
    velocities); then epochs of ``DP_TIMED_STEPS`` timed steps in turns
    without and with the group (without, with, with, without), a profiled
    step of each, and the flat reduction's time."""
    import tempfile

    import numpy as np
    import torch

    from tpudet_torch.runtime import mesh as mesh_lib

    plain = dp_model(TRAIN_BATCH, images, gt, DP_STEPS)
    if plain.mesh.group is not None or plain.mesh.world != 1:
        raise AssertionError(f"a model without a group must be one rank: {plain.mesh}")
    plain_losses = [x for _ in range(DP_STEPS) for x in dp_steps(plain, 1)]
    want = dp_state(plain)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        mesh_lib.initialize("nccl", init_method=f"file://{tmp}/store", world_size=1,
                            rank=0, device=dev)
        try:
            model = dp_model(TRAIN_BATCH, images, gt, DP_STEPS)
            if (model.mesh.group is None or model.mesh.world != 1
                    or torch.distributed.get_backend() != "nccl"):
                raise AssertionError(f"the model is not on the one-rank NCCL group: "
                                     f"{model.mesh}")
            losses = dp_steps(model, 1)
            first = dp_state(model)
            losses += [x for _ in range(DP_STEPS - 1) for x in dp_steps(model, 1)]
            got = dp_state(model)
            differ = [k for k in want if not torch.equal(got[k], want[k])]
            if losses != plain_losses or differ:
                raise AssertionError(f"one NCCL rank differs from no group: losses "
                                     f"{losses} vs {plain_losses}, {len(differ)} of "
                                     f"{len(want)} tensors differ ({differ[:5]})")
            log(f"19a. one rank on NCCL == no group, bit for bit, over {DP_STEPS} bf16 "
                f"steps: losses {losses}, all {len(want)} parameters, BatchNorm "
                f"statistics and velocities")
            turns = {"no_group": [], "group": []}
            for name in ("no_group", "group", "group", "no_group"):
                m = plain if name == "no_group" else model
                m.num_train = DP_TIMED_STEPS * TRAIN_BATCH
                run = run_epoch(m, images, gt, warmup=0)
                if (run["counts"]["assign"] != DP_TIMED_STEPS
                        or run["counts"]["scan"] != DP_TIMED_STEPS
                        or not all(np.isfinite(run["losses"]))):
                    raise AssertionError(f"19a's timed steps ({name}): {run}")
                turns[name].append({k: run[k] for k in (
                    "images_per_s", "step_ms", "counts", "steps")})
            timed = turns["group"][0]
            profiles = {name: profile_step(m, images, gt)
                        for name, m in (("no_group", plain), ("group", model))}
            red = reduce_ms(model)
        finally:
            mesh_lib.shutdown()
    del model, plain
    torch.cuda.empty_cache()
    card = card_line()
    log(f"19a. epochs of {DP_TIMED_STEPS} bf16 steps at batch {TRAIN_BATCH} in turns "
        f"(without a group, on one NCCL rank twice, without): "
        + "; ".join(f"{name} {[round(t['images_per_s'], 1) for t in turns[name]]} images/s "
                    f"by the host clock, {[round(t['step_ms'], 3) for t in turns[name]]} "
                    f"ms/step by CUDA events, a profiled step {profiles[name]['wall_ms']:.3f} "
                    f"ms, busy {profiles[name]['busy_ms']} ms" for name in turns)
        + f"; phase 4: {phase4['images_per_s']:.1f} images/s, {phase4['step_ms']:.3f} "
        f"ms/step; the flat reduction of {red['floats']} float32 values: "
        f"{red['ms']:.4f} ms a step on the card ({red['host_ms']:.4f} ms by the host "
        f"clock); one BatchNorm's reduction {red['batchnorm_host_ms']:.4f} ms by the host "
        f"clock, {2 * red['batchnorms']} a step [{card}]")
    return dict(losses=losses, first=first, state=got, timed=timed, turns=turns,
                profiles=profiles, reduce=red, card=card,
                phase4={k: phase4[k] for k in ("images_per_s", "step_ms")})


def dp_spy(captured):
    """Record each call's inputs of the assignment and NMS kernels' wrappers
    on this rank, through the real wrappers. Returns the undo."""
    from tpudet_torch.ops.cuda import assign_kernel, nms_kernel

    real = (assign_kernel.assign_anchors, nms_kernel.nms_rows)

    def spy(key, fn):
        def call(*a):
            captured.append((key, a))
            return fn(*a)
        return call

    assign_kernel.assign_anchors = spy("assign", real[0])
    nms_kernel.nms_rows = spy("nms_rows", real[1])

    def undo():
        assign_kernel.assign_anchors, nms_kernel.nms_rows = real
    return undo


def dp_kernels_vs_plain(captured):
    """Each captured call's kernel against its plain version on the same
    inputs, exactly; the number of calls held."""
    from tpudet_torch.ops import matching
    from tpudet_torch.ops.cuda import assign_kernel, nms_kernel

    for key, args in captured:
        if key == "assign":
            ok = assign_equal(assign_kernel.assign_anchors(*args), matching.assign_plain(*args))
        else:
            ok = nms_equal(nms_kernel.nms_rows(*args), nms_kernel.plain_rows(*args))
        if not ok:
            raise AssertionError(f"the {key} kernel differs from its plain version on "
                                 f"this rank's inputs {[tuple(a.shape) for a in args if hasattr(a, 'shape')]}")
    return len(captured)


def dp_two_rank_step(rank):
    """19 (b), one rank: ``DP_STEPS`` bf16 steps of the training config at
    batch 32 (16 rows here) from the seeded weights, one at a time, the
    kernels' launches counted and their inputs captured; the state after
    the first and the last (rank 0); then 3 steps timed on the host clock
    and the flat reduction alone; then batch 31, padded to 32."""
    import numpy as np
    import torch

    from tpudet_torch.runtime import mesh as mesh_lib

    from tpudet_torch import device as device_lib

    tf32_off()
    images, gt = train_batch()
    model = dp_model(TRAIN_BATCH, images, gt, DP_STEPS)
    if model.mesh.world != DP_WORLD or not device_lib.same(model.device,
                                                           mesh_lib.local_device()):
        raise AssertionError(f"rank {rank}: {model.mesh} on {model.device}, not on "
                             f"{mesh_lib.local_device()}")
    captured = []
    undo = dp_spy(captured)
    try:
        reset_kernel_counts()
        losses = dp_steps(model, 1)
        first = dp_state(model) if rank == 0 else None
        losses += [x for _ in range(DP_STEPS - 1) for x in dp_steps(model, 1)]
        counts = kernel_counts()
    finally:
        undo()
    checked = dp_kernels_vs_plain(captured)
    state = dp_state(model)
    torch.cuda.synchronize()
    t = time.perf_counter()
    dp_steps(model, 3)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / 3
    red = reduce_ms(model, reps=3)
    del model
    padded = dp_model(DP_PADDED_BATCH, images[:DP_PADDED_BATCH], gt[:DP_PADDED_BATCH], 1)
    weight = padded._sample_weight()
    padded_losses = dp_steps(padded, 1)
    if padded.device_batch != TRAIN_BATCH or not np.isfinite(padded_losses).all():
        raise AssertionError(f"rank {rank}: batch {DP_PADDED_BATCH} gave device batch "
                             f"{padded.device_batch}, losses {padded_losses}")
    return dict(losses=losses, counts=counts, checked=checked, first=first,
                state=state if rank == 0 else None, digest=dp_digest(state),
                step_ms=step_ms, reduce=red, padded_losses=padded_losses,
                padded_digest=dp_digest(dp_state(padded)),
                padded_weight=weight.cpu().numpy().tolist(), card=card_line())


def dp_resident_rank(rank):
    """19 (c), one rank: phase 17's set cut to ``DP_RESIDENT_ROWS`` rows in a
    ``DeviceDataset`` distributed over the ranks, SSD300 with the device
    augmentation, one scanned epoch of ``DP_SCAN_STEPS`` steps, then a
    per-step epoch of ``DP_PER_STEP_STEPS``; the row ids stamped in each
    gathered batch, the kernels' launches in each epoch."""
    import torch

    from tpudet_torch.data.device_dataset import DeviceDataset
    from tpudet_torch.runtime import mesh as mesh_lib

    tf32_off()
    images, gt = resident_arrays()
    images, gt = images[:DP_RESIDENT_ROWS], gt[:DP_RESIDENT_ROWS]
    ds = DeviceDataset(images, gt, TRAIN_BATCH, seed=DP_RESIDENT_SEED)
    model = resident_model(mesh_lib.local_device(), ds)
    model.num_train = DP_SCAN_STEPS * TRAIN_BATCH
    ds.distribute(model.mesh, model.device_batch)
    gathered = []
    gather = ds.gather

    def spy(idx):
        out = gather(idx)
        gathered.append(stamped_rows(out[0]).tolist())
        return out

    ds.gather = spy
    writer = StepLog()
    stamps = []
    add = writer.add_summary
    writer.add_summary = lambda loss, global_step: (stamps.append(time.perf_counter()),
                                                    add(loss, global_step))
    reset_kernel_counts()
    t = time.perf_counter()
    model.train_one_epoch(0.01, writer)
    torch.cuda.synchronize()
    counts = kernel_counts()
    # the gaps between the steps' writes are the host's times a step (no
    # host sync in the step; the card can lag up to the loss window's read);
    # the first step is the process's first and is left out
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    paths = [model.last_epoch]
    model.config = dict(model.config, no_scan_epoch=True)
    model.num_train = DP_PER_STEP_STEPS * TRAIN_BATCH
    reset_kernel_counts()
    model.train_one_epoch(0.01, writer)
    paths.append(model.last_epoch)
    return dict(rows=gathered, losses=[float(x) for x in writer.losses], paths=paths,
                counts=[counts, kernel_counts()], n_shard=ds.n_shard,
                digest=dp_digest(dp_state(model)), step_ms=step_ms,
                first_ms=(stamps[0] - t) * 1e3)


def dp_expected_rows(rank):
    """The rows a CPU ``DeviceDataset`` of the same size and seed assigns to
    ``rank`` of ``DP_WORLD`` over ``DP_SCAN_STEPS`` scanned steps, then
    ``DP_PER_STEP_STEPS`` steps drawn one at a time (each epoch after a
    ``reset``, as ``train_one_epoch`` does)."""
    import numpy as np

    from tpudet_torch.data.device_dataset import DeviceDataset
    from tpudet_torch.runtime import mesh as mesh_lib

    n = DP_RESIDENT_ROWS
    cpu = DeviceDataset(np.zeros((n, 1, 1, 3), np.uint8), np.zeros((n, 1, 5), np.float32),
                        TRAIN_BATCH, seed=DP_RESIDENT_SEED, device="cpu")
    cpu.distribute(mesh_lib.Mesh(DP_WORLD, rank), TRAIN_BATCH)
    block = np.arange(rank * cpu.n_shard, (rank + 1) * cpu.n_shard) % n
    cpu.reset()
    idx = [*cpu.scan_indices(DP_SCAN_STEPS).numpy()]
    cpu.reset()
    idx += [cpu.next_indices(1)[0] for _ in range(DP_PER_STEP_STEPS)]
    return block[np.stack(idx)].tolist()


def phase_data_parallel(dev, phase4):
    """19. data parallelism at the training config: (a) one rank on NCCL,
    bit for bit the step without a group, then timed; (b) two ranks sharing
    the card on gloo against (a); (c) the distributed resident feed on two
    ranks."""
    import tempfile

    import numpy as np
    import torch

    from tpudet_torch.runtime import mesh as mesh_lib

    t0 = time.perf_counter()
    images, gt = train_batch()
    one = dp_one_rank(dev, images, gt, phase4)
    build = Path(__file__).resolve().parent / "build"
    devices = [f"cuda:{torch.cuda.current_device()}"] * DP_WORLD
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        t = time.perf_counter()
        two = mesh_lib.launch(dp_two_rank_step, DP_WORLD, tmp, backend="gloo",
                              devices=devices, timeout=DP_TIMEOUT_S)
        two_s = time.perf_counter() - t
        t = time.perf_counter()
        res = mesh_lib.launch(dp_resident_rank, DP_WORLD, tmp, backend="gloo",
                              devices=devices, timeout=DP_TIMEOUT_S)
        res_s = time.perf_counter() - t
    # (b) against (a)
    if len({r["digest"] for r in two}) != 1:
        raise AssertionError("the two ranks' parameters differ")
    if len({r["padded_digest"] for r in two}) != 1:
        raise AssertionError("the two ranks' parameters differ after the padded batch")
    for r in two:
        c = r["counts"]
        if (c["assign"], c["nms_rows"], c["scan"]) != (DP_STEPS,) * 3 or \
                r["checked"] != 2 * DP_STEPS:
            raise AssertionError(f"a rank's {DP_STEPS} steps launched {c}, "
                                 f"{r['checked']} calls held against the plain versions")
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(two[0]["losses"], one["losses"])]
    if loss_rel[0] > DP_LOSS_RTOL or max(loss_rel) > DP_BF16_STEP_RTOL:
        raise AssertionError(f"two ranks' losses {two[0]['losses']} vs one rank's "
                             f"{one['losses']}: rel {loss_rel}")
    params = [k for k in one["state"] if not k.startswith("velocity/")
              and not k.endswith((".mean", ".var"))]

    def max_abs(a, b, keys):
        return max(float((a[k] - b[k]).abs().max()) for k in keys)

    worst = max_abs(two[0]["first"], one["first"], params)
    if worst > DP_PARAM_ATOL:
        raise AssertionError(f"two ranks' parameters after a step are {worst} from one "
                             f"rank's")
    worst_last = max_abs(two[0]["state"], one["state"], params)
    if two[0]["padded_weight"] + two[1]["padded_weight"] != (
            [1.0] * DP_PADDED_BATCH + [0.0] * (TRAIN_BATCH - DP_PADDED_BATCH)):
        raise AssertionError(f"the padded batch's mask: {[r['padded_weight'] for r in two]}")
    stats = [k for k in one["state"] if k.endswith((".mean", ".var"))]
    stat_worst = max_abs(two[0]["first"], one["first"], stats)
    log(f"19b. two ranks on cuda:0 over gloo, 16 rows each: losses {two[0]['losses']} "
        f"vs one rank's {one['losses']} (rel {loss_rel}, bounds {DP_LOSS_RTOL} for the "
        f"first, {DP_BF16_STEP_RTOL} after a bf16 update); {len(params)} parameters "
        f"within {worst:.2e} of one rank's after the first step (bound {DP_PARAM_ATOL}), "
        f"{worst_last:.2e} after step {DP_STEPS}; BatchNorm statistics within "
        f"{stat_worst:.2e} after the first; ranks bitwise equal; each rank launched "
        f"{two[0]['counts']} in {DP_STEPS} steps, every call == the plain version on its "
        f"inputs; batch {DP_PADDED_BATCH} padded to {TRAIN_BATCH}, losses "
        f"{[r['padded_losses'] for r in two]}, ranks equal; a step "
        f"{[round(r['step_ms'], 1) for r in two]} ms by the host clock, the flat "
        f"reduction {[round(r['reduce']['host_ms'], 1) for r in two]} ms of it, a "
        f"BatchNorm's {[round(r['reduce']['batchnorm_host_ms'], 3) for r in two]} ms; "
        f"{two_s:.1f} s with the spawns [{two[0]['card']}]")
    # (c)
    for r, rank in enumerate(res):
        want = dp_expected_rows(r)
        if rank["rows"] != want:
            raise AssertionError(f"rank {r} gathered rows that a CPU dataset of the same "
                                 f"seed does not assign it")
        steps = [DP_SCAN_STEPS, DP_PER_STEP_STEPS]
        if (rank["paths"] != ["scanned", "per-step"]
                or not np.isfinite(rank["losses"]).all()
                or len(rank["losses"]) != sum(steps)
                or [(c["assign"], c["scan"]) for c in rank["counts"]]
                != [(s, s) for s in steps]):
            raise AssertionError(f"rank {r}'s resident epochs: {rank}")
    if len({r["digest"] for r in res}) != 1:
        raise AssertionError("the resident epoch's ranks differ")
    log(f"19c. the resident set's first {DP_RESIDENT_ROWS} rows distributed over "
        f"{DP_WORLD} ranks ({res[0]['n_shard']} a rank): {DP_SCAN_STEPS} scanned steps, "
        f"then {DP_PER_STEP_STEPS} per step, each rank's gathered rows == a CPU "
        f"dataset's, losses {res[0]['losses']}, ranks "
        f"equal, launches {[r['counts'] for r in res]}; the first step "
        f"{[round(r['first_ms'], 1) for r in res]} ms, then "
        f"{[[round(x, 1) for x in r['step_ms']] for r in res]} ms a step by the host clock; "
        f"{res_s:.1f} s with the spawns; phase 19 took "
        f"{time.perf_counter() - t0:.1f} s [{one['card']}]")
    return dict(one_rank={k: one[k] for k in ("losses", "timed", "turns", "profiles",
                                              "phase4", "reduce")},
                two_ranks={"losses": two[0]["losses"], "loss_rel": loss_rel,
                           "param_max_abs_first": worst,
                           "param_max_abs_last": worst_last,
                           "stat_max_abs_first": stat_worst,
                           "counts": [r["counts"] for r in two],
                           "step_ms": [r["step_ms"] for r in two],
                           "reduce": [r["reduce"] for r in two],
                           "padded_losses": [r["padded_losses"] for r in two],
                           "seconds": two_s},
                resident={"losses": [r["losses"] for r in res],
                          "counts": [r["counts"] for r in res],
                          "step_ms": [r["step_ms"] for r in res],
                          "first_ms": [r["first_ms"] for r in res], "seconds": res_s},
                card=one["card"])


# ------------------------------------------------------ the user's entry points
ENTRY_SEED = 18
BENCH_STEPS = 30  # bench_torch's protocol: 2 warm-up steps, 30 timed steps
DRIVER_BATCH = 2
DRIVER_RECORDS = 8  # the mini VOC set: one epoch of 4 steps


def kernel_counts() -> dict:
    from tpudet_torch.ops.cuda import assign_kernel, nms_kernel

    return {**nms_counts(), "assign": assign_kernel.launches}


def reset_kernel_counts():
    from tpudet_torch.ops.cuda import assign_kernel

    reset_nms_counts()
    assign_kernel.launches = 0


def entry_vs_cpu(dev):
    """``entry()`` on the card: an eval-mode net there, run on its example
    args and on a seeded image, each within 1e-4 of the same net on the CPU
    (``entry(device="cpu")``: the same seed, so the same weights)."""
    import numpy as np
    import torch

    import entry_torch

    fn, (arg,) = entry_torch.entry()
    if fn.training or next(fn.parameters()).device.type != dev.type or arg.device != \
            next(fn.parameters()).device or tuple(arg.shape) != (1, 3, 300, 300):
        raise AssertionError("entry() must give an eval-mode net and a [1, 3, 300, 300] "
                             "input on the card")
    cpu_fn, _ = entry_torch.entry(device="cpu")
    image = torch.from_numpy(np.random.default_rng(ENTRY_SEED).normal(
        0, 60, (1, 3, 300, 300)).astype(np.float32))
    worst, shapes = 0.0, None
    with torch.inference_mode():
        for x in (arg, image.to(dev)):
            got, want = fn(x), cpu_fn(x.cpu())
            shapes = [list(g.shape) for g in got]
            worst = max([worst] + [float((g.cpu() - w).abs().max())
                                   / max(float(w.abs().max()), 1e-30)
                                   for g, w in zip(got, want)])
    if worst > 1e-4:
        raise AssertionError(f"entry() on the card vs the CPU: rel err {worst}")
    log(f"entry(): SSD300's net on {dev}, outputs {shapes}; against the CPU on the "
        f"example args and a seeded image: max |diff| / max |value| {worst:.2e}")
    return dict(shapes=shapes, max_rel_err=worst)


def bench_on_card():
    """``bench_torch.main()`` at its protocol (batch 32, 30 timed steps, a
    scanned epoch of 30 after a warm one); it prints its JSON line. Both
    kernels launch once a step: 2 + 30 + 2 x 30 launches each."""
    import bench_torch

    reset_kernel_counts()
    t0 = time.perf_counter()
    result = bench_torch.main(batch=TRAIN_BATCH, steps=BENCH_STEPS)
    seconds = time.perf_counter() - t0
    counts = kernel_counts()
    steps = 2 + BENCH_STEPS + 2 * max(BENCH_STEPS, 20)
    if result["scan_epoch_imgs_per_sec"] is None:
        raise AssertionError("the bench's scanned epoch failed")
    if counts["nms_rows"] != steps or counts["assign"] != steps:
        raise AssertionError(f"the bench's {steps} steps launched {counts}")
    log(f"bench_torch: {result['value']} images/s a step, "
        f"{result['scan_epoch_imgs_per_sec']} scanned, on {result['device']}; "
        f"{steps} steps launched the NMS kernel {counts['nms_rows']} times "
        f"({counts['scan']} sorted scans) and the assignment kernel "
        f"{counts['assign']} times; {seconds:.1f} s")
    return dict(result=result, counts=counts, steps=steps, seconds=seconds)


def driver_on_card(dev):
    """The mini VOC set through ``drivers_torch/test_voc_utils.py`` (run as a
    user runs it, in a directory holding ``VOC2007/``), then one epoch of
    ``drivers_torch/_common.run`` with ``drivers_torch/testSSD300.py``'s
    config at batch 2 without ``vgg_16.ckpt``: one assignment and one mining
    pool a step, a finite epoch loss, a ``.pt`` checkpoint."""
    import importlib.util
    import io
    import runpy
    import tempfile

    import numpy as np

    from drivers_torch import _common
    from tpudet_torch.models import SSD300

    repo = Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location("_driver_ssd300",
                                                  repo / "drivers_torch" / "testSSD300.py")
    driver = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(driver)
    build = repo / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp, contextlib.chdir(tmp):
        tmp = Path(tmp)
        (tmp / "VOC2007").mkdir()
        for sub in ("Annotations", "JPEGImages"):
            (tmp / "VOC2007" / sub).symlink_to(voc_mini() / sub)
        with contextlib.redirect_stdout(io.StringIO()):
            runpy.run_path(str(repo / "drivers_torch" / "test_voc_utils.py"),
                           run_name="__main__")
        shards = sorted(p.name for p in (tmp / "data").iterdir())
        config = dict(driver.config, batch_size=DRIVER_BATCH, pretraining_weight=None)
        reset_kernel_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            model = _common.run(SSD300, config, driver.image_augmentor_config,
                                [300, 300, 3], data_dir="./data/",
                                num_train=DRIVER_RECORDS, batch_size=DRIVER_BATCH,
                                epochs=1, lr=driver.lr, save_path="./ssd/test")
        seconds = time.perf_counter() - t0
        counts = kernel_counts()
        steps = DRIVER_RECORDS // DRIVER_BATCH
        ckpt = tmp / "ssd" / f"test-{steps}.pt"
        (line,) = [ln for ln in out.getvalue().splitlines()
                   if ln.startswith(">> mean loss")]
        loss = float(line.split()[-1])
        if model.device.type != dev.type or model.global_step != steps:
            raise AssertionError(f"the driver trained {model.global_step} steps on "
                                 f"{model.device}; {steps} on the card expected")
        if counts["nms_rows"] != steps or counts["assign"] != steps:
            raise AssertionError(f"the driver's {steps} steps launched {counts}")
        if not np.isfinite(loss) or not ckpt.is_file():
            raise AssertionError(f"the driver's epoch: loss {loss}, checkpoint "
                                 f"{ckpt.is_file()}")
        size = ckpt.stat().st_size
    log(f"drivers_torch: test_voc_utils wrote {shards}; _common.run trained SSD300 "
        f"bf16 at batch {DRIVER_BATCH} for {steps} steps on {model.device} in {seconds:.1f} s "
        f"(the host feed included), epoch loss {loss:.4f}, launches {counts}, "
        f"checkpoint {ckpt.name} of {size} bytes")
    return dict(shards=shards, steps=steps, mean_loss=loss, counts=counts,
                seconds=seconds, checkpoint_bytes=size)


def phase_entry_points(dev):
    """18. the user's entry points: entry(), the bench and a driver."""
    import torch

    t0 = time.perf_counter()
    entry = entry_vs_cpu(dev)
    bench = bench_on_card()
    torch.cuda.empty_cache()
    driver = driver_on_card(dev)
    torch.cuda.empty_cache()
    log(f"phase 18 took {time.perf_counter() - t0:.1f} s")
    return dict(entry=entry, bench=bench, driver=driver)


def entry_point_record(entry_points, key):
    """A kernel's launches on phase 18's bench and driver runs."""
    return {name: {"launches": entry_points[name]["counts"][key],
                   "launches_per_step": (entry_points[name]["counts"][key]
                                         / entry_points[name]["steps"])}
            for name in ("bench", "driver")}


def data_parallel_record(dp, key):
    """A kernel's launches in phase 19: (a)'s timed steps, and each rank's of
    (b)'s compared steps and (c)'s scanned epoch."""
    return {"one_rank_nccl": {"launches": dp["one_rank"]["timed"]["counts"][key],
                              "launches_per_step": (dp["one_rank"]["timed"]["counts"][key]
                                                    / DP_TIMED_STEPS)},
            "two_ranks_gloo": {"launches_per_rank": [c[key] for c in dp["two_ranks"]["counts"]],
                               "launches_per_step": [c[key] / DP_STEPS
                                                     for c in dp["two_ranks"]["counts"]]},
            "resident_two_ranks": {
                "launches_per_rank": [sum(c[key] for c in rank)
                                      for rank in dp["resident"]["counts"]],
                "launches_per_step": [sum(c[key] for c in rank)
                                      / (DP_SCAN_STEPS + DP_PER_STEP_STEPS)
                                      for rank in dp["resident"]["counts"]]}}


# ------------------------------------------------- the convergence protocol
PROTOCOL_NAME = "RefineDet320"  # the spec with host_feed and gt_pad 24
PROTOCOL_TRAIN = 256  # rendered synthvoc scenes at the spec's 320x320
PROTOCOL_TEST = 16
PROTOCOL_STEPS = 60  # the spec's schedule scaled to 60 steps: chunks of 3, 42, 12, 3
PROTOCOL_CKPT_EVERY = 40  # one periodic checkpoint, at step 45
PROTOCOL_EVAL_EVERY = 10  # mid-run evaluations at steps 45 and 57
PROTOCOL_FEED_BATCHES = 10  # batches of the host feed timed alone
PROTOCOL_GT_PAD = 24


def load_script(name: str):
    """``scripts/{name}.py`` as a module of its own (``_{name}``)."""
    import importlib.util

    path = Path(__file__).resolve().parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def protocol_script():
    return load_script("train_convergence_torch")


def protocol_state(model):
    """The model's parameters and BatchNorm statistics, velocity and
    ``global_step``, copied to the host."""
    return dict(state={k: v.detach().cpu().clone() for k, v in model.net.state_dict().items()},
                velocity={k: v.detach().cpu().clone()
                          for k, v in (model.velocity or {}).items()},
                global_step=model.global_step)


def protocol_states_equal(got, want) -> bool:
    import torch

    return (got["global_step"] == want["global_step"]
            and got["state"].keys() == want["state"].keys()
            and got["velocity"].keys() == want["velocity"].keys()
            and all(got[part][k].dtype == want[part][k].dtype
                    and torch.equal(got[part][k], want[part][k])
                    for part in ("state", "velocity") for k in want[part]))


def protocol_hooks(tc, saved, loaded, models):
    """Make ``tc._load_class`` give a subclass that records the state at
    each ``save_weight`` (by the file's ``path-step``) and after each
    ``load_weight``, and each model built. Returns the undo."""
    real = tc._load_class

    def load_class(path):
        cls = real(path)

        class Recorded(cls):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                models.append(self)

            def save_weight(self, mode, path):
                super().save_weight(mode, path)
                saved[f"{path}-{self.global_step}"] = protocol_state(self)

            def load_weight(self, path):
                super().load_weight(path)
                loaded.append(protocol_state(self))

        Recorded.__name__ = cls.__name__
        return Recorded

    tc._load_class = load_class

    def undo():
        tc._load_class = real
    return undo


def protocol_spy(captured, evaluations):
    """Record each call's inputs of both kernels' wrappers as ``(key, args,
    evaluating)`` (whether ``evaluate_model`` made it), and the kernels'
    launches in each call of ``evaluate_model``. Returns the undo."""
    from tpudet_torch.ops.cuda import assign_kernel, nms_kernel
    from tpudet_torch.runtime import evaluate

    real = (assign_kernel.assign_anchors, nms_kernel.nms_rows, evaluate.evaluate_model)
    state = {"evaluating": False}

    def spy(key, fn):
        def call(*a):
            captured.append((key, a, state["evaluating"]))
            return fn(*a)
        return call

    def evaluate_model(model, records, *args, **kwargs):
        before = kernel_counts()
        state["evaluating"] = True
        try:
            out = real[2](model, records, *args, **kwargs)
        finally:
            state["evaluating"] = False
        after = kernel_counts()
        evaluations.append(dict(images=len(records),
                                counts={k: after[k] - before[k] for k in after}))
        return out

    assign_kernel.assign_anchors = spy("assign", real[0])
    nms_kernel.nms_rows = spy("nms_rows", real[1])
    evaluate.evaluate_model = evaluate_model

    def undo():
        assign_kernel.assign_anchors, nms_kernel.nms_rows, evaluate.evaluate_model = real
    return undo


def protocol_feed_alone(tc, images, gt):
    """Images/s of ``MemmapFeeder`` alone over ``PROTOCOL_FEED_BATCHES``
    batches, from its construction (the producer thread included)."""
    t = time.perf_counter()
    feeder = tc.MemmapFeeder(images, gt, TRAIN_BATCH, seed=1)
    try:
        for _ in range(PROTOCOL_FEED_BATCHES):
            b_images, b_gt = next(feeder)
    finally:
        feeder.close()
    seconds = time.perf_counter() - t
    if b_images.shape != (TRAIN_BATCH, *images.shape[1:]) or b_gt.shape[1:] != (
            PROTOCOL_GT_PAD, 5):
        raise AssertionError(f"the host feed gave {b_images.shape}, {b_gt.shape}")
    return PROTOCOL_FEED_BATCHES * TRAIN_BATCH / seconds


def protocol_cut_copy(tc, run_root: Path, cut_root: Path, step: int):
    """A copy of the run as a run cut after its periodic checkpoint at
    ``step`` leaves it: that checkpoint, ``ckpt_meta.json`` of that step and
    the curve up to it; the dataset shared."""
    src = run_root / "torch_runs" / PROTOCOL_NAME
    dst = cut_root / "torch_runs" / PROTOCOL_NAME
    dst.mkdir(parents=True)
    (cut_root / "data").symlink_to(run_root / "data")
    (dst / f"ckpt-{step}.pt").symlink_to(src / f"ckpt-{step}.pt")
    curve = [json.loads(ln) for ln in (src / "curve.jsonl").read_text().splitlines()]
    kept = [c for c in curve if c["step"] <= step]
    (dst / "curve.jsonl").write_text("".join(json.dumps(c) + "\n" for c in kept))
    (dst / "ckpt_meta.json").write_text(json.dumps(
        {"steps": step, "elapsed_s": kept[-1]["elapsed_s"]}))
    return curve


def phase_protocol(dev):
    """20. The convergence script's machinery on the card: ``run_model`` of
    RefineDet320 (``host_feed``, ``gt_pad`` 24) on a small rendered set, the
    spec's schedule scaled to ``PROTOCOL_STEPS`` steps, ``--eval-every``, a
    periodic checkpoint; a resume from it; ``eval_from_checkpoint``."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    tc = protocol_script()
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    saved, loaded, models, captured, evaluations = {}, [], [], [], []
    real_ckpt_every = tc.CKPT_EVERY
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        root = Path(tmp) / "run"
        kwargs = dict(root=str(root), n_train=PROTOCOL_TRAIN, n_test=PROTOCOL_TEST)
        t = time.perf_counter()
        _, (h, w), _, _, total_steps, _ = tc.model_specs()[PROTOCOL_NAME]
        d = tc.synthvoc.build(str(root / "data"), h, w, n_train=PROTOCOL_TRAIN,
                              n_test=PROTOCOL_TEST)
        render_s = time.perf_counter() - t
        train_images, train_gt, _, _ = tc.synthvoc.load(d)
        feed_ips = protocol_feed_alone(tc, train_images, train_gt[:, :PROTOCOL_GT_PAD])
        steps_scale = PROTOCOL_STEPS / total_steps
        undo_hooks = protocol_hooks(tc, saved, loaded, models)
        undo_spy = protocol_spy(captured, evaluations)
        tc.CKPT_EVERY = PROTOCOL_CKPT_EVERY
        try:
            reset_kernel_counts()
            result = tc.run_model(PROTOCOL_NAME, steps_scale=steps_scale,
                                  eval_every=PROTOCOL_EVAL_EVERY, **kwargs)
            counts = kernel_counts()
            run_evals = list(evaluations)
            run_captured = [(key, a) for key, a, in_eval in captured if not in_eval]
            captured.clear()
            # the resume, from a copy of the run as a cut after its checkpoint
            prefix = str(root / "torch_runs" / PROTOCOL_NAME / "ckpt")
            (ckpt_step,) = [int(k.rsplit("-", 1)[1]) for k in saved
                            if int(k.rsplit("-", 1)[1]) < PROTOCOL_STEPS]
            cut_root = Path(tmp) / "cut"
            curve = protocol_cut_copy(tc, root, cut_root, ckpt_step)
            reset_kernel_counts()
            resumed = tc.run_model(PROTOCOL_NAME, steps_scale=steps_scale, resume=True,
                                   **dict(kwargs, root=str(cut_root)))
            resumed_counts = kernel_counts()
            resumed_curve = [json.loads(ln) for ln in (
                cut_root / "torch_runs" / PROTOCOL_NAME / "curve.jsonl").read_text().splitlines()]
            evaluations.clear()
            salvaged = tc.eval_from_checkpoint(PROTOCOL_NAME, **kwargs)
            salvage_evals = list(evaluations)
        finally:
            tc.CKPT_EVERY = real_ckpt_every
            undo_spy()
            undo_hooks()
        run_dir = root / "torch_runs" / PROTOCOL_NAME
        evals = [json.loads(ln) for ln in (run_dir / "eval.jsonl").read_text().splitlines()]
        ckpts = sorted(p.name for p in run_dir.glob("ckpt-*"))

        # the main path's launches: the assignment and the mining pool once a step
        eval_counts = {k: sum(e["counts"][k] for e in run_evals) for k in counts}
        train_counts = {k: counts[k] - eval_counts[k] for k in counts}
        steps = result["steps"]
        if (steps != PROTOCOL_STEPS or train_counts["assign"] != steps
                or any(train_counts[k] != steps for k in ("nms_rows", *NMS_KERNELS))):
            raise AssertionError(f"{steps} steps of the protocol launched {train_counts} "
                                 f"(evaluations {eval_counts} excluded)")
        widths = {int(a[2].shape[1]) for key, a in run_captured if key == "assign"}
        if widths != {PROTOCOL_GT_PAD}:
            raise AssertionError(f"the assignment saw gt widths {widths}, not "
                                 f"{PROTOCOL_GT_PAD}")
        compared = dp_kernels_vs_plain(run_captured)
        if compared != train_counts["assign"] + train_counts["nms_rows"]:
            raise AssertionError(f"{compared} captured calls for {train_counts}")
        # both kernels timed at G = 24 on the first step's inputs
        assign = assign_timing(next(a for key, a in run_captured if key == "assign"))
        mining = pool_site(next(a for key, a in run_captured if key == "nms_rows"))
        log(f"phase 20 assign at G = {PROTOCOL_GT_PAD}: kernel {assign['ms']:.4f} ms "
            f"(device {fmt_ms(assign['device_ms'], 4)} ms), plain {assign['plain_ms']:.4f} "
            f"ms, bound {assign['bound_ms']:.6f} ms ({assign['bound_by']})")
        log_pool(f"{PROTOCOL_NAME}'s mining pool at G = {PROTOCOL_GT_PAD}", mining)
        for e in run_evals + salvage_evals:
            if e["counts"]["assign"] or e["counts"]["nms_rows"] < e["images"]:
                raise AssertionError(f"an evaluation of {e['images']} images launched "
                                     f"{e['counts']}")
        if [e["step"] for e in evals] != [45, 57] or ckpts != ["ckpt-45.pt",
                                                                   "ckpt-60.pt"]:
            raise AssertionError(f"evaluations at {[e['step'] for e in evals]}, "
                                 f"checkpoints {ckpts}")
        # the resume: the state loaded == the state saved, bit for bit
        if len(loaded) != 2 or not protocol_states_equal(loaded[0],
                                                         saved[f"{prefix}-{ckpt_step}"]):
            raise AssertionError(f"the resumed state differs from the one saved at step "
                                 f"{ckpt_step} ({len(loaded)} loads)")
        if not protocol_states_equal(loaded[1], saved[f"{prefix}-{PROTOCOL_STEPS}"]):
            raise AssertionError("eval_from_checkpoint's state differs from the run's "
                                 "final one")
        if ([(c["step"], c["lr"]) for c in resumed_curve]
                != [(c["step"], c["lr"]) for c in curve]):
            raise AssertionError(f"the resumed curve {resumed_curve} is not the run's {curve}")
        resumed_steps = PROTOCOL_STEPS - ckpt_step
        if (resumed["steps"] != PROTOCOL_STEPS
                or resumed_counts["assign"] != resumed_steps):
            raise AssertionError(f"the resume trained to {resumed['steps']} with "
                                 f"{resumed_counts}")
        if salvaged["mAP@0.5_voc07"] != result["mAP@0.5_voc07"]:
            raise AssertionError(f"eval_from_checkpoint's mAP {salvaged['mAP@0.5_voc07']} "
                                 f"!= the run's {result['mAP@0.5_voc07']}")
        losses = [c["mean_loss"] for c in curve]
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"non-finite losses {losses}")

        # one profiled step of the trained model on the host feed
        model = models[0]
        model.train_iterator = tc.MemmapFeeder(train_images,
                                               train_gt[:, :PROTOCOL_GT_PAD],
                                               TRAIN_BATCH, seed=2)
        try:
            model.num_train = TRAIN_BATCH
            model.train_one_epoch(1e-5)  # the feeder's first batch is waited for here
            profile = profile_feed_step(model, 1e-5)
        finally:
            model.train_iterator.close()
        del models[:], model
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    card = card_line()
    log(f"phase 20, {PROTOCOL_NAME} through train_convergence_torch.run_model on "
        f"{PROTOCOL_TRAIN}/{PROTOCOL_TEST} rendered scenes ({render_s:.1f} s to render): "
        f"{steps} steps (curve {[c['step'] for c in curve]}, losses {losses}), "
        f"{train_counts['assign']} assignments and {train_counts['scan']} mining-pool "
        f"pools at G = {PROTOCOL_GT_PAD} ({train_counts['continued']} rows continued), "
        f"{compared} calls == plain; evaluations at {[e['step'] for e in evals]}, mAP "
        f"{[e['mAP@0.5_voc07'] for e in evals]}, launches {[e['counts'] for e in run_evals]}")
    log(f"phase 20: resumed from the checkpoint at step {ckpt_step}, the state bit for "
        f"bit the saved one ({len(loaded[0]['state'])} tensors, "
        f"{len(loaded[0]['velocity'])} velocities, global_step "
        f"{loaded[0]['global_step']}), {resumed_steps} steps more, the curve equal to the "
        f"run's; eval_from_checkpoint mAP {salvaged['mAP@0.5_voc07']} == the run's "
        f"{result['mAP@0.5_voc07']}")
    log(f"phase 20 took {seconds:.1f} s; the host feed alone {feed_ips:.1f} images/s, "
        f"training on it {result['train_imgs_per_sec']} images/s (evaluations included), "
        f"a profiled step {fmt_share(profile['busy_share'])} busy; {card}")
    return dict(seconds=seconds, render_s=render_s, feed_images_per_s=feed_ips,
                train_images_per_s=result["train_imgs_per_sec"], profile=profile,
                steps=steps, counts=train_counts, eval_counts=eval_counts,
                evals=evals, mAP=result["mAP@0.5_voc07"], resumed_counts=resumed_counts,
                resumed_from=ckpt_step, eval_only_mAP=salvaged["mAP@0.5_voc07"],
                compared=compared, assign=assign, mining_pool=mining, card=card)


def protocol_record(protocol, key):
    """A kernel's launches in phase 20's run: its training steps and its
    evaluations (for the NMS kernel, these by design)."""
    record = {"launches": protocol["counts"][key] + protocol["eval_counts"][key],
              "launches_per_step": protocol["counts"][key] / protocol["steps"],
              "eval_launches": protocol["eval_counts"][key]}
    pool = protocol["mining_pool"]
    if key == "assign":
        record.update({k: protocol["assign"][k] for k in ("ms", "device_ms", "plain_ms",
                                                          "bound_ms", "bound_by")})
    elif key in pool["kernels"]:
        record.update(pool["kernels"][key])
    elif key == "nms_rows":
        record["eval_launches_by_path"] = {k: protocol["eval_counts"][k]
                                           for k in NMS_COUNT_KEYS}
        record.update({k: pool[k] for k in POOL_KEYS if k != "kernels"})
    return record


# ------------------------------------- the protocol of the last four families
# spec: the assignment kernel's launches a training step, the NMS pools a
# training step and an evaluated image by design (a row that runs out of its
# pool continues on the card), and the feed; phase 21 runs the first
# four, phase 22 the rest
FAMILY_SPECS = {"LHRCNN": (0, 2, 2, "host"), "YOLOv3-consistent": (0, 0, 1, "resident"),
                "CenterNet": (0, 0, 0, "resident"), "FCOS": (0, 0, 1, "host"),
                "YOLOv3": (0, 0, 1, "resident"), "YOLOv2-consistent": (0, 0, 1, "resident"),
                "RefineDet320-pad60": (1, 1, 1, "host")}
TOPK_AN_IMAGE = {"CenterNet": 1}  # the decode's top K through the select kernel
PHASE21_SPECS = ("LHRCNN", "YOLOv3-consistent", "CenterNet", "FCOS")
PHASE22_SPECS = ("YOLOv3", "YOLOv2-consistent", "RefineDet320-pad60")
CARRY_SPEC = "CenterNet"
CARRY_STEPS = 4  # CenterNet's schedule scaled to 4 steps before its carry copy
FAMILY_TRAIN = 32  # rendered synthvoc scenes at each spec's input size
FAMILY_TEST = 8  # held-out scenes of the one evaluation
FAMILY_STEPS = 6  # the spec's schedule scaled to 6 steps
FAMILY_SIZES = {}  # spec name -> an input (h, w) other than the spec's (a rehearsal's)


def family_run(tc, name, root: Path):
    """``run_model(name)`` on ``FAMILY_TRAIN``/``FAMILY_TEST`` rendered scenes,
    the spec's schedule scaled to ``FAMILY_STEPS`` steps, one evaluation;
    the counts set to 0 just before it and read just after. Every call of
    either kernel (training's and the evaluation's) is then held against
    its plain version; the launches, by design; the feed, the spec's."""
    import torch

    from tpudet_torch.data.device_dataset import DeviceDataset

    assigns_a_step, scans_a_step, scans_an_image, feed = FAMILY_SPECS[name]
    total_steps = tc.model_specs()[name][4]
    captured, evaluations, models = [], [], []
    undo_hooks = protocol_hooks(tc, {}, [], models)
    undo_spy = protocol_spy(captured, evaluations)
    t = time.perf_counter()
    try:
        reset_kernel_counts()
        # the run takes int(total_steps * steps_scale) steps: + 0.5 against rounding down
        result = tc.run_model(name, steps_scale=(FAMILY_STEPS + 0.5) / total_steps,
                              root=str(root), n_train=FAMILY_TRAIN, n_test=FAMILY_TEST,
                              size=FAMILY_SIZES.get(name))
        counts = kernel_counts()
    finally:
        undo_spy()
        undo_hooks()
    seconds = time.perf_counter() - t
    (model,) = models
    feeder = model.train_iterator
    curve = [json.loads(ln) for ln in (root / "torch_runs" / name / "curve.jsonl")
             .read_text().splitlines()]
    losses = [c["mean_loss"] for c in curve]
    (ev,) = evaluations
    train = {k: counts[k] - ev["counts"][k] for k in counts}
    steps = result["steps"]
    if steps != FAMILY_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{name}: {steps} steps, losses {losses}")
    if not 0.0 <= result["mAP@0.5_voc07"] <= 1.0 or ev["images"] != FAMILY_TEST:
        raise AssertionError(f"{name}: mAP {result['mAP@0.5_voc07']} on {ev['images']} "
                             f"images")
    for what, c, n, assigns, scans, tops in (
            ("training", train, steps, assigns_a_step, scans_a_step, 0),
            ("the evaluation", ev["counts"], FAMILY_TEST, 0, scans_an_image,
             TOPK_AN_IMAGE.get(name, 0))):
        if (c["assign"] != assigns * n or c["scan"] != scans * n or c["mask"] != c["scan"]
                or c["nms_rows"] != c["select"] or c["select"] != (scans + tops) * n):
            raise AssertionError(f"{name}: {what} of {n} launched {c}; by design "
                                 f"{scans} NMS pools, {tops} top-K selections and "
                                 f"{assigns} assignments each")
    gt_width = int(feeder.gt.shape[1]) if feed == "host" else None
    gt_pad = tc.model_specs()[name][2].get("gt_pad", gt_width)
    if not isinstance(feeder, tc.MemmapFeeder if feed == "host" else DeviceDataset) or (
            gt_width != gt_pad):
        raise AssertionError(f"{name} was fed by {type(feeder).__name__} (gt width "
                             f"{gt_width}), not the spec's {feed} feed (gt_pad {gt_pad})")
    compared = dp_kernels_vs_plain([(key, a) for key, a, _ in captured])
    if compared != train["scan"] + train["assign"] + ev["counts"]["scan"]:
        raise AssertionError(f"{name}: {compared} calls captured for {train} and "
                             f"{ev['counts']}")
    del models[:], model, feeder
    torch.cuda.empty_cache()
    return dict(steps=steps, curve_steps=[c["step"] for c in curve], losses=losses,
                lrs=[c["lr"] for c in curve], mAP=result["mAP@0.5_voc07"],
                eval_seconds=result["eval_seconds"],
                train_images_per_s=result["train_imgs_per_sec"], seconds=seconds,
                counts=train, eval_counts=ev["counts"], compared=compared,
                input=result["input"], batch=result["batch"], feed=feed, gt_width=gt_width)


def phase_families(dev, names=PHASE21_SPECS, phase=21):
    """21. ``run_model`` of each newly trained spec (``FAMILY_SPECS``) at its
    own input size and feed: LH-RCNN from the host feed with its two NMS
    pools a step, YOLOv3-consistent and CenterNet resident, FCOS from the
    host feed at ``gt_pad`` 24; a few steps each and one evaluation, every
    pool and assignment held against its plain version. Phase 22 runs
    ``PHASE22_SPECS`` the same way."""
    import tempfile

    t0 = time.perf_counter()
    tc = protocol_script()
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    runs = {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        for name in names:
            run = runs[name] = family_run(tc, name, Path(tmp))
            log(f"phase {phase}, {name} ({run['input'][0]}x{run['input'][1]}, batch "
                f"{run['batch']}, {run['feed']} feed, host gt width {run['gt_width']}) "
                f"through run_model: {run['steps']} steps (curve {run['curve_steps']}, lr "
                f"{run['lrs']}, losses {run['losses']}), {run['train_images_per_s']} "
                f"images/s; training launched {run['counts']}; the evaluation of "
                f"{FAMILY_TEST} images {run['eval_counts']} in {run['eval_seconds']} s, "
                f"mAP {run['mAP']}; {run['compared']} calls == plain; "
                f"{run['seconds']:.1f} s")
    seconds = time.perf_counter() - t0
    card = card_line()
    log(f"phase {phase} took {seconds:.1f} s; {card}")
    return dict(seconds=seconds, runs=runs, card=card)


def carry_run(tc, root: Path):
    """``run_model(CARRY_SPEC)`` for ``CARRY_STEPS`` steps on
    ``FAMILY_TRAIN``/``FAMILY_TEST`` rendered scenes, its net's
    ``carry_state`` written and read back into a freshly built model; the
    decodes of the held-out scenes by both, each output equal bit for bit."""
    import numpy as np
    import torch

    from tpudet_torch.runtime import evaluate

    carry_state = load_script("convergence_variants_torch").carry_state
    models = []
    undo = protocol_hooks(tc, {}, [], models)
    t = time.perf_counter()
    try:
        total_steps = tc.model_specs()[CARRY_SPEC][4]
        result = tc.run_model(CARRY_SPEC, steps_scale=(CARRY_STEPS + 0.5) / total_steps,
                              root=str(root), n_train=FAMILY_TRAIN, n_test=FAMILY_TEST,
                              size=FAMILY_SIZES.get(CARRY_SPEC))
    finally:
        undo()
    (trained,) = models
    path = root / "carry.pt"
    torch.save(carry_state(trained.net.state_dict()), path)
    carry = torch.load(path, map_location="cpu")
    kinds = {k: str(v.dtype) for k, v in carry.items()}
    if any(kinds[k] != ("torch.bfloat16" if v.dim() >= 2 else "torch.float32")
           for k, v in carry.items()):
        raise AssertionError(f"carry copy leaves of the wrong type: {kinds}")
    cls, (h, w), config, _, _, _ = tc._spec(CARRY_SPEC, FAMILY_SIZES.get(CARRY_SPEC))
    for k in tc.SCRIPT_KEYS:
        config.pop(k, None)
    provider = {"data_shape": [h, w, 3], "num_train": config["batch_size"], "num_val": 0,
                "train_generator": iter(()), "val_generator": None}
    fresh = cls(config, provider)
    fresh.net.load_state_dict(carry, strict=True)
    d = tc.synthvoc.build(str(root / "data"), h, w, n_train=FAMILY_TRAIN, n_test=FAMILY_TEST)
    equal, detections = 0, 0
    for image, _ in list(tc.synthvoc.test_records(d))[:FAMILY_TEST]:
        inp, _ = evaluate.eval_preprocess(image, h, w)
        want, got = trained.test_one_image(inp[None]), fresh.test_one_image(inp[None])
        if not all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"the carry copy's decode differs from the trained net's: "
                                 f"{got} against {want}")
        equal += 1
        detections += len(want[0])
    steps = result["steps"]
    del models[:], trained, fresh
    torch.cuda.empty_cache()
    return dict(steps=steps, seconds=time.perf_counter() - t, images_equal=equal,
                detections=detections, mAP=result["mAP@0.5_voc07"],
                carry_mib=path.stat().st_size / 2**20,
                bf16_leaves=sum(v == "torch.bfloat16" for v in kinds.values()),
                f32_leaves=sum(v == "torch.float32" for v in kinds.values()))


def phase_carry_and_specs(dev):
    """22. The carry copy of a trained CenterNet decodes as the trained net,
    bit for bit (:func:`carry_run`); then ``PHASE22_SPECS`` through
    :func:`phase_families`."""
    import tempfile

    t0 = time.perf_counter()
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        carry = carry_run(protocol_script(), Path(tmp))
    log(f"phase 22, {CARRY_SPEC}'s carry copy after {carry['steps']} steps: "
        f"{carry['carry_mib']:.1f} MiB, {carry['bf16_leaves']} bfloat16 and "
        f"{carry['f32_leaves']} float32 leaves; the decodes of {carry['images_equal']} "
        f"held-out scenes ({carry['detections']} detections) == the trained net's bit for "
        f"bit; {carry['seconds']:.1f} s")
    families = phase_families(dev, PHASE22_SPECS, 22)
    return dict(seconds=time.perf_counter() - t0, carry=carry, families=families)


def families_record(families, key):
    """A kernel's launches in phase 21's runs: each family's training steps
    and its evaluation (for the NMS kernel, these by design)."""
    runs = families["runs"]
    record = {"launches": sum(r["counts"][key] + r["eval_counts"][key]
                              for r in runs.values())}
    for name, r in runs.items():
        record[name] = {"launches": r["counts"][key] + r["eval_counts"][key],
                        "launches_per_step": r["counts"][key] / r["steps"],
                        "eval_launches_per_image": r["eval_counts"][key] / FAMILY_TEST}
        if key == "nms_rows":
            record[name]["eval_launches_by_path"] = {
                k: r["eval_counts"][k] for k in NMS_COUNT_KEYS}
    return record


# ------------------------------------------------ tpudet's per-model bench
# the two ways a training step launches kernels: SSD300 one assignment and one
# mining pool a step, LH-RCNN (its RPN phase) two NMS pools a step
BENCH_ALL_FAMILIES = ("SSD300", "LHRCNN")
BENCH_ALL_SERVE_SCANS = {"SSD300": 1, "LHRCNN": 2}  # sorted scans a request
BENCH_ALL_REQUESTS = 16  # bench_model's warm request and its 15 timed ones
BENCH_ALL_STEPS = 2 + 6 + 1  # warm-up, timed and the FLOP count's step


def phase_bench_all(dev):
    """23. ``scripts/bench_all_torch.py::bench_model`` of ``BENCH_ALL_FAMILIES``
    at tpudet's bench specs (SSD300 at batch 32, 300x300; LH-RCNN at batch 8,
    700x1100, its RPN phase), each with the counts set to 0 just before it and
    read just after: the bench itself raises unless its timed steps launched
    by design; over the whole call every step and request launched by design
    too (a row that runs out of its pool continues on the card); the first captured
    call of each kernel == its plain version."""
    t0 = time.perf_counter()
    bench = load_script("bench_all_torch")
    runs = {}
    for name in BENCH_ALL_FAMILIES:
        captured = []
        undo = dp_spy(captured)
        t = time.perf_counter()
        try:
            reset_kernel_counts()
            result = bench.bench_model(name, bench._specs()[name], device=dev)
            counts = kernel_counts()
        finally:
            undo()
        seconds = time.perf_counter() - t
        assigns, scans = bench.KERNELS_A_STEP[name]
        want = (assigns * BENCH_ALL_STEPS,
                scans * BENCH_ALL_STEPS + BENCH_ALL_SERVE_SCANS[name] * BENCH_ALL_REQUESTS)
        if (counts["assign"], counts["scan"]) != want or any(
                counts[k] != counts["scan"] for k in ("nms_rows", "select", "mask")):
            raise AssertionError(f"bench_model({name}) launched {counts}; by design "
                                 f"{want[0]} assignments and {want[1]} sorted scans")
        if not result["loss_finite"] or not result["train_step_tflop"] > 0:
            raise AssertionError(f"bench_model({name}): {result}")
        first = {}
        for key, args in captured:
            first.setdefault(key, args)
        compared = dp_kernels_vs_plain(list(first.items()))
        runs[name] = dict(result=result, counts=counts, compared=sorted(first),
                          seconds=seconds)
        log(f"phase 23, bench_model({name}): {result['train_imgs_per_sec']} images/s "
            f"({result['train_step_ms']} ms a step), {result['train_step_tflop']} TFLOP a "
            f"step, MFU {result['mfu_pct']}%, serve p50 {result['infer_p50_ms']} ms, "
            f"build and warm-up {result['compile_plus_warmup_s']} s; timed steps "
            f"launched {result['kernel_launches']}, the whole call {counts}; the first "
            f"call of {', '.join(sorted(first))} == plain ({compared} held); "
            f"{seconds:.1f} s")
    seconds = time.perf_counter() - t0
    card = card_line()
    log(f"phase 23 took {seconds:.1f} s; {card}")
    return dict(seconds=seconds, runs=runs, card=card)


def bench_all_record(bench_all, key):
    """A kernel's launches in phase 23's calls, each family's beside its
    timed steps'."""
    runs = bench_all["runs"]
    record = {"launches": sum(r["counts"][key] for r in runs.values())}
    for name, r in runs.items():
        timed = r["result"]["kernel_launches"]
        record[name] = {"launches": r["counts"][key],
                        "timed_steps": timed["steps"],
                        "timed_launches": timed["assign"] if key == "assign" else
                        timed["nms_continue"] if key == "continue" else timed["nms_scan"]}
        if key == "nms_rows":
            record[name]["launches_by_path"] = {k: r["counts"][k]
                                                for k in NMS_COUNT_KEYS}
    return record


def phase_sync_free(dev, sites):
    """24. the NMS pool with no host sync: under
    ``torch.cuda.set_sync_debug_mode("error")`` (a synchronising call
    raises) ``ssd_loss`` forward and backward at SSD300's training shapes
    (batch 32, 8828 anchors: the assignment and the mining pool),
    LH-RCNN's ``rpn_select`` at its driver's 700x1100 (batch 32, 6818
    anchors: both sampling pools) and ``per_class_nms`` over SSD300's
    anchors raise nothing, after one warm-up call outside the mode; then
    the main-path pools that phases 2-15 measured (``pool_site``: each also
    held == plain, sync-free and replayed from a CUDA graph there), old
    pool call against new, as one table."""
    import numpy as np
    import torch
    from torch_assign_cases import rand_gt

    from tpudet_torch.heads import lhrcnn as lh
    from tpudet_torch.heads import ssd as ssd_head
    from tpudet_torch.models.ssd import SSD300, _ssd_feat_shapes
    from tpudet_torch.ops import nms as nms_ops

    t0 = time.perf_counter()
    rng = np.random.default_rng(24)
    anc = ssd_head.build_anchors(300, _ssd_feat_shapes(300, SSD300.extra_strides),
                                 device=dev)
    heads = [torch.from_numpy(rng.normal(0, sd, (TRAIN_BATCH, anc.yx.shape[0], c))
                              .astype(np.float32)).to(dev).requires_grad_()
             for sd, c in ((2.0, 21), (0.5, 2), (0.5, 2))]
    gt = torch.from_numpy(rand_gt(rng, TRAIN_BATCH, 60, 10, size=300.0,
                                  n_valid_min=1)).to(dev)
    h, w = LHRCNN_CONFIG["data_shape"][:2]
    lh_anc, keep = lh.build_anchors(-(-h // 32), -(-w // 32), 32.0, h, w, device=dev)
    pconf = torch.from_numpy((2.0 * rng.normal(size=(TRAIN_BATCH, int(keep.sum()), 2)))
                             .astype(np.float32)).to(dev)
    lh_gt = torch.from_numpy(rand_gt(rng, TRAIN_BATCH, 60, 10, size=float(min(h, w)),
                                     n_valid_min=1)).to(dev)
    rows = lh.rpn_rows(pconf, lh_anc, lh_gt)
    corners = torch.cat([anc.y1x1, anc.y2x2], -1).contiguous()
    class_scores = torch.sigmoid(heads[0][0].detach().T[1:]).contiguous()

    def calls():
        loss = ssd_head.ssd_loss(*heads, anc, gt, 21, neg_sel_cap=384)
        torch.autograd.grad(loss, heads)
        lh.rpn_select(rows, lh_anc)
        nms_ops.per_class_nms(corners, class_scores, 0.01, 200, 0.45)

    calls()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        calls()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"phase 24: ssd_loss forward and backward [{TRAIN_BATCH}, {anc.yx.shape[0]}], "
        f"rpn_select [{TRAIN_BATCH}, {lh_anc.yx.shape[0]}] and per_class_nms [20, "
        f"{anc.yx.shape[0]}] ran under the sync debug mode 'error' with no "
        f"synchronising call")
    table = {}
    for site, t in sites.items():
        table[site] = {k: t[k] for k in ("shape", "full_shape", "old_pool_call_ms",
                                         "pool_call_ms", "device_ms", "bound_ms",
                                         "continued")}
        log(f"  {site:28s} {t['shape']} of {t['full_shape']}: old {t['old_pool_call_ms']:.4f} "
            f"ms, new {t['pool_call_ms']:.4f} ms (device {fmt_ms(t['device_ms'])} ms), "
            f"bound {t['bound_ms']:.6f} ms, {t['continued']} rows continued")
    seconds = time.perf_counter() - t0
    card = card_line()
    log(f"phase 24 took {seconds:.1f} s; {card}")
    return dict(seconds=seconds, sync_free=["ssd_loss forward and backward", "rpn_select",
                                            "per_class_nms", "each pool call"],
                sites=table, card=card)


API_MAX_OUT = 20  # drivers/testSSD300.py's nms_max_boxes
API_IOU = 0.45  # and its nms_iou_threshold
API_PRE_TOPK = 200  # tpudet's default nms_pre_topk (tpudet/models/base.py:224)
API_FEW = 150  # candidates of the row that is not truncated
API_REPS = 20
API_LOSS_RTOL = 1e-5


def api_rows(dev, corners):
    """One SSD300 class row on the card: seeded scores over the 8828
    anchors' corners, and two candidate masks, the scores over 0.05 (more
    than ``API_PRE_TOPK``) and the top ``API_FEW``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(25)
    scores = torch.sigmoid(torch.from_numpy(rng.normal(-2.0, 1.5, corners.shape[0])
                                            .astype(np.float32))).to(dev)
    few = scores >= torch.sort(scores, descending=True).values[API_FEW - 1]
    return scores, scores >= 0.05, few


def api_launches(what, counts, want):
    """Raise unless ``counts`` holds the kernels' launches ``want`` (a dict
    over ``NMS_KERNELS``)."""
    got = {k: counts[k] for k in NMS_KERNELS}
    if got != want:
        raise AssertionError(f"phase 25: {what} launched {got}, by design {want}")


def api_loss_cases(rng):
    """``(name, card function, its arguments)`` of the three loss primitives
    and the four per-image losses, on numpy inputs at the drivers' sizes."""
    import numpy as np
    import torch

    from tpudet_torch.heads import centernet as center_head
    from tpudet_torch.heads import fcos as fcos_head
    from tpudet_torch.heads import yolo as yolo_head
    from tpudet_torch.models.yolo import priors_per_head
    from tpudet_torch.ops import losses as loss_ops
    from torch_assign_cases import rand_gt

    def f32(*shape, sd=1.0):
        return torch.from_numpy(rng.normal(0, sd, shape).astype(np.float32))

    def gt(size, g=24):
        return torch.from_numpy(rand_gt(rng, 1, g, 8, size=size, n_valid_min=1)[0])

    v2 = YOLO_CONFIGS["YOLOv2"]
    v3 = YOLO_CONFIGS["YOLOv3"]
    fcos_levels = [(-(-800 // s), -(-1200 // s)) for s in (8, 16, 32, 64, 128)]
    return [
        ("softmax_focal", loss_ops.softmax_focal,
         (f32(8828, 21, sd=2.0), torch.from_numpy(rng.integers(0, 21, 8828)), 0.25, 2.0)),
        ("penalty_reduced_focal", loss_ops.penalty_reduced_focal,
         (torch.sigmoid(f32(20, 96, 96, sd=2.0)),
          torch.from_numpy(rng.uniform(0, 1, (20, 96, 96)).astype(np.float32)),
          torch.from_numpy(rng.random((20, 96, 96)) < 0.01))),
        ("neg_log_iou", loss_ops.neg_log_iou,
         (torch.exp(f32(20017, 4)) * 8.0, torch.exp(f32(20017, 4)) * 8.0)),
        ("yolov2_image_loss", yolo_head.yolov2_image_loss,
         (f32(5 * 25, 15, 15, sd=1.5), v2["priors"], gt(480.0), 20, 32.0,
          (1.0, 1.0, 5.0, 1.0))),
        ("yolov3_image_loss", yolo_head.yolov3_image_loss,
         ([f32(3 * 25, s, s, sd=1.5) for s in (14, 28, 56)],
          priors_per_head(v3["priors"], False), gt(448.0), 20, (1.0, 1.0, 5.0, 1.0))),
        ("fcos_image_loss", fcos_head.fcos_image_loss,
         ([(f32(20, h, w), torch.exp(0.5 * f32(4, h, w)) * 4.0, f32(1, h, w))
           for h, w in fcos_levels], gt(800.0), 20)),
        ("centernet_image_loss", center_head.centernet_image_loss,
         (f32(20, 96, 96, sd=2.0), f32(2, 96, 96), torch.exp(f32(2, 96, 96)) * 4.0,
          gt(384.0), 20)),
    ]


def api_to(args, dev):
    import torch

    if isinstance(args, torch.Tensor):
        return args.to(dev)
    if isinstance(args, (list, tuple)):
        return type(args)(api_to(a, dev) for a in args)
    return args


def phase_api_rest(dev):
    """25. ``greedy_nms`` and ``topk_then_nms`` on the kernels, and the loss
    primitives and per-image losses on the card (see the module's list)."""
    import numpy as np
    import torch

    from tpudet_torch.heads import ssd as ssd_head
    from tpudet_torch.models.ssd import SSD300, _ssd_feat_shapes
    from tpudet_torch.ops import nms as nms_ops
    from tpudet_torch.ops.cuda import nms_kernel

    t0 = time.perf_counter()
    anc = ssd_head.build_anchors(300, _ssd_feat_shapes(300, SSD300.extra_strides),
                                 device=dev)
    corners = torch.cat([anc.y1x1, anc.y2x2], -1).contiguous()
    scores, many, few = api_rows(dev, corners)
    width = corners.shape[0]
    pool = nms_kernel.pretopk_pool(API_MAX_OUT)
    calls = {
        "greedy_nms": (nms_ops.greedy_nms, nms_ops.plain_greedy_nms,
                       (corners, scores, API_MAX_OUT, API_IOU, many),
                       dict.fromkeys(nms_kernel.pool_kernels(width, pool), 1)),
        "topk_then_nms truncated": (
            nms_ops.topk_then_nms, nms_ops.plain_topk_then_nms,
            (corners, scores, many, API_PRE_TOPK, API_MAX_OUT, API_IOU),
            {"select": 2, "mask": 1, "scan": 1}),
        "topk_then_nms": (
            nms_ops.topk_then_nms, nms_ops.plain_topk_then_nms,
            (corners, scores, few, API_PRE_TOPK, API_MAX_OUT, API_IOU),
            {"select": 2, "mask": 1, "scan": 1})}
    counts, out = {k: 0 for k in ("nms_rows", *NMS_COUNT_KEYS)}, {}
    for what, (fn, plain, args, want) in calls.items():
        fn(*args)  # build and load outside the counted, sync-checked run
        torch.cuda.synchronize()
        reset_nms_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        c = nms_counts()
        api_launches(what, c, {k: want.get(k, 0) for k in NMS_KERNELS})
        for k in counts:
            counts[k] += c[k]
        ref = plain(*args)
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            raise AssertionError(f"phase 25: {what} on the kernels != its plain version")
        out[what] = {"ms": event_ms(lambda: fn(*args), API_REPS),
                     "plain_ms": event_ms(lambda: plain(*args), 3),
                     "launches_by_path": {k: c[k] for k in NMS_KERNELS},
                     "picks": int(got[1].sum()),
                     **({"truncated": bool(got[3])} if len(got) == 4 else {})}
        log(f"phase 25: {what} of [{width}] ({int(args[4 if len(args) == 5 else 2].sum())} "
            f"candidates): {out[what]['ms']:.4f} ms a call on the kernels, plain "
            f"{out[what]['plain_ms']:.4f} ms, launches {out[what]['launches_by_path']}, "
            f"{out[what]['picks']} picks, == plain, no synchronising call")
    if not out["topk_then_nms truncated"]["truncated"] or out["topk_then_nms"]["truncated"]:
        raise AssertionError("phase 25: truncated is not as the candidates' count says")
    losses = {}
    for name, fn, args in api_loss_cases(np.random.default_rng(25)):
        want = fn(*args)
        on_card = api_to(args, dev)
        got = fn(*on_card)
        err = float(torch.linalg.vector_norm((got.cpu() - want).double())
                    / torch.linalg.vector_norm(want.double()).clamp(min=1e-30))
        if not (torch.isfinite(got).all() and err <= API_LOSS_RTOL):
            raise AssertionError(f"phase 25: {name} on the card {err:.3e} from the CPU's")
        losses[name] = {"rel_err": err, "ms": event_ms(lambda: fn(*on_card), 5)}
    seconds = time.perf_counter() - t0
    card = card_line()
    log(f"phase 25: losses on the card against the CPU: "
        f"{ {k: round(v['rel_err'], 9) for k, v in losses.items()} }")
    log(f"phase 25 took {seconds:.1f} s; ms a call "
        f"{ {k: round(v['ms'], 5) for k, v in out.items()} } on {card}")
    return dict(seconds=seconds, counts=counts, calls=out, losses=losses, card=card)


PROFILE_FAMILIES = ("SSD300", "LHRCNN")
PROFILE_N, PROFILE_WARMUP = 3, 1
# (assignments, NMS pool calls) a call of each train phase by design
PROFILE_TRAIN_LAUNCHES = {
    "SSD300": {"fwd": (0, 0), "fwd+loss": (1, 1), "grad": (1, 1), "step": (1, 1)},
    "LHRCNN": {"fwd": (0, 0), **{p: (0, 2) for p in ("+rpn", "+rcnn", "grad@rpn",
                                                       "grad@rcnn", "step", "step@rcnn")}}}
PROFILE_SERVE_POOLS = {"SSD300": 1, "LHRCNN": 2}  # NMS pool calls a request's decode
PROFILE_SYNC_FREE = ("SSD300",)  # families whose train phases make no synchronising call


def profile_figures_ok(what, phases, by_design, sync_free):
    """Raise unless every phase's figures are finite and positive (counts
    finite and not negative), its launches a call are ``by_design[label]``
    (assignments, NMS pool calls; one sorted scan a pool call) and, where
    ``sync_free``, it made no synchronising call."""
    for label, fig in phases.items():
        timing = [fig[k] for k in ("host_ms", "device_ms", "busy", "kernels")]
        counts = [fig["syncs"], fig["calls"], *fig["launches"].values()]
        if not (all(math.isfinite(v) and v > 0 for v in timing)
                and all(math.isfinite(v) and v >= 0 for v in counts)):
            raise AssertionError(f"phase 26, {what} {label}: figures {fig}")
        got = (fig["launches"]["assign"], fig["launches"]["nms_rows"])
        if got != by_design[label] or fig["launches"]["scan"] != got[1]:
            raise AssertionError(f"phase 26, {what} {label}: launches a call "
                                 f"{fig['launches']}; by design {by_design[label]} "
                                 f"(assignments, NMS pool calls)")
        if sync_free and fig["syncs"]:
            raise AssertionError(f"phase 26, {what} {label}: {fig['syncs']} synchronising "
                                 f"calls; the step has none")


def phase_profilers(dev):
    """26. tpudet's two per-model profilers (``scripts/profile_model_torch.py``,
    ``scripts/profile_decode_torch.py``) for ``PROFILE_FAMILIES`` at tpudet's
    bench specs, ``PROFILE_N`` timed calls after ``PROFILE_WARMUP``, each
    family with the counts set to 0 just before it and read just after: every
    figure finite and positive; the launches a call by design in each phase
    (``PROFILE_TRAIN_LAUNCHES``; the serve phases' decodes
    ``PROFILE_SERVE_POOLS`` pools a request, no assignment); SSD300's four
    train phases with no synchronising call; the whole call's launches those
    of its phases' calls; the first captured call of each kernel == its plain
    version."""
    t0 = time.perf_counter()
    train_script = load_script("profile_model_torch")
    serve_script = load_script("profile_decode_torch")
    runs = {}
    for name in PROFILE_FAMILIES:
        spec = train_script._specs()[name]
        captured = []
        undo = dp_spy(captured)
        t = time.perf_counter()
        try:
            reset_kernel_counts()
            train = train_script.profile_model(name, spec, PROFILE_N, PROFILE_WARMUP,
                                               device=dev)
            serve = serve_script.profile_decode(name, spec, PROFILE_N, PROFILE_WARMUP,
                                                device=dev)
            counts = kernel_counts()
        finally:
            undo()
        seconds = time.perf_counter() - t
        pools = PROFILE_SERVE_POOLS[name]
        profile_figures_ok(f"{name} train", train["phases"], PROFILE_TRAIN_LAUNCHES[name],
                           name in PROFILE_SYNC_FREE)
        profile_figures_ok(f"{name} serve", serve["phases"], {
            "transfer": (0, 0), "forward": (0, 0), "decode": (0, pools), "fused": (0, pools),
            "full": (0, pools)}, False)
        want = tuple(sum(f["calls"] * f["launches"][k] for r in (train, serve)
                         for f in r["phases"].values())
                     for k in ("assign", "nms_rows"))
        if (counts["assign"], counts["nms_rows"]) != want or any(
                counts[k] != counts["nms_rows"] for k in ("select", "mask", "scan")):
            raise AssertionError(f"phase 26, {name}: the whole call launched {counts}; its "
                                 f"phases' calls {want} (assignments, NMS pool calls)")
        first = {}
        for key, args in captured:
            first.setdefault(key, args)
        compared = dp_kernels_vs_plain(list(first.items()))
        runs[name] = dict(train=train, serve=serve, counts=counts, compared=sorted(first),
                          seconds=seconds)
        log(f"phase 26, {name}: train phases host / device ms " + ", ".join(
            f"{label} {f['host_ms']:.2f} / {f['device_ms']:.2f}"
            for label, f in train["phases"].items()) + "; serve " + ", ".join(
            f"{label} {f['host_ms']:.3f} / {f['device_ms']:.3f}"
            for label, f in serve["phases"].items())
            + f"; the whole call {counts}; the first call of {', '.join(sorted(first))} "
            f"== plain ({compared} held); {seconds:.1f} s")
    seconds = time.perf_counter() - t0
    card = card_line()
    log(f"phase 26 took {seconds:.1f} s; {card}")
    return dict(seconds=seconds, runs=runs, card=card)


def profilers_record(profilers, key):
    """A kernel's launches in phase 26's calls, each family's apart."""
    runs = profilers["runs"]
    return {"launches": sum(r["counts"][key] for r in runs.values()),
            **{name: {"launches": r["counts"][key]} for name, r in runs.items()}}


def log_old_vs_new(sites, top_k, run_outs):
    """With ``--old-nms``: every main-path site's select, CenterNet's top K
    and the run-outs' continuations, the earlier library's and the
    package's timed in turns, as one table; the table."""
    table = {"select": {**{k: t["kernels"]["select"]["old"] for k, t in sites.items()},
                        "CenterNet top K": top_k["old"]},
             "continue": {**{k: t["kernels"]["continue"]["old"] for k, t in sites.items()
                             if "continue" in t["kernels"]},
                          **{f"{k} (run-out)": t["old"] for k, t in run_outs.items()}}}
    for kernel, rows in table.items():
        for site, r in rows.items():
            log(f"--old-nms {kernel} at {site}: earlier {r['old_ms']:.5f} ms (device "
                f"{fmt_ms(r['old_device_ms'])}), package {r['new_ms']:.5f} ms (device "
                f"{fmt_ms(r['new_device_ms'])}); device turns "
                f"{[fmt_ms(x) for x in r['device_turns_ms']]}")
    log(json.dumps({"old_vs_new": table}))
    return table


def fmt_share(share) -> str:
    return "not measured" if share is None else f"{100 * share:.1f}%"


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-nms", type=Path, help="an earlier csrc/nms.cu, timed beside "
                    "the package's select and continuation")
    args = ap.parse_args()
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
    jobs = [lambda: build.build("nms"), lambda: build.build("assign")]
    if args.old_nms:
        jobs.append(lambda: old_nms_build(args.old_nms.resolve()))
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = list(pool.map(lambda job: job(), jobs))
    log(f"built {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.2f} s "
        f"({' '.join(build.NVCC_FLAGS)})")
    if args.old_nms:
        OLD_NMS["lib"] = old_nms_load(libs[-1])

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
    serve_nms = pool_site(serve["kernel_args"])
    log_pool("the serving path's decode pool", serve_nms)

    # 4. train
    train = phase_train(dev)
    n_steps = train["bf16"]["steps"]
    counts = train["bf16"]["counts"]
    mining = train["mining"]
    mine_pool = pool_site(mining["pool"])
    log_pool("the train step's mining pool (cap 384, IoU 0.7)", mine_pool)
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
        y_pool = pool_site(y_serve["kernel_args"])
        log_pool(f"{name}'s decode pool", y_pool)
        yolo[key] = dict(serve=y_serve, run=y_run, pool=y_pool,
                         records=yolo_records(y_serve, y_run, y_pool, n_requests))
    # 13. FCOS: serve, train, the NMS kernel on the decode pool and at full width
    fcos_serve = phase_fcos_serve(dev, n_requests)
    fcos_run = phase_fcos_train(dev)
    fcos_pool = pool_site(fcos_serve["kernel_args"])
    log_pool("FCOS's decode pool", fcos_pool)
    fcos_full = pool_run_out("FCOS", run_out_args(fcos_serve["kernel_args"]))
    fcos_nms = yolo_records(fcos_serve, fcos_run, fcos_pool, n_requests)[0]
    fcos_nms["run_out_continuation"] = {k: fcos_full[k] for k in RUN_OUT_KEYS}
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
    # 18. the user's entry points: entry(), the bench, a driver's epoch
    entry_points = phase_entry_points(dev)
    log(json.dumps({"entry_points": entry_points}))
    ep_counts = [entry_points[k]["counts"] for k in ("bench", "driver")]
    # 19. data parallelism: one NCCL rank, two gloo ranks on the card, the
    # distributed resident feed
    dp = phase_data_parallel(dev, train["bf16"])
    log(json.dumps({"data_parallel": dp}))
    dp_counts = ([dp["one_rank"]["timed"]["counts"]] + dp["two_ranks"]["counts"]
                 + [c for rank in dp["resident"]["counts"] for c in rank])
    # 20. the convergence protocol's machinery: the host feed at gt_pad 24,
    # --eval-every, a periodic checkpoint, --resume, --eval-only
    protocol = phase_protocol(dev)
    log(json.dumps({"protocol": protocol}))
    # 21. the protocol of the last four families: LH-RCNN, YOLOv3-consistent,
    # CenterNet and FCOS through run_model at their specs' sizes and feeds
    families = phase_families(dev)
    log(json.dumps({"families": families}))
    # 22. the carry copy on the card, and the remaining specs: YOLOv3 (the
    # quirk-faithful decode), YOLOv2-consistent, RefineDet320-pad60
    phase22 = phase_carry_and_specs(dev)
    log(json.dumps({"carry_and_specs": phase22}))
    # 23. tpudet's per-model bench: SSD300 and LH-RCNN through bench_model
    bench_all = phase_bench_all(dev)
    log(json.dumps({"bench_all": bench_all}))
    # 24. the NMS pool with no host sync, and the main-path pools old and new
    sites = {"SSD300 mining": mine_pool, "SSD300 decode": serve_nms,
             "RetinaNet decode": r_kern["decode_pool"],
             **{f"{name} mining": refine[key]["kernels"]["mining_pool"]
                for name, (_, _, key) in REFINE_FAMILIES.items()},
             "SSD512 mining": ssd512["kernels"]["mining_pool"],
             "LH-RCNN positives": lh_kern["positive_pool"],
             "LH-RCNN negatives": lh_kern["negative_pool"],
             "LH-RCNN proposals": lh_kern["proposal_pool"],
             "FCOS decode": fcos_pool}
    sync_free = phase_sync_free(dev, sites)
    log(json.dumps({"sync_free": sync_free}))
    # 25. greedy_nms and topk_then_nms on the kernels; the remaining losses
    api_rest = phase_api_rest(dev)
    log(json.dumps({"api_rest": api_rest}))
    # 26. tpudet's two per-model profilers: SSD300 and LH-RCNN, train and serve phases
    profilers = phase_profilers(dev)
    log(json.dumps({"profilers": profilers}))
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
            **({"decode_pool": fcos_pool, "run_out_continuation": fcos_full}
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
                    "serve_pool": serve_nms, "mining_pool": mine_pool}))
    # each kernel's launches over every main-path run of phases 3-23 (the
    # counts each phase set to 0 just before its run and read just after)
    main_counts = [serve["counts"], counts, r_serve["counts"], r_counts,
                   *(c for f in refine.values()
                     for c in (f["serve"]["counts"], f["train"]["run"]["counts"])),
                   ssd512["serve"]["counts"], ssd512["train"]["run"]["counts"],
                   *(c for f in yolo.values() for c in (f["serve"]["counts"],
                                                         f["run"]["counts"])),
                   fcos_serve["counts"], fcos_run["counts"], cn_serve["counts"],
                   cn_run["counts"], lh_serve["counts"], lh_train["rpn"]["counts"],
                   lh_train["rcnn"]["counts"], f_train["counts"], f_eval["counts"],
                   *res_counts, *ep_counts, *dp_counts, api_rest["counts"]]

    def launches(key):
        return (sum(c[key] for c in main_counts) + protocol_record(protocol, key)["launches"]
                + families_record(families, key)["launches"]
                + families_record(phase22["families"], key)["launches"]
                + bench_all_record(bench_all, key)["launches"]
                + profilers_record(profilers, key)["launches"])

    if OLD_NMS:
        log_old_vs_new(sites, cn_serve["top_k"],
                       {"LH-RCNN negatives": lh_kern["run_out_continuation"],
                        "RetinaNet decode": r_kern["full_width"], "FCOS decode": fcos_full})
    nms_replaces = {"select": "tpudet/ops/pallas/nms_kernel.py:242",
                    "mask": "tpudet/ops/pallas/nms_kernel.py:86",
                    "scan": "tpudet/ops/pallas/nms_kernel.py:86",
                    "continue": "tpudet/ops/pallas/nms_kernel.py:268"}
    lh_run_out = lh_kern["run_out_continuation"]
    records = []
    for k in NMS_KERNELS:
        kern = mine_pool["kernels"][k]  # the train step's mining pool, SSD300
        rec = {"name": f"nms_{k}", "route": "cuda",
               "source": "tpudet_torch/ops/cuda/csrc/nms.cu",
               "replaces": nms_replaces[k], "launches": launches(k),
               "launches_per_request": serve["counts"][k] / n_requests,
               "launches_per_step": counts[k] / n_steps,
               "max_abs_err": kern["max_abs_err"],  # indices and flags, equal exactly
               "ms": kern["ms"], "device_ms": kern["device_ms"],
               "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
               "bound_by": kern["bound_by"],
               "library_ms": kern.get("library_ms"),
               "site": f"SSD300 mining pool {mine_pool['shape']} of "
                       f"{mine_pool['full_shape']}",
               "sites": {site: t["kernels"].get(k) for site, t in sites.items()}}
        if k == "select":
            rec["sites"]["CenterNet top K"] = cn_serve["top_k"]
        if k == "continue":
            rec["run_out"] = {"LH-RCNN negatives": lh_run_out, "RetinaNet decode":
                              r_kern["full_width"], "FCOS decode": fcos_full}
        records.append(rec)
    records[2].update({  # the scan's record carries the pool's per-path details
        "launches_by_path": {k: launches(k) for k in ("nms_rows", *NMS_COUNT_KEYS)},
        "pool_call": {site: {k: t[k] for k in ("old_pool_call_ms", "pool_call_ms",
                                                "device_ms", "plain_ms", "bound_ms",
                                                "bound_by", "continued")}
                      for site, t in sites.items()},
        "retinanet": {
            "launches": r_serve["counts"]["nms_rows"] + r_counts["nms_rows"],
            "launches_per_request": r_serve["counts"]["nms_rows"] / n_requests,
            "launches_per_step": r_counts["nms_rows"] / r_steps,
            "launches_by_path": {k: r_serve["counts"][k] for k in NMS_COUNT_KEYS},
            "decode_pool": {k: r_kern["decode_pool"][k] for k in POOL_KEYS},
            "run_out_continuation": {k: r_kern["full_width"][k] for k in RUN_OUT_KEYS}},
        # tpudet's per-image kernel's case: per-row boxes [5, 300, 4]
        "per_row_boxes": timings["per_row_boxes"],
        **{key: f["records"][0] for key, f in refine.items()},
        "ssd512": ssd512["records"][0],
        **{key: f["records"][0] for key, f in yolo.items()},
        "fcos": fcos_nms, "centernet": {"select_launches": cn_serve["counts"]["select"],
                                        "requests": n_requests},
        "lhrcnn": lh_nms,
        "feed": {"launches": (f_train["counts"]["nms_rows"]
                              + f_eval["counts"]["nms_rows"]),
                 "launches_per_step": f_train["counts"]["nms_rows"] / FEED_STEPS,
                 "launches_per_image": f_eval["counts"]["nms_rows"] / f_eval["images"],
                 "launches_by_path": {k: f_train["counts"][k] + f_eval["counts"][k]
                                      for k in NMS_COUNT_KEYS},
                 "eval_decode_pool": {k: f_eval["decode_pool"][k] for k in POOL_KEYS}},
        "resident": {"launches": sum(c["nms_rows"] for c in res_counts),
                     "launches_per_step": [c["nms_rows"] / res_steps for c in res_counts],
                     "launches_by_path": {k: sum(c[k] for c in res_counts)
                                          for k in NMS_COUNT_KEYS}},
        "entry_points": entry_point_record(entry_points, "nms_rows"),
        "data_parallel": data_parallel_record(dp, "nms_rows"),
        "protocol": protocol_record(protocol, "nms_rows"),
        "protocol_families": families_record(families, "nms_rows"),
        "protocol_phase22": families_record(phase22["families"], "nms_rows"),
        "bench_all": bench_all_record(bench_all, "nms_rows"),
        "api_rest": {k: api_rest[k] for k in ("counts", "calls")},
        "profilers": profilers_record(profilers, "nms_rows")})
    records.append(
        {"name": "assign", "route": "cuda", "source": "tpudet_torch/ops/cuda/csrc/assign.cu",
         "replaces": "tpudet/ops/pallas/assign_kernel.py:43",
         "launches": (counts["assign"] + r_counts["assign"]
                      + sum(f["records"][1]["launches"] for f in refine.values())
                      + ssd512["records"][1]["launches"] + f_train["counts"]["assign"]
                      + sum(c["assign"] for c in res_counts)
                      + sum(c["assign"] for c in ep_counts)
                      + sum(c["assign"] for c in dp_counts)
                      + protocol_record(protocol, "assign")["launches"]
                      + families_record(families, "assign")["launches"]
                      + families_record(phase22["families"], "assign")["launches"]
                      + bench_all_record(bench_all, "assign")["launches"]
                      + profilers_record(profilers, "assign")["launches"]),
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
                                            for c in res_counts]},
         "entry_points": entry_point_record(entry_points, "assign"),
         "data_parallel": data_parallel_record(dp, "assign"),
         "protocol": protocol_record(protocol, "assign"),
         "protocol_families": families_record(families, "assign"),
         "protocol_phase22": families_record(phase22["families"], "assign"),
         "bench_all": bench_all_record(bench_all, "assign"),
         "profilers": profilers_record(profilers, "assign")})
    idle = [r["name"] for r in records if not r["launches"]]
    if idle:
        raise AssertionError(f"kernels the main path never launched: {idle}")
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
