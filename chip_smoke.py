"""Drive the PyTorch/CUDA port (tpudet_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each raising on failure (nothing is caught):
  1. card and build: the card's name and power limit, then nvcc builds every
     kernel of the serving path from the checkout's sources;
  2. each kernel against its plain PyTorch version, on the card, on the shapes
     the system gives it, with exact equality of the discrete outputs; kernel
     times with CUDA events;
  3. serve: SSD300 at full width (300x300, 20 classes + background, 8828
     anchors) from seeded random weights answers requests through
     ``test_one_image``; the kernels' launch counts show the path went through
     them; outputs are checked against the plain versions on the same card and
     the network against the same weights on the CPU.

The last lines are a JSON record of the kernels, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. float32 convolutions and matmuls
run without TF32 here (both switches are set off below), so the card's
network agrees with the CPU's to float32 accumulation-order error.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

F32_PEAK_FLOPS = 67e12   # H100 SXM float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
NEG = -1e30
IOU_FLOPS = 18  # per candidate per pick: 4 min/max, 4 sub, 2 clamp, 2 mul, add, sub, div, 2 cmp


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
    # per-row boxes [5, 300, 4] (tpudet's per-image kernel case), zero-area
    # boxes (NaN IoU: each box still picked once), tied scores
    for name in ("per_row_boxes", "zero_area", "ties"):
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


def raw_kernel_ms(boxes, scores, ns, max_out, thr, reps=200) -> float:
    """Device time of the NMS kernel alone: launches through the C entry with
    preallocated outputs, so the wrapper's Python work stays out of the time."""
    import torch

    from tpudet_torch.ops.cuda import nms_kernel

    fn = nms_kernel._library()
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

    return event_ms(launch, reps)


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(dev, anchor_corners):
    import torch
    from torch_nms_cases import nms_case

    from tpudet_torch.ops import nms as nms_ops
    from tpudet_torch.ops.cuda import nms_kernel

    timings = {}
    for name, boxes, scores, ns, max_out, thr in nms_cases(anchor_corners):
        args = [torch.from_numpy(a).to(dev) for a in (boxes, scores, ns)]
        sel, val = nms_kernel.nms_rows(*args, max_out, thr)
        psel, pval = nms_ops.batched_greedy_nms(*args, max_out, thr)
        torch.cuda.synchronize()
        if not (torch.equal(val, pval) and torch.equal(sel, psel)):
            raise AssertionError(f"NMS kernel != plain version on {name}")
        if name == "zero_area" and int(val.sum()) != 4:
            raise AssertionError("zero-area boxes: expected 4 distinct picks")
        log(f"nms {name}: scores {tuple(scores.shape)} max_out {max_out} thr {thr}: "
            f"kernel == plain, {int(val.sum())} picks")
        if name in ("decode_pool", "mining"):
            ms = raw_kernel_ms(*args, max_out, thr)
            wrapped = event_ms(lambda: nms_kernel.nms_rows(*args, max_out, thr), 50)
            plain = event_ms(lambda: nms_ops.batched_greedy_nms(*args, max_out, thr), 3)
            nbytes, flops = nms_work(*args[:2], sel, val, thr)
            b_ms, b_by = bound(nbytes, flops)
            timings[name] = dict(ms=ms, wrapper_ms=wrapped, plain_ms=plain,
                                 bound_ms=b_ms, bound_by=b_by)
            log(f"nms {name} timing: kernel {ms:.4f} ms, through the wrapper "
                f"{wrapped:.4f} ms, plain {plain:.4f} ms, "
                f"bound {b_ms:.6f} ms ({b_by}: {nbytes} B, {flops} flop)")

    boxes, scores, ns, max_out, thr = nms_case("exhaustion")  # one cluster fills the pool
    args = [torch.from_numpy(a).to(dev) for a in (boxes, scores, ns)]
    before = nms_kernel.launches
    sel, val = nms_kernel.batched_greedy_nms_pretopk(*args, max_out, thr)
    reran = nms_kernel.launches - before
    fsel, fval = nms_kernel.nms_rows(*args, max_out, thr)
    psel, pval = nms_ops.batched_greedy_nms(*args, max_out, thr)
    torch.cuda.synchronize()
    if reran != 2:
        raise AssertionError(f"exhaustion scene: expected the full-width rerun "
                             f"(2 launches), got {reran}")
    for s2, v2 in ((fsel, fval), (psel, pval)):
        if not (torch.equal(val, v2) and torch.equal(sel, s2)):
            raise AssertionError("exhaustion scene: pretopk != full width")
    if int(val.sum()) != 60:
        raise AssertionError(f"exhaustion scene: {int(val.sum())} picks, expected 60")
    log("nms exhaustion: pool exhausted, full-width rerun through the kernel, "
        "== full width == plain (60 picks)")
    return timings


# --------------------------------------------------------------- serving
def phase_serve(dev, n_requests=10):
    import numpy as np
    import torch

    from tpudet_torch.heads import ssd as ssd_head
    from tpudet_torch.models.ssd import SSD300
    from tpudet_torch.ops import nms as nms_ops
    from tpudet_torch.ops.cuda import nms_kernel

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
    rng = np.random.default_rng(1)
    images = [rng.uniform(0, 255, (1, 300, 300, 3)).astype(np.float32)
              for _ in range(n_requests)]
    for img in images[:2]:  # warm-up: cuDNN handles, the kernel library
        model.test_one_image(img)
    torch.cuda.synchronize()

    # the main path, counted
    nms_kernel.launches = 0
    latencies, results = [], []
    for img in images:
        t = time.perf_counter()
        results.append(model.test_one_image(img))
        latencies.append((time.perf_counter() - t) * 1e3)
    counts = {"nms_rows": nms_kernel.launches}
    log(f"served {n_requests} requests; kernel launches {counts}")
    if counts["nms_rows"] < n_requests:
        raise AssertionError("the serving path did not launch the NMS kernel "
                             "once per request")
    n_dets = [len(r[0]) for r in results]
    for scores, boxes, cid in results:
        if not (np.isfinite(scores).all() and np.isfinite(boxes).all()):
            raise AssertionError("non-finite detections")
        if boxes.shape != (len(scores), 4) or cid.shape != scores.shape:
            raise AssertionError("malformed detections")
        if len(cid) and not (cid.min() >= 0 and cid.max() < 20):
            raise AssertionError("class id out of range")
    if max(n_dets) == 0:
        raise AssertionError("no request returned detections")
    p50 = statistics.median(latencies)
    log(f"detections per request {n_dets}; latency p50 {p50:.3f} ms, "
        f"min {min(latencies):.3f} ms, max {max(latencies):.3f} ms")

    # one request's head outputs through decode with the kernel and with the
    # plain version, both on the card
    x = torch.from_numpy(images[0].transpose(0, 3, 1, 2).copy()).to(dev)
    captured = {}
    real_rows = nms_kernel.nms_rows

    def capture(*a):
        captured.setdefault("args", a)
        return real_rows(*a)

    with torch.inference_mode():
        outputs = model.net(model._preprocess(x))
        pconf, pyx, phw = (a[0] for a in ssd_head.flatten_preds(outputs, 21))

        def decode():
            return ssd_head.ssd_decode(pconf, pyx, phw, model.anchors, 0.01, 0.5, 20)

        nms_kernel.nms_rows = capture
        try:
            with_kernel = decode()
            nms_kernel.nms_rows = nms_ops.batched_greedy_nms
            with_plain = decode()
        finally:
            nms_kernel.nms_rows = real_rows
        torch.cuda.synchronize()
        for a, b in zip(with_kernel, with_plain):
            if not torch.equal(a, b):
                raise AssertionError("decode with the NMS kernel != with the plain version")
        log(f"decode of one request: kernel == plain on the card "
            f"({int(with_kernel[3].sum())} detections)")

        fwd_ms = event_ms(lambda: model.net(model._preprocess(x)), 10)
        dec_ms = event_ms(decode, 10)
        log(f"request breakdown (device, CUDA events): network {fwd_ms:.3f} ms, "
            f"decode {dec_ms:.3f} ms")

        # the network against the same weights on the CPU
        cpu_net = model.net.to("cpu")
        try:
            want = cpu_net(model._preprocess(x).cpu())
        finally:
            model.net.to(dev)
        # normwise: float32 sums in another order, no TF32
        worst = max(float((g.cpu() - w).abs().max() / w.abs().max())
                    for g, w in zip(outputs, want))
        if worst > 1e-4:
            raise AssertionError(f"network on the card vs the CPU: rel err {worst}")
        log(f"network on the card vs the CPU, same weights: max |diff| / max |value| "
            f"over levels {worst:.2e}")

    profile_requests(model, images[:3])
    boxes, scores, ns, max_out, thr = captured["args"]
    log(f"main-path NMS input: scores {tuple(scores.shape)}, boxes "
        f"{tuple(boxes.shape)}, max_out {max_out}, thr {thr}")
    return dict(latencies=latencies, p50=p50, counts=counts,
                kernel_args=(boxes, scores, ns, max_out, thr))


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


def kernel_record(dev, main_args, launches):
    """Time the NMS kernel on the main path's own inputs (one request's pool)."""
    import torch

    from tpudet_torch.ops import nms as nms_ops
    from tpudet_torch.ops.cuda import nms_kernel

    boxes, scores, ns, max_out, thr = main_args
    sel, val = nms_kernel.nms_rows(boxes, scores, ns, max_out, thr)
    psel, pval = nms_ops.batched_greedy_nms(boxes, scores, ns, max_out, thr)
    torch.cuda.synchronize()
    if not (torch.equal(sel, psel) and torch.equal(val, pval)):
        raise AssertionError("NMS kernel != plain version on the main path's input")
    err = 0  # the outputs are indices and flags, equal exactly
    ms = raw_kernel_ms(boxes, scores, ns, max_out, thr)
    plain = event_ms(lambda: nms_ops.batched_greedy_nms(boxes, scores, ns, max_out, thr), 5)
    nbytes, flops = nms_work(boxes, scores, sel, val, thr)
    b_ms, b_by = bound(nbytes, flops)
    return {"name": "nms_rows", "route": "cuda",
            "source": "tpudet_torch/ops/cuda/csrc/nms.cu",
            "replaces": "tpudet/ops/pallas/nms_kernel.py:86",
            "launches": launches, "max_abs_err": float(err), "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


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

    # 1. card and build
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    from tpudet_torch.ops.cuda import build

    t0 = time.perf_counter()
    lib = build.build("nms")
    log(f"built {lib.name} in {time.perf_counter() - t0:.2f} s "
        f"({' '.join(build.NVCC_FLAGS)})")

    # 2. kernels against their plain versions
    from tpudet_torch.heads import ssd as ssd_head
    from tpudet_torch.models.ssd import SSD300, _ssd_feat_shapes

    anc = ssd_head.build_anchors(300, _ssd_feat_shapes(300, SSD300.extra_strides))
    anchor_corners = torch.cat([anc.y1x1, anc.y2x2], -1).numpy()
    timings = phase_kernels(dev, anchor_corners)

    # 3. serve
    serve = phase_serve(dev)
    record = kernel_record(dev, serve["kernel_args"], serve["counts"]["nms_rows"])
    log(f"nms_rows on the main path's pool: kernel {record['ms']:.4f} ms, plain "
        f"{record['plain_ms']:.4f} ms, bound {record['bound_ms']:.6f} ms "
        f"({record['bound_by']})")
    log(json.dumps({"shapes": timings, "serve_p50_ms": serve["p50"],
                    "serve_ms": serve["latencies"]}))
    print(json.dumps({"kernels": [record]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
