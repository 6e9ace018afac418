"""Train the port's detectors to convergence on the synthetic VOC-20 dataset and
report their held-out VOC07 mAP (the counterpart of
``scripts/train_convergence.py``, with its protocol and its 24 specs).

The dataset is ``scripts/synthvoc.py``'s: 5,000 train and 500 held-out
20-class scenes, rendered once per input size (from the command line by up
to 8 processes, byte for byte ``synthvoc.build``'s files). Each spec is
tpudet's: the model's config (bf16, uint8 images, flips on the device,
weight decay 1e-4, nms 0.05 / 40 / 0.45, the family's keys), its input, base
lr, steps and staircase schedule (the first entry is the warm-up), trained
in chunks of 50 steps (``num_train`` = chunk x batch). Each chunk appends a
line to ``curve.jsonl`` (step, lr, mean loss, images/s, elapsed); a
non-finite loss stops the run. At the end ``save_weight`` and
``evaluate_model`` on the 500 held-out scenes write ``result.json``
(``probe_result.json`` under 500 steps).

The feed, by the spec's script-only keys (popped before the model is built):
  * ``host_feed``: :class:`MemmapFeeder`, numpy batches from the memmaps,
    sent to the card a step at a time (``DetectorBase._to_device``);
  * ``chunk_bytes`` (with ``rotate_every``, ``max_bytes``, default 10^10):
    chunked residency, ``DeviceDataset(..., max_bytes, chunk_bytes,
    rotate_every)``;
  * else the whole set resident on the card, ``DeviceDataset(images, gt,
    batch, seed=1, max_bytes=10^10)``;
  * ``gt_pad``: the ``[N, 60, 5]`` gt cut to ``[:, :gt_pad]`` (lossless for
    synthvoc's at most 6 objects a scene).

Periodic checkpoints: every ``CKPT_EVERY`` steps ``save_weight("latest",
run_dir/ckpt)`` and ``ckpt_meta.json`` (steps, elapsed seconds), keeping only
the newest; written again at the end. ``--resume`` restores the parameters,
the BatchNorm statistics, the optimizer's state and ``global_step`` from the
newest checkpoint, fast-forwards the schedule past the steps done and
appends to the curve. The feed restarts from its seed (1), as tpudet's does,
so a resumed run is not bit-equal to an uninterrupted one.

A stall watchdog (a daemon thread, armed after the first chunk) checks every
``STALL_CHECK_S`` seconds and exits the process with 93 once no chunk has
finished for ``STALL_LIMIT_S`` seconds (environment, default 1800);
``--eval-only`` then scores the newest checkpoint.

Usage (from the root of a checkout, on the card):
  python scripts/train_convergence_torch.py MODEL... [--smoke] [--steps-scale=S]
                                            [--eval-every=N] [--resume]
  python scripts/train_convergence_torch.py all      (the ten of ``ALL``)
  python scripts/train_convergence_torch.py MODEL... --eval-only

``--smoke``: 60 steps at one lr, 50 evaluation images. ``--eval-every=N``:
after each chunk where N steps have passed since the last, ``evaluate_model``
on the first 150 held-out scenes, a line in ``eval.jsonl`` (step, mAP,
images, seconds, elapsed). ``--eval-only``: the newest checkpoint on the
500 held-out scenes. Everything goes under ``.convergence/torch_runs/MODEL/``
(the dataset under ``.convergence/data/``). A family that fails is recorded
with its error and the next one runs; the exit status is 0 only if every
family has an mAP.
"""

from __future__ import annotations

import glob
import importlib
import json
import os
import queue
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

import synthvoc  # noqa: E402

CONVERGENCE_ROOT = os.path.join(ROOT, ".convergence")
CKPT_EVERY = 500  # steps between periodic checkpoints
STALL_CHECK_S = 60  # the watchdog's check interval
MID_EVAL_IMAGES = 150  # held-out scenes of each --eval-every point
RENDER_WORKERS = min(8, os.cpu_count() or 1)  # the command line's render processes
# the spec keys only this script reads
SCRIPT_KEYS = ("gt_pad", "host_feed", "chunk_bytes", "rotate_every", "max_bytes")


# ----------------------------------------------------------------- feeder
class MemmapFeeder:
    """Infinite ``(images uint8, gt)`` numpy batch iterator over the rendered
    memmaps: a ``default_rng(seed)`` shuffle at each wrap, sorted indices
    within a batch, assembled by a producer thread ``depth`` batches ahead."""

    def __init__(self, images, gt, batch: int, seed: int = 0, depth: int = 3):
        self.images, self.gt, self.batch = images, gt, batch
        self.rng = np.random.default_rng(seed)
        self.q = queue.Queue(maxsize=depth)
        self.stop = threading.Event()
        self.t = threading.Thread(target=self._produce, daemon=True)
        self.t.start()

    def _produce(self):
        n = self.images.shape[0]
        order = np.arange(n)
        pos = n  # shuffle on the first batch
        while not self.stop.is_set():
            if pos + self.batch > n:
                self.rng.shuffle(order)
                pos = 0
            idx = np.sort(order[pos:pos + self.batch])  # sorted: sequential memmap reads
            pos += self.batch
            batch = (np.ascontiguousarray(self.images[idx]),
                     np.ascontiguousarray(self.gt[idx]))
            while not self.stop.is_set():
                try:
                    self.q.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self.stop.set()


# ----------------------------------------------------------------- model specs
def _common(extra):
    cfg = {
        "mode": "train", "data_format": "channels_last", "num_classes": 20,
        "weight_decay": 1e-4, "keep_prob": 0.5,
        "nms_score_threshold": 0.05, "nms_max_boxes": 40,
        "nms_iou_threshold": 0.45, "pretraining_weight": None,
        "compute_dtype": "bfloat16", "input_dtype": "uint8",
        "device_augment": {"flip_prob": [0.5, 0.5]},
        "loss_sync_every": 25,
    }
    cfg.update(extra)
    return cfg


def model_specs():
    """name -> (class path, input (h, w), config, base_lr, total_steps, schedule)

    schedule: list of (fraction_of_steps, lr_multiplier); warmup is the first
    entry. tpudet's specs (``scripts/train_convergence.py``) with the port's
    classes; the comments there say why each exists."""
    drop = [(0.05, 0.1), (0.70, 1.0), (0.20, 0.1), (0.05, 0.01)]
    long_drop = [(0.02, 0.1), (0.88, 1.0), (0.07, 0.1), (0.03, 0.01)]
    fcos_drop = [(0.03, 0.1), (0.87, 1.0), (0.07, 0.1), (0.03, 0.01)]
    yolov2_priors = [[1.08, 1.19], [3.42, 4.41], [6.63, 11.38], [9.42, 5.11],
                     [16.62, 10.52]]
    yolov3_priors = [[[10.0, 13.0], [16, 30.0], [33.0, 23.0]],
                     [[30.0, 61.0], [62.0, 45.0], [59.0, 119.0]],
                     [[116.0, 90.0], [156.0, 198.0], [373.0, 326.0]]]
    yolo = {"coord_scale": 1, "noobj_scale": 1, "obj_scale": 5.0, "class_scale": 1.0}
    yolov2 = dict(yolo, batch_size=32, rescore_confidence=False, priors=yolov2_priors,
                  data_shape=[480, 480, 3])
    yolov3 = dict(yolo, batch_size=12, weight_decay=5e-4, num_priors=3,
                  priors=yolov3_priors, data_shape=[448, 448, 3])
    retina = {"batch_size": 32, "is_bottleneck": True, "residual_block_list": [3, 4, 6, 3],
              "init_conv_filters": 16, "is_pretraining": False, "gamma": 2.0,
              "alpha": 0.25, "data_shape": [500, 500, 3]}
    centernet = {"batch_size": 15, "input_size": 384, "score_threshold": 0.05,
                 "top_k_results_output": 40}
    refine = {"batch_size": 32, "input_size": 320}
    # the pad-24 feeds: from the host, or resident
    refine_host = dict(refine, host_feed=True, gt_pad=24)
    # the full pad-60 gt through the split augmentation dispatch
    refine_pad60 = dict(refine, host_feed=True, device_augment_split=True)
    fcos = {"batch_size": 8, "data_shape": [800, 1200, 3]}
    chunked = {"chunk_bytes": 13 * 10**8, "rotate_every": 6, "gt_pad": 24}
    lhrcnn = {"data_shape": [700, 1100, 3], "loss_sync_every": 2,
              "is_pretraining": False, "post_nms_proposal": 500}
    lhrcnn_drop = [(0.03, 0.1), (0.80, 1.0), (0.17, 0.1)]
    m = "tpudet_torch.models."
    return {
        "SSD300": (m + "ssd.SSD300", (300, 300), _common({"batch_size": 32}), 1e-3,
                   4000, drop),
        "SSD512": (m + "ssd.SSD512", (512, 512), _common({"batch_size": 32}), 1e-3,
                   4000, drop),
        "YOLOv2": (m + "yolo.YOLOv2", (480, 480), _common(yolov2), 5e-4, 5000, drop),
        "YOLOv3": (m + "yolo.YOLOv3", (448, 448), _common(yolov3), 5e-4, 7000, drop),
        # the decode that inverts the training encoding, and a plain prediction conv
        "YOLOv3-consistent": (m + "yolo.YOLOv3", (448, 448),
                              _common(dict(yolov3, consistent_geometry=True,
                                           raw_prediction_conv=True)),
                              5e-4, 7000, drop),
        "YOLOv2-consistent": (m + "yolo.YOLOv2", (480, 480),
                              _common(dict(yolov2, consistent_geometry=True)),
                              5e-4, 5000, drop),
        "RetinaNet": (m + "retinanet.RetinaNet", (500, 500), _common(retina), 1e-3,
                      4500, drop),
        # long variants: the base-lr segment extended
        "RetinaNet-long": (m + "retinanet.RetinaNet", (500, 500), _common(retina), 1e-3,
                           9000, [(0.03, 0.1), (0.87, 1.0), (0.07, 0.1), (0.03, 0.01)]),
        "CenterNet-long": (m + "centernet.CenterNet", (384, 384), _common(centernet),
                           1e-3, 30000, long_drop),
        "RefineDet320": (m + "refinedet.RefineDet320", (320, 320), _common(refine_host),
                         5e-4, 5000, drop),
        "PFPNetR": (m + "refinedet.PFPNetR", (320, 320), _common(refine_host), 5e-4,
                    5000, drop),
        "RefineDet320-pad60": (m + "refinedet.RefineDet320", (320, 320),
                               _common(refine_pad60), 5e-4, 5000, drop),
        "LHRCNN": (m + "lhrcnn.LHRCNN", (700, 1100),
                   _common(dict(lhrcnn, batch_size=8, host_feed=True,
                                rpn_first_step=2500, rcnn_first_step=4000,
                                rpn_second_step=5000)),
                   3e-4, 6000, [(0.05, 0.1), (0.78, 1.0), (0.17, 0.1)]),
        "CenterNet": (m + "centernet.CenterNet", (384, 384), _common(centernet), 1e-3,
                      12000, drop),
        "FCOS": (m + "fcos.FCOS", (800, 1200),
                 _common(dict(fcos, host_feed=True, gt_pad=24)), 1e-3, 5000, drop),
        # chunked residency: ~10 GB resident in 1.3 GB chunks, rotated every 6 pins
        "FCOS-long": (m + "fcos.FCOS", (800, 1200), _common(dict(fcos, **chunked)),
                      1e-3, 15000, [(0.01, 0.1), (0.89, 1.0), (0.07, 0.1), (0.03, 0.01)]),
        "FCOS-long2": (m + "fcos.FCOS", (800, 1200), _common(dict(fcos, **chunked)),
                       1e-2, 15000, fcos_drop),
        "FCOS-long3": (m + "fcos.FCOS", (800, 1200), _common(dict(fcos, **chunked)),
                       3e-3, 15000, fcos_drop),
        "RefineDet320-long": (m + "refinedet.RefineDet320", (320, 320),
                              _common(dict(refine, gt_pad=24)), 5e-4, 15000, long_drop),
        "LHRCNN-long": (m + "lhrcnn.LHRCNN", (700, 1100),
                        _common(dict(lhrcnn, batch_size=8, **chunked,
                                     rpn_first_step=5000, rcnn_first_step=8000,
                                     rpn_second_step=10000)),
                        3e-4, 12000, lhrcnn_drop),
        # the paper's form of the FCOS objective on FCOS-long's config
        "FCOS-consistent": (m + "fcos.FCOS", (800, 1200),
                            _common(dict(fcos, **chunked, consistent_objective=True)),
                            1e-3, 15000,
                            [(0.01, 0.1), (0.89, 1.0), (0.07, 0.1), (0.03, 0.01)]),
        # LH-RCNN at the reference's batch 32, phases in its proportions
        "LHRCNN-long2": (m + "lhrcnn.LHRCNN", (700, 1100),
                         _common(dict(lhrcnn, batch_size=32, **dict(chunked, rotate_every=3),
                                      max_bytes=45 * 10**8, rpn_first_step=3350,
                                      rcnn_first_step=5350, rpn_second_step=6680)),
                         6e-4, 8000, lhrcnn_drop),
        "PFPNetR-pad60": (m + "refinedet.PFPNetR", (320, 320), _common(refine_pad60),
                          5e-4, 5000, drop),
        "PFPNetR-long": (m + "refinedet.PFPNetR", (320, 320),
                         _common(dict(refine, gt_pad=24)), 5e-4, 15000, long_drop),
    }


ALL = ["SSD300", "YOLOv3", "SSD512", "YOLOv2", "RetinaNet", "RefineDet320",
       "PFPNetR", "CenterNet", "FCOS", "LHRCNN"]


def _load_class(path):
    mod, cls = path.rsplit(".", 1)
    return getattr(importlib.import_module(mod), cls)


def _spec(name, size):
    """The spec's class, input, config (a copy) and schedule; with ``size``
    an input ``(h, w)`` other than the spec's, the class (``input_size``) and
    the config (``input_size``, ``data_shape``) take it."""
    cls_path, (h, w), config, base_lr, total_steps, schedule = model_specs()[name]
    cls = _load_class(cls_path)
    config = dict(config)
    if size is not None and tuple(size) != (h, w):
        h, w = size
        cls = type(cls.__name__, (cls,), {"input_size": h})
        if "input_size" in config:
            config["input_size"] = h
        if "data_shape" in config:
            config["data_shape"] = [h, w, 3]
    return cls, (h, w), config, base_lr, total_steps, schedule


def render_dataset(root, h, w, n_train=synthvoc.N_TRAIN, n_test=synthvoc.N_TEST,
                   workers=1):
    """``synthvoc.build``'s dataset at ``h`` x ``w`` under ``root``, byte for
    byte, its scenes rendered by ``workers`` Python processes, each into its
    share of the image memmaps (by ``synthvoc.build`` itself for one worker,
    or when the dataset is there); returns its directory."""
    d = os.path.join(root, f"{h}x{w}")
    if workers > 1 and not os.path.exists(os.path.join(d, "DONE")):
        import subprocess

        os.makedirs(d, exist_ok=True)
        for split, n in (("train", n_train), ("test", n_test)):  # the headers
            np.lib.format.open_memmap(os.path.join(d, f"{split}_images.npy"), mode="w+",
                                      dtype=np.uint8, shape=(n, h, w, 3)).flush()
        n = n_train + n_test
        cuts = [n * k // workers for k in range(workers + 1)]
        code = (f"import sys; sys.path[:0] = {[os.path.dirname(__file__)]!r}; "
                f"import train_convergence_torch as tc; tc._render_part(*sys.argv[1:])")
        procs = [subprocess.Popen([sys.executable, "-c", code, d, str(h), str(w),
                                   str(n_train), str(n_test), str(a), str(b)])
                 for a, b in zip(cuts, cuts[1:])]
        if any(p.wait() for p in procs):
            raise RuntimeError(f"a render process failed: {[p.returncode for p in procs]}")
        gt = np.concatenate([np.load(os.path.join(d, f"gt_{a}.npy")) for a in cuts[:-1]])
        np.save(os.path.join(d, "train_gt.npy"), gt[:n_train])
        np.save(os.path.join(d, "test_gt.npy"), gt[n_train:])
        for a in cuts[:-1]:
            os.unlink(os.path.join(d, f"gt_{a}.npy"))
        with open(os.path.join(d, "DONE"), "w") as f:
            f.write("ok")
    return synthvoc.build(root, h, w, n_train=n_train, n_test=n_test)


def _render_part(d, h, w, n_train, n_test, start, stop):
    """One render process of :func:`render_dataset`: scenes ``start:stop`` of
    the train-then-test order into the memmaps, their gt rows (train as
    ``[yc, xc, h, w, cid]``, test as corners, as ``synthvoc.build`` keeps
    them) into ``gt_{start}.npy``."""
    h, w, n_train, n_test, start, stop = map(int, (h, w, n_train, n_test, start, stop))
    specs = synthvoc.scene_specs(np.random.default_rng(7), n_train + n_test)  # build's seed
    images = {split: np.load(os.path.join(d, f"{split}_images.npy"), mmap_mode="r+")
              for split in ("train", "test")}
    gt = np.full((stop - start, synthvoc.MAX_OBJ, 5), -1.0, np.float32)
    for i in range(start, stop):
        image, boxes = synthvoc.render_scene(specs[i], h, w)
        if i < n_train:
            images["train"][i] = image
            boxes = synthvoc._corner_to_center(boxes)
        else:
            images["test"][i - n_train] = image
        gt[i - start, :len(boxes)] = boxes
    for m in images.values():
        m.flush()
    np.save(os.path.join(d, f"gt_{start}.npy"), gt)


def _write_meta(run_dir, steps, elapsed):
    with open(os.path.join(run_dir, "ckpt_meta.json"), "w") as f:
        json.dump({"steps": steps, "elapsed_s": round(elapsed, 1)}, f)


def _evaluate(name, model, records):
    """``evaluate_model`` on ``records``; logs the NMS kernel's launches in
    it by design (each kernel of the pool, ``continue``: the continuation's
    launches; the counts move only on the card)."""
    from tpudet_torch.ops.cuda import nms_kernel
    from tpudet_torch.runtime import evaluate

    before = dict(nms_kernel.launches_by_path)
    out = evaluate.evaluate_model(model, records)
    launches = {k: v - before[k] for k, v in nms_kernel.launches_by_path.items()}
    print(f"[{name}] evaluation of {len(records)} images: NMS kernel launches "
          f"{json.dumps(launches)}", flush=True)
    return out


def _scores(mAP, aps):
    return {"mAP@0.5_voc07": round(float(mAP), 4),
            "per_class_AP": {str(k): round(float(v), 4) for k, v in sorted(aps.items())}}


# ----------------------------------------------------------------- training
def run_model(name: str, steps_scale: float = 1.0, smoke: bool = False,
              resume: bool = False, eval_every: int = 0,
              root: str = CONVERGENCE_ROOT, n_train: int = synthvoc.N_TRAIN,
              n_test: int = synthvoc.N_TEST, size=None, device=None,
              render_workers: int = 1):
    """Train and evaluate ``name``; returns the result's dict.

    ``root`` holds ``data/`` (the rendered dataset) and ``torch_runs/``;
    ``n_train``/``n_test`` are the dataset's scenes, ``size`` an input
    ``(h, w)`` other than the spec's, ``device`` the model's and the
    dataset's (None: the card), ``render_workers`` the processes that
    render a dataset not yet there."""
    from tpudet_torch import device as device_lib
    from tpudet_torch.data.device_dataset import DeviceDataset
    from tpudet_torch.ops.cuda import nms_kernel

    device = device_lib.resolve(device)
    cls, (h, w), config, base_lr, total_steps, schedule = _spec(name, size)
    total_steps = int(total_steps * steps_scale)
    if smoke:
        total_steps = 60
        schedule = [(1.0, 1.0)]

    run_dir = os.path.join(root, "torch_runs", name)
    os.makedirs(run_dir, exist_ok=True)
    curve_path = os.path.join(run_dir, "curve.jsonl")

    print(f"[{name}] rendering/loading dataset at {h}x{w} ...", flush=True)
    t_data = time.time()
    d = render_dataset(os.path.join(root, "data"), h, w, n_train, n_test, render_workers)
    train_images, train_gt, _, _ = synthvoc.load(d)
    print(f"[{name}] dataset ready in {time.time() - t_data:.1f} s", flush=True)

    batch = config["batch_size"]
    gt_pad = config.pop("gt_pad", None)
    if gt_pad is not None:
        train_gt = train_gt[:, :gt_pad]
    chunk_bytes = config.pop("chunk_bytes", None)
    rotate_every = config.pop("rotate_every", None)
    max_bytes = config.pop("max_bytes", 10 * 10**9)
    if config.pop("host_feed", False):
        feeder = MemmapFeeder(train_images, train_gt, batch, seed=1)
    elif chunk_bytes is not None:
        feeder = DeviceDataset(train_images, train_gt, batch, seed=1, max_bytes=max_bytes,
                               chunk_bytes=chunk_bytes, rotate_every=rotate_every,
                               device=device)
    else:
        feeder = DeviceDataset(train_images, train_gt, batch, seed=1,
                               max_bytes=10 * 10**9, device=device)
    provider = {"data_shape": [h, w, 3], "num_train": batch,  # set per chunk below
                "num_val": 0, "train_generator": feeder, "val_generator": None}

    print(f"[{name}] building model ...", flush=True)
    model = cls(config, provider, device=device)
    model.train_initializer = None  # feeder is infinite; no per-epoch reset

    # staircase schedule in chunks so the curve gets sampled and lr can step
    chunk = 50 if not smoke else 30
    t0 = time.time()
    done_steps = 0
    meta_path = os.path.join(run_dir, "ckpt_meta.json")
    if resume and os.path.exists(meta_path):
        with open(meta_path) as f:
            done_steps = int(json.load(f)["steps"])
        model.load_weight(os.path.join(run_dir, "ckpt"))
        print(f"[{name}] resuming from step {done_steps}", flush=True)
    skip_steps = done_steps
    last_ckpt = done_steps
    curve = open(curve_path, "a" if done_steps else "w")

    # the stall watchdog, armed after the first chunk
    progress = {"t": None, "armed": False}
    stall_limit = float(os.environ.get("STALL_LIMIT_S", 1800))

    def _watchdog():
        while True:
            time.sleep(STALL_CHECK_S)
            if progress["armed"] and time.time() - progress["t"] > stall_limit:
                print(f"[{name}] STALLED: no chunk finished in {stall_limit:.0f}s"
                      f" at step {done_steps}; exiting (salvage via --eval-only)",
                      flush=True)
                os._exit(93)

    threading.Thread(target=_watchdog, daemon=True).start()

    eval_state = {"records": None, "last": done_steps}
    # the NMS kernels' launches in training, by design (the counts move only on
    # the card)
    train_launches = dict.fromkeys(nms_kernel.launches_by_path, 0)

    def _mid_eval():
        if eval_state["records"] is None:
            eval_state["records"] = list(synthvoc.test_records(d))[:MID_EVAL_IMAGES]
        te = time.time()
        mAP_i, _ = _evaluate(name, model, eval_state["records"])
        rec = {"step": done_steps, "mAP@0.5_voc07": round(float(mAP_i), 4),
               "eval_images": len(eval_state["records"]),
               "eval_seconds": round(time.time() - te, 1),
               "elapsed_s": round(time.time() - t0, 1)}
        with open(os.path.join(run_dir, "eval.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"\n[{name}] mid-run eval @ {done_steps}: mAP {mAP_i:.4f} "
              f"({rec['eval_seconds']}s)", flush=True)

    try:
        for frac, mult in schedule:
            seg_steps = max(1, int(round(total_steps * frac)))
            lr = base_lr * mult
            if skip_steps > 0:  # --resume: fast-forward past completed segments
                ff = min(skip_steps, seg_steps)
                seg_steps -= ff
                skip_steps -= ff
            while seg_steps > 0 and done_steps < total_steps:
                this = min(chunk, seg_steps)
                model.num_train = this * batch
                before = dict(nms_kernel.launches_by_path)
                mean_loss = model.train_one_epoch(lr)
                launches = {k: v - before[k] for k, v in nms_kernel.launches_by_path.items()}
                for k, v in launches.items():
                    train_launches[k] += v
                done_steps += this
                seg_steps -= this
                progress["t"] = time.time()
                progress["armed"] = True
                rec = {"step": done_steps, "lr": lr,
                       "mean_loss": round(float(mean_loss), 5),
                       "imgs_per_sec": round(done_steps * batch / (time.time() - t0), 1),
                       "elapsed_s": round(time.time() - t0, 1),
                       "nms_launches": launches}
                curve.write(json.dumps(rec) + "\n")
                curve.flush()
                if not np.isfinite(mean_loss):
                    print(f"[{name}] DIVERGED at step {done_steps}", flush=True)
                    return {"model": name, "diverged_at": done_steps}
                if done_steps - last_ckpt >= CKPT_EVERY:
                    old = set(glob.glob(os.path.join(run_dir, "ckpt-*")))
                    model.save_weight("latest", os.path.join(run_dir, "ckpt"))
                    _write_meta(run_dir, done_steps, time.time() - t0)
                    last_ckpt = done_steps
                    for p in old:  # keep only the newest periodic checkpoint
                        os.unlink(p)
                if eval_every and done_steps - eval_state["last"] >= eval_every:
                    eval_state["last"] = done_steps
                    _mid_eval()
                    progress["t"] = time.time()  # evaluation is not a stall
    finally:
        # disarmed however the loop ends, so a later family of the queue is
        # not cut by this one's watchdog
        progress["armed"] = False
        curve.close()
        feeder.close()
    train_secs = time.time() - t0
    model.save_weight("latest", os.path.join(run_dir, "ckpt"))
    _write_meta(run_dir, done_steps, train_secs)

    print(f"\n[{name}] trained {done_steps} steps in {train_secs:.0f}s (NMS kernel "
          f"launches {json.dumps(train_launches)}); evaluating ...", flush=True)
    n_eval = 50 if smoke else n_test
    records = list(synthvoc.test_records(d))[:n_eval]
    t1 = time.time()
    mAP, aps = _evaluate(name, model, records)
    result = {
        "model": name, "steps": done_steps, "batch": batch,
        "input": [h, w], "base_lr": base_lr,
        "train_seconds": round(train_secs, 1),
        "train_imgs_per_sec": round(done_steps * batch / train_secs, 1),
        "eval_images": len(records),
        "eval_seconds": round(time.time() - t1, 1),
        **_scores(mAP, aps),
        "train_nms_launches": train_launches,
        "device": device_lib.card_line(device),
    }
    # anything under 500 steps is a probe, never a convergence result
    fname = "result.json" if (done_steps >= 500 and not smoke) else "probe_result.json"
    with open(os.path.join(run_dir, fname), "w") as f:
        json.dump(result, f, indent=1)
    print(f"[{name}] mAP@0.5 = {mAP:.4f}  ({done_steps} steps, "
          f"{result['train_imgs_per_sec']} imgs/s)", flush=True)
    return result


def eval_from_checkpoint(name: str, root: str = CONVERGENCE_ROOT,
                         n_train: int = synthvoc.N_TRAIN, n_test: int = synthvoc.N_TEST,
                         size=None, device=None):
    """Evaluate the newest checkpoint of ``name``'s run (an interrupted one,
    say) on the held-out scenes; writes ``result.json``, or
    ``probe_result.json`` under 500 steps. Arguments as :func:`run_model`'s."""
    from tpudet_torch import device as device_lib

    device = device_lib.resolve(device)
    cls, (h, w), config, base_lr, _, _ = _spec(name, size)
    run_dir = os.path.join(root, "torch_runs", name)
    with open(os.path.join(run_dir, "ckpt_meta.json")) as f:
        meta = json.load(f)
    d = synthvoc.build(os.path.join(root, "data"), h, w, n_train=n_train, n_test=n_test)
    batch = config["batch_size"]
    for k in SCRIPT_KEYS:
        config.pop(k, None)
    provider = {"data_shape": [h, w, 3], "num_train": batch, "num_val": 0,
                "train_generator": iter(()), "val_generator": None}
    model = cls(config, provider, device=device)
    model.load_weight(os.path.join(run_dir, "ckpt"))  # the newest step
    records = list(synthvoc.test_records(d))[:n_test]
    t1 = time.time()
    mAP, aps = _evaluate(name, model, records)
    result = {
        "model": name, "steps": meta["steps"], "batch": batch,
        "input": [h, w], "base_lr": base_lr,
        "train_seconds": meta.get("elapsed_s"),
        "note": "evaluated from periodic checkpoint (run interrupted)",
        "eval_images": len(records), "eval_seconds": round(time.time() - t1, 1),
        **_scores(mAP, aps),
        "device": device_lib.card_line(device),
    }
    fname = "result.json" if meta["steps"] >= 500 else "probe_result.json"
    with open(os.path.join(run_dir, fname), "w") as f:
        json.dump(result, f, indent=1)
    print(f"[{name}] mAP@0.5 = {mAP:.4f}  (ckpt @ {meta['steps']} steps)", flush=True)
    return result


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("--")]
    scale = 1.0
    eval_every = 0
    for a in argv:
        if a.startswith("--steps-scale="):
            scale = float(a.split("=")[1])
        if a.startswith("--eval-every="):
            eval_every = int(a.split("=")[1])
    specs = model_specs()
    names = ALL if (not args or args[0] == "all") else args
    unknown = [n for n in names if n not in specs]
    if unknown:
        print(f"no spec for {unknown}: the specs are {sorted(specs)}", file=sys.stderr)
        return 2
    results = []
    for name in names:
        try:
            if "--eval-only" in argv:
                results.append(eval_from_checkpoint(name))
                continue
            results.append(run_model(name, steps_scale=scale, smoke="--smoke" in argv,
                                     resume="--resume" in argv, eval_every=eval_every,
                                     render_workers=RENDER_WORKERS))
        except Exception as e:  # keep the queue going; record the failure
            import traceback

            traceback.print_exc()
            results.append({"model": name, "error": repr(e)})
    print(json.dumps(results, indent=1))
    return 0 if all("mAP@0.5_voc07" in r for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
