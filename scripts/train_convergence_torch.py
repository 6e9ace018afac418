"""Train SSD300 of the port to convergence on the synthetic VOC-20 dataset and
report its held-out VOC07 mAP (the counterpart of the SSD300 path of
``scripts/train_convergence.py``, with its protocol).

The dataset is ``scripts/synthvoc.py``'s: 5,000 train and 500 held-out
20-class scenes, rendered once per input size. The run: tpudet's SSD300
convergence config (bf16, uint8 images, flips on the device, weight decay
1e-4, nms 0.05 / 40 / 0.45), the training set resident on the card
(``DeviceDataset(images, gt, 32, seed=1)``), base lr 1e-3 over 4000 steps with
the staircase schedule (5% at 0.1x, 70% at 1x, 20% at 0.1x, 5% at 0.01x),
trained in chunks of 50 steps (``num_train`` = chunk x batch). Each chunk
appends a line to ``curve.jsonl`` (step, lr, mean loss, images/s, elapsed); a
non-finite loss stops the run. At the end ``save_weight`` and
``evaluate_model`` on the 500 held-out scenes write ``result.json``.

Usage (from the root of a checkout, on the card):
  python scripts/train_convergence_torch.py SSD300 [--smoke] [--steps-scale=S]

``--smoke``: 60 steps at one lr, 50 evaluation images, ``probe_result.json``
(as is any run under 500 steps). Everything goes under
``.convergence/torch_runs/SSD300/`` (the dataset under ``.convergence/data/``).

Not ported yet: ``--resume``, ``--eval-every``, ``--eval-only``, the stall
watchdog, chunked residency and the other families' specs (ROADMAP.md,
queue 1).
"""

from __future__ import annotations

import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

import synthvoc  # noqa: E402

CONVERGENCE_ROOT = os.path.join(ROOT, ".convergence")


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
    entry."""
    drop = [(0.05, 0.1), (0.70, 1.0), (0.20, 0.1), (0.05, 0.01)]
    return {
        "SSD300": ("tpudet_torch.models.ssd.SSD300", (300, 300),
                   _common({"batch_size": 32}), 1e-3, 4000, drop),
    }


def _load_class(path):
    mod, cls = path.rsplit(".", 1)
    return getattr(importlib.import_module(mod), cls)


# ----------------------------------------------------------------- training
def run_model(name: str, steps_scale: float = 1.0, smoke: bool = False,
              root: str = CONVERGENCE_ROOT, n_train: int = synthvoc.N_TRAIN,
              n_test: int = synthvoc.N_TEST, size=None, device=None):
    """Train and evaluate ``name``; returns the result's dict.

    ``root`` holds ``data/`` (the rendered dataset) and ``torch_runs/``;
    ``n_train``/``n_test`` are the dataset's scenes, ``size`` an input
    ``(h, w)`` other than the spec's (the model class then takes it as its
    ``input_size``), ``device`` the model's and the dataset's (None: the
    card)."""
    from tpudet_torch import device as device_lib
    from tpudet_torch.data.device_dataset import DeviceDataset
    from tpudet_torch.runtime import evaluate

    device = device_lib.resolve(device)
    cls_path, (h, w), config, base_lr, total_steps, schedule = model_specs()[name]
    total_steps = int(total_steps * steps_scale)
    if smoke:
        total_steps = 60
        schedule = [(1.0, 1.0)]
    cls = _load_class(cls_path)
    if size is not None and tuple(size) != (h, w):
        h, w = size
        cls = type(cls.__name__, (cls,), {"input_size": h})

    run_dir = os.path.join(root, "torch_runs", name)
    os.makedirs(run_dir, exist_ok=True)
    curve_path = os.path.join(run_dir, "curve.jsonl")

    print(f"[{name}] rendering/loading dataset at {h}x{w} ...", flush=True)
    t_data = time.time()
    d = synthvoc.build(os.path.join(root, "data"), h, w, n_train=n_train, n_test=n_test)
    train_images, train_gt, _, _ = synthvoc.load(d)
    print(f"[{name}] dataset ready in {time.time() - t_data:.1f} s", flush=True)

    batch = config["batch_size"]
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
    curve = open(curve_path, "w")
    for frac, mult in schedule:
        seg_steps = max(1, int(round(total_steps * frac)))
        lr = base_lr * mult
        while seg_steps > 0 and done_steps < total_steps:
            this = min(chunk, seg_steps)
            model.num_train = this * batch
            mean_loss = model.train_one_epoch(lr)
            done_steps += this
            seg_steps -= this
            rec = {"step": done_steps, "lr": lr,
                   "mean_loss": round(float(mean_loss), 5),
                   "imgs_per_sec": round(done_steps * batch / (time.time() - t0), 1),
                   "elapsed_s": round(time.time() - t0, 1)}
            curve.write(json.dumps(rec) + "\n")
            curve.flush()
            if not np.isfinite(mean_loss):
                print(f"[{name}] DIVERGED at step {done_steps}", flush=True)
                feeder.close()
                curve.close()
                return {"model": name, "diverged_at": done_steps}
    curve.close()
    train_secs = time.time() - t0
    feeder.close()
    model.save_weight("latest", os.path.join(run_dir, "ckpt"))

    print(f"\n[{name}] trained {done_steps} steps in {train_secs:.0f}s; "
          f"evaluating ...", flush=True)
    n_eval = 50 if smoke else n_test
    records = list(synthvoc.test_records(d))[:n_eval]
    t1 = time.time()
    mAP, aps = evaluate.evaluate_model(model, records)
    result = {
        "model": name, "steps": done_steps, "batch": batch,
        "input": [h, w], "base_lr": base_lr,
        "train_seconds": round(train_secs, 1),
        "train_imgs_per_sec": round(done_steps * batch / train_secs, 1),
        "eval_images": len(records),
        "eval_seconds": round(time.time() - t1, 1),
        "mAP@0.5_voc07": round(float(mAP), 4),
        "per_class_AP": {str(k): round(float(v), 4) for k, v in sorted(aps.items())},
        "device": device_lib.card_line(device),
    }
    # anything under 500 steps is a probe, never a convergence result
    fname = "result.json" if (done_steps >= 500 and not smoke) else "probe_result.json"
    with open(os.path.join(run_dir, fname), "w") as f:
        json.dump(result, f, indent=1)
    print(f"[{name}] mAP@0.5 = {mAP:.4f}  ({done_steps} steps, "
          f"{result['train_imgs_per_sec']} imgs/s)", flush=True)
    return result


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    scale = 1.0
    for a in sys.argv[1:]:
        if a.startswith("--steps-scale="):
            scale = float(a.split("=")[1])
    specs = model_specs()
    names = args or list(specs)
    unknown = [n for n in names if n not in specs]
    if unknown:
        print(f"no spec for {unknown}: the port has {sorted(specs)} "
              "(the other families: ROADMAP.md, queue 1)", file=sys.stderr)
        return 2
    results = [run_model(n, steps_scale=scale, smoke="--smoke" in sys.argv)
               for n in names]
    print(json.dumps(results))
    return 0 if all("mAP@0.5_voc07" in r for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
