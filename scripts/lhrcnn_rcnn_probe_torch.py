"""LH-RCNN's RCNN phase from a trained state, in bfloat16 and in float32.

    python scripts/lhrcnn_rcnn_probe_torch.py STATE [STEPS]

STATE is the ``state_at_5000.pt`` that ``scripts/convergence_variants_torch.py
LHRCNN-long-tpudet-init --state-at=5000`` writes: the RPN phase's parameters,
velocity and every BatchNorm statistic after 5000 steps. The rest of the net
(the ``rcnn`` scope's parameters, never trained before step 5000) is flax's
initial variables, ``build/LHRCNN-long_tpudet_init.pt`` (``python
tests/torch_flax_init.py LHRCNN-long``). For each dtype in turn, the
LHRCNN-long spec's model with that ``compute_dtype`` takes that state and
``global_step``, and trains STEPS (default 2000) steps of the RCNN phase at
the spec's lr there, 3e-4, in 50-step epochs from the spec's chunked feed
(from its seed: not the stream the original run was at by step 5000), then
scores 150 held-out scenes. The runs differ in the compute dtype alone.

Writes ``curve_<dtype>.jsonl`` and ``result.json`` under
``.convergence/torch_runs/LHRCNN-long-rcnn-probe/`` and prints the result as
one JSON line last: for each dtype the mean loss of each 500-step window, the
mAP@0.5 on the held-out scenes, images/s and the NMS kernel's launches.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import train_convergence_torch as tc  # noqa: E402
from convergence_variants_torch import init_path  # noqa: E402

SPEC = "LHRCNN-long"
RUN = "LHRCNN-long-rcnn-probe"
CHUNK = 50
WINDOW = 500
EVAL_IMAGES = tc.MID_EVAL_IMAGES


def run(dtype, state_path, steps, root=tc.CONVERGENCE_ROOT, size=None,
        n_train=tc.synthvoc.N_TRAIN, n_test=tc.synthvoc.N_TEST, chunk=CHUNK,
        init=None, device=None, render_workers=1):
    """One dtype's run (module docstring); returns its record. ``size``,
    ``n_train`` and ``n_test`` as ``run_model``'s; ``init`` the initial
    ``state_dict``'s file (default ``init_path(SPEC)``)."""
    import torch

    from tpudet_torch import device as device_lib
    from tpudet_torch.data.device_dataset import DeviceDataset
    from tpudet_torch.ops.cuda import nms_kernel

    device = device_lib.resolve(device)
    cls, (h, w), config, _, _, _ = tc._spec(SPEC, size)
    config["compute_dtype"] = dtype
    carried = torch.load(state_path, map_location=device)
    step0 = int(carried["global_step"])
    if not (config["rpn_first_step"] <= step0 and step0 + steps <= config["rcnn_first_step"]):
        raise ValueError(f"steps {step0}..{step0 + steps - 1} leave the RCNN phase")
    d = tc.render_dataset(os.path.join(root, "data"), h, w, n_train, n_test, render_workers)
    train_images, train_gt, _, _ = tc.synthvoc.load(d)
    batch = config["batch_size"]
    feeder = DeviceDataset(train_images, train_gt[:, :config.pop("gt_pad")], batch, seed=1,
                           max_bytes=config.pop("max_bytes", 10 * 10**9),
                           chunk_bytes=config.pop("chunk_bytes"),
                           rotate_every=config.pop("rotate_every"), device=device)
    provider = {"data_shape": [h, w, 3], "num_train": batch, "num_val": 0,
                "train_generator": feeder, "val_generator": None}
    model = cls(config, provider, device=device)
    model.train_initializer = None
    state = torch.load(init or init_path(SPEC), map_location=device)
    state.update(carried["params"])
    model.net.load_state_dict(state, strict=True)
    with torch.no_grad():
        for k, v in carried["velocity"].items():
            model.velocity[k].copy_(v)
    model.global_step = step0
    _, _, _, lr, total, schedule = tc.model_specs()[SPEC]
    lr = _lr_at(step0, lr, total, schedule)
    run_dir = os.path.join(root, "torch_runs", RUN)
    os.makedirs(run_dir, exist_ok=True)
    before = dict(nms_kernel.launches_by_path)
    curve, t0 = [], time.time()
    try:
        with open(os.path.join(run_dir, f"curve_{dtype}.jsonl"), "w") as f:
            for _ in range(0, steps, chunk):
                model.num_train = chunk * batch
                loss = model.train_one_epoch(lr)
                curve.append({"step": model.global_step, "lr": lr,
                              "mean_loss": round(float(loss), 5)})
                f.write(json.dumps(curve[-1]) + "\n")
                f.flush()
    finally:
        feeder.close()
    seconds = time.time() - t0
    launches = {k: v - before[k] for k, v in nms_kernel.launches_by_path.items()}
    records = list(tc.synthvoc.test_records(d))[:EVAL_IMAGES]
    mAP, _ = tc._evaluate(f"{RUN} {dtype}", model, records)
    return {"dtype": dtype, "from_step": step0, "steps": model.global_step - step0,
            "lr": lr, "windows": windows(curve, step0), "mAP@0.5_voc07": round(float(mAP), 4),
            "eval_images": len(records), "train_seconds": round(seconds, 1),
            "train_imgs_per_sec": round((model.global_step - step0) * batch / seconds, 1),
            "train_nms_launches": launches, "device": device_lib.card_line(device)}


def _lr_at(step, base_lr, total, schedule):
    """The spec's lr at ``step``, as ``run_model`` steps its schedule."""
    done = 0
    for frac, mult in schedule:
        done += max(1, int(round(total * frac)))
        if step < done:
            return base_lr * mult
    return base_lr * schedule[-1][1]


def windows(curve, step0, width=WINDOW):
    """``{end: mean loss of the chunks that end in (end - width, end]}``,
    ``end`` counted from ``step0``."""
    out = {}
    for rec in curve:
        end = step0 + -(-(rec["step"] - step0) // width) * width
        out.setdefault(end, []).append(rec["mean_loss"])
    return {str(k): round(sum(v) / len(v), 5) for k, v in sorted(out.items())}


def main(argv):
    steps = int(argv[1]) if len(argv) > 1 else 2000
    result = {dt: run(dt, argv[0], steps, render_workers=tc.RENDER_WORKERS)
              for dt in ("bfloat16", "float32")}
    with open(os.path.join(tc.CONVERGENCE_ROOT, "torch_runs", RUN, "result.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
