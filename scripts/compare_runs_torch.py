"""Hold a convergence run of the port against tpudet's run of the same spec.

    python scripts/compare_runs_torch.py NAME [TPUDET_NAME] [--window=1000]

Reads ``.convergence/torch_runs/NAME/`` (the port's ``curve.jsonl``,
``eval.jsonl``, ``result.json``) and ``.convergence/runs/TPUDET_NAME/``
(tpudet's; default ``NAME`` without a ``-seed1`` or ``-tpudet-init``
suffix) and prints one JSON object: both mAP@0.5 values, the port's per-class
range, its ``--eval-every`` curve, the mean loss of each window of steps
(``(k - window, k]``) on both sides and the port's difference in percent
(windows that tpudet's curve does not reach are left out), the port's
images/s and train seconds, and the card it ran on.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUFFIXES = ("-seed1", "-tpudet-init")


def _lines(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def windows(curve, width):
    """``{k: mean loss of the chunks whose step lies in (k - width, k]}``."""
    out = {}
    for rec in curve:
        k = -(-rec["step"] // width) * width
        out.setdefault(k, []).append(rec["mean_loss"])
    return {k: sum(v) / len(v) for k, v in sorted(out.items())}


def compare(name, base=None, width=1000, root=os.path.join(ROOT, ".convergence")):
    if base is None:
        base = name
        for s in SUFFIXES:
            base = base[:-len(s)] if base.endswith(s) else base
    port_dir, ref_dir = (os.path.join(root, d, n) for d, n in (("torch_runs", name),
                                                                 ("runs", base)))
    with open(os.path.join(port_dir, "result.json")) as f:
        port = json.load(f)
    ref_path = os.path.join(ref_dir, "result.json")
    ref = json.load(open(ref_path)) if os.path.exists(ref_path) else {}
    mine, theirs = (windows(_lines(os.path.join(d, "curve.jsonl")), width)
                    for d in (port_dir, ref_dir))
    aps = list(port["per_class_AP"].values())
    return {
        "model": name, "reference": base,
        "mAP": port["mAP@0.5_voc07"], "tpudet_mAP": ref.get("mAP@0.5_voc07"),
        "tpudet_steps": ref.get("steps"),
        "per_class_AP_range": [min(aps), max(aps)],
        "eval_curve": [(e["step"], e["mAP@0.5_voc07"])
                       for e in _lines(os.path.join(port_dir, "eval.jsonl"))],
        "loss_windows": {k: [round(v, 4), round(theirs[k], 4),
                             round(100 * (v / theirs[k] - 1), 1)]
                         for k, v in mine.items() if k in theirs},
        "steps": port["steps"], "images_per_s": port["train_imgs_per_sec"],
        "train_s": port["train_seconds"], "eval_s": port["eval_seconds"],
        "device": port.get("device"),
    }


def main(argv):
    args = [a for a in argv if not a.startswith("--")]
    width = 1000
    for a in argv:
        if a.startswith("--window="):
            width = int(a.split("=")[1])
    print(json.dumps(compare(args[0], args[1] if len(args) > 1 else None, width)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
