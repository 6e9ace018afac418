"""One trained net evaluated through both packages on the CPU.

    python tests/torch_cross_eval.py NAME CARRY [--images=N] [--data=DIR]
                                                [--threads=T] [--out=FILE]
                                                [--dtype=float32]

``CARRY`` is a carry copy (``carry.pt`` of a run of
``scripts/convergence_variants_torch.py``: the trained ``state_dict`` with
its kernels rounded to bfloat16). The script

  1. renders spec ``NAME``'s synthvoc set at its input size with the port's
     ``render_dataset`` (under ``DIR``, default ``.convergence/data``; a set
     already there is reused) and takes the first ``N`` (default 500)
     held-out scenes;
  2. loads the copy into tpudet's model of the spec (test mode, its config,
     bfloat16 as in the run, or ``--dtype``; through
     :func:`torch_flax_init.to_flax`) and into the port's on the CPU;
  3. runs each package's own ``evaluate_model`` on the same records, each
     model's ``test_one_image`` recording its detections;
  4. prints both mAP@0.5 values, the per-class APs, the images whose
     detections differ (in their count or a class, or a box by more than
     1e-2 px), also among the detections scoring 0.3 or more, and the
     first of them, the largest box and score differences
     where the picks agree, and the mAP of the card run that wrote the copy
     (``result.json`` beside it), and writes them as JSON to ``FILE``
     (default ``cross_eval.json`` beside the copy);
  5. holds the pieces apart: both packages' ``evaluate_detections`` on
     tpudet's detections, and on the first differing image (:func:`diagnose`)
     the inputs, the nets' outputs on the same input, and both decodes on
     tpudet's outputs.

It needs JAX and tpudet; it is not collected by pytest.
"""

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
BOX_TOL = 1e-2  # px: a box that moves further is a different detection
CONFIDENT = 0.3  # score: the detections also compared on their own


def _args(argv):
    opts = {"images": 500, "data": str(REPO / ".convergence" / "data"), "threads": 8,
            "out": None, "dtype": None}
    pos = []
    for a in argv:
        if a.startswith("--"):
            k, v = a[2:].split("=", 1)
            opts[k] = type(opts[k])(v) if opts[k] is not None else v
        else:
            pos.append(a)
    return pos, opts


def recording(model, log):
    """Make ``model.test_one_image`` append its ``[scores, boxes, classes]``
    to ``log``."""
    real = model.test_one_image

    def test_one_image(images):
        out = real(images)
        log.append([np.asarray(o) for o in out])
        return out
    model.test_one_image = test_one_image


def difference(a, b):
    """How two images' detections differ: ``"picks"`` (a count or a class),
    ``"boxes"`` (a box by more than ``BOX_TOL``), or None; and the largest
    box and score differences where the picks agree."""
    if len(a[0]) != len(b[0]) or not np.array_equal(a[2], b[2]):
        return "picks", None, None
    if not len(a[0]):
        return None, 0.0, 0.0
    box = float(np.abs(np.asarray(a[1], np.float64) - np.asarray(b[1], np.float64)).max())
    score = float(np.abs(np.asarray(a[0], np.float64) - np.asarray(b[0], np.float64)).max())
    return ("boxes" if box > BOX_TOL else None), box, score


def compare_decodes(a, b):
    """Two decodes' valid detections: ``(same picks, largest box px
    difference)``; picks are the valid flags and classes."""
    a, b = [[np.asarray(t) for t in d[:4]] for d in (a, b)]
    if not (np.array_equal(a[3], b[3]) and np.array_equal(a[2][a[3]], b[2][b[3]])):
        return False, None
    box = np.abs(a[1][a[3]].astype(np.float64) - b[1][b[3]]).max() if a[3].any() else 0.0
    return True, float(box)


def diagnose(jm, pm, record, h, w):
    """One image, function by function: the two packages' inputs
    (``eval_preprocess``), then their nets' outputs on the same input
    (tpudet's NHWC against the port's NCHW: the largest and the normwise
    difference and the share of equal values, beside the port's own
    normwise difference between its two CPU summation orders, oneDNN's
    convolutions and PyTorch's own), then both decodes on tpudet's outputs
    (``_decode_outputs``, the family's decode)."""
    import jax
    import jax.numpy as jnp
    import torch

    from tpudet.runtime import evaluate as j_eval
    from tpudet_torch.runtime import evaluate as t_eval

    image, _ = record
    inp, _ = t_eval.eval_preprocess(image, h, w)
    j_inp, _ = j_eval.eval_preprocess(image, h, w)
    apply = jax.jit(lambda p, b, x: jm.net.apply({"params": p, "batch_stats": b},
                                                 jm._preprocess(x), False))
    j_out = [np.asarray(o, np.float32)
             for o in apply(jm.params, jm.batch_stats, jnp.asarray(j_inp[None]))]
    pm.net.eval()
    x = torch.from_numpy(np.ascontiguousarray(inp[None].transpose(0, 3, 1, 2)))
    with torch.no_grad():
        t_out = [o.float().numpy().transpose(0, 2, 3, 1) for o in pm.net(pm._preprocess(x))]
        with torch.backends.mkldnn.flags(enabled=False):  # the port's other summation order
            t_other = [o.float().numpy().transpose(0, 2, 3, 1)
                       for o in pm.net(pm._preprocess(x))]

    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    outputs = [{"max_abs": float(np.abs(t - j).max()), "rel": rel(t, j),
                "equal_share": float((t == j).mean()), "port_orders_rel": rel(o, t)}
               for t, j, o in zip(t_out, j_out, t_other)]
    want = jm._decode_outputs([jnp.asarray(o) for o in j_out], jm._base_pre_topk)
    with torch.no_grad():
        got = pm._decode_outputs([torch.from_numpy(np.ascontiguousarray(
            o.transpose(0, 3, 1, 2))) for o in j_out])
    same, box = compare_decodes(want, [t.numpy() for t in got])
    return {"inputs_equal": bool(np.array_equal(inp, j_inp)), "net_outputs": outputs,
            "decodes_on_tpudets_outputs_same_picks": same,
            "decodes_on_tpudets_outputs_max_box_px": box}


def main(argv):
    (name, carry_path), opts = _args(argv)
    sys.path[:0] = [str(REPO), str(REPO / "scripts"), str(REPO / "tests")]
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    torch.set_num_threads(opts["threads"])
    import torch_flax_init
    import train_convergence_torch as tc
    from tpudet.runtime import evaluate as j_eval
    from tpudet_torch.runtime import evaluate as t_eval

    t0 = time.time()
    cls, (h, w), config, _, _, _ = tc._spec(name, None)
    if opts["dtype"]:
        config["compute_dtype"] = opts["dtype"]
    d = tc.render_dataset(opts["data"], h, w, workers=tc.RENDER_WORKERS)
    records = list(tc.synthvoc.test_records(d))[:opts["images"]]
    print(f"[{name}] {len(records)} held-out scenes at {h}x{w} ({time.time() - t0:.1f} s)",
          flush=True)
    carry = torch.load(carry_path, map_location="cpu")

    jcls, jconfig = torch_flax_init.spec_class(name)
    jm = jcls(dict(jconfig, compute_dtype=config["compute_dtype"]))
    tree = torch_flax_init.to_flax(carry, {"params": jax.device_get(jm.params),
                                           "batch_stats": jax.device_get(jm.batch_stats)})
    jm.params = jax.tree.map(jnp.asarray, tree["params"])
    jm.batch_stats = jax.tree.map(jnp.asarray, tree["batch_stats"])
    port_config = {k: v for k, v in config.items() if k not in tc.SCRIPT_KEYS}
    pm = cls(dict(port_config, mode="test"), None, device="cpu")
    pm.net.load_state_dict(carry, strict=True)

    logs, scores, seconds = {}, {}, {}
    for side, model, mod in (("tpudet", jm, j_eval), ("port", pm, t_eval)):
        logs[side] = []
        recording(model, logs[side])
        t = time.time()
        scores[side] = mod.evaluate_model(model, records)
        seconds[side] = round(time.time() - t, 1)
        print(f"[{name}] {side}: mAP@0.5 {scores[side][0]:.4f} in {seconds[side]} s",
              flush=True)
    diffs = [difference(a, b) for a, b in zip(logs["tpudet"], logs["port"])]
    confident = [difference(*[[o[a[0] >= CONFIDENT] for o in a] for a in pair])[0]
                 for pair in zip(logs["tpudet"], logs["port"])]
    diff = [i for i, (kind, _, _) in enumerate(diffs) if kind]
    same_picks = [(box, score) for kind, box, score in diffs if kind != "picks"]
    # evaluate_detections of each package on the same detections (tpudet's)
    unmaps = [t_eval.eval_preprocess(image, h, w)[1] for image, _ in records]
    dets = {i: [(s_, np.asarray(u(np.asarray(b, np.float64))), int(c))
                for s_, b, c in zip(*logs["tpudet"][i])] for i, u in enumerate(unmaps)}
    gts = {i: np.stack([g[:, 0], g[:, 2], g[:, 1], g[:, 3], g[:, 4]], -1)
           for i, (_, g) in enumerate(records)}
    nc = getattr(pm, "raw_classes", None) or (pm.num_classes - 1)
    on_same = [float(mod.evaluate_detections(dets, gts, nc, 0.5, True)[0])
               for mod in (j_eval, t_eval)]
    diagnosis = diagnose(jm, pm, records[diff[0]], h, w) if diff else None
    card = None
    result = Path(carry_path).with_name("result.json")
    if result.exists():
        card = json.loads(result.read_text())["mAP@0.5_voc07"]
    out = {"model": name, "carry": str(carry_path), "images": len(records),
           "input": [h, w],
           **{f"{side}_mAP@0.5": round(float(scores[side][0]), 4) for side in scores},
           **{f"{side}_per_class_AP": {str(k): round(float(v), 4)
                                       for k, v in sorted(scores[side][1].items())}
              for side in scores},
           "images_differing": len(diff), "first_differing": diff[0] if diff else None,
           "images_differing_in_picks": sum(k == "picks" for k, _, _ in diffs),
           f"images_differing_above_{CONFIDENT}": sum(k is not None for k in confident),
           "max_box_px_where_picks_agree": max((b for b, _ in same_picks), default=None),
           "median_box_px_where_picks_agree": (float(np.median([b for b, _ in same_picks]))
                                               if same_picks else None),
           "max_score_where_picks_agree": max((s for _, s in same_picks), default=None),
           "compute_dtype": config["compute_dtype"],
           "evaluate_detections_on_tpudets_detections": on_same,
           "first_differing_diagnosis": diagnosis,
           "detections": {side: int(sum(len(x[0]) for x in logs[side])) for side in logs},
           "box_tol_px": BOX_TOL, "card_mAP@0.5": card, "seconds": seconds}
    path = opts["out"] or str(Path(carry_path).with_name("cross_eval.json"))
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
