"""Hold a convergence run of the port against tpudet's run of the same spec.

    python scripts/compare_runs_torch.py NAME [TPUDET_NAME] [--window=1000]
    python scripts/compare_runs_torch.py --free-run[=DIR] [--window=250]
    python scripts/compare_runs_torch.py --rpn32 [--window=250]
    python scripts/compare_runs_torch.py --rpn-free-run[=DIR]

Reads ``.convergence/torch_runs/NAME/`` (the port's ``curve.jsonl``,
``eval.jsonl``, ``result.json``) and ``.convergence/runs/TPUDET_NAME/``
(tpudet's; default ``NAME`` without a ``-seed1`` or ``-tpudet-init``
suffix) and prints one JSON object: both mAP@0.5 values, the port's per-class
range, its ``--eval-every`` curve, the mean loss of each window of steps
(``(k - window, k]``) on both sides and the port's difference in percent
(windows that tpudet's curve does not reach are left out), the port's
images/s and train seconds, and the card it ran on.

``--free-run`` reads ``tests/torch_lhrcnn_free_run.py``'s records (``DIR``,
default ``.convergence/torch_runs/LHRCNN-long-cpu-free/``) and prints
:func:`free_run`: the mean loss of each window of four curves of
LHRCNN-long's RCNN phase from the free run's first step, tpudet's and the
port's CPU curves, the port's card rerun from the same state
(``LHRCNN-long-tpudet-init-rerun``) and tpudet's own run, and the free
run's classification by the rule that ``PERF.md`` states for it.

``--rpn-free-run`` reads ``tests/torch_lhrcnn_rpn_free_run.py``'s records
(``DIR``, default ``.convergence/torch_runs/LHRCNN-long-rpn-cpu-free/``) and
prints :func:`rpn_free_run`: both CPU curves of LHRCNN-long's RPN phase from
flax's initial variables in 50-step windows, each leaf's side steps against
the noise floor, and the verdict by the rule below; beside them, not in the
rule, the windows of the port against itself with its images times
``1 + 2^-22`` (``--self`` of that script, ``LHRCNN-long-rpn-cpu-self``).

``--rpn32`` prints :func:`rpn32_probe`: LHRCNN-long's RCNN-phase windows
(steps 5000-7000) of ``LHRCNN-long-tpudet-init-rpn32`` (its RPN phase in
float32), of the bfloat16 run ``LHRCNN-long-tpudet-init`` and of tpudet's
run, each run's difference from tpudet's in percent, and the probe's
classification by the rule of ROADMAP's Queue 3.
"""

import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUFFIXES = ("-seed1", "-tpudet-init")
FREE_RUN = "LHRCNN-long-cpu-free"
CARD_RERUN = "LHRCNN-long-tpudet-init-rerun"
# the rule: the port's RCNN step is at fault if its CPU curve sits FAULT_PCT
# or more over tpudet's in every window from FAULT_FROM; it is cleared if
# the two agree within CLEAR_PCT in every window from CLEAR_FROM
FAULT_PCT, FAULT_FROM, CLEAR_PCT, CLEAR_FROM = 2.0, 5750, 1.0, 5500
RPN32 = "LHRCNN-long-tpudet-init-rpn32"
BF16_RUN = "LHRCNN-long-tpudet-init"
# the probe's rule: within RPN32_NEAR_PCT of tpudet's in every RCNN window
# (5000, RPN32_END] is the platforms' bf16 arithmetic; RPN32_FAR_PCT or more
# above in every one leaves the gap open
RPN32_NEAR_PCT, RPN32_FAR_PCT, RPN32_START, RPN32_END = 1.0, 2.0, 5000, 7000
RPN_FREE_RUN = "LHRCNN-long-rpn-cpu-free"
RPN_SELF_RUN = "LHRCNN-long-rpn-cpu-self"  # the port against itself, images x (1 + 2^-22)
# the RPN free run's rule: the port's RPN step is cleared if every
# RPN_WINDOW-step window from step RPN_WINDOW_FROM has the two CPU losses
# within RPN_LOSS_PCT, no leaf's running sum of relative differences grows
# by RPN_GROWTH_MAX or more from side step RPN_GROWTH_FROM to RPN_GROWTH_TO
# (a bias grows it 4x, noise 2x), and every leaf's every side step is within
# RPN_FLOOR_MULT times its noise floor there (the largest of the step-0
# thread move, that side step's oneDNN and 2^-22 image moves of the port's
# own step, the repo's gradient-check yardsticks, the 2^-22 image move of
# tpudet's own step, and the float32 spacing of
# tpudet's new values over its update); some leaf failing either
# is a fault; anything else is between. Under RPN_MIN_STEPS steps: no verdict.
RPN_WINDOW, RPN_WINDOW_FROM, RPN_LOSS_PCT = 50, 100, 1.0
RPN_GROWTH_FROM, RPN_GROWTH_TO, RPN_GROWTH_MAX = 125, 500, 3.2
RPN_FLOOR_MULT, RPN_MIN_STEPS = 4.0, 250
BIAS_Z = 3.0  # after the run, not in the rule: |z| of a leaf's projections read as one sign


def _lines(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def last_per_step(curve):
    """A curve with one record a step, the last: a resumed run appends the
    epochs after its checkpoint again."""
    return list({rec["step"]: rec for rec in curve}.values())


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
    mine, theirs = (windows(last_per_step(_lines(os.path.join(d, "curve.jsonl"))), width)
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


def epochs(total, schedule, base_lr, chunk=50):
    """``(first step, steps, lr)`` of each epoch of a convergence run
    (``train_convergence_torch.run_model``'s chunks of the schedule's
    segments); its ``curve.jsonl`` has a line per epoch."""
    done = 0
    for frac, mult in schedule:
        seg = max(1, int(round(total * frac)))
        while seg > 0 and done < total:
            this = min(chunk, seg)
            yield done, this, base_lr * mult
            done += this
            seg -= this


def _chunks(spec):
    """``{last step + 1: first step}`` of each epoch of ``spec``'s run."""
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    import train_convergence_torch as tc

    _, _, _, lr, total, schedule = tc.model_specs()[spec]
    return {first + k: first for first, k, _ in epochs(total, schedule, lr)}


def free_run(run_dir=None, start=None, width=250, root=os.path.join(ROOT, ".convergence")):
    """The free run's four curves in windows of ``width`` steps from its
    first step ``start`` (default: the first in ``steps.jsonl``): each curve
    as the script's epochs (the CPU curves' steps averaged epoch by epoch;
    epochs that begin before ``start`` or that the CPU run has not finished
    are left out), then ``windows``. Returns the windows, the differences
    in percent (port over tpudet on the CPU, the card run over tpudet's, the
    CPU curves' mean over each card curve), the sample mismatches and the
    classification."""
    run_dir = run_dir or os.path.join(root, "torch_runs", FREE_RUN)
    steps = _lines(os.path.join(run_dir, "steps.jsonl"))
    start = steps[0]["step"] if start is None else start
    last = steps[-1]["step"] + 1
    chunks = {end: first for end, first in _chunks("LHRCNN-long").items()
              if first >= start and end <= last}
    by_step = {r["step"]: r for r in steps}

    def cpu(key):
        return [{"step": end, "mean_loss": sum(by_step[s][key] for s in range(first, end))
                 / (end - first)} for end, first in chunks.items()]

    curves = {"tpudet_cpu": cpu("tpudet_loss"), "port_cpu": cpu("port_loss")}
    for name, path in (("port_card", os.path.join(root, "torch_runs", CARD_RERUN)),
                       ("tpudet_tpu", os.path.join(root, "runs", "LHRCNN-long"))):
        curves[name] = [r for r in last_per_step(_lines(os.path.join(path, "curve.jsonl")))
                        if r["step"] in chunks]
    win = {k: windows(v, width) for k, v in curves.items()}
    ends = sorted(win["port_cpu"])

    def pct(a, b):
        return {k: round(100 * (win[a][k] / win[b][k] - 1), 2) for k in ends
                if k in win[a] and k in win[b]}

    gap = pct("port_cpu", "tpudet_cpu")
    cpu_mean = {k: (win["port_cpu"][k] + win["tpudet_cpu"][k]) / 2 for k in ends}
    fault = [gap[k] for k in ends if k >= FAULT_FROM]
    clear = [gap[k] for k in ends if k >= CLEAR_FROM]
    if fault and min(fault) >= FAULT_PCT:
        verdict = "port_rcnn_step_at_fault"
    elif clear and max(abs(g) for g in clear) <= CLEAR_PCT:
        verdict = "rcnn_step_cleared"
    else:
        verdict = "undecided"
    near = {k: ("port_card" if abs(cpu_mean[k] - win["port_card"][k])
                < abs(cpu_mean[k] - win["tpudet_tpu"][k]) else "tpudet_tpu")
            for k in ends if k >= CLEAR_FROM and k in win["port_card"]
            and k in win["tpudet_tpu"]}
    return {
        "start": start, "steps": last - start, "width": width,
        "windows": {k: {c: round(win[c][k], 5) for c in curves if k in win[c]}
                    for k in ends},
        "port_cpu_over_tpudet_cpu_pct": gap,
        "port_card_over_tpudet_tpu_pct": pct("port_card", "tpudet_tpu"),
        "cpu_mean_over_port_card_pct": {
            k: round(100 * (cpu_mean[k] / win["port_card"][k] - 1), 2)
            for k in ends if k in win["port_card"]},
        "cpu_mean_over_tpudet_tpu_pct": {
            k: round(100 * (cpu_mean[k] / win["tpudet_tpu"][k] - 1), 2)
            for k in ends if k in win["tpudet_tpu"]},
        "cpu_curves_nearer": near,
        "sample_mismatched_images": sum(len(r["sample_mismatch"]) for r in steps),
        "steps_with_sample_mismatch": sum(bool(r["sample_mismatch"]) for r in steps),
        "mismatched_images_with_other_sets": sum(
            not same for r in steps for same in r.get("mismatch_same_sets", [])),
        "verdict": verdict,
    }


def _rpn_windows(steps, a, b, names):
    """``{end: {names[0]: mean a, names[1]: mean b, "pct": b over a}}`` of
    each whole ``RPN_WINDOW``-step window of ``{step: record}``."""
    win = {}
    for lo in range(0, len(steps) - RPN_WINDOW + 1, RPN_WINDOW):
        if all(s in steps for s in range(lo, lo + RPN_WINDOW)):
            x, y = (sum(steps[s][k] for s in range(lo, lo + RPN_WINDOW)) / RPN_WINDOW
                    for k in (a, b))
            win[lo + RPN_WINDOW] = {names[0]: x, names[1]: y, "pct": 100 * (y / x - 1)}
    return win


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else 0.0


def _sign_z(xs):
    """``sum(xs) / sqrt(sum(xs^2))``: about ``sqrt(len(xs))`` in size for
    terms of one sign and size, about 1 for terms of random sign."""
    norm = math.sqrt(sum(x * x for x in xs))
    return sum(xs) / norm if norm > 0 else 0.0


def _worst_ratio(leaf):
    """A leaf's largest side-step difference over its floor at that step."""
    return max(r / max(f, 1e-300) for r, f in zip(leaf["rel"], leaf["floor"]))


def rpn_free_run(run_dir=None, root=os.path.join(ROOT, ".convergence")):
    """The RPN free run's summary: both CPU losses' ``RPN_WINDOW``-step
    windows and the port's difference in percent, each leaf's side-step
    series (relative difference, running-sum norm) beside its noise floor,
    the growth of the running sums, the leaves that break a test, and the
    verdict with its reasons. A run that stops short of ``RPN_GROWTH_TO``
    measures the growth to its last side step ``t``, against
    ``RPN_GROWTH_MAX * t / RPN_GROWTH_TO`` (linear growth gives ``t / 125``)."""
    run_dir = run_dir or os.path.join(root, "torch_runs", RPN_FREE_RUN)
    steps = {r["step"]: r for r in _lines(os.path.join(run_dir, "steps.jsonl"))}
    side = _lines(os.path.join(run_dir, "side.jsonl"))
    with open(os.path.join(run_dir, "floor.json")) as f:
        floor = json.load(f)
    n = len(steps)
    win = _rpn_windows(steps, "tpudet_loss", "port_loss", ("tpudet", "port"))
    chaos = _rpn_windows({r["step"]: r for r in _lines(os.path.join(
        root, "torch_runs", RPN_SELF_RUN, "steps.jsonl"))}, "port_loss", "bumped_loss",
        ("port", "bumped"))
    by_step = {r["step"]: r["leaves"] for r in side}
    leaves = sorted(floor["rel"])
    floors = {r["step"]: r["floor"] for r in side}
    order = sorted(by_step)
    series = {k: {"floor_threads": floor["rel_threads"][k],
                  "floor": [max(floor["rel_threads"][k], *(f[k] for f in floors[s].values()))
                            for s in order],
                  "rel": [by_step[s][k][0] for s in order],
                  "proj": [by_step[s][k][1] for s in order],
                  "sum_norm": [by_step[s][k][2] for s in order]} for k in leaves}
    last = max((s for s in by_step if s <= RPN_GROWTH_TO), default=0)
    limit = RPN_GROWTH_MAX * min(last, RPN_GROWTH_TO) / RPN_GROWTH_TO
    growth, over_floor = {}, {}
    for k in leaves:
        if RPN_GROWTH_FROM in by_step and last > RPN_GROWTH_FROM:
            growth[k] = by_step[last][k][2] / max(by_step[RPN_GROWTH_FROM][k][2], 1e-300)
        worst = _worst_ratio(series[k])
        if worst > RPN_FLOOR_MULT:
            over_floor[k] = worst
    grown = {k: g for k, g in growth.items() if g >= limit}
    late = [v["pct"] for end, v in win.items() if end - RPN_WINDOW >= RPN_WINDOW_FROM]
    loss_ok = bool(late) and max(abs(p) for p in late) <= RPN_LOSS_PCT
    reasons = []
    if n < RPN_MIN_STEPS:
        verdict = "no_verdict"
        reasons.append(f"{n} steps, under {RPN_MIN_STEPS}")
    else:
        if grown:
            reasons.append(f"{len(grown)} leaves grow {limit:.2f}x or more")
        if over_floor:
            reasons.append(f"{len(over_floor)} leaves over {RPN_FLOOR_MULT}x the floor")
        if not loss_ok:
            reasons.append(f"a window from step {RPN_WINDOW_FROM} off by more than "
                           f"{RPN_LOSS_PCT}%")
        verdict = ("fault" if grown or over_floor
                   else "rpn_step_cleared" if loss_ok else "between")
    ratio = sorted(_worst_ratio(series[k]) for k in leaves)
    # read after the run, not in the rule: a bias keeps its projection's sign
    # (|z| near the root of the side steps' count), noise flips it (|z| ~ 1);
    # a leaf's typical side step over its floor says whether its growth
    # follows the floor's
    bias_z = {k: _sign_z(series[k]["proj"][1:]) for k in leaves}
    rel_floor = {k: _median([r / max(f, 1e-300) for r, f in
                             zip(series[k]["rel"], series[k]["floor"]) if f > 0])
                 for k in leaves}
    return {"steps": n, "side_steps": sorted(by_step), "growth_to": last,
            "growth_limit": limit,
            "windows": {str(k): {c: round(v, 6) for c, v in w.items()}
                        for k, w in win.items()},
            "chaos_windows": {str(k): {c: round(v, 6) for c, v in w.items()}
                              for k, w in chaos.items()},
            "growth": {k: round(g, 4) for k, g in growth.items()},
            "growth_max": max(growth.values(), default=None),
            "growth_median": sorted(growth.values())[len(growth) // 2] if growth else None,
            "over_floor_ratio_max": ratio[-1] if ratio else None,
            "over_floor_ratio_median": ratio[len(ratio) // 2] if ratio else None,
            "leaves_grown": grown, "leaves_over_floor": over_floor,
            "floor": {k: floor[k] for k in floor
                      if k not in ("rel", "rel_threads", "rel_onednn")},
            "series": series, "verdict": verdict, "reasons": reasons,
            "after_run": {
                "bias_z": {k: round(v, 4) for k, v in bias_z.items()},
                "leaves_sign_consistent": {k: round(v, 4) for k, v in bias_z.items()
                                           if abs(v) >= BIAS_Z},
                "rel_over_floor_median": {k: round(v, 4) for k, v in rel_floor.items()},
                "grown_rel_over_floor_max": max((rel_floor[k] for k in grown), default=None)}}


def rpn32_probe(width=250, root=os.path.join(ROOT, ".convergence")):
    """The windows of the float32-RPN probe, the bfloat16 run and tpudet's
    run: each port run over tpudet's in percent in the RCNN windows
    (RPN32_START, RPN32_END], the probe's over tpudet's in the RPN windows
    before them, and the probe's verdict."""
    curves = {"rpn32": os.path.join(root, "torch_runs", RPN32),
              "bf16": os.path.join(root, "torch_runs", BF16_RUN),
              "tpudet": os.path.join(root, "runs", "LHRCNN-long")}
    win = {key: windows(last_per_step(_lines(os.path.join(path, "curve.jsonl"))), width)
           for key, path in curves.items()}

    def over_tpudet(key, lo, hi):
        return {k: round(100 * (v / win["tpudet"][k] - 1), 2)
                for k, v in win[key].items() if lo < k <= hi and k in win["tpudet"]}

    pct = {key: over_tpudet(key, RPN32_START, RPN32_END) for key in ("rpn32", "bf16")}
    gaps = list(pct["rpn32"].values())
    if gaps and max(abs(g) for g in gaps) <= RPN32_NEAR_PCT:
        verdict = "within_1pct_bf16_arithmetic"
    elif gaps and min(gaps) >= RPN32_FAR_PCT:
        verdict = "open_2pct_or_more_above"
    else:
        verdict = "between"
    return {"width": width,
            "windows": {k: {c: round(win[c][k], 5) for c in curves if k in win[c]}
                        for k in pct["rpn32"]},
            "over_tpudet_pct": pct,
            "rpn_phase_rpn32_over_tpudet_pct": over_tpudet("rpn32", 0, RPN32_START),
            "verdict": verdict}


def main(argv):
    args = [a for a in argv if not a.startswith("--")]
    width = None
    for a in argv:
        if a.startswith("--window="):
            width = int(a.split("=")[1])
    if "--rpn32" in argv:
        print(json.dumps(rpn32_probe(width or 250)))
        return 0
    rpn_free = [a for a in argv if a.split("=")[0] == "--rpn-free-run"]
    if rpn_free:
        run_dir = rpn_free[0].split("=", 1)[1] if "=" in rpn_free[0] else None
        out = rpn_free_run(run_dir)
        print(json.dumps({k: v for k, v in out.items() if k != "series"}))
        return 0
    free = [a for a in argv if a.split("=")[0] == "--free-run"]
    if free:
        run_dir = free[0].split("=", 1)[1] if "=" in free[0] else None
        print(json.dumps(free_run(run_dir, width=width or 250)))
        return 0
    print(json.dumps(compare(args[0], args[1] if len(args) > 1 else None, width or 1000)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
