"""Per-model train-step phase profiler of the port on one NVIDIA GPU (the
counterpart of ``scripts/profile_model.py``, with its specs, batch and
phases).

Splits a family's train step into nested phases, each built from the model's
own methods so that it computes what ``train_step`` computes, each holding
the ones before it (the deltas localise the cost). The forward phases run
with autograd recording, as in the step:

    fwd        ``_device_augment``, ``_preprocess`` and the net in train mode
    fwd+loss   + ``_loss_from_outputs`` and ``weight_decay * global_l2``
    grad       ``_step_grads`` of that loss (every gradient an output)
    step       ``train_step`` itself

LH-RCNN's step has two stages (tpudet's ``profile_lhrcnn``):

    fwd        the net: the feature extractor, the RPN head, ``thin_feature``
    +rpn       + ``rpn_loss_and_sample`` and the weighted mean: the RPN loss
    +rcnn      ``phase_loss(..., rpn_phase=False)``: the RCNN loss
    grad@rpn   ``_step_grads`` of the RPN phase's loss on its scopes
    grad@rcnn  ``_step_grads`` of the RCNN phase's loss on its scopes
    step       ``train_step`` at ``global_step`` 0, the RPN phase (tpudet's)
    step@rcnn  ``train_step`` at ``global_step`` ``rpn_first_step``, the RCNN phase

``global_step`` is restored after every phase.

Figures for each phase (``n`` timed calls after ``warmup``):

    host_ms    perf_counter over the n calls, ended by ``torch.cuda.synchronize``
    device_ms  the durations of the device operations (kernels, copies,
               memsets) that torch.profiler records in one more call, summed
               (a call's mean over more calls where the profiler recorded
               nothing for one)
    kernels    the kernels among those operations, a call
    busy       device_ms / host_ms
    syncs      the synchronising CUDA calls of one more call, as
               ``torch.cuda.set_sync_debug_mode("warn")`` reports them
    launches   a call, over the n timed calls, from the wrappers' counters:
               the assignment kernel's (``assign``), the NMS pool calls
               (``nms_rows``) and each NMS kernel's
    calls      the phase's calls in all: warm-up, timed, profiled and
               (on the card) the sync-debug one

On the CPU (``device="cpu"``, the tests) there is no device operation and no
kernel launch: those figures are 0.

Run from the root of a checkout:  python scripts/profile_model_torch.py [model ...]
(default YOLOv2, as tpudet's). Writes PROFILE_TORCH.json at the root of the
checkout, one record a family merged into what is there (the serve phases of
``scripts/profile_decode_torch.py`` stay under each family's ``serve`` key).
A family that fails records its error, the rest go on, and the script exits 1.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time
import warnings

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_all_torch import LR, _specs, fixed_provider, seeded_batch  # noqa: E402

from tpudet_torch import device as device_lib  # noqa: E402
from tpudet_torch.ops.cuda import assign_kernel, nms_kernel  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "PROFILE_TORCH.json")
PROFILE_PAD_S = 0.01  # host pause at each end of a profiled call
# calls of each profiler session tried in turn while the profiler records no
# device operation (it has returned none for a session of one short call)
PROFILE_CALLS = (1, 4, 16)
# tpudet's deltas: label -> (phase, phase it is taken over)
DELTAS = {"loss": ("fwd+loss", "fwd"), "bwd": ("grad", "fwd+loss"), "opt": ("step", "grad")}
LHRCNN_DELTAS = {"rpn-sample": ("+rpn", "fwd"), "roi+rcnn": ("+rcnn", "+rpn"),
                 "bwd@rpn": ("grad@rpn", "+rpn"), "bwd@rcnn": ("grad@rcnn", "+rcnn"),
                 "step-over-grad": ("step", "grad@rpn"),
                 "step-over-grad@rcnn": ("step@rcnn", "grad@rcnn")}


# ------------------------------------------------------------------ figures
def counts() -> dict:
    """The kernel wrappers' launch counters."""
    return {"assign": assign_kernel.launches, "nms_rows": nms_kernel.launches,
            **nms_kernel.launches_by_path}


def sync(dev) -> None:
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def device_ops(fn, dev):
    """``(ops, calls)``: ``(name, us)`` of every device operation that
    torch.profiler records over ``calls`` calls of ``fn``, which sit between
    two host pauses inside the session. A session is one call; one that
    records nothing on the card is run again with more calls
    (``PROFILE_CALLS``). No operation on the CPU."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    for calls in PROFILE_CALLS if dev.type == "cuda" else PROFILE_CALLS[:1]:
        sync(dev)
        with profile(activities=activities) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(calls):
                fn()
            sync(dev)
            time.sleep(PROFILE_PAD_S)
        ops = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if ops:
            break
    return ops, calls


def host_syncs(fn, dev) -> list:
    """The synchronising CUDA calls of one call of ``fn``, as the sync debug
    mode reports them (none on the CPU)."""
    if dev.type != "cuda":
        return []
    import torch

    sync(dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sync(dev)
    return [str(w.message).splitlines()[0][:160] for w in caught
            if "synchroniz" in str(w.message).lower()
            and "prototype" not in str(w.message).lower()]


def measure(fn, dev, n, warmup, p50=False) -> dict:
    """The figures of one phase (module docstring). ``p50``: host_ms is the
    median of the n calls, each ended by a sync, instead of their mean."""
    for _ in range(warmup):
        fn()
    sync(dev)
    before = counts()
    times = []
    t0 = time.perf_counter()
    for _ in range(n):
        t = time.perf_counter()
        fn()
        if p50:
            sync(dev)
            times.append(time.perf_counter() - t)
    sync(dev)
    host_ms = 1e3 * (statistics.median(times) if p50 else (time.perf_counter() - t0) / n)
    launches = {k: (v - before[k]) / n for k, v in counts().items()}
    ops, profiled = device_ops(fn, dev)
    device_ms = sum(us for _, us in ops) / 1e3 / profiled
    syncs = host_syncs(fn, dev)
    return {"host_ms": host_ms, "device_ms": device_ms,
            "kernels": sum(not name.startswith(("Memcpy", "Memset"))
                           for name, _ in ops) / profiled,
            "busy": device_ms / host_ms, "syncs": len(syncs), "launches": launches,
            "calls": warmup + n + profiled + (dev.type == "cuda")}


def line(label, fig, batch=None) -> str:
    rate = f"  {batch / fig['host_ms'] * 1e3:8.1f} imgs/s" if batch else ""
    launched = {k: v for k, v in fig["launches"].items() if v}
    return (f"  {label:12s} {fig['host_ms']:8.2f} ms{rate}  device {fig['device_ms']:8.3f} "
            f"ms ({100 * fig['busy']:5.1f}% busy), {fig['kernels']} kernels, "
            f"{fig['syncs']} syncs, launches {launched}")


def run_phases(model, phases, n, warmup, batch=None, p50=False) -> dict:
    """``measure`` each phase in order, ``model.global_step`` restored after
    each; prints tpudet's line for each."""
    out = {}
    for label, fn in phases.items():
        start = model.global_step
        try:
            fig = measure(fn, model.device, n, warmup, p50)
        finally:
            model.global_step = start
        print(line(label, fig, batch), flush=True)
        out[label] = fig
    return out


def deltas(phases, table) -> dict:
    return {label: {k: phases[a][k] - phases[b][k] for k in ("host_ms", "device_ms")}
            for label, (a, b) in table.items()}


def print_deltas(d) -> None:
    print("  deltas: " + " | ".join(f"{label} {v['host_ms']:.2f} ms (device "
                                    f"{v['device_ms']:.2f})" for label, v in d.items()),
          flush=True)


# ------------------------------------------------------------------ phases
def train_phases(model, images, gt, lr=LR) -> dict:
    """label -> one call of that phase on the device batch ``images``, ``gt``;
    each returns what its phase computes."""
    from tpudet_torch.models.base import global_l2
    from tpudet_torch.runtime import mesh as mesh_lib

    net = model.net
    params = dict(net.named_parameters())

    def forward():
        x, g = model._device_augment(images, gt, model.global_step)
        net.train()
        return net(model._preprocess(x)), g

    def fwd():
        with mesh_lib.over(model.mesh):
            return forward()[0]

    def loss():
        with mesh_lib.over(model.mesh):
            outputs, g = forward()
            return model._loss_from_outputs(outputs, g, model._sample_weight())

    def fwd_loss():
        return loss() + model.weight_decay * global_l2(params.values())

    return {"fwd": fwd, "fwd+loss": fwd_loss,
            "grad": lambda: model._step_grads(loss(), params),
            "step": lambda: model.train_step(images, gt, lr)}


def lhrcnn_phases(model, images, gt, lr=LR) -> dict:
    """LH-RCNN's phases (module docstring), as :func:`train_phases`."""
    from tpudet_torch.heads import lhrcnn as lh
    from tpudet_torch.models.lhrcnn import RCNN_SCOPES, RPN_SCOPES
    from tpudet_torch.ops import losses as loss_ops
    from tpudet_torch.runtime import mesh as mesh_lib

    net = model.net
    scoped = {phase: {k: p for k, p in net.named_parameters()
                      if k.split(".", 1)[0] in scopes}
              for phase, scopes in ((True, RPN_SCOPES), (False, RCNN_SCOPES))}

    def augmented():
        return model._device_augment(images, gt, model.global_step)

    def fwd():
        x, _ = augmented()
        with mesh_lib.over(model.mesh):
            return net.train()(model._preprocess(x))

    def rpn():
        x, g = augmented()
        with mesh_lib.over(model.mesh):
            rpn_conf, rpn_loc, _ = net.train()(model._preprocess(x))
            sample = lh.rpn_loss_and_sample(*model._split_rpn(rpn_conf, rpn_loc),
                                            model.anchors, g)
            return loss_ops.weighted_mean(sample.rpn_loss, model._sample_weight())

    def phase_loss(rpn_phase):
        x, g = augmented()
        with mesh_lib.over(model.mesh):
            return model.phase_loss(x, g, rpn_phase)

    def step_at(global_step):
        def call():
            model.global_step = global_step
            return model.train_step(images, gt, lr)
        return call

    return {"fwd": fwd, "+rpn": rpn, "+rcnn": lambda: phase_loss(False),
            "grad@rpn": lambda: model._step_grads(phase_loss(True), scoped[True]),
            "grad@rcnn": lambda: model._step_grads(phase_loss(False), scoped[False]),
            "step": step_at(0), "step@rcnn": step_at(model.rpn_first_step)}


# ------------------------------------------------------------------ families
def build(name, spec, device=None):
    """The family's model from seeded random weights at the spec's config and
    tpudet's bench batch on its device: ``(model, images, gt)``."""
    from tpudet_torch import models

    dev = device_lib.resolve(device)
    images, gt = seeded_batch(spec)
    model = getattr(models, name)(dict(spec["config"]), fixed_provider(images, gt),
                                  device=dev)
    return (model, *model._to_device(images, gt))


def profile_model(name, spec, n=10, warmup=3, device=None) -> dict:
    """One family's train-step phases (LH-RCNN's two stages for ``LHRCNN``);
    ``device=None`` is the card."""
    h, w = spec["shape"]
    batch = spec["batch"]
    print(f"=== {name} (batch {batch} @ {h}x{w}) building...", flush=True)
    model, images, gt = build(name, spec, device)
    lhrcnn = name == "LHRCNN"
    phases = run_phases(model, (lhrcnn_phases if lhrcnn else train_phases)(model, images, gt),
                        n, warmup, batch)
    d = deltas(phases, LHRCNN_DELTAS if lhrcnn else DELTAS)
    print_deltas(d)
    record = {"batch": batch, "shape": [h, w], "compute_dtype": spec["config"].get(
        "compute_dtype", "float32"), "n": n, "warmup": warmup, "phases": phases,
        "deltas": d, "device": device_lib.card_line(model.device)}
    dev = model.device
    del model, images, gt
    empty_cache(dev)
    return record


def empty_cache(dev) -> None:
    if dev.type == "cuda":
        import torch

        torch.cuda.empty_cache()


def merge(out, name, record, key=None) -> None:
    """Write ``record`` into ``out`` (JSON) as ``name``'s record, keeping its
    ``serve`` key, or as its ``key`` entry."""
    results = {}
    if os.path.exists(out):
        with open(out) as f:
            results = json.load(f)
    entry = results.get(name, {})
    if key is None:
        entry = {**({"serve": entry["serve"]} if "serve" in entry else {}), **record}
    else:
        entry[key] = record
    results[name] = entry
    with open(out, "w") as f:
        json.dump(results, f, indent=1)


def run_all(fn, names, out, key=None) -> int:
    """``fn(name, spec)`` for each family, each record merged into ``out``;
    a family that raises records its error. Returns 1 if any failed."""
    failed = []
    for name in names:
        try:
            record = fn(name, _specs()[name])
        except Exception as e:  # keep going; record the failure
            import traceback

            traceback.print_exc()
            print(f"  {name} FAILED: {e!r}", flush=True)
            record = {"error": repr(e)[:500]}
            failed.append(name)
        merge(out, name, record, key)
    print("wrote", out)
    if failed:
        print("failed:", ", ".join(failed), file=sys.stderr)
    return 1 if failed else 0


def main(argv=None, out=OUT, device=None) -> int:
    names = list(sys.argv[1:] if argv is None else argv) or ["YOLOv2"]
    return run_all(lambda name, spec: profile_model(name, spec, device=device), names, out)


if __name__ == "__main__":
    sys.exit(main())
