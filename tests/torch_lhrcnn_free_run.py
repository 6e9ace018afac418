"""LH-RCNN's RCNN phase, tpudet and the port free-running side by side from
one trained state, on the CPU.

    python tests/torch_lhrcnn_free_run.py STATE [--steps=1000] [--resume]
        [--out=DIR] [--threads=8] [--init=FILE]

STATE is the ``state_at_5000.pt`` that ``scripts/convergence_variants_torch.py
LHRCNN-long-tpudet-init --state-at=5000`` writes on the card: the RPN phase's
parameters, velocity and every BatchNorm statistic after 5000 steps of the
LHRCNN-long spec (700x1100, batch 8). The ``rcnn`` scope, never trained
before that step, is flax's initial one (``--init``, default
``build/LHRCNN-long_tpudet_init.pt``, written by ``python
tests/torch_flax_init.py LHRCNN-long``) with zero velocity. Both
packages take that state, in float32: tpudet through
``torch_flax_init.to_flax``, the port through its ``state_dict``.

The RCNN phase trains the ``rcnn`` scope alone, and train-mode BatchNorm
normalises by the batch, so the trunk's outputs depend on the batch alone.
Each step therefore runs one trunk, tpudet's, jitted: its step-keyed device
augmentation, ``feature_extractor``, ``rpn`` and ``rpn_loss_and_sample`` give
``c4`` and the sample, and both packages' RCNN steps take them, each on its
own ``rcnn`` state (the thin map, the crop, the RoI head, ``rcnn_losses``,
weight decay over ``rcnn`` and Momentum, at the spec's lr there). The
port's own ``rpn_loss_and_sample`` also runs on tpudet's RPN outputs; its
picks (both NMS calls' selections and valid masks, the positives' labels)
are compared exactly and the images that differ counted.

The feed is the spec's chunked stream where the original run was at STATE's
step: ``DeviceDataset`` over row ids with the spec's budgets scaled to rows
of 3 bytes (the geometry of ``tests/test_torch_device_feed.py``'s chunked
stream test), replayed through the spec's 50-step epochs, each batch's
scenes rendered as ``synthvoc.build`` renders them.

Every ``SIDE_EVERY`` steps the port also steps from tpudet's current
``rcnn`` state on the same batch (teacher-forced), and records for each
leaf of the scope the update's relative difference to tpudet's, its
projection on tpudet's update and the norm of the running sum of the
differences (a bias grows it linearly, noise as the square root).

Records go to ``DIR`` (default ``.convergence/torch_runs/LHRCNN-long-cpu-free/``):
``steps.jsonl`` (a line a step: both losses, the sample's mismatched
images; written every ``RECORD_EVERY`` steps), ``side.jsonl`` and, every
``SAVE_EVERY`` steps, ``ckpt_free.pt`` (both packages' ``rcnn`` state and
the side sums) from which ``--resume`` continues a cut run. At the end
``result.json`` holds the 250-step windows of both CPU curves, the port's
card rerun and tpudet's run (``scripts/compare_runs_torch.py
--free-run``). It needs JAX and tpudet, takes ~12 s a step on 8 cores and
is not collected by pytest.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
SPEC = "LHRCNN-long"
RUN = "LHRCNN-long-cpu-free"
SIDE_EVERY = 25
RECORD_EVERY = 50
SAVE_EVERY = 250
CKPT = "ckpt_free.pt"


def _paths():
    for p in (str(REPO / "scripts"), str(REPO / "tests"), str(REPO)):
        if p not in sys.path:
            sys.path.insert(0, p)


# ------------------------------------------------------------ tpudet's side
def tpudet_sample(pyx, phw, pconf, anc, gt):
    """tpudet's ``rpn_loss_and_sample`` (traced) and the outputs of its two
    sampling NMS calls, ``(pos_sel, pos_valid, neg_sel, neg_valid)``,
    caught as it makes them."""
    from tpudet.heads import lhrcnn as lh

    picks, real = [], lh.nms.batched_greedy_nms

    def caught(*args, **kwargs):
        out = real(*args, **kwargs)
        picks.extend(out)
        return out

    lh.nms.batched_greedy_nms = caught
    try:
        sample = lh.rpn_loss_and_sample(pyx, phw, pconf, anc, gt)
    finally:
        lh.nms.batched_greedy_nms = real
    return sample, tuple(picks)


def tpudet_trunk(jm):
    """tpudet's jitted ``fn(params, batch_stats, images, gt, step)``: the
    train step's augmentation, preprocessing, train-mode ``feature_extractor``
    and ``rpn``, and the sample. Returns a dict: ``c4`` (NHWC), ``pyx``,
    ``phw``, ``pconf``, the augmented ``gt``, ``sample`` and ``picks``."""
    import jax
    import jax.numpy as jnp

    net = jm.net

    def trunk(params, bstats, images, gt, step):
        images, gt = jm._device_augment(images.astype(jnp.float32), gt, step)
        variables = {"params": params, "batch_stats": bstats}
        c4, _ = net.apply(variables, jm._preprocess(images), True,
                          method=lambda m, x, t: m.feature_extractor(x, t),
                          mutable=["batch_stats"])
        (conf, loc), _ = net.apply(variables, c4, True,
                                   method=lambda m, x, t: m.rpn(x, t),
                                   mutable=["batch_stats"])
        pyx, phw, pconf = jm._split_rpn(conf, loc)
        sample, picks = tpudet_sample(pyx, phw, pconf, jm.anchors, gt)
        return dict(c4=c4, pyx=pyx, phw=phw, pconf=pconf, gt=gt, sample=sample,
                    picks=picks)

    return jax.jit(trunk)


def tpudet_rcnn_step(jm):
    """tpudet's jitted ``fn(params, batch_stats, velocity, c4, sample, lr)``
    over the ``rcnn`` scope's trees: its train step's RCNN branch (the thin
    map, ``rcnn_losses``, ``weight_decay * global_l2(params["rcnn"])`` and
    Momentum). Returns the new ``(params, batch_stats, velocity, loss)``."""
    import jax

    from tpudet.heads import lhrcnn as lh
    from tpudet.models.base import global_l2
    from tpudet.models.lhrcnn import LHRCNNNet
    from tpudet.runtime.optim import MomentumState

    net, opt, wd = jm.net, jm._optimizer, jm.weight_decay
    (h, w), classes, weight = jm.data_shape_hw, jm.num_classes, jm._sample_weight()

    def step(params, bstats, velocity, c4, sample, lr):
        def loss_fn(p):
            feat, mut = net.apply({"params": {"rcnn": p}, "batch_stats": {"rcnn": bstats}},
                                  c4, True, method=lambda m, x, t: m.rcnn.thin_feature(x, t),
                                  mutable=["batch_stats"])

            def roi_fn(feats):
                return net.apply({"params": {"rcnn": p}}, feats, method=LHRCNNNet.roi_head)

            loss = lh.rcnn_losses(roi_fn, feat, sample, float(h), float(w), classes,
                                  sample_weight=weight)
            return loss + wd * global_l2(p), mut["batch_stats"]["rcnn"]

        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        new, state = opt.update(grads, MomentumState(velocity), params, lr)
        return new, stats, state.velocity, loss

    return jax.jit(step)


# -------------------------------------------------------------- the port's
def torch_sample(sample):
    """tpudet's ``RPNSample`` (numpy or JAX arrays) as the port's."""
    import torch

    from tpudet_torch.heads import lhrcnn as t_lh

    return t_lh.RPNSample(*(torch.from_numpy(np.array(x)) for x in sample))


def nchw(c4):
    """An NHWC map (numpy or JAX) as a contiguous NCHW tensor."""
    import torch

    return torch.from_numpy(np.array(c4)).permute(0, 3, 1, 2).contiguous()


def port_trunk(pm, images, gt):
    """The port's train step up to its RCNN loss, on a device batch: the
    augmentation, ``c4`` and the RPN outputs without gradient, and its
    sample. Returns ``(c4, sample)``."""
    import torch

    from tpudet_torch.heads import lhrcnn as t_lh

    images, gt = pm._device_augment(images, gt, pm.global_step)
    net = pm.net.train()
    with torch.no_grad():
        c4 = net.feature_extractor(pm._preprocess(images))
        conf, loc = net.rpn(c4)
        sample = t_lh.rpn_loss_and_sample(*pm._split_rpn(conf, loc), pm.anchors, gt)
    return c4, sample


def port_rcnn_step(pm, c4, sample, lr):
    """The port's train step from its RCNN loss on: the thin map of ``c4``
    (NCHW), ``rcnn_losses`` of ``sample``, weight decay over ``rcnn`` and
    Momentum on it (``LHRCNN.train_step``'s RCNN phase). Returns the loss."""
    import torch

    from tpudet_torch.heads import lhrcnn as t_lh
    from tpudet_torch.models.lhrcnn import RCNN_SCOPES
    from tpudet_torch.runtime import mesh as mesh_lib

    net = pm.net.train()
    params = {k: p for k, p in net.named_parameters() if k.split(".", 1)[0] in RCNN_SCOPES}
    h, w = pm.data_shape_hw
    with mesh_lib.over(pm.mesh), torch.enable_grad():
        feat = net.rcnn.thin_feature(c4)
        loss = t_lh.rcnn_losses(net.roi_head, feat, sample, float(h), float(w),
                                pm.num_classes, sample_weight=pm._sample_weight())
    grads, loss, _ = pm._step_grads(loss, params)
    pm._optimizer.update(dict(zip(params, grads)), pm.opt_state, params, lr)
    pm.global_step += 1
    return loss


def port_picks(pm, pyx, phw, pconf, gt):
    """The port's ``rpn_loss_and_sample`` on the given RPN outputs, in its
    parts: ``((pos_sel, pos_valid, neg_sel, neg_valid), sample)``."""
    from tpudet_torch.heads import lhrcnn as t_lh

    rows = t_lh.rpn_rows(pconf, pm.anchors, gt)
    sel = t_lh.rpn_select(rows, pm.anchors)
    return sel, t_lh.rpn_sample(rows, *sel, pyx, phw, pm.anchors, gt)


def same_sets(want_picks, want_labels, got_picks, got_labels, image):
    """Whether image ``image`` picked the same positives (with their labels)
    and the same negatives on both sides, in whatever order."""
    (wp, wpv, wn, wnv), (gp, gpv, gn, gnv) = (
        [np.asarray(a)[image] for a in picks] for picks in (want_picks, [
            g.numpy() for g in got_picks]))
    wl, gl = np.asarray(want_labels)[image], got_labels.numpy()[image]
    return bool(sorted(zip(wp[wpv], wl[wpv])) == sorted(zip(gp[gpv], gl[gpv]))
                and sorted(wn[wnv]) == sorted(gn[gnv]))


def mismatched_images(want_picks, want_labels, got_picks, got_labels):
    """The images whose picks differ: either NMS call's selections or valid
    mask, or a selected positive's label."""
    bad = np.zeros(np.shape(want_labels)[0], bool)
    for w, g in zip(want_picks, got_picks):
        bad |= (np.asarray(w) != g.numpy()).any(-1)
    valid = np.asarray(want_picks[1])
    bad |= ((np.asarray(want_labels) != got_labels.numpy()) & valid).any(-1)
    return np.flatnonzero(bad)


# --------------------------------------------------------------------- state
def rcnn_state_dict(params, bstats):
    """tpudet's ``rcnn`` trees as the port's ``state_dict`` entries."""
    import jax

    from tpudet_torch.runtime import transfer

    return transfer.from_flax(jax.device_get({"params": {"rcnn": params},
                                              "batch_stats": {"rcnn": bstats}}))


def _template(jm):
    import jax
    import jax.numpy as jnp

    h, w = jm.data_shape_hw

    def init_all(mdl, x, feats):
        return mdl(x, False), mdl.roi_head(feats)

    return jax.eval_shape(lambda key: jm.net.init(
        key, jnp.zeros((1, h, w, 3)), jnp.zeros((1, 7, 7, 490)), method=init_all),
        jax.random.PRNGKey(0))


def models(state_path, init_path):
    """tpudet's and the port's LHRCNN-long models in float32 (and a second
    port model for the side steps), all at STATE over the initial file, and
    tpudet's variables and velocity as numpy trees."""
    import torch

    import torch_flax_init as fi
    import train_convergence_torch as tc

    carried = torch.load(state_path)
    state = torch.load(init_path)
    unknown = set(carried["params"]) - set(state)
    if unknown:
        raise KeyError(f"{state_path}: no such leaves {sorted(unknown)[:5]}")
    state.update(carried["params"])
    velocity = {k: torch.zeros_like(v) for k, v in state.items()
                if not k.endswith((".mean", ".var"))}
    velocity.update(carried["velocity"])

    cls, config = fi.spec_class(SPEC, mode="train")
    config = dict(config, compute_dtype="float32")
    held = {}

    class FromState(cls):
        def _init_variables(self):
            template = _template(self)
            held.update(variables=fi.to_flax(state, template),
                        velocity=fi.to_flax(velocity, {"params": template["params"]})["params"])
            self.params = held["variables"]["params"]
            self.batch_stats = held["variables"]["batch_stats"]
            self._optimizer = self._make_optimizer()
            self.opt_state = None

        def _setup_mesh(self):  # no padding to a CPU mesh
            self.device_batch = self.batch_size

    jm = FromState(config)
    cls_path, _, t_config, _, _, _ = tc.model_specs()[SPEC]
    t_config = {k: v for k, v in t_config.items() if k not in fi.SCRIPT_KEYS}
    t_config["compute_dtype"] = "float32"
    ports = []
    for _ in range(2):
        pm = tc._load_class(cls_path)(t_config, None, device="cpu")
        pm.net.load_state_dict(state, strict=True)
        with torch.no_grad():
            for k, v in velocity.items():
                pm.velocity[k].copy_(v)
        pm.global_step = int(carried["global_step"])
        ports.append(pm)
    return jm, ports, held["variables"], held["velocity"], int(carried["global_step"])


# ---------------------------------------------------------------------- feed
def stream(spec, start):
    """``(step, dataset rows, lr)`` of every step of ``spec``'s chunked feed
    from ``start``: its ``DeviceDataset`` on the CPU over row ids (rows of 3
    bytes, the byte budgets scaled alike: the same chunks, pins and
    rotations), drawn epoch by epoch as the run draws them."""
    import synthvoc
    import train_convergence_torch as tc
    from compare_runs_torch import epochs
    from tpudet_torch.data.device_dataset import DeviceDataset

    _, (h, w), config, base_lr, total, schedule = tc.model_specs()[spec]
    n, per, row = synthvoc.N_TRAIN, 3, h * w * 3
    ids = np.zeros((n, 1, 5), np.float32)
    ids[:, 0, 0] = np.arange(n)
    ds = DeviceDataset(np.zeros((n, 1, 1, 3), np.uint8), ids, config["batch_size"], seed=1,
                       max_bytes=config.get("max_bytes", 10**10) // row * per,
                       chunk_bytes=config["chunk_bytes"] // row * per,
                       rotate_every=config["rotate_every"], device="cpu")
    try:
        for first, k, lr in epochs(total, schedule, base_lr):
            idx = ds.scan_indices(k).numpy()
            rows = ds.gt.numpy()[idx, 0, 0].astype(np.int64)
            for i in range(k):
                if first + i >= start:
                    yield first + i, rows[i], lr
    finally:
        ds.close()


class Scenes:
    """The synthvoc training scenes at ``h`` x ``w``, rendered on demand as
    ``synthvoc.build`` renders them: uint8 images and center-form gt padded
    with -1 to ``gt_pad`` rows."""

    def __init__(self, h, w, gt_pad):
        import synthvoc

        self.synthvoc, self.hw, self.gt_pad = synthvoc, (h, w), gt_pad
        self.specs = synthvoc.scene_specs(np.random.default_rng(7),
                                          synthvoc.N_TRAIN + synthvoc.N_TEST)

    def batch(self, rows):
        sv = self.synthvoc
        images = np.empty((len(rows), *self.hw, 3), np.uint8)
        gt = np.full((len(rows), sv.MAX_OBJ, 5), -1.0, np.float32)
        for i, r in enumerate(rows):
            images[i], boxes = sv.render_scene(self.specs[int(r)], *self.hw)
            gt[i, :len(boxes)] = sv._corner_to_center(boxes)
        return images, gt[:, :self.gt_pad]


# ---------------------------------------------------------------- side step
def side_record(old, new_t, new_p, sums, keys):
    """Per leaf: the port's update against tpudet's from one state (its
    relative difference, its projection on tpudet's update), and the running
    sum of the differences (its norm over this update's; the projections'
    sum), ``sums`` updated in place."""
    import torch

    out = {}
    for k in keys:
        want = (new_t[k] - old[k]).double()
        diff = (new_p[k] - old[k]).double() - want
        norm2 = float(torch.sum(want * want))
        proj = float(torch.sum(diff * want)) / max(norm2, 1e-300)
        if k in sums:
            sums[k]["sum"] += diff.float()
        else:
            sums[k] = {"sum": diff.float().clone(), "proj": 0.0}
        sums[k]["proj"] += proj
        rel = float(torch.linalg.vector_norm(diff)) / max(norm2 ** 0.5, 1e-300)
        cum = float(torch.linalg.vector_norm(sums[k]["sum"].double())) / max(norm2 ** 0.5,
                                                                             1e-300)
        out[k] = [rel, proj, cum, sums[k]["proj"]]
    return out


# ---------------------------------------------------------------------- run
def _truncate(path, before):
    """Keep the lines of a jsonl file whose step is under ``before``."""
    if not path.exists():
        return
    keep = [ln for ln in path.read_text().splitlines()
            if ln.strip() and json.loads(ln)["step"] < before]
    path.write_text("".join(ln + "\n" for ln in keep))


def run(state_path, steps, out_dir, resume=False, threads=8, init=None):
    _paths()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    import train_convergence_torch as tc
    from convergence_variants_torch import init_path
    from tpudet_torch.models.lhrcnn import RCNN_SCOPES

    torch.set_num_threads(threads)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    jm, (pm, side), variables, velocity, step0 = models(state_path, init or init_path(SPEC))
    t_params = jax.device_put(variables["params"]["rcnn"])
    t_stats = jax.device_put(variables["batch_stats"]["rcnn"])
    t_vel = jax.device_put(velocity["rcnn"])
    frozen_params = jax.device_put(variables["params"])
    frozen_stats = jax.device_put(variables["batch_stats"])
    trunk, t_step = tpudet_trunk(jm), tpudet_rcnn_step(jm)
    keys = [k for k in pm.velocity if k.split(".", 1)[0] in RCNN_SCOPES]
    sums, start = {}, step0
    ckpt = out_dir / CKPT
    if resume and ckpt.exists():
        blob = torch.load(ckpt, weights_only=False)
        start = blob["step"]
        t_params, t_stats, t_vel = (jax.device_put(blob["tpudet"][k])
                                    for k in ("params", "batch_stats", "velocity"))
        pm.net.load_state_dict(blob["port"], strict=False)
        with torch.no_grad():
            for k in keys:
                pm.velocity[k].copy_(blob["port_velocity"][k])
        pm.global_step = start
        sums = blob["sums"]
        print(f"resuming at step {start}", flush=True)
    for name in ("steps.jsonl", "side.jsonl"):
        _truncate(out_dir / name, start)
    _, (h, w), config, _, _, _ = tc.model_specs()[SPEC]
    scenes = Scenes(h, w, config["gt_pad"])
    lines, t0 = [], time.time()
    for step, rows, lr in stream(SPEC, start):
        if step >= step0 + steps:
            break
        images, gt = scenes.batch(rows)
        t = trunk(frozen_params, frozen_stats, jnp.asarray(images), jnp.asarray(gt),
                  jnp.int32(step))
        t = jax.device_get(t)
        got_picks, got_sample = port_picks(
            pm, *(torch.from_numpy(np.array(t[k])) for k in ("pyx", "phw", "pconf", "gt")))
        bad = mismatched_images(t["picks"], t["sample"].pos_label, got_picks,
                                got_sample.pos_label)
        c4, sample = nchw(t["c4"]), torch_sample(t["sample"])
        old = (t_params, t_stats, t_vel)
        t_params, t_stats, t_vel, t_loss = t_step(*old, t["c4"], t["sample"], jnp.float32(lr))
        p_loss = float(port_rcnn_step(pm, c4, sample, lr))
        rec = {"step": step, "lr": lr, "rows": [int(r) for r in rows],
               "tpudet_loss": float(t_loss), "port_loss": p_loss,
               "rpn_loss": float(np.mean(t["sample"].rpn_loss)),
               "port_rpn_loss": float(got_sample.rpn_loss.mean()),
               "sample_mismatch": [int(i) for i in bad],
               "mismatch_same_sets": [same_sets(t["picks"], t["sample"].pos_label, got_picks,
                                                got_sample.pos_label, i) for i in bad]}
        if (step - step0) % SIDE_EVERY == 0:
            before = rcnn_state_dict(old[0], old[1])
            side.net.load_state_dict(before, strict=False)
            with torch.no_grad():
                for k, v in rcnn_state_dict(old[2], {}).items():
                    side.velocity[k].copy_(v)
            side.global_step = step
            s_loss = float(port_rcnn_step(side, c4, sample, lr))
            got = side.net.state_dict()
            leaves = side_record(before, rcnn_state_dict(t_params, t_stats), got, sums, keys)
            with open(out_dir / "side.jsonl", "a") as f:
                f.write(json.dumps({"step": step, "tpudet_loss": float(t_loss),
                                    "port_loss": s_loss, "leaves": leaves}) + "\n")
            rec["side_loss"] = s_loss
        lines.append(json.dumps(rec))
        done = step + 1
        print(f"step {step}: tpudet {float(t_loss):.5f} port {p_loss:.5f} "
              f"({(p_loss / float(t_loss) - 1) * 100:+.2f}%), sample mismatches {len(bad)}, "
              f"{(time.time() - t0) / (done - start):.2f} s a step", flush=True)
        if (done - step0) % RECORD_EVERY == 0 or done == step0 + steps:
            with open(out_dir / "steps.jsonl", "a") as f:
                f.write("".join(ln + "\n" for ln in lines))
            lines = []
        if (done - step0) % SAVE_EVERY == 0:
            blob = {"step": done,
                    "tpudet": dict(zip(("params", "batch_stats", "velocity"),
                                       jax.device_get((t_params, t_stats, t_vel)))),
                    "port": {k: v for k, v in pm.net.state_dict().items()
                             if k.split(".", 1)[0] in RCNN_SCOPES},
                    "port_velocity": {k: pm.velocity[k] for k in keys}, "sums": sums}
            torch.save(blob, str(ckpt) + ".tmp")
            os.replace(str(ckpt) + ".tmp", ckpt)
    return summary(out_dir, step0)


def summary(out_dir, step0):
    """``result.json``: the four curves' 250-step windows, their
    differences and the sample mismatches (``compare_runs_torch.free_run``),
    and the side steps' last record."""
    import compare_runs_torch as cr

    out = cr.free_run(out_dir, step0)
    side = [json.loads(ln) for ln in (Path(out_dir) / "side.jsonl").read_text().splitlines()
            if ln.strip()] if (Path(out_dir) / "side.jsonl").exists() else []
    out.update(step0=step0, side_steps=len(side), side_last=side[-1] if side else None)
    (Path(out_dir) / "result.json").write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items() if k != "side_last"}), flush=True)
    return out


def main(argv):
    opts = dict(a[2:].split("=", 1) if "=" in a else (a[2:], "1")
                for a in argv if a.startswith("--"))
    args = [a for a in argv if not a.startswith("--")]
    out = opts.get("out", str(REPO / ".convergence" / "torch_runs" / RUN))
    run(args[0], int(opts.get("steps", 1000)), out, resume="resume" in opts,
        threads=int(opts.get("threads", 8)), init=opts.get("init"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
