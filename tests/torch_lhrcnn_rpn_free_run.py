"""LH-RCNN's RPN phase, tpudet and the port free-running side by side from
flax's initial variables, on the CPU.

    python tests/torch_lhrcnn_rpn_free_run.py [--steps=501] [--resume]
        [--out=DIR] [--threads=8] [--init=FILE]
    python tests/torch_lhrcnn_rpn_free_run.py --self [--steps=501] [--threads=4]

Both packages start from flax's initial variables of the LHRCNN-long spec
(``scripts/train_convergence.py``: 700x1100, batch 8, chunked feed,
``gt_pad`` 24; ``--init``, default ``build/LHRCNN-long_tpudet_init.pt``,
written by ``python tests/torch_flax_init.py LHRCNN-long``) with zero
velocity, in float32. Each runs its own full RPN-phase step on the same
batch: tpudet its jitted ``_train_step_fn``, the port ``LHRCNN.train_step``
(the step-keyed device augmentation, train-mode ``feature_extractor``,
``rpn`` and the ``rcnn`` thin map with every BatchNorm's statistics,
``rpn_loss_and_sample``, weight decay over ``feature_extractor`` and
``rpn``, Momentum at the spec's lr on those scopes, ``rcnn`` untouched).
The feed is ``tests/torch_lhrcnn_free_run.py``'s: the spec's chunked
stream from step 0, scenes rendered on demand.

Before the first step the noise floor is measured: the port's own step from
the initial state at ``torch.set_num_threads(1)`` against ``--threads``,
and with oneDNN off against on, per leaf the larger relative difference of
the two pairs of updates.

Every ``SIDE_EVERY`` steps the port also steps from tpudet's current state
(parameters, every BatchNorm statistic, velocity) on the same batch
(teacher-forced), and records for each parameter of the two scopes and each
BatchNorm statistic the update's relative difference to tpudet's, its
projection on tpudet's update and the norm of the running sum of the
differences, each relative to its step's update, from step ``SIDE_EVERY``
on (a bias grows it linearly, noise as the square root), and the port's own noise there, per leaf: its step with
oneDNN off against on, and with the images times ``1 + 2^-22`` against
them (the yardsticks of the repo's gradient checks), tpudet's own step with
the images so against its step, and the float32 spacing of tpudet's new
values over its update.

Records go to ``DIR`` (default
``.convergence/torch_runs/LHRCNN-long-rpn-cpu-free/``): ``floor.json``,
``steps.jsonl`` (a line a step: both losses; written every
``RECORD_EVERY`` steps), ``side.jsonl`` and, every ``SAVE_EVERY`` steps,
``ckpt_rpn_free.pt`` (both packages' state and velocity, the side sums),
from which ``--resume`` continues a cut run. At the end ``result.json``
holds ``scripts/compare_runs_torch.py --rpn-free-run``'s summary and
verdict. It needs JAX and tpudet, is not collected by pytest, and takes a
few tens of GB: run nothing heavy beside it.

``--self`` runs the yardstick of the free curves instead (:func:`run_self`):
the port against itself from the same state and stream, the second run's
images times ``1 + 2^-22`` at every step, to
``.convergence/torch_runs/LHRCNN-long-rpn-cpu-self/steps.jsonl``. How far
two such runs part in a 50-step window is what chaos alone gives.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [p for p in (str(REPO / "tests"),) if p not in sys.path]

import torch_lhrcnn_free_run as fr  # noqa: E402

SPEC = fr.SPEC
RUN = "LHRCNN-long-rpn-cpu-free"
SELF_RUN = "LHRCNN-long-rpn-cpu-self"
SIDE_EVERY = fr.SIDE_EVERY
RECORD_EVERY = 25
SAVE_EVERY = 50
CKPT = "ckpt_rpn_free.pt"


def is_stat(key):
    return key.endswith((".mean", ".var"))


def models(init_path):
    """tpudet's LHRCNN-long model in float32 and two of the port's (the free
    one and the side one), all at flax's initial variables; tpudet's
    variables and zero velocity as numpy trees."""
    import torch

    import torch_flax_init as fi
    import train_convergence_torch as tc

    state = torch.load(init_path)
    cls, config = fi.spec_class(SPEC, mode="train")
    config = dict(config, compute_dtype="float32")
    held = {}

    class FromInit(cls):
        def _init_variables(self):
            template = fr._template(self)
            held.update(variables=fi.to_flax(state, template))
            self.params = held["variables"]["params"]
            self.batch_stats = held["variables"]["batch_stats"]
            self._optimizer = self._make_optimizer()
            self.opt_state = None

        def _setup_mesh(self):  # no padding to a CPU mesh
            self.device_batch = self.batch_size

    jm = FromInit(config)
    cls_path, _, t_config, _, _, _ = tc.model_specs()[SPEC]
    t_config = {k: v for k, v in t_config.items() if k not in fi.SCRIPT_KEYS}
    t_config["compute_dtype"] = "float32"
    ports = []
    for _ in range(2):
        pm = tc._load_class(cls_path)(t_config, None, device="cpu")
        pm.net.load_state_dict(state, strict=True)
        with torch.no_grad():
            for v in pm.velocity.values():
                v.zero_()
        pm.global_step = 0
        ports.append(pm)
    velocity = jm._optimizer.init(held["variables"]["params"]).velocity
    return jm, ports, held["variables"], velocity


def set_state(pm, state, velocity, step):
    """Load a port model with a full ``state_dict``, a velocity dict and
    ``global_step``."""
    import torch

    pm.net.load_state_dict(state, strict=True)
    with torch.no_grad():
        for k, v in pm.velocity.items():
            v.copy_(velocity[k])
    pm.global_step = step


def port_step(pm, images, gt, lr, scale=1.0):
    """The port's full train step on a numpy batch, its images times
    ``scale`` on the device; the loss."""
    x, g = pm._to_device(images, gt)
    return float(pm.train_step(x * scale if scale != 1.0 else x, g, lr))


def tpudet_state(params, stats, velocity):
    """tpudet's trees as the port's ``state_dict`` and velocity dict."""
    import jax

    from tpudet_torch.runtime import transfer

    params, stats, velocity = jax.device_get((params, stats, velocity))
    return (transfer.from_flax({"params": params, "batch_stats": stats}),
            transfer.velocity_from_flax(velocity))


def leaf_keys(pm):
    """The parameters of the RPN phase's scopes and every BatchNorm
    statistic, as ``state_dict`` keys."""
    from tpudet_torch.models.lhrcnn import RPN_SCOPES

    return [k for k in pm.net.state_dict()
            if is_stat(k) or (k.split(".", 1)[0] in RPN_SCOPES and k in pm.velocity)]


def rel_updates(old, got, want, keys):
    """Per leaf, ``|(got - old) - (want - old)| / |want - old|``."""
    import torch

    out = {}
    for k in keys:
        u = (want[k] - old[k]).double()
        d = (got[k] - old[k]).double() - u
        out[k] = float(torch.linalg.vector_norm(d)) / max(
            float(torch.linalg.vector_norm(u)), 1e-300)
    return out


def ulp_floor(old, new, keys):
    """Per leaf the float32 resolution of the update: the norm of the
    spacing of ``new``'s values over that of ``new - old``. A leaf whose
    update is a few ulps (a scale moved by weight decay alone) differs by
    its rounding whatever the arithmetic."""
    import torch

    out = {}
    for k in keys:
        v = new[k].float()
        ulp = (torch.nextafter(v, torch.full_like(v, float("inf"))) - v).double()
        out[k] = float(torch.linalg.vector_norm(ulp)) / max(
            float(torch.linalg.vector_norm((new[k] - old[k]).double())), 1e-300)
    return out


def noise_floor(pm, state, velocity, images, gt, lr, threads):
    """The port's own float32 noise from ``state``: its step at one thread
    against ``threads`` (``rel_threads``), and with oneDNN off against on
    (``rel_onednn``: the repo's other summation-order yardstick; a leaf that
    the thread count leaves bit for bit, the first BatchNorm's mean, moves
    under it). Per leaf ``rel`` is the larger of the two; both losses and
    step times."""
    import torch

    keys = leaf_keys(pm)
    new = {}
    for name, n, onednn in (("base", threads, True), ("threads_1", 1, True),
                            ("onednn_off", threads, False)):
        torch.set_num_threads(n)
        set_state(pm, state, velocity, 0)
        t0 = time.time()
        with torch.backends.mkldnn.flags(enabled=onednn):
            loss = port_step(pm, images, gt, lr)
        new[name] = ({k: v.clone() for k, v in pm.net.state_dict().items()}, loss,
                     time.time() - t0)
    torch.set_num_threads(threads)
    by_threads = rel_updates(state, new["threads_1"][0], new["base"][0], keys)
    by_onednn = rel_updates(state, new["onednn_off"][0], new["base"][0], keys)
    return {"threads": threads, "rel": {k: max(by_threads[k], by_onednn[k]) for k in keys},
            "rel_threads": by_threads, "rel_onednn": by_onednn,
            "loss": {k: v[1] for k, v in new.items()},
            "seconds": {k: v[2] for k, v in new.items()}}


def side_record(old, new_t, new_p, sums, keys, accumulate):
    """Per leaf ``[rel, proj, |sum|, sum of proj]``: the port's update
    against tpudet's from one state (its relative difference, its projection
    on tpudet's update), and the running sum of the differences, each taken
    relative to its step's update (``torch_lhrcnn_free_run.side_record``
    sums them raw; the lr here grows tenfold at the end of the warm-up, so
    raw sums would grow with it), from the first ``accumulate`` step on;
    ``sums`` updated in place."""
    import torch

    out = {}
    for k in keys:
        want = (new_t[k] - old[k]).double()
        diff = (new_p[k] - old[k]).double() - want
        norm = max(float(torch.linalg.vector_norm(want)), 1e-300)
        proj = float(torch.sum(diff * want)) / norm ** 2
        if accumulate:
            if k in sums:
                sums[k]["sum"] += diff / norm
                sums[k]["proj"] += proj
            else:
                sums[k] = {"sum": diff / norm, "proj": proj}
        held = sums.get(k)
        out[k] = [float(torch.linalg.vector_norm(diff)) / norm, proj,
                  float(torch.linalg.vector_norm(held["sum"])) if held else 0.0,
                  held["proj"] if held else 0.0]
    return out


def run(steps, out_dir, resume=False, threads=8, init=None):
    fr._paths()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    import train_convergence_torch as tc
    from convergence_variants_torch import init_path

    torch.set_num_threads(threads)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    jm, (pm, side), variables, velocity = models(init or init_path(SPEC))
    t_params, t_stats = jax.device_put(variables["params"]), jax.device_put(
        variables["batch_stats"])
    t_opt = jax.device_put(velocity)
    from tpudet.runtime.optim import MomentumState

    t_step = jax.jit(jm._train_step_fn)
    keys = leaf_keys(pm)
    sums, start = {}, 0
    ckpt = out_dir / CKPT
    _, (h, w), config, _, _, _ = tc.model_specs()[SPEC]
    scenes = fr.Scenes(h, w, config["gt_pad"])
    if resume and ckpt.exists():
        blob = torch.load(ckpt, weights_only=False)
        start = blob["step"]
        t_params, t_stats, t_opt = (jax.device_put(blob["tpudet"][k])
                                    for k in ("params", "batch_stats", "velocity"))
        set_state(pm, blob["port"], blob["port_velocity"], start)
        sums = blob["sums"]
        print(f"resuming at step {start}", flush=True)
    elif not (out_dir / "floor.json").exists():
        _, rows, lr = next(fr.stream(SPEC, 0))
        images, gt = scenes.batch(rows)
        state0 = {k: v.clone() for k, v in pm.net.state_dict().items()}
        vel0 = {k: v.clone() for k, v in pm.velocity.items()}
        floor = noise_floor(side, state0, vel0, images, gt, lr, threads)
        (out_dir / "floor.json").write_text(json.dumps(floor, indent=1))
        worst = sorted(floor["rel"].items(), key=lambda kv: kv[1])
        print(f"noise floor: {len(worst)} leaves, smallest {worst[0]}, largest {worst[-1]}, "
              f"step {floor['seconds']}", flush=True)
    for name in ("steps.jsonl", "side.jsonl"):
        fr._truncate(out_dir / name, start)
    t_opt = MomentumState(t_opt) if not isinstance(t_opt, MomentumState) else t_opt
    lines, t0 = [], time.time()
    for step, rows, lr in fr.stream(SPEC, start):
        if step >= steps:
            break
        if not pm.is_rpn_step(step):
            raise ValueError(f"step {step} is not in the RPN phase")
        images, gt = scenes.batch(rows)
        old = (t_params, t_stats, t_opt)
        t_params, t_stats, t_opt, t_loss = t_step(
            *old, jnp.asarray(images), jnp.asarray(gt), jnp.float32(lr), jnp.int32(step))
        t_loss = float(t_loss)
        p_loss = port_step(pm, images, gt, lr)
        rec = {"step": step, "lr": lr, "rows": [int(r) for r in rows],
               "tpudet_loss": t_loss, "port_loss": p_loss}
        if step % SIDE_EVERY == 0:
            before, before_vel = tpudet_state(old[0], old[1], old[2].velocity)
            moved = {}
            for name, onednn, scale in (("onednn", False, 1.0),
                                        ("images", True, 1.0 + 2.0 ** -22)):
                set_state(side, before, before_vel, step)
                with torch.backends.mkldnn.flags(enabled=onednn):
                    port_step(side, images, gt, lr, scale)
                moved[name] = {k: v.clone() for k, v in side.net.state_dict().items()}
            bumped = t_step(*old, jnp.asarray(images, jnp.float32) * jnp.float32(
                1.0 + 2.0 ** -22), jnp.asarray(gt), jnp.float32(lr), jnp.int32(step))
            moved["tpudet_images"] = tpudet_state(*bumped[:2], bumped[2].velocity)[0]
            set_state(side, before, before_vel, step)
            s_loss = port_step(side, images, gt, lr)
            got = side.net.state_dict()
            after, _ = tpudet_state(t_params, t_stats, t_opt.velocity)
            leaves = side_record(before, after, got, sums, keys,
                                 accumulate=step >= SIDE_EVERY)
            with open(out_dir / "side.jsonl", "a") as f:
                f.write(json.dumps({"step": step, "tpudet_loss": t_loss,
                                    "port_loss": s_loss, "leaves": leaves,
                                    "floor": dict(
                                        {n: rel_updates(before, m, got, keys)
                                         for n, m in moved.items() if n != "tpudet_images"},
                                        tpudet_images=rel_updates(
                                            before, moved["tpudet_images"], after, keys),
                                        ulp=ulp_floor(before, after, keys))})
                        + "\n")
            rec["side_loss"] = s_loss
        lines.append(json.dumps(rec))
        done = step + 1
        print(f"step {step}: tpudet {t_loss:.5f} port {p_loss:.5f} "
              f"({(p_loss / t_loss - 1) * 100:+.3f}%), "
              f"{(time.time() - t0) / (done - start):.2f} s a step", flush=True)
        if done % RECORD_EVERY == 0 or done == steps:
            with open(out_dir / "steps.jsonl", "a") as f:
                f.write("".join(ln + "\n" for ln in lines))
            lines = []
        if done % SAVE_EVERY == 0 and done < steps:
            blob = {"step": done,
                    "tpudet": dict(zip(("params", "batch_stats", "velocity"),
                                       jax.device_get((t_params, t_stats, t_opt.velocity)))),
                    "port": pm.net.state_dict(),
                    "port_velocity": dict(pm.velocity), "sums": sums}
            torch.save(blob, str(ckpt) + ".tmp")
            os.replace(str(ckpt) + ".tmp", ckpt)
    return summary(out_dir)


def summary(out_dir):
    """``result.json``: ``compare_runs_torch.rpn_free_run`` of the records."""
    import compare_runs_torch as cr

    out = cr.rpn_free_run(out_dir)
    (Path(out_dir) / "result.json").write_text(json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in ("steps", "verdict", "reasons")}), flush=True)
    return out


def run_self(steps, out_dir, threads=8, init=None):
    """The chaos yardstick of the free run: the port against itself, two
    free runs from the same initial state on the same stream, the second's
    images times ``1 + 2^-22`` at every step. ``steps.jsonl`` holds both
    losses a step (``port_loss``, ``bumped_loss``); no JAX."""
    fr._paths()
    import torch

    import torch_flax_init as fi
    import train_convergence_torch as tc
    from convergence_variants_torch import init_path

    torch.set_num_threads(threads)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    state = torch.load(init or init_path(SPEC))
    cls_path, (h, w), config, _, _, _ = tc.model_specs()[SPEC]
    t_config = {k: v for k, v in config.items() if k not in fi.SCRIPT_KEYS}
    t_config["compute_dtype"] = "float32"
    pair = []
    for _ in range(2):
        pm = tc._load_class(cls_path)(t_config, None, device="cpu")
        set_state(pm, state, {k: torch.zeros_like(v) for k, v in pm.velocity.items()}, 0)
        pair.append(pm)
    scenes = fr.Scenes(h, w, config["gt_pad"])
    (out_dir / "steps.jsonl").write_text("")
    lines, t0 = [], time.time()
    for step, rows, lr in fr.stream(SPEC, 0):
        if step >= steps:
            break
        images, gt = scenes.batch(rows)
        a = port_step(pair[0], images, gt, lr)
        b = port_step(pair[1], images, gt, lr, 1.0 + 2.0 ** -22)
        lines.append(json.dumps({"step": step, "lr": lr, "port_loss": a, "bumped_loss": b}))
        print(f"step {step}: port {a:.5f} bumped {b:.5f} ({(b / a - 1) * 100:+.3f}%), "
              f"{(time.time() - t0) / (step + 1):.2f} s a step", flush=True)
        if (step + 1) % RECORD_EVERY == 0 or step + 1 == steps:
            with open(out_dir / "steps.jsonl", "a") as f:
                f.write("".join(ln + "\n" for ln in lines))
            lines = []


def main(argv):
    opts = dict(a[2:].split("=", 1) if "=" in a else (a[2:], "1")
                for a in argv if a.startswith("--"))
    if "self" in opts:
        out = opts.get("out", str(REPO / ".convergence" / "torch_runs" / SELF_RUN))
        run_self(int(opts.get("steps", 501)), out, threads=int(opts.get("threads", 8)),
                 init=opts.get("init"))
        return 0
    out = opts.get("out", str(REPO / ".convergence" / "torch_runs" / RUN))
    run(int(opts.get("steps", 501)), out, resume="resume" in opts,
        threads=int(opts.get("threads", 8)), init=opts.get("init"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
