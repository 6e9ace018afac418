"""The port's LH-RCNN step along tpudet's own trajectory, step by step.

    python tests/torch_lhrcnn_teacher.py [RPN_STEPS STEPS LR]   (default 20 50 3e-4)
        [--dtype=bfloat16] [--out=FILE.json]

tpudet trains ``tests/test_torch_lhrcnn.py``'s model (192x320, batch 2,
float32, 21 classes, numpy variables) on synthvoc scenes rendered at that
size, RPN phase for ``RPN_STEPS`` steps, then the RCNN phase. Before each
of tpudet's steps the port's model takes tpudet's state (parameters,
BatchNorm statistics, velocity, ``global_step``) and steps on the same
batch, so the two never drift apart: the script prints, every 5 steps,
the largest relative difference of the step's loss and the normwise
relative difference of the update of the phase's parameters (the port's
new minus the old, against tpudet's). A fault in a phase's step shows as
an update that parts at every step of that phase, not only at the
ill-conditioned first steps (train-mode BatchNorm over batch 2). It needs
JAX and tpudet; it is not collected by pytest.

``--dtype=bfloat16`` runs both models with ``compute_dtype`` bfloat16 (the
float32 default prints as before) and adds a line a step. tpudet's RoI crop
then takes the branch that ``TPUDET_ROI_IMPL`` names (``mm``, the TPU's
bfloat16 einsum, or ``gather``; unset, the CPU takes ``gather``), and XLA
runs with ``--xla_allow_excess_precision=false``, so each bfloat16 op
rounds its result as PyTorch's do: with excess precision XLA:CPU's fused
bfloat16 step of this model gave NaN parameters at the first step, where
the same step op by op gave none.
``--out`` writes the per-step series as JSON.

``--state=FILE`` steps from a trained state at the convergence spec's full
size instead: ``state_at_STEP.pt`` of ``scripts/convergence_variants_torch.py
LHRCNN-long-tpudet-init --state-at=STEP`` (the RPN phase's parameters,
velocity and every BatchNorm statistic after STEP steps on the card), over
flax's own initial variables of tpudet's LHRCNN-long spec for the rest (the
``rcnn`` scope, never trained before step 5000), on synthvoc scenes rendered
at 700x1100, batch 8, bfloat16, at the spec's lr there, 3e-4; ``STEPS``
(default 20) steps from ``global_step`` STEP. tpudet's trajectory takes the
TPU's crop, ``mm``; each step also takes tpudet's other crop, ``gather``,
from the same state, whose update against ``mm``'s is printed beside the
port's as a yardstick of what the crop alone moves.

    python tests/torch_lhrcnn_teacher.py --state=state_at_5000.pt [STEPS]
"""

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def _rel(got, want, keys):
    num = sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in keys)
    return (num / max(sum(float((want[k].double() ** 2).sum()) for k in keys),
                      1e-300)) ** 0.5


def _scenes(n, hw, gt_width):
    import synthvoc

    images, gts = [], []
    for spec in synthvoc.scene_specs(np.random.default_rng(7), n):
        image, boxes = synthvoc.render_scene(spec, *hw)
        gt = -np.ones((gt_width, 5), np.float32)
        gt[:len(boxes)] = synthvoc._corner_to_center(boxes)[:gt_width]
        images.append(image.astype(np.float32))
        gts.append(gt)
    return np.stack(images), np.stack(gts)


def _test_setup(argv, dtype):
    """``tests/test_torch_lhrcnn.py``'s model at 192x320, batch 2, from
    numpy variables, on 64 scenes."""
    from test_torch_lhrcnn import HW, config, port_model, tpudet_model

    rpn, steps, lr = (int(argv[0]), int(argv[1]), float(argv[2])) if argv else (20, 50, 3e-4)
    kw = dict(rpn_first_step=rpn, rcnn_first_step=10**6, rpn_second_step=10**7,
              num_classes=21)
    if dtype != "float32":
        kw["compute_dtype"] = dtype
    jm, variables = tpudet_model(config(**kw))
    images, gts = _scenes(64, HW, 24)
    return dict(jm=jm, variables=variables, opt=jm._optimizer.init(variables["params"]),
                pm=port_model(variables, **kw), images=images, gts=gts, batch=2, step0=0,
                steps=steps, lr=lr, rpn=rpn)


def _trained_setup(path, argv):
    """LHRCNN-long at 700x1100, batch 8, bfloat16, from the carried state
    at ``path`` over flax's initial variables, on 256 scenes."""
    import jax
    import torch

    import torch_flax_init as fi
    import train_convergence_torch as tc
    from tpudet_torch.runtime import transfer

    carried = torch.load(path)
    jm, _ = fi.tpudet_model("LHRCNN-long", mode="train")
    template = jax.device_get({"params": jm.params, "batch_stats": jm.batch_stats})
    state = transfer.from_flax(template)
    unknown = set(carried["params"]) - set(state)
    if unknown:
        raise KeyError(f"{path}: no such leaves {sorted(unknown)[:5]}")
    state.update(carried["params"])
    variables = fi.to_flax(state, template)
    velocity = {k: torch.zeros_like(v) for k, v in state.items()}
    velocity.update(carried["velocity"])
    opt = jm._optimizer.init(variables["params"])
    opt = type(opt)(fi.to_flax(velocity, template)["params"])
    cls_path, hw, config, lr, _, _ = tc.model_specs()["LHRCNN-long"]
    config = {k: v for k, v in config.items() if k not in fi.SCRIPT_KEYS}
    pm = tc._load_class(cls_path)(config, None, device="cpu")
    step0 = int(carried["global_step"])
    images, gts = _scenes(256, hw, tc.model_specs()["LHRCNN-long"][2]["gt_pad"])
    return dict(jm=jm, variables=variables, opt=opt, pm=pm, images=images, gts=gts,
                batch=config["batch_size"], step0=step0,
                steps=int(argv[0]) if argv else 20, lr=lr, rpn=None)


def main(argv):
    sys.path[:0] = [str(REPO), str(REPO / "tests"), str(REPO / "scripts")]
    opts = dict(a[2:].split("=", 1) for a in argv if a.startswith("--"))
    argv = [a for a in argv if not a.startswith("--")]
    trained = "state" in opts
    dtype = "bfloat16" if trained else opts.get("dtype", "float32")
    if dtype != "float32":  # before JAX starts its backend
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_allow_excess_precision=false")
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    torch.set_num_threads(8 if trained else 4)
    from torch_anchor_free_common import port_opt_state
    from tpudet_torch.models.base import _copy_state
    from tpudet_torch.models.lhrcnn import RCNN_SCOPES, RPN_SCOPES
    from tpudet_torch.runtime import transfer

    setup = _trained_setup(opts["state"], argv) if trained else _test_setup(argv, dtype)
    jm, pm, images, gts = setup["jm"], setup["pm"], setup["images"], setup["gts"]
    batch, step0, steps, lr, rpn = (setup[k] for k in ("batch", "step0", "steps", "lr",
                                                       "rpn"))
    jax_step = jax.jit(jm._train_step_fn)
    # the yardstick of a trained state: tpudet's other crop from the same state
    other_step = jax.jit(lambda *a: jm._train_step_fn(*a)) if trained else None

    def branch(fn, impl, *args):
        if trained:  # read when the step is traced, at its first call
            os.environ["TPUDET_ROI_IMPL"] = impl
        return fn(*args)

    params, stats = setup["variables"]["params"], setup["variables"]["batch_stats"]
    opt = setup["opt"]
    rows, losses, t0 = [], [], time.time()
    for s in range(steps):
        i = (batch * s) % len(images)
        x, g = images[i:i + batch], gts[i:i + batch]
        step = step0 + s
        rpn_phase = pm.is_rpn_step(step)
        label = "RPN" if rpn_phase else "RCNN"
        state = jax.device_get({"params": params, "batch_stats": stats})
        old = transfer.from_flax(state)
        transfer.load_flax(pm.net, state)
        _copy_state(pm.opt_state, port_opt_state(jax.device_get(opt)))
        pm.global_step = step
        port_loss = float(pm.train_step(*pm._to_device(x, g), lr))
        args = (jnp.asarray(x), jnp.asarray(g), jnp.float32(lr), jnp.int32(step))
        if trained:
            o_params, o_stats, _, o_loss = branch(other_step, "gather", params, stats, opt,
                                                  *args)
            other = transfer.from_flax(jax.device_get({"params": o_params,
                                                       "batch_stats": o_stats}))
        params, stats, opt, loss = branch(jax_step, "mm", params, stats, opt, *args)
        new = transfer.from_flax(jax.device_get({"params": params, "batch_stats": stats}))
        got = pm.net.state_dict()
        on = RPN_SCOPES if rpn_phase else RCNN_SCOPES
        keys = [k for k in new if k.split(".", 1)[0] in on
                and not k.endswith((".mean", ".var"))]
        want = {k: new[k] - old[k] for k in keys}
        losses.append((float(loss), port_loss))
        rows.append((abs(port_loss / float(loss) - 1),
                     _rel({k: got[k] - old[k] for k in keys}, want, keys)))
        if trained:
            rows[-1] += (abs(float(o_loss) / float(loss) - 1),
                         _rel({k: other[k] - old[k] for k in keys}, want, keys))
            print(f"step {step} ({label}): loss {float(loss):.6f}, port: loss {port_loss:.6f}, rel "
                  f"{rows[-1][0]:.3e}, update rel {rows[-1][1]:.4e}; tpudet's gather crop: "
                  f"loss rel {rows[-1][2]:.3e}, update rel {rows[-1][3]:.4e} "
                  f"({time.time() - t0:.0f} s)", flush=True)
        elif dtype != "float32":
            print(f"step {s} ({label}): loss {float(loss):.6f}, "
                  f"loss rel {rows[-1][0]:.3e}, update rel {rows[-1][1]:.4e}", flush=True)
        if s % 5 == 4 and not trained:
            last = np.asarray(rows[-5:])
            print(f"steps {s - 4}-{s} ({label}): loss rel "
                  f"{last[:, 0].max():.2e}, update rel {np.array2string(last[:, 1], precision=5)}"
                  f" ({time.time() - t0:.0f} s)", flush=True)
    rows = np.asarray(rows)
    parts = (("RCNN", rows),) if trained else (("RPN", rows[:rpn]), ("RCNN", rows[rpn:]))
    for name, part in parts:
        if len(part):
            print(f"{name} steps: loss rel max {part[:, 0].max():.2e}, update rel max "
                  f"{part[:, 1].max():.2e}, median {np.median(part[:, 1]):.2e}")
    if trained:
        finite = [(a, b) for a, b in losses if np.isfinite(a) and np.isfinite(b)]
        print(f"port's loss over tpudet's, mean of {len(finite)} finite steps: "
              f"{np.mean([b / a for a, b in finite]) - 1:+.4f}")
        print(f"tpudet's gather crop against mm: loss rel max {rows[:, 2].max():.2e}, "
              f"update rel max {rows[:, 3].max():.2e}, median {np.median(rows[:, 3]):.2e}")
    if "out" in opts:
        out = {"dtype": dtype, "roi_impl": "mm" if trained else os.environ.get(
                   "TPUDET_ROI_IMPL", ""),
               "step0": step0, "rpn_steps": rpn, "lr": lr, "loss_rel": rows[:, 0].tolist(),
               "update_rel": rows[:, 1].tolist(), "loss": [a for a, _ in losses],
               "port_loss": [b for _, b in losses]}
        if trained:
            out.update(state=opts["state"], gather_loss_rel=rows[:, 2].tolist(),
                       gather_update_rel=rows[:, 3].tolist())
        Path(opts["out"]).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
