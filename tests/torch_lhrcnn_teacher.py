"""The port's LH-RCNN step along tpudet's own trajectory, step by step.

    python tests/torch_lhrcnn_teacher.py [RPN_STEPS STEPS LR]   (default 20 50 3e-4)

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
"""

import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def main(argv):
    sys.path[:0] = [str(REPO), str(REPO / "tests"), str(REPO / "scripts")]
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    torch.set_num_threads(4)
    import synthvoc
    from test_torch_lhrcnn import HW, config, port_model, tpudet_model
    from torch_anchor_free_common import port_opt_state
    from tpudet_torch.models.base import _copy_state
    from tpudet_torch.models.lhrcnn import RCNN_SCOPES, RPN_SCOPES
    from tpudet_torch.runtime import transfer

    rpn, steps, lr = (int(argv[0]), int(argv[1]), float(argv[2])) if argv else (20, 50, 3e-4)
    kw = dict(rpn_first_step=rpn, rcnn_first_step=10**6, rpn_second_step=10**7,
              num_classes=21)
    jm, variables = tpudet_model(config(**kw))
    jax_step = jax.jit(jm._train_step_fn)
    pm = port_model(variables, **kw)
    opt = jm._optimizer.init(variables["params"])
    images, gts = [], []
    for spec in synthvoc.scene_specs(np.random.default_rng(7), 64):
        image, boxes = synthvoc.render_scene(spec, *HW)
        gt = -np.ones((24, 5), np.float32)
        gt[:len(boxes)] = synthvoc._corner_to_center(boxes)
        images.append(image.astype(np.float32))
        gts.append(gt)
    images, gts = np.stack(images), np.stack(gts)

    def rel(got, want, keys):
        num = sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in keys)
        return (num / max(sum(float((want[k].double() ** 2).sum()) for k in keys),
                          1e-300)) ** 0.5

    params, stats = variables["params"], variables["batch_stats"]
    rows, t0 = [], time.time()
    for s in range(steps):
        i = (2 * s) % len(images)
        x, g = images[i:i + 2], gts[i:i + 2]
        state = jax.device_get({"params": params, "batch_stats": stats})
        old = transfer.from_flax(state)
        transfer.load_flax(pm.net, state)
        _copy_state(pm.opt_state, port_opt_state(jax.device_get(opt)))
        pm.global_step = s
        port_loss = float(pm.train_step(*pm._to_device(x, g), lr))
        params, stats, opt, loss = jax_step(params, stats, opt, jnp.asarray(x),
                                            jnp.asarray(g), jnp.float32(lr), jnp.int32(s))
        new = transfer.from_flax(jax.device_get({"params": params, "batch_stats": stats}))
        got = pm.net.state_dict()
        on = RPN_SCOPES if s < rpn else RCNN_SCOPES
        keys = [k for k in new if k.split(".", 1)[0] in on
                and not k.endswith((".mean", ".var"))]
        rows.append((abs(port_loss / float(loss) - 1),
                     rel({k: got[k] - old[k] for k in keys},
                         {k: new[k] - old[k] for k in keys}, keys)))
        if s % 5 == 4:
            last = np.asarray(rows[-5:])
            print(f"steps {s - 4}-{s} ({'RPN' if s < rpn else 'RCNN'}): loss rel "
                  f"{last[:, 0].max():.2e}, update rel {np.array2string(last[:, 1], precision=5)}"
                  f" ({time.time() - t0:.0f} s)", flush=True)
    rows = np.asarray(rows)
    for name, part in (("RPN", rows[:rpn]), ("RCNN", rows[rpn:])):
        if len(part):
            print(f"{name} steps: loss rel max {part[:, 0].max():.2e}, update rel max "
                  f"{part[:, 1].max():.2e}, median {np.median(part[:, 1]):.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
