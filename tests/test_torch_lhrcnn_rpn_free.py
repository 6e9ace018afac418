"""LH-RCNN's RPN phase run free for 3 steps through both packages, at
192x320, batch 2, float32, from one state: the small guard of
``tests/torch_lhrcnn_rpn_free_run.py`` (the 500-step run at 700x1100).

Each package takes its own three steps (tpudet its jitted
``_train_step_fn``, the port ``LHRCNN.train_step``) from
``tests/test_torch_lhrcnn.py``'s numpy variables and zero velocity, on three
seeded batches. Every leaf of the phase (the parameters of
``feature_extractor`` and ``rpn``, every BatchNorm statistic) must have
moved as tpudet's did, to 4x that run's per-leaf floor: the largest of the
port's three steps with oneDNN off, the port's and tpudet's three steps
with the images times ``1 + 2^-22``, each against its own run, and the
float32 spacing of tpudet's values, each relative to tpudet's move.
The conv biases, each before a BatchNorm, move by rounding alone on both
sides, and the ``rcnn`` scope's parameters stay bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tpudet_torch.models.lhrcnn import RCNN_SCOPES, RPN_SCOPES
from tpudet_torch.runtime import transfer
from test_torch_lhrcnn import HW, config, gt_batch, port_model, tpudet_model
from torch_lhrcnn_rpn_free_run import rel_updates, ulp_floor

torch.set_num_threads(1)

LR = 0.003  # the training script's
STEPS = 3
BUMP = 1.0 + 2.0 ** -22


def _batches():
    rng = np.random.default_rng(31)
    return [(rng.uniform(0, 255, (2, *HW, 3)).astype(np.float32), gt_batch(rng, HW))
            for _ in range(STEPS)]


def _tpudet_run(jm, step, variables, batches, scale=1.0):
    params, stats = variables["params"], variables["batch_stats"]
    opt = jm._optimizer.init(params)
    for s, (images, gt) in enumerate(batches):
        params, stats, opt, _ = step(params, stats, opt, jnp.asarray(images * scale),
                                     jnp.asarray(gt), jnp.float32(LR), jnp.int32(s))
    return transfer.from_flax(jax.device_get({"params": params, "batch_stats": stats}))


def _port_run(variables, batches, scale=1.0, onednn=True):
    pm = port_model(variables)
    with torch.backends.mkldnn.flags(enabled=onednn):
        for images, gt in batches:
            assert pm.is_rpn_step(pm.global_step)
            x, g = pm._to_device(images, gt)
            pm.train_step(x * scale, g, LR)
    return {k: v.clone() for k, v in pm.net.state_dict().items()}


def test_three_free_rpn_steps_match_tpudet_to_the_floor():
    jm, variables = tpudet_model(config())
    step = jax.jit(jm._train_step_fn)
    batches = _batches()
    init = transfer.from_flax(variables)
    want = _tpudet_run(jm, step, variables, batches)
    got = _port_run(variables, batches)
    keys = [k for k in want if k.endswith((".mean", ".var"))
            or (k.split(".", 1)[0] in RPN_SCOPES and not k.endswith((".mean", ".var")))]
    floors = [rel_updates(init, _port_run(variables, batches, onednn=False), got, keys),
              rel_updates(init, _port_run(variables, batches, BUMP), got, keys),
              rel_updates(init, _tpudet_run(jm, step, variables, batches, BUMP), want, keys),
              ulp_floor(init, want, keys)]
    diff = rel_updates(init, got, want, keys)
    over = {k: (diff[k], max(f[k] for f in floors)) for k in keys
            if diff[k] > 4 * max(f[k] for f in floors)}
    assert not over, over
    # a conv bias before a train-mode BatchNorm has a zero gradient: on both
    # sides it moves by rounding alone, far below its conv's weights
    for k in keys:
        if k.endswith("conv.bias"):
            w = k[:-len("bias")] + "weight"
            for new in (want, got):
                assert (new[k] - init[k]).norm() < 1e-5 * (new[w] - init[w]).norm(), k
    for k in want:
        if k.split(".", 1)[0] in RCNN_SCOPES and not k.endswith((".mean", ".var")):
            assert torch.equal(got[k], init[k]) and torch.equal(want[k], init[k]), k


def test_floor_helpers_measure_relative_moves():
    """``rel_updates`` and ``ulp_floor`` on hand-made leaves: a move off by
    1% reads 0.01, a move of one float32 spacing reads 1."""
    old, want = {"w": torch.zeros(4)}, {"w": torch.full((4,), 0.5)}
    got = {"w": torch.full((4,), 0.505)}
    assert rel_updates(old, got, want, ["w"])["w"] == pytest.approx(0.01, rel=1e-4)
    one = {"w": torch.ones(4)}
    assert ulp_floor(one, {"w": torch.full((4,), 1.0 + 2.0 ** -23)}, ["w"])["w"] == 1.0
