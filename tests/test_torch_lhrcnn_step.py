"""The port's LH-RCNN train step against tpudet's jitted ``train_step`` on
the same numpy inputs, at 192x320, batch 2, float32, one step of each
phase from the same variables and a non-zero velocity; and the phase
schedule through ``train_one_epoch``.

Tolerances, each with its reason: the loss to 1e-5; the running statistics
of every BatchNorm, and the phase's parameters and velocities (normwise
over the tree), to 4x the difference between the port's own step under its
two CPU summation orders (oneDNN's convolutions and PyTorch's own), or to
1e-4 where that is larger: train-mode BatchNorm over batch 2 at the 6x10
level amplifies rounding. The other phase's parameters and velocities stay
bit for bit, in both.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tpudet_torch.models import LHRCNN
from tpudet_torch.models.base import _copy_state
from tpudet_torch.models.lhrcnn import RCNN_SCOPES, RPN_SCOPES
from tpudet_torch.runtime import transfer
from test_torch_lhrcnn import HW, config, gt_batch, port_model, tpudet_model
from torch_anchor_free_common import port_opt_state, random_opt_state
from torch_refine_common import tree_rel

torch.set_num_threads(1)

LR = 0.003  # the training script's


@pytest.fixture(scope="module")
def pair():
    jm, variables = tpudet_model(config())
    step = jax.jit(jm._train_step_fn)
    return jm, variables, step


def _batch(seed):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 255, (2, *HW, 3)).astype(np.float32)
    gt = gt_batch(rng, HW)
    gt[1, :3] = [[60, 90, 70, 100, 3], [120, 240, 50, 60, 0], [100, 160, 150, 280, 2]]
    return images, gt


@pytest.mark.parametrize("phase,step", [("rpn", 5), ("rcnn", 3)])
def test_lhrcnn_step_matches_tpudet(pair, phase, step):
    """The RPN step at ``global_step`` 5 (``rcnn_first_step``: the second RPN
    phase) and the RCNN step at 3 (``rpn_first_step``)."""
    jm, variables, jax_step = pair
    opt_state = random_opt_state(jm, variables["params"], np.random.default_rng(21))
    images, gt = _batch(4)
    w_params, w_stats, w_opt, w_loss = jax.device_get(jax_step(
        variables["params"], variables["batch_stats"], opt_state, jnp.asarray(images),
        jnp.asarray(gt), jnp.float32(LR), jnp.int32(step)))

    pm = port_model(variables)
    assert pm.is_rpn_step(step) == (phase == "rpn")
    x, g = pm._to_device(images, gt)
    start = port_opt_state(opt_state)["velocity"]

    def port_step():
        transfer.load_flax(pm.net, variables)
        _copy_state(pm.opt_state, port_opt_state(opt_state))
        pm.global_step = step
        loss = float(pm.train_step(x, g, LR))
        assert pm.global_step == step + 1
        return loss, {k: v.clone() for k, v in pm.net.state_dict().items()}, {
            k: v.clone() for k, v in pm.velocity.items()}

    loss, state, vel = port_step()
    with torch.backends.mkldnn.flags(enabled=False):  # the other summation order
        _, state_b, vel_b = port_step()
    np.testing.assert_allclose(loss, float(w_loss), rtol=1e-5)

    init = transfer.from_flax(variables)
    want = transfer.from_flax({"params": w_params, "batch_stats": w_stats})
    want_vel = transfer.velocity_from_flax(w_opt.velocity)
    stats = [k for k in want if k.endswith((".mean", ".var"))]
    sens = max(tree_rel({k: state_b[k]}, {k: state[k]}) for k in stats)
    assert max(tree_rel({k: state[k]}, {k: want[k]}) for k in stats) < max(1e-4, 4 * sens)
    on = RPN_SCOPES if phase == "rpn" else RCNN_SCOPES
    on_keys = [k for k in want_vel if k.split(".", 1)[0] in on]
    off_keys = [k for k in want_vel if k not in on_keys]
    assert on_keys and off_keys
    for got, other, w in ((state, state_b, want), (vel, vel_b, want_vel)):
        sens = tree_rel({k: other[k] for k in on_keys}, {k: got[k] for k in on_keys})
        assert tree_rel({k: got[k] for k in on_keys},
                        {k: w[k] for k in on_keys}) < max(1e-4, 4 * sens)
    for k in off_keys:
        assert torch.equal(state[k], init[k]) and torch.equal(want[k], init[k]), k
        assert torch.equal(vel[k], start[k]) and torch.equal(want_vel[k], start[k]), k


def test_train_one_epoch_follows_the_phase_schedule(capsys):
    """tpudet's own schedule test's phases (rpn, rcnn, rpn, rcnn over steps
    0-3 at ``rpn_first_step`` 1, ``rcnn_first_step`` 2, ``rpn_second_step``
    3), at batch 1: each step moves only its phase's parameters and every
    BatchNorm's statistics, and the progress line names the loss as tpudet
    does, by the phase of ``global_step`` after the step."""
    images, gt = _batch(6)
    images, gt = images[:1], gt[:1]

    def batches():
        while True:
            yield images, gt

    class Snapshots:
        def __init__(self):
            self.states = []

        def add_summary(self, loss, global_step):
            self.states.append({k: v.clone() for k, v in pm.net.state_dict().items()})

    pm = LHRCNN(config(batch_size=1, rpn_first_step=1, rcnn_first_step=2,
                       rpn_second_step=3), {"num_train": 4, "train_generator": batches()},
                device="cpu")
    before = {k: v.clone() for k, v in pm.net.state_dict().items()}
    writer = Snapshots()
    assert np.isfinite(pm.train_one_epoch(0.001, writer))
    assert pm.global_step == 4
    for phase, state in zip(("rpn", "rcnn", "rpn", "rcnn"), writer.states):
        on = RPN_SCOPES if phase == "rpn" else RCNN_SCOPES
        moved = {k for k, v in state.items() if not torch.equal(v, before[k])}
        stats = {k for k in state if k.endswith((".mean", ".var"))}
        assert stats <= moved, phase
        assert moved - stats and all(k.split(".", 1)[0] in on for k in moved - stats), phase
        before = state
    labels = [part.split()[3] for part in capsys.readouterr().out.split("\r") if part]
    assert labels == ["rcnn_loss", "rpn_loss", "rcnn_loss", "rcnn_loss"]
