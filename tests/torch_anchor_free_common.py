"""Shared pieces of the FCOS and CenterNet parity tests
(``tests/test_torch_fcos.py``, ``tests/test_torch_centernet.py``).

tpudet's model is built once a file with its variables drawn from a seeded
numpy generator in the shapes flax gives them
(``torch_refine_common.numpy_variables``), and the port takes them through
``transfer.from_flax``. Both nets keep the training scripts' full widths.

Tolerances, each with its reason:
  * float32 network outputs: 1e-4 relative, normwise (oneDNN and XLA sum the
    convolutions in other orders);
  * a whole step, float32 and bfloat16: the loss to 1e-4 (float32) or 2e-2
    (bfloat16); the train-mode outputs and the running statistics, and in
    float32 the parameters and the optimizer's state after the step
    (each normwise over the tree: all the outputs together, all the
    parameters, each part of the optimizer's state), to 4x the difference
    between the port's own step under its two CPU summation orders (oneDNN's
    convolutions and PyTorch's own), or to 1e-4 / 2e-2 where that is larger.
    Train-mode normalisation over a few values (BatchNorm over batch 2 at a
    2x2 level, GroupNorm at FCOS's 1x2 top level) amplifies rounding, so a
    fixed tolerance would be either loose or flaky; and a top-level output
    holds 4 values, too few for a yardstick of its own. bfloat16 gradients
    are not compared.
  * eval-mode bfloat16 outputs: per output, to 4x the port's own difference
    between its two summation orders where that exceeds 2e-2 (FCOS rounds
    after ~60 GroupNorm units: the two orders differ by 3-7% at its heads).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import serialization

from tpudet.models import base as jax_base
from tpudet_torch.models.base import _copy_state
from tpudet_torch.runtime import transfer
from torch_refine_common import nhwc, numpy_variables, rel, tree_like, tree_rel


def seeded_pair(jax_cls, config, hw, seed=0):
    """tpudet's model with variables drawn by ``numpy_variables`` at input
    ``hw``, and those variables as numpy trees."""
    rng = np.random.default_rng(seed)

    class Seeded(jax_cls):
        def _init_variables(self):
            variables = numpy_variables(self.net, rng, hw)
            self.params = variables["params"]
            self.batch_stats = variables.get("batch_stats", {})
            self._optimizer = self._make_optimizer()
            self.opt_state = None

    jm = Seeded(config)
    return jm, {"params": jax.device_get(jm.params),
                "batch_stats": jax.device_get(jm.batch_stats)}


def leaves(outputs):
    """The tensors of a net's output, nested lists and tuples flattened."""
    if isinstance(outputs, (tuple, list)):
        return [t for item in outputs for t in leaves(item)]
    return [outputs]


def check_outputs(got, want, tol, other=None):
    """Every NCHW port output within ``tol`` (normwise) of tpudet's NHWC one,
    or within 4x its difference from ``other`` (the port's outputs under its
    other summation order) where that is larger."""
    got, want = leaves(got), leaves(want)
    other = got if other is None else leaves(other)
    assert len(got) == len(want) == len(other)
    for g, w, o in zip(got, want, other):
        assert tuple(nhwc(g).shape) == tuple(np.shape(w))
        assert rel(nhwc(g), np.asarray(w, np.float32)) < max(tol, 4 * rel(nhwc(o), nhwc(g)))


def random_opt_state(jm, params, rng):
    """A non-zero state of tpudet's optimizer for ``params``: Momentum's
    velocity, or Adam's moments at step 3."""
    state = jm._optimizer.init(params)
    def moment(v):
        return (0.01 * rng.normal(size=np.shape(v))).astype(np.float32)

    if hasattr(state, "velocity"):
        return type(state)(tree_like(params, moment))
    return type(state)(np.int32(3), tree_like(params, moment), tree_like(
        params, lambda v: rng.uniform(1e-5, 1e-4, np.shape(v)).astype(np.float32)))


def port_opt_state(state):
    """tpudet's optimizer state in the port's form."""
    return transfer.opt_state_from_flax(serialization.to_state_dict(state))


def jax_step(jm, params, bstats, opt_state, images, gt, lr, wd):
    """tpudet's step from its parts (its ``DetectorBase`` pads the batch to
    the CPU mesh), with the model's own preprocessing and optimizer: loss,
    new params, new statistics, new optimizer state and the train-mode
    outputs."""
    def forward_loss(p, s):
        x = jm._preprocess(jnp.asarray(images))
        outputs, mut = jm.net.apply({"params": p, "batch_stats": s}, x, True,
                                    mutable=["batch_stats"])
        loss = jm._loss_from_outputs(outputs, jnp.asarray(gt), None)
        return loss + wd * jax_base.global_l2(p), (mut["batch_stats"], outputs)

    def step(p, s, o):
        (loss, (stats, outputs)), grads = jax.value_and_grad(
            forward_loss, has_aux=True)(p, s)
        new_p, new_o = jm._optimizer.update(grads, o, p, jnp.float32(lr))
        return loss, new_p, stats, new_o, outputs

    return jax.device_get(jax.jit(step)(params, bstats, opt_state))


def check_step(jm, pm, variables, imgs, gt, lr, wd, dtype="float32"):
    """One step of tpudet's ``jm`` (its net in ``dtype``) and of the port's
    ``pm`` from ``variables`` and a non-zero optimizer state, on the same
    batch, held as the module docstring says. Returns the port's loss."""
    rng = np.random.default_rng(21)
    params, bstats = variables["params"], variables["batch_stats"]
    opt_state = random_opt_state(jm, params, rng)
    w_loss, w_params, w_stats, w_opt, w_out = jax_step(jm, params, bstats, opt_state,
                                                       imgs, gt, lr, wd)
    x, g = pm._to_device(imgs, gt)

    def port_step(x):
        transfer.load_flax(pm.net, variables)
        _copy_state(pm.opt_state, port_opt_state(opt_state))
        seen = []
        hook = pm.net.register_forward_hook(lambda m, a, out: seen.append(out))
        loss = pm.train_step(x, g, lr)
        hook.remove()
        return (float(loss), {k: v.clone() for k, v in pm.net.state_dict().items()},
                {k: v for k, v in _flat(pm.opt_state).items()},
                [t.detach() for t in leaves(seen[0])])

    loss, state, opt, outs = port_step(x)
    with torch.backends.mkldnn.flags(enabled=False):  # the other summation order
        _, state_b, opt_b, outs_b = port_step(x)
    floor = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(loss, float(w_loss), rtol=floor)
    got_out = _cat([nhwc(t) for t in outs])
    sens = rel(_cat([nhwc(t) for t in outs_b]), got_out)
    assert rel(got_out, _cat([np.asarray(w, np.float32) for w in leaves(w_out)])) < max(
        floor, 4 * sens)
    want = transfer.from_flax({"params": w_params, "batch_stats": w_stats})
    stats = [k for k in want if k.endswith((".mean", ".var"))]
    if stats:
        sens = max(rel(state_b[k].numpy(), state[k].numpy()) for k in stats)
        assert max(rel(state[k].numpy(), want[k].numpy()) for k in stats) < max(
            floor, 4 * sens)
    if dtype != "float32":
        return loss
    p_keys = [k for k in want if k not in stats]
    sens = tree_rel({k: state_b[k] for k in p_keys}, {k: state[k] for k in p_keys})
    assert tree_rel(state, {k: want[k] for k in p_keys}) < max(floor, 4 * sens)
    w_opt = _flat(port_opt_state(w_opt))
    assert opt.keys() == w_opt.keys()
    for part in {k.split("/")[0] for k in w_opt}:
        keys = [k for k in w_opt if k.split("/")[0] == part]
        got = {k: opt[k] for k in keys}
        sens = tree_rel({k: opt_b[k] for k in keys}, got)
        assert tree_rel(got, {k: w_opt[k] for k in keys}) < max(floor, 4 * sens), part
    return loss


def _cat(arrays):
    """Numpy arrays raveled and concatenated."""
    return np.concatenate([np.ravel(a) for a in arrays])


def _flat(state, prefix=""):
    """An optimizer state as ``{"part/name": tensor}``."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v.clone()
    return out
