"""Shared pieces of the RefineDet and PFPNet parity tests
(``tests/test_torch_refine.py``, ``tests/test_torch_pfpnet.py``).

Both families run at input 64: RefineDet's TCB deconvolutions need each level
to be exactly twice the next, which holds at 64 (8/4/2/1) and at 320
(40/20/10/5) but not at the SSD tests' 76 (10/5/3/2); PFPNet needs a multiple
of 64. The nets keep the full widths of ``drivers/`` (54.7M and 52.3M
parameters), so each file builds tpudet's model once (``scope="module"``
fixtures), with its
variables drawn from a seeded numpy generator in the shapes flax gives them
(flax's own eager initialisation of these nets takes ~25 s on the CPU), and
jits tpudet's step once.

Tolerances, each with its reason:
  * float32 network outputs and running statistics: 1e-4 relative, normwise
    (oneDNN and XLA sum the convolutions in other orders);
  * bfloat16 network outputs: 2e-2 (bf16 rounds after every convolution, in
    other places of a sum in the two frameworks);
  * a whole float32 step: the loss to 1e-4 and the running statistics to
    1e-4 per tensor. The step's other products are ill-conditioned at this
    size: train-mode BatchNorm over batch 2 at the 1x1 top level (and the
    TCBs that carry it down to every ODM level) amplifies rounding, so that
    images changed by 2^-22 relative (a few float32 roundings) move the
    port's own velocity by ~5% over the tree. So the train-mode levels, and
    the parameters and velocity after the step (normwise over the tree), are
    held to 4x what that perturbation does to the port itself, and to 1e-4
    where that is larger. The velocity starts non-zero, as in
    ``tests/test_torch_train.py``;
  * per-tensor float32 gradients of the loss at 128x128, batch 4
    (:func:`check_grads`): each held to 4x the larger of two moves of the
    port's own gradient, its other summation order (oneDNN off) and images
    changed by 2^-22 relative. A few pre-activations a net lie within ~1e-6
    of zero, and a rounding flips one ReLU's mask: that moves the pyramid's
    and the TCBs' gradients by ~0.5% (PFPNet), ~2% (RefineDet). Which one
    flips depends on the order of every sum before it, so each side flips
    its own: tpudet's gradient is as far from the port's as either move,
    and the order switch alone (it changes the convolutions', not the
    BatchNorms', sums) sometimes flips none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpudet.models import base as jax_base
from tpudet.runtime import optim as jax_optim
from tpudet_torch.runtime import transfer
from torch_assign_cases import rand_gt

PIXEL_MEAN = np.asarray([123.68, 116.779, 103.979], np.float32)
SIZE = 64
NUM_CLASSES = 4  # 5 with the background


def config(**kw):
    cfg = {"mode": "train", "input_size": SIZE, "data_format": "channels_last",
           "num_classes": NUM_CLASSES, "weight_decay": 1e-4, "keep_prob": 1.0,
           "batch_size": 2, "nms_score_threshold": 0.01, "nms_max_boxes": 5,
           "nms_iou_threshold": 0.45, "pretraining_weight": None, "hard_neg_cap": 384,
           "seed": 3}
    cfg.update(kw)
    return cfg


def nchw(x):
    return torch.tensor(np.transpose(np.asarray(x, np.float32), (0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def rel(got, want):
    """Normwise relative difference."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def tree_like(tree, fn):
    return {k: tree_like(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def random_stats(tree, rng):
    return tree_like(tree, lambda v: rng.uniform(0.5, 2.0, np.shape(v)).astype(np.float32))


def gt_rows(rng, b, g, n_max, size, num_classes=NUM_CLASSES, n_min=1):
    """``rand_gt`` with class ids below ``num_classes``."""
    gt = rand_gt(rng, b, g, n_max, size=size, n_valid_min=n_min)
    gt[..., 4] = np.where(gt[..., 0] >= 0, gt[..., 4] % num_classes, -1)
    return gt


def batch(seed, b=2, size=SIZE):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 255, (b, size, size, 3)).astype(np.float32)
    return images, gt_rows(rng, b, 8, 4, float(size))


def numpy_variables(net, rng, hw=(SIZE, SIZE)):
    """Variables of the flax ``net`` at input ``hw`` (default ``SIZE``
    square), drawn from ``rng``: glorot-normal kernels (fans from the HWIO
    shape), small biases, BatchNorm and GroupNorm scales near 1, statistics
    in [0.5, 2], L2-norm scales in [5, 15]."""
    shapes = jax.eval_shape(lambda key, x: net.init(key, x, False),
                            jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)))

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            fans = np.prod(shape[:-2]) * (shape[-2] + shape[-1])
            out = rng.normal(0, np.sqrt(2.0 / fans), shape)
        elif name == "scale":
            out = rng.uniform(5, 15, shape) if shape == (1,) else rng.uniform(0.5, 1.5, shape)
        elif name == "bias":
            out = rng.normal(0, 0.05, shape)
        elif name == "mean":
            out = rng.normal(0, 0.5, shape)
        else:
            out = rng.uniform(0.5, 2.0, shape)
        return out.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def tpudet_pair(jax_cls, port_cls):
    """tpudet's model in test mode with seeded numpy variables
    (:func:`numpy_variables`), the variables, and an image."""
    rng = np.random.default_rng(0)

    class Seeded(jax_cls):
        def _init_variables(self):
            variables = numpy_variables(self.net, rng)
            self.params, self.batch_stats = variables["params"], variables["batch_stats"]
            self._optimizer = self._make_optimizer()
            self.opt_state = None

    jm = Seeded(config(mode="test"))
    variables = {"params": jax.device_get(jm.params),
                 "batch_stats": jax.device_get(jm.batch_stats)}
    image = rng.uniform(0, 255, (1, SIZE, SIZE, 3)).astype(np.float32)
    return jm, variables, image


def port_model(port_cls, variables, **kw):
    pm = port_cls(config(**kw), device="cpu")
    transfer.load_flax(pm.net, variables)
    return pm


def levels(outputs):
    """``(arms, odms)`` -> the 16 per-level tensors, arms first."""
    arms, odms = outputs
    return [t for pair in list(arms) + list(odms) for t in pair]


def check_levels(got, want, tol):
    got, want = levels(got), levels(want)
    assert len(got) == len(want) == 16
    for g, w in zip(got, want):
        assert g.shape[0] == w.shape[0] and tuple(g.shape[2:]) == tuple(w.shape[1:3])
        assert rel(nhwc(g), np.asarray(w, np.float32)) < tol


def check_eval_forward(jm, port_cls, variables, image, dtype="float32"):
    """The eval-mode per-level outputs of both nets on one image; the
    parameter counts agree."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    net = type(jm.net)(num_classes_total=jm.num_classes, extractor=jm.net.extractor,
                       dtype=jdt)
    x = image - PIXEL_MEAN
    want = net.apply(variables, jnp.asarray(x), False)
    pm = port_model(port_cls, variables, mode="test", compute_dtype=dtype)
    with torch.no_grad():
        got = pm.net(nchw(x))
    for g in levels(got):
        assert g.dtype == tdt
    check_levels(got, want, 1e-4 if dtype == "float32" else 2e-2)
    assert sum(p.numel() for p in pm.net.parameters()) == sum(
        np.size(v) for v in jax.tree.leaves(variables["params"]))
    return pm


def check_test_one_image(jm, port_cls, variables, image):
    """``test_one_image`` on both sides: the same classes, scores to 1e-4
    (the same picks: the network outputs differ by float32 rounding)."""
    pm = port_model(port_cls, variables, mode="test")
    got = pm.test_one_image(image)
    want = [np.asarray(w) for w in jm.test_one_image(image)]
    assert len(want[0]) > 0
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-3)


def jax_step(jm, params, bstats, velocity, images, gt, lr, wd):
    """tpudet's step from its parts (its ``DetectorBase`` pads the batch to
    the CPU mesh): loss, new params, new statistics, new velocity and the
    train-mode network outputs."""
    def forward_loss(p, s):
        x = jnp.asarray(images) - PIXEL_MEAN.reshape(1, 1, 1, 3)
        outputs, mut = jm.net.apply({"params": p, "batch_stats": s}, x, True,
                                    mutable=["batch_stats"])
        loss = jm._loss_from_outputs(outputs, jnp.asarray(gt), None)
        return loss + wd * jax_base.global_l2(p), (mut["batch_stats"], outputs)

    def step(p, s, v):
        (loss, (stats, outputs)), grads = jax.value_and_grad(
            forward_loss, has_aux=True)(p, s)
        new_p, new_opt = jax_optim.Momentum(0.9).update(
            grads, jax_optim.MomentumState(v), p, jnp.float32(lr))
        return loss, new_p, stats, new_opt.velocity, outputs

    return jax.device_get(jax.jit(step)(params, bstats, velocity))


def check_grads(jax_cls, port_cls, keys, size=128, b=4):
    """The float32 gradient of the loss (no weight decay) of tpudet's
    ``jax.grad`` and the port's ``autograd.grad`` from the same numpy
    variables at ``size`` x ``size``, batch ``b``: the loss to 1e-5, and
    each parameter whose name ``keys`` accepts held on its own to the
    module docstring's tolerance (norms of differences, so that a gradient
    that cancels to near zero is held to the port's own scatter, not to its
    size). Returns the names held."""
    rng = np.random.default_rng(0)

    class Seeded(jax_cls):
        def _init_variables(self):
            variables = numpy_variables(self.net, rng, hw=(size, size))
            self.params, self.batch_stats = variables["params"], variables["batch_stats"]
            self._optimizer = self._make_optimizer()
            self.opt_state = None

    jm = Seeded(config(mode="test", input_size=size, batch_size=b))
    variables = {"params": jax.device_get(jm.params),
                 "batch_stats": jax.device_get(jm.batch_stats)}
    images, gt = batch(5, b=b, size=size)

    def jax_loss(p, s):
        x = jnp.asarray(images) - PIXEL_MEAN.reshape(1, 1, 1, 3)
        outputs, _ = jm.net.apply({"params": p, "batch_stats": s}, x, True,
                                  mutable=["batch_stats"])
        return jm._loss_from_outputs(outputs, jnp.asarray(gt), None)

    w_loss, w_grads = jax.device_get(jax.jit(jax.value_and_grad(jax_loss))(
        variables["params"], variables["batch_stats"]))
    want = transfer.from_flax({"params": w_grads})
    pm = port_model(port_cls, variables, input_size=size, batch_size=b)
    x, g = pm._to_device(images, gt)

    def port_grads(x):
        transfer.load_flax(pm.net, variables)
        pm.net.train()
        params = dict(pm.net.named_parameters())
        loss = pm._loss_from_outputs(pm.net(pm._preprocess(x)), g, pm._sample_weight())
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        return float(loss.detach()), {  # VGG block 5 is unused: no gradient
            k: torch.zeros_like(p) if gr is None else gr
            for (k, p), gr in zip(params.items(), grads)}

    loss, got = port_grads(x)
    with torch.backends.mkldnn.flags(enabled=False):  # the other summation order
        _, got_order = port_grads(x)
    _, got_input = port_grads(x * (1 + 2.0 ** -22))
    np.testing.assert_allclose(loss, float(w_loss), rtol=1e-5)
    held = [k for k in got if keys(k)]
    for k in held:
        mine = got[k].double()
        moves = [float(torch.linalg.vector_norm(o[k].double() - mine))
                 for o in (got_order, got_input)]
        err = float(torch.linalg.vector_norm(mine - want[k].double()))
        bound = max(4 * max(moves), 1e-6 * float(torch.linalg.vector_norm(mine)))
        assert err < bound, f"{k}: |port - tpudet| {err:.3e}, bound {bound:.3e} {moves}"
    return held


def tree_rel(got, want):
    """Normwise relative difference over a dict of tensors."""
    num = sum(float(torch.sum((got[k].double() - want[k].double()) ** 2)) for k in want)
    return np.sqrt(num / sum(float(torch.sum(want[k].double() ** 2)) for k in want))


def check_train_step(jm, port_cls, variables, lr=0.01, wd=1e-4):
    """One float32 step from the transferred variables and a non-zero
    velocity at batch 2, on both sides: the train-mode per-level outputs, the
    loss, and the state after the step, with the tolerances of the module
    docstring. Returns tpudet's state after the step, the port's, and the
    velocity the step started from."""
    rng = np.random.default_rng(21)
    params, bstats = variables["params"], variables["batch_stats"]
    velocity = tree_like(params, lambda v: (0.01 * rng.normal(size=np.shape(v)))
                         .astype(np.float32))
    images, gt = batch(5)
    w_loss, w_params, w_stats, w_vel, w_out = jax_step(jm, params, bstats, velocity,
                                                       images, gt, lr, wd)
    pm = port_model(port_cls, variables)
    x, g = pm._to_device(images, gt)

    def port_step(x):
        transfer.load_flax(pm.net, variables)
        for k, v in transfer.velocity_from_flax(velocity).items():
            pm.velocity[k].copy_(v)
        seen = []
        hook = pm.net.register_forward_hook(lambda m, a, out: seen.append(out))
        loss = pm.train_step(x, g, lr)
        hook.remove()
        return (float(loss), {k: v.clone() for k, v in pm.net.state_dict().items()},
                {k: v.clone() for k, v in pm.velocity.items()},
                [t.detach() for t in levels(seen[0])])

    loss, state, vel, outs = port_step(x)
    _, state_b, vel_b, outs_b = port_step(x * (1 + 2.0 ** -22))
    assert pm.global_step == 2
    np.testing.assert_allclose(loss, float(w_loss), rtol=1e-4)
    for got, other, want in zip(outs, outs_b, levels(w_out)):
        sens = rel(nhwc(other), nhwc(got))
        assert rel(nhwc(got), np.asarray(want)) < max(1e-4, 4 * sens)
    want = transfer.from_flax({"params": w_params, "batch_stats": w_stats})
    stats = [k for k in want if k.endswith((".mean", ".var"))]
    assert max(rel(state[k].numpy(), want[k].numpy()) for k in stats) < 1e-4
    p_keys = [k for k in want if k not in stats]
    sens = tree_rel({k: state_b[k] for k in p_keys}, {k: state[k] for k in p_keys})
    assert tree_rel(state, {k: want[k] for k in p_keys}) < max(1e-4, 4 * sens)
    w_v = transfer.velocity_from_flax(w_vel)
    assert tree_rel(vel, w_v) < max(1e-4, 4 * tree_rel(vel_b, vel))
    return want, state, transfer.velocity_from_flax(velocity)


def check_tpudet_file(tmp_path, jm, port_cls, variables, image):
    """tpudet's ``save_weight`` (a non-zero Momentum velocity, step 7) read
    by the port's ``load_weight``: the same tensors, velocity and step, and
    the eval forward of tpudet's net."""
    rng = np.random.default_rng(1)
    velocity = tree_like(variables["params"],
                         lambda v: rng.normal(size=np.shape(v)).astype(np.float32))
    jm.opt_state = jax_optim.MomentumState(velocity)
    jm.global_step = 7
    jm.save_weight("latest", str(tmp_path / "model"))
    jm.opt_state, jm.global_step = None, 0

    pm = port_cls(config(seed=11), device="cpu")
    pm.load_weight(str(tmp_path / "model"))
    want = transfer.from_flax(variables)
    got = pm.net.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    for k, v in transfer.velocity_from_flax(velocity).items():
        assert torch.equal(pm.velocity[k], v), k
    assert pm.global_step == 7
    x = image - PIXEL_MEAN
    with torch.no_grad():
        mine = pm.net.eval()(nchw(x))
    check_levels(mine, jm.net.apply(variables, jnp.asarray(x), False), 1e-4)
