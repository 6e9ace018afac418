"""Shared pieces of the YOLO parity tests (``tests/test_torch_yolo.py``,
``tests/test_torch_yolov3.py``).

The nets keep the training scripts' full widths (DarkNet-19 + head: 39.95M
parameters; DarkNet-53 + headers: 57.92M) at input 64, where YOLOv2's grid
is 2x2 and YOLOv3's are 2/4/8 (the nearest upsample is an exact 2x). tpudet's
variables are drawn from a seeded numpy generator in the shapes flax gives
them (``torch_refine_common.numpy_variables``), since flax's own eager
initialisation of these nets is slow on the CPU. The losses and decodes run
on head tensors at the training scripts' sizes (YOLOv2 480x480: 15x15 cells; YOLOv3
448x448: 14/28/56), fed identically to both sides.

Tolerances, each with its reason:
  * float32 network outputs: 1e-4 relative, normwise (oneDNN and XLA sum the
    convolutions in other orders); bfloat16: 2e-2 (bf16 rounds after every
    convolution, in other places of a sum in the two frameworks);
  * losses on identical head tensors: the value to 1e-5 relative, the
    gradients to 1e-5 of their largest entry (the same formulas, reductions
    in other orders);
  * decodes on identical head tensors: the picks and class ids exactly,
    scores to 1e-6 and boxes to 1e-5 relative (``sigmoid`` and ``exp`` may
    round differently by an ulp);
  * a whole step, float32 and bfloat16: the loss to 1e-4 (float32) or 2e-2
    (bfloat16); the train-mode outputs and the running statistics, and in
    float32 the parameters and the velocity after the step (normwise over the
    tree), to 4x the difference between the port's own step under its two
    summation orders (oneDNN's convolutions and PyTorch's own), or to 1e-4 /
    2e-2 where that is larger. Train-mode BatchNorm over batch 2 at the 2x2
    top level amplifies rounding: the two orders move the port's float32
    velocity by ~5e-4 and its bfloat16 outputs by ~16%, which images changed
    by 2^-22 relative (``torch_refine_common``'s yardstick) underestimate
    tenfold here. bfloat16 gradients are not compared, as in
    ``tests/test_torch_train.py``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpudet.models.yolo import YOLOv2 as JaxYOLOv2
from tpudet.models.yolo import YOLOv3 as JaxYOLOv3
from tpudet.runtime import optim as jax_optim
from tpudet_torch.models import YOLOv2, YOLOv3
from tpudet_torch.runtime import transfer
from torch_refine_common import (PIXEL_MEAN, jax_step, nchw, nhwc, numpy_variables, rel,
                                 tree_like, tree_rel)

SIZE = 64
NUM_CLASSES = 20
V2_PRIORS = [[1.08, 1.19], [3.42, 4.41], [6.63, 11.38], [9.42, 5.11], [16.62, 10.52]]
V3_PRIORS = [[[10.0, 13.0], [16, 30.0], [33.0, 23.0]],
             [[30.0, 61.0], [62.0, 45.0], [59.0, 119.0]],
             [[116.0, 90.0], [156.0, 198.0], [373.0, 326.0]]]
FAMILIES = {"v2": (JaxYOLOv2, YOLOv2), "v3": (JaxYOLOv3, YOLOv3)}


def config(family, **kw):
    """The training script's config (``drivers/testYOLOv2.py``, ``testYOLOv3.py``) at
    input ``SIZE`` and batch 2, with a score threshold that random weights
    pass."""
    cfg = {"mode": "train", "data_shape": [SIZE, SIZE, 3], "num_classes": NUM_CLASSES,
           "weight_decay": 1e-4 if family == "v2" else 5e-4, "keep_prob": 0.5,
           "data_format": "channels_last", "batch_size": 2, "coord_scale": 1,
           "noobj_scale": 1, "obj_scale": 5.0, "class_scale": 1.0,
           "nms_score_threshold": 0.3, "nms_max_boxes": 10, "nms_iou_threshold": 0.5,
           "seed": 3}
    if family == "v2":
        cfg.update(priors=V2_PRIORS, rescore_confidence=False)
    else:
        cfg.update(priors=V3_PRIORS, num_priors=3)
    cfg.update(kw)
    return cfg


def outputs_list(out):
    """A net's output as a list of NCHW (port) or NHWC (tpudet) tensors."""
    return list(out) if isinstance(out, (tuple, list)) else [out]


def gt_batch(rng, size, b=2, g=12):
    """``gt [b, g, 5]`` in pixels: image 0 with two gts in one cell (one of
    them with an out-of-range class id), sides log-uniform from 3% to 80% of
    the image, so every YOLOv3 head takes some; the last image (b >= 3) has
    none."""
    gt = -np.ones((b, g, 5), np.float32)
    for i in range(b if b < 3 else b - 1):
        n = int(rng.integers(5, g - 1))
        hw = size * np.exp(rng.uniform(np.log(0.03), np.log(0.8), (n, 2)))
        yx = rng.uniform(hw / 2, size - hw / 2)
        gt[i, :n] = np.concatenate([yx, hw, rng.integers(0, NUM_CLASSES, (n, 1))], -1)
    # one gt for each of YOLOv3's heads at 448 (ties of the three IoUs go to
    # the stride-8 head): small, thin, large
    gt[0, 2:5, 2:4] = size * np.asarray([[0.03, 0.045], [0.027, 0.22], [0.45, 0.33]])
    gt[0, 1, :2] = gt[0, 0, :2] + 0.25  # the same cell as gt 0
    gt[0, 1, 4] = NUM_CLASSES + 5       # out of range: a zero one-hot row
    return gt


def images(seed, b=2, size=SIZE):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (b, size, size, 3)).astype(np.float32),
            gt_batch(rng, float(size), b))


def tpudet_pair(family, seed=0, **kw):
    """tpudet's model in test mode with seeded numpy variables, the
    variables, and an image."""
    jax_cls = FAMILIES[family][0]
    rng = np.random.default_rng(seed)

    class Seeded(jax_cls):
        def _init_variables(self):
            variables = numpy_variables(self.net, rng)
            self.params, self.batch_stats = variables["params"], variables["batch_stats"]
            self._optimizer = self._make_optimizer()
            self.opt_state = None

    jm = Seeded(config(family, mode="test", **kw))
    variables = {"params": jax.device_get(jm.params),
                 "batch_stats": jax.device_get(jm.batch_stats)}
    image = rng.uniform(0, 255, (1, SIZE, SIZE, 3)).astype(np.float32)
    return jm, variables, image


def port_model(family, variables, **kw):
    pm = FAMILIES[family][1](config(family, **kw), device="cpu")
    transfer.load_flax(pm.net, variables)
    return pm


def check_outputs(got, want, tol):
    got, want = outputs_list(got), outputs_list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape[0] == w.shape[0] and tuple(g.shape[2:]) == tuple(w.shape[1:3])
        assert rel(nhwc(g), np.asarray(w, np.float32)) < tol


def check_eval_forward(jm, family, variables, image, dtype="float32", **kw):
    """The eval-mode outputs of both nets on one image; the parameter counts
    agree."""
    net = type(jm.net)(final_units=jm.net.final_units, dtype=getattr(jnp, dtype),
                       raw_pred=jm.net.raw_pred)
    x = image - PIXEL_MEAN
    want = net.apply(variables, jnp.asarray(x), False)
    pm = port_model(family, variables, mode="test", compute_dtype=dtype, **kw)
    with torch.no_grad():
        got = pm.net(nchw(x))
    for g in outputs_list(got):
        assert g.dtype == getattr(torch, dtype)
    check_outputs(got, want, 1e-4 if dtype == "float32" else 2e-2)
    assert sum(p.numel() for p in pm.net.parameters()) == sum(
        np.size(v) for v in jax.tree.leaves(variables["params"]))
    return pm


def check_train_step(jm, family, variables, dtype="float32", lr=0.01):
    """One YOLO step at batch 2, held as the module docstring says
    (:func:`check_step`)."""
    jm = copy.copy(jm)
    jm.net = type(jm.net)(final_units=jm.net.final_units, dtype=getattr(jnp, dtype),
                          raw_pred=jm.net.raw_pred)
    pm = port_model(family, variables, compute_dtype=dtype)
    return check_step(jm, pm, variables, *images(5), lr, config(family)["weight_decay"],
                      dtype)


def check_step(jm, pm, variables, imgs, gt, lr, wd, dtype="float32"):
    """One step of tpudet's ``jm`` (its net in ``dtype``) and of the port's
    ``pm`` from ``variables`` and a non-zero velocity, on the same batch, held
    as the module docstring says. Returns the port's loss."""
    rng = np.random.default_rng(21)
    params, bstats = variables["params"], variables["batch_stats"]
    velocity = tree_like(params, lambda v: (0.01 * rng.normal(size=np.shape(v)))
                         .astype(np.float32))
    w_loss, w_params, w_stats, w_vel, w_out = jax_step(jm, params, bstats, velocity,
                                                       imgs, gt, lr, wd)
    x, g = pm._to_device(imgs, gt)

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
                [t.detach() for t in outputs_list(seen[0])])

    loss, state, vel, outs = port_step(x)
    with torch.backends.mkldnn.flags(enabled=False):  # the other summation order
        _, state_b, vel_b, outs_b = port_step(x)
    floor = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(loss, float(w_loss), rtol=floor)
    for got, other, w in zip(outs, outs_b, outputs_list(w_out)):
        sens = rel(nhwc(other), nhwc(got))
        assert rel(nhwc(got), np.asarray(w, np.float32)) < max(floor, 4 * sens)
    want = transfer.from_flax({"params": w_params, "batch_stats": w_stats})
    stats = [k for k in want if k.endswith((".mean", ".var"))]
    sens = max(rel(state_b[k].numpy(), state[k].numpy()) for k in stats)
    assert max(rel(state[k].numpy(), want[k].numpy()) for k in stats) < max(floor, 4 * sens)
    if dtype != "float32":
        return loss
    p_keys = [k for k in want if k not in stats]
    sens = tree_rel({k: state_b[k] for k in p_keys}, {k: state[k] for k in p_keys})
    assert tree_rel(state, {k: want[k] for k in p_keys}) < max(floor, 4 * sens)
    w_v = transfer.velocity_from_flax(w_vel)
    assert tree_rel(vel, w_v) < max(floor, 4 * tree_rel(vel_b, vel))
    return loss


def check_test_one_image(jm, family, variables, image):
    """``test_one_image`` on both sides: the same classes, scores to 1e-4
    (the same picks: the network outputs differ by float32 rounding)."""
    pm = port_model(family, variables, mode="test")
    got = pm.test_one_image(image)
    want = [np.asarray(w) for w in jm.test_one_image(image)]
    assert len(want[0]) > 0
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-3)


def check_tpudet_file(tmp_path, jm, family, variables, image):
    """tpudet's ``save_weight`` (a non-zero velocity, step 7) read by the
    port's ``load_weight``, and its ``backone`` by ``load_pretraining_weight``
    into a port model of other weights: the same tensors."""
    rng = np.random.default_rng(1)
    velocity = tree_like(variables["params"],
                         lambda v: rng.normal(size=np.shape(v)).astype(np.float32))
    jm.opt_state = jax_optim.MomentumState(velocity)
    jm.global_step = 7
    jm.save_weight("latest", str(tmp_path / "model"))
    jm.opt_state, jm.global_step = None, 0

    port_cls = FAMILIES[family][1]
    want = transfer.from_flax(variables)
    pm = port_cls(config(family, seed=11), device="cpu")
    pm.load_weight(str(tmp_path / "model"))
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
    check_outputs(mine, jm.net.apply(variables, jnp.asarray(x), False), 1e-4)

    other = port_cls(config(family, seed=12), device="cpu")
    before = other.net.state_dict()
    other.load_pretraining_weight(str(tmp_path / "model"))
    after = other.net.state_dict()
    for k in want:
        if k.startswith("backone."):
            assert torch.equal(after[k], want[k]), k
        else:
            assert torch.equal(after[k], before[k]), k
