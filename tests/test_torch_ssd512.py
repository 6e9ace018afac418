"""The port's SSD512 against tpudet's on the same numpy inputs.

The whole model runs at input 76 with SSD512's full widths and its scale
rule taken at 76 on both sides: the seven levels are 10/5/3/2/2/1/1, so the
stride-2 extra stages pad asymmetrically as at 512 (64/32/16/8/8/4/2).
tpudet's variables are drawn from numpy (``torch_refine_common``). The loss
and the decode run on identical head tensors over the real 24,912 anchors of
512x512. tpudet's conf CE runs in its ``ac`` layout, the port's.

Tolerances: float32 network outputs 1e-4 normwise; the loss on identical
head tensors 1e-5 relative and its gradients 1e-5 of their largest entry;
the decode's picks exactly; whole steps as ``tests/torch_yolo_common.py``
says (``check_step``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.heads import ssd as jax_ssd
from tpudet.models.ssd import SSD512 as JaxSSD512
from tpudet.models.ssd import _ssd512_scale_pairs as jax_scale_pairs
from tpudet_torch.heads import ssd as t_ssd
from tpudet_torch.models.ssd import SSD512, _ssd512_scale_pairs, _ssd_feat_shapes
from tpudet_torch.ops.cuda import assign_kernel, nms_kernel
from tpudet_torch.runtime import transfer
from torch_assign_cases import rand_gt
from torch_refine_common import PIXEL_MEAN, nchw, numpy_variables
from torch_yolo_common import check_outputs, check_step

torch.set_num_threads(1)

SIZE = 76


class _JaxSSD512Small(JaxSSD512):
    input_size = SIZE
    scale_pairs = jax_scale_pairs(float(SIZE))


class SSD512Small(SSD512):
    input_size = SIZE
    scale_pairs = _ssd512_scale_pairs(float(SIZE))


def _config(**kw):
    cfg = {"mode": "train", "data_format": "channels_last", "num_classes": 20,
           "weight_decay": 1e-4, "keep_prob": 0.5, "batch_size": 2,
           "nms_score_threshold": 0.05, "nms_max_boxes": 20, "nms_iou_threshold": 0.5,
           "pretraining_weight": None, "hard_neg_cap": 384, "seed": 3}
    cfg.update(kw)
    return cfg


@pytest.fixture(autouse=True)
def _ac_layout(monkeypatch):
    monkeypatch.setenv("TPUDET_SSD_CONF_LAYOUT", "ac")


@pytest.fixture(scope="module")
def pair():
    """tpudet's SSD512 at 76 with seeded numpy variables, the variables, and
    an image."""
    rng = np.random.default_rng(0)

    class Seeded(_JaxSSD512Small):
        def _init_variables(self):
            variables = numpy_variables(self.net, rng)
            self.params, self.batch_stats = variables["params"], variables["batch_stats"]
            self._optimizer = self._make_optimizer()
            self.opt_state = None

    jm = Seeded(_config(mode="test"))
    variables = {"params": jax.device_get(jm.params),
                 "batch_stats": jax.device_get(jm.batch_stats)}
    image = rng.uniform(0, 255, (1, SIZE, SIZE, 3)).astype(np.float32)
    return jm, variables, image


def _port(variables, **kw):
    pm = SSD512Small(_config(**kw), device="cpu")
    transfer.load_flax(pm.net, variables)
    return pm


def test_ssd512_levels_and_anchors_match_tpudet(pair):
    """Eval mode, float32: the seven levels; the anchors exactly."""
    jm, variables, image = pair
    pm = _port(variables, mode="test")
    x = image - PIXEL_MEAN
    want = jm.net.apply(variables, jnp.asarray(x), False)
    with torch.no_grad():
        got = pm.net(nchw(x))
    assert [tuple(g.shape[2:]) for g in got] == [(s, s) for s in (10, 5, 3, 2, 2, 1, 1)]
    check_outputs(got, want, 1e-4)
    for g, w in zip(pm.anchors, jm.anchors):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert sum(p.numel() for p in pm.net.parameters()) == sum(
        np.size(v) for v in jax.tree.leaves(variables["params"]))


@pytest.fixture(scope="module")
def anchors512():
    shapes = _ssd_feat_shapes(512, SSD512.extra_strides)
    assert shapes == [(s, s) for s in (64, 32, 16, 8, 8, 4, 2)]
    args = (512, shapes, SSD512.aspect_ratios, SSD512.scale_pairs)
    janc, tanc = jax_ssd.build_anchors(*args), t_ssd.build_anchors(*args)
    assert tanc.yx.shape == (24912, 2)
    return janc, tanc


def test_ssd512_loss_matches_tpudet(anchors512):
    """fp32 on identical head tensors over 24,912 anchors, batch 2 with 1-10
    gts an image padded to 60: the value and the gradients; the mining goes
    through the pool (768 of 24,912)."""
    janc, tanc = anchors512
    rng = np.random.default_rng(3)
    heads = [rng.normal(0, s, (2, 24912, c)).astype(np.float32)
             for s, c in ((2.0, 21), (0.5, 2), (0.5, 2))]
    gt = rand_gt(rng, 2, 60, 10, size=512.0, n_valid_min=1)

    def loss(gt, *h):
        return jax_ssd.ssd_loss(*h, janc, gt, 21, neg_sel_cap=384)

    want, wgrads = jax.jit(jax.value_and_grad(loss, argnums=(1, 2, 3)))(
        jnp.asarray(gt), *map(jnp.asarray, heads))
    tt = [torch.tensor(h, requires_grad=True) for h in heads]
    calls = []
    real = nms_kernel.nms_rows

    def spy(boxes, scores, ns, max_out, thr, order=None):
        calls.append(None if order is None else tuple(order.shape))
        return real(boxes, scores, ns, max_out, thr, order)

    nms_kernel.nms_rows, saved = spy, nms_kernel.nms_rows
    try:
        got = t_ssd.ssd_loss(*tt, tanc, torch.from_numpy(gt), 21, neg_sel_cap=384)
    finally:
        nms_kernel.nms_rows = saved
    assert calls == [(2, 768)]
    grads = torch.autograd.grad(got, tt)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for g, w in zip(grads, wgrads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_ssd512_decode_matches_tpudet(anchors512):
    """One image's head tensors over 24,912 anchors through both decodes
    (tpudet with a pre-top-k as wide as the anchors): identical picks; the
    rows [20, 24912] go through the 512-wide pool."""
    janc, tanc = anchors512
    rng = np.random.default_rng(8)
    heads = [rng.normal(0, s, (24912, c)).astype(np.float32)
             for s, c in ((2.0, 21), (0.5, 2), (0.5, 2))]
    want = [np.asarray(w) for w in jax_ssd.ssd_decode(
        *map(jnp.asarray, heads), janc, 0.1, 0.5, 20, pre_topk=24912)]
    assert not bool(want[4])
    got = [t.numpy() for t in t_ssd.ssd_decode(*map(torch.from_numpy, heads), tanc,
                                                0.1, 0.5, 20)]
    valid = want[3]
    np.testing.assert_array_equal(got[3], valid)
    assert valid.sum() > 20
    np.testing.assert_array_equal(got[2][valid], want[2][valid])
    np.testing.assert_allclose(got[0][valid], want[0][valid], rtol=1e-6)
    np.testing.assert_allclose(got[1][valid], want[1][valid], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd512_train_step_matches_tpudet(pair, dtype):
    """One step at input 76, batch 2: the train-mode levels, the loss and
    the state after the step; on the CPU no kernel launches."""
    jm, variables, _ = pair
    jm = copy.copy(jm)
    jm.net = type(jm.net)(num_classes_total=21, aspect_ratios=SSD512.aspect_ratios,
                          extra_widths=SSD512.extra_widths,
                          extra_strides=SSD512.extra_strides, dtype=getattr(jnp, dtype))
    rng = np.random.default_rng(5)
    images = rng.uniform(0, 255, (2, SIZE, SIZE, 3)).astype(np.float32)
    gt = rand_gt(rng, 2, 60, 6, size=float(SIZE), n_valid_min=1)
    launches = (assign_kernel.launches, nms_kernel.launches)
    check_step(jm, _port(variables, compute_dtype=dtype), variables, images, gt, 0.01,
               1e-4, dtype)
    assert (assign_kernel.launches, nms_kernel.launches) == launches


def test_ssd512_test_one_image_matches_tpudet(pair):
    """The same classes and picks; scores to 1e-4."""
    jm, variables, image = pair
    got = _port(variables, mode="test").test_one_image(image)
    want = [np.asarray(w) for w in jm.test_one_image(image)]
    assert len(want[0]) > 0
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-3)
