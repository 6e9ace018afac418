"""The port's YOLO pieces against tpudet's on the same numpy inputs: the
shared pieces (``split_pred``, the nearest upsample, ``one_hot``, the sigmoid
CE, the leaky ReLU), and both losses and both decodes on identical head
tensors at the training scripts' sizes. The whole models are in
``tests/test_torch_yolov2.py`` and ``tests/test_torch_yolov3.py`` (its train
steps in ``tests/test_torch_yolov3_step.py``). Tolerances and their reasons
are in ``tests/torch_yolo_common.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.heads import yolo as jax_yolo
from tpudet.nn.backbones import darknet as jax_darknet
from tpudet.ops import losses as jax_losses
from tpudet_torch.heads import yolo as t_yolo
from tpudet_torch.models import YOLOv2
from tpudet_torch.models.yolo import priors_per_head
from tpudet_torch.nn.backbones import darknet as t_darknet
from tpudet_torch.ops import losses as t_losses
from tpudet_torch.ops.cuda import nms_kernel
from torch_refine_common import nchw, nhwc
from torch_yolo_common import NUM_CLASSES, V2_PRIORS, V3_PRIORS, config, gt_batch

torch.set_num_threads(1)

# head sizes at the training scripts' inputs: YOLOv2 480 (15x15), YOLOv3 448 (14/28/56)
V2_GRID = (15,)
V3_GRIDS = (14, 28, 56)


def _v3_priors(consistent):
    """YOLOv3's per-head priors as both models build them (Q4 or not)."""
    return priors_per_head(V3_PRIORS, consistent)


# ------------------------------------------------------------ small pieces
def test_split_pred_matches_tpudet():
    """NCHW in, tpudet's NHWC reshape order out, float32 from bf16."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 4, 5 * 25)).astype(np.float32)
    want = jax_yolo.split_pred(jnp.asarray(x, jnp.bfloat16), 5, 20)
    got = t_yolo.split_pred(nchw(x).to(torch.bfloat16), 5, 20)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("shape,out", [((2, 2), (4, 4)), ((3, 5), (7, 4)),
                                       ((7, 7), (14, 14)), ((5, 3), (5, 3))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nearest_resize_matches_tpudet(shape, out, dtype):
    """Exactly, at integer and non-integer ratios, in both dtypes."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, *shape, 3)).astype(np.float32)
    want = jax_yolo._nearest_resize(jnp.asarray(x, getattr(jnp, dtype)), *out)
    got = t_yolo.nearest_resize(nchw(x).to(getattr(torch, dtype)), *out)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(nhwc(got), np.asarray(want, np.float32))


def test_one_hot_gives_zero_rows_out_of_range():
    """``jax.nn.one_hot``'s semantics: -1, 20 and 25 give rows of zeros."""
    labels = np.asarray([[-1, 2, 5], [20, 25, 0]], np.int32)
    want = np.asarray(jax.nn.one_hot(jnp.asarray(labels), 20))
    got = t_losses.one_hot(torch.from_numpy(labels), 20)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.sum(-1).numpy(), [[0, 1, 1], [0, 0, 1]])


def test_sigmoid_cross_entropy_matches_tpudet():
    """Values and gradients, ties at 0 included (each side of the max gets
    half the gradient, as in JAX)."""
    x = np.asarray([-30.0, -2.5, -0.0, 0.0, 1e-3, 3.0, 40.0], np.float32)
    t = np.asarray([0.0, 1.0, 0.5, 0.0, 1.0, 0.25, 0.0], np.float32)
    want, wgrad = jax.value_and_grad(
        lambda a: jnp.sum(jax_losses.sigmoid_cross_entropy(a, jnp.asarray(t))))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = torch.sum(t_losses.sigmoid_cross_entropy(xt, torch.from_numpy(t)))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(torch.autograd.grad(got, xt)[0].numpy(), np.asarray(wgrad),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_leaky_matches_flax(dtype):
    """``where(x >= 0, x, 0.1 * x)`` with the slope in ``x``'s dtype (bf16's
    0.1 in bf16), exactly; gradient 1 at 0."""
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.normal(size=200), [0.0]]).astype(np.float32)
    want = jax_darknet._leaky(jnp.asarray(x, getattr(jnp, dtype)))
    xt = torch.tensor(x).to(getattr(torch, dtype)).requires_grad_(True)
    got = t_darknet.leaky(xt)
    np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(want, np.float32))
    grad = torch.autograd.grad(got.sum(), xt)[0]
    assert float(grad[-1]) == 1.0


# ------------------------------------------------------------ losses
def _heads(rng, b, grids, k=3):
    """NHWC head tensors ``[B, H, W, K*(C+5)]``, logits spread over +-4."""
    return [rng.normal(0, 1.5, (b, s, s, k * (NUM_CLASSES + 5))).astype(np.float32)
            for s in grids]


@pytest.fixture(scope="module")
def loss_cases():
    rng = np.random.default_rng(4)
    return {"v2": (_heads(rng, 3, V2_GRID, 5), gt_batch(rng, 480.0, 3, 20)),
            "v3": (_heads(rng, 3, V3_GRIDS), gt_batch(rng, 448.0, 3, 20))}


def _jax_loss(family, consistent):
    if family == "v2":
        def loss(gt, pred):
            return jax_yolo.yolov2_loss(pred, V2_PRIORS, gt, NUM_CLASSES, 32.0,
                                        (1.0, 1.0, 5.0, 1.0), consistent=consistent)
    else:
        def loss(gt, p1, p2, p3):
            return jax_yolo.yolov3_loss((p1, p2, p3), _v3_priors(consistent), gt,
                                        NUM_CLASSES, (1.0, 1.0, 5.0, 1.0),
                                        consistent=consistent)
    return jax.jit(jax.value_and_grad(loss, argnums=tuple(range(1, 4 if family == "v3"
                                                                 else 2))))


def _port_loss(family, consistent, gt, heads):
    if family == "v2":
        return t_yolo.yolov2_loss(heads[0], V2_PRIORS, gt, NUM_CLASSES, 32.0,
                                  (1.0, 1.0, 5.0, 1.0), consistent=consistent)
    return t_yolo.yolov3_loss(heads, _v3_priors(consistent), gt, NUM_CLASSES,
                              (1.0, 1.0, 5.0, 1.0), consistent=consistent)


@pytest.mark.parametrize("consistent", [False, True])
@pytest.mark.parametrize("family", ["v2", "v3"])
def test_loss_matches_tpudet(loss_cases, family, consistent):
    """fp32 on identical head tensors at the training scripts' sizes: the value and
    the gradient of every head. Two gts share a cell, one has an
    out-of-range class id, the last image has none; YOLOv3 routes some gts
    to each head."""
    heads, gt = loss_cases[family]
    want, wgrads = _jax_loss(family, consistent)(jnp.asarray(gt), *map(jnp.asarray, heads))
    tt = [nchw(h).requires_grad_(True) for h in heads]
    got = _port_loss(family, consistent, torch.from_numpy(gt), tt)
    grads = torch.autograd.grad(got, tt)
    assert np.isfinite(float(want))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for g, w in zip(grads, wgrads):
        w = np.asarray(w)
        np.testing.assert_allclose(nhwc(g), w, rtol=0, atol=1e-5 * np.abs(w).max())
    if family == "v3":
        g_ = t_yolo.matching.unpack_gt(torch.from_numpy(gt))
        ious = []
        for h, priors, stride in zip(tt, _v3_priors(consistent), t_yolo.CELL_STRIDES):
            s = h.shape[-1]
            centers, prior_hw = t_yolo.grid_prior_arrays(s, s, priors)
            ious.append(t_yolo.match(centers, prior_hw, g_.yx / stride,
                                     g_.hw / stride).iou_max)
        m1 = (ious[0] > ious[1]) & (ious[0] > ious[2])
        m2 = (ious[1] > ious[0]) & (ious[1] > ious[2])
        routed = [m & g_.valid for m in (m1, m2, ~(m1 | m2))]
        assert all(int(m.sum()) > 0 for m in routed)


@pytest.mark.parametrize("label", [-1, NUM_CLASSES, NUM_CLASSES + 5])
@pytest.mark.parametrize("family", ["v2", "v3"])
def test_out_of_range_label_gives_tpudets_finite_loss(loss_cases, family, label):
    """A valid gt with a class id outside [0, 20) adds no class target (a zero
    one-hot row) and the loss stays finite, equal to tpudet's; nothing raises."""
    heads, gt = loss_cases[family]
    gt = gt.copy()
    gt[1, 0, 4] = label
    want, _ = _jax_loss(family, False)(jnp.asarray(gt), *map(jnp.asarray, heads))
    got = _port_loss(family, False, torch.from_numpy(gt), [nchw(h) for h in heads])
    assert torch.isfinite(got)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# ------------------------------------------------------------ decodes
@pytest.mark.parametrize("consistent", [False, True])
@pytest.mark.parametrize("family", ["v2", "v3"])
def test_decode_matches_tpudet(family, consistent, monkeypatch):
    """One image's head tensors at the training script's size through both decodes
    (tpudet with a pre-top-k as wide as the rows, so it does not truncate),
    at the training script's thresholds: identical picks. The rows, 1125 (YOLOv2) and
    12348 (YOLOv3) of 20 classes, go through the 512-wide pool."""
    rng = np.random.default_rng(6)
    heads = [h[0] for h in _heads(rng, 1, V2_GRID if family == "v2" else V3_GRIDS,
                                  5 if family == "v2" else 3)]
    n = sum(h.shape[0] * h.shape[1] for h in heads) * (5 if family == "v2" else 3)
    if family == "v2":
        want = jax_yolo.yolov2_decode(jnp.asarray(heads[0]), V2_PRIORS, NUM_CLASSES, 32.0,
                                      0.5, 0.5, 10, pre_topk=n, consistent=consistent)
    else:
        want = jax_yolo.yolov3_decode([jnp.asarray(h) for h in heads],
                                      _v3_priors(consistent), NUM_CLASSES, 0.5, 0.5, 10,
                                      pre_topk=n, consistent=consistent)
    want = [np.asarray(w) for w in want]
    assert not bool(want[4])
    calls = []
    real = nms_kernel.nms_rows
    monkeypatch.setattr(nms_kernel, "nms_rows",
                        lambda *a: calls.append((tuple(a[1].shape), tuple(a[5].shape)))
                        or real(*a))
    chw = [torch.from_numpy(np.ascontiguousarray(h.transpose(2, 0, 1))) for h in heads]
    if family == "v2":
        got = t_yolo.yolov2_decode(chw[0], V2_PRIORS, NUM_CLASSES, 32.0, 0.5, 0.5, 10,
                                   consistent=consistent)
    else:
        got = t_yolo.yolov3_decode(chw, _v3_priors(consistent), NUM_CLASSES, 0.5, 0.5, 10,
                                   consistent=consistent)
    assert calls == [((NUM_CLASSES, n), (NUM_CLASSES, 512))]
    got = [t.numpy() for t in got]
    valid = want[3]
    np.testing.assert_array_equal(got[3], valid)
    assert valid.sum() > 20
    np.testing.assert_array_equal(got[2][valid], want[2][valid])
    np.testing.assert_allclose(got[0][valid], want[0][valid], rtol=1e-6)
    np.testing.assert_allclose(got[1][valid], want[1][valid], rtol=1e-5, atol=1e-4)


def test_yolo_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        YOLOv2(config("v2", compute_dtype="bfloat16"))
