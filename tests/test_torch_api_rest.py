"""The last of tpudet's public functions in the port, each held against
tpudet's on the same seeded numpy inputs: the loss primitives
``softmax_focal``, ``penalty_reduced_focal`` and ``neg_log_iou``,
``topk_then_nms``, the per-image losses of YOLOv2, YOLOv3, FCOS and
CenterNet, and tpudet's ``LHRCNNTrunk`` against the port's ``LHRCNNNet``
carried by ``transfer.lhrcnn_trunk_from_flax``."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.heads import centernet as jax_center
from tpudet.heads import fcos as jax_fcos
from tpudet.heads import lhrcnn as jax_lh
from tpudet.heads import yolo as jax_yolo
from tpudet.models.lhrcnn import LHRCNNNet as JaxNet
from tpudet.ops import losses as jax_losses
from tpudet.ops import nms as jax_nms
from tpudet_torch.heads import centernet as t_center
from tpudet_torch.heads import fcos as t_fcos
from tpudet_torch.heads import yolo as t_yolo
from tpudet_torch.models.lhrcnn import LHRCNNNet
from tpudet_torch.models.yolo import priors_per_head
from tpudet_torch.ops import losses as t_losses
from tpudet_torch.ops import nms as t_nms
from tpudet_torch.ops.cuda import nms_kernel
from tpudet_torch.runtime import transfer
from torch_anchor_free_common import check_outputs
from torch_refine_common import nchw, rel
from torch_yolo_common import NUM_CLASSES, V2_PRIORS, V3_PRIORS, gt_batch

torch.set_num_threads(1)


# ------------------------------------------------------------ loss primitives
def test_softmax_focal_matches_tpudet():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 2.0, (64, 21)).astype(np.float32)
    labels = rng.integers(0, 21, 64).astype(np.int32)
    want = jax_losses.softmax_focal(jnp.asarray(logits), jnp.asarray(labels), 0.25, 2.0)
    got = t_losses.softmax_focal(torch.tensor(logits), torch.tensor(labels), 0.25, 2.0)
    assert got.shape == (64,)
    assert rel(got.numpy(), np.asarray(want)) < 1e-6


def test_penalty_reduced_focal_matches_tpudet():
    """Both branches, at random cells and at tpudet's own case
    (``tests/test_ops.py``: s = 0.5 everywhere, one positive cell)."""
    rng = np.random.default_rng(1)
    s = rng.uniform(0.01, 0.99, (3, 16, 16)).astype(np.float32)
    g = rng.uniform(0.0, 1.0, (3, 16, 16)).astype(np.float32)
    pos = rng.random((3, 16, 16)) < 0.1
    for args in ((s, g, pos),
                 (np.full((4, 4), 0.5, np.float32),
                  np.eye(1, 16, 5, dtype=np.float32).reshape(4, 4),
                  np.eye(1, 16, 5, dtype=bool).reshape(4, 4))):
        want = np.asarray(jax_losses.penalty_reduced_focal(*map(jnp.asarray, args)))
        got = t_losses.penalty_reduced_focal(*map(torch.tensor, args)).numpy()
        assert got.shape == want.shape
        for branch in (args[2], ~args[2]):
            assert rel(got[branch], want[branch]) < 1e-6
    assert got[1, 1] == pytest.approx(-np.square(0.5) * np.log(0.5), rel=1e-6)


def test_neg_log_iou_matches_tpudet():
    rng = np.random.default_rng(2)
    p = np.exp(rng.normal(0, 1, (50, 4))).astype(np.float32) * 3.0
    g = np.exp(rng.normal(0, 1, (50, 4))).astype(np.float32) * 3.0
    want = jax_losses.neg_log_iou(jnp.asarray(p), jnp.asarray(g))
    got = t_losses.neg_log_iou(torch.tensor(p), torch.tensor(g))
    assert rel(got.numpy(), np.asarray(want)) < 1e-6
    t = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    assert abs(float(t_losses.neg_log_iou(t, t)[0])) < 1e-5


# ------------------------------------------------------------ topk_then_nms
def _row(rng, n, levels=None):
    """``n`` corner boxes in a 40x40 field and scores; ``levels`` integer
    scores from ``range(levels)`` (many ties), else uniform."""
    yx = rng.uniform(0, 40, (n, 2))
    boxes = np.concatenate([yx, yx + rng.uniform(2, 12, (n, 2))], 1).astype(np.float32)
    scores = (rng.integers(0, levels, n) if levels else rng.uniform(0, 1, n))
    return boxes, scores.astype(np.float32)


@pytest.mark.parametrize("case", ["ties", "truncated", "inactive", "k_is_n_wide",
                                  "k_wide", "k_n"])
def test_topk_then_nms_matches_tpudet(case):
    """Boxes, valid and truncated exactly, scores equal: a tie-heavy row
    (five score levels), a truncated one (more active than ``pre_topk``), an
    all-inactive one, and ``pre_topk`` past the select kernel's width both at
    ``k = N`` and at ``1024 < k < N`` (the card's whole-row route, taken on
    the CPU alike), and ``pre_topk`` over ``N``."""
    rng = np.random.default_rng(["ties", "truncated", "inactive", "k_is_n_wide", "k_wide",
                                 "k_n"].index(case))
    n, pre, max_out, levels = {"ties": (300, 200, 40, 5), "truncated": (300, 50, 30, None),
                               "inactive": (64, 32, 10, 5),
                               "k_is_n_wide": (1500, 1500, 25, 7),
                               "k_wide": (1500, 1200, 25, 7),
                               "k_n": (100, 400, 20, 4)}[case]
    boxes, scores = _row(rng, n, levels)
    active = scores >= (1 if levels else 0.3) if case != "inactive" else np.zeros(n, bool)
    want = jax.jit(jax_nms.topk_then_nms, static_argnums=(3, 4, 5))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(active), pre, max_out, 0.45)
    got = t_nms.topk_then_nms(torch.tensor(boxes), torch.tensor(scores),
                              torch.tensor(active), pre, max_out, 0.45)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[3]) == bool(pre < n and active.sum() > pre)
    plain = t_nms.plain_topk_then_nms(torch.tensor(boxes), torch.tensor(scores),
                                      torch.tensor(active), pre, max_out, 0.45)
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g.numpy(), p.numpy())


def test_greedy_nms_takes_the_plain_loop_on_the_cpu_and_raises_elsewhere():
    rng = np.random.default_rng(9)
    boxes, scores = _row(rng, 80, 6)
    active = scores > 0
    want = jax.jit(jax_nms.greedy_nms, static_argnums=(2, 3))(
        jnp.asarray(boxes), jnp.asarray(scores), 15, 0.45, jnp.asarray(active),
        jnp.int32(11))
    before = nms_kernel.launches
    got = t_nms.greedy_nms(torch.tensor(boxes), torch.tensor(scores), 15, 0.45,
                           torch.tensor(active), num_select=torch.tensor(11))
    assert nms_kernel.launches == before
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    meta = torch.empty((80,), device="meta")
    with pytest.raises(ValueError, match="no NMS implementation"):
        t_nms.greedy_nms(torch.empty((80, 4), device="meta"), meta, 15, 0.45)
    with pytest.raises(ValueError, match="no NMS implementation"):
        t_nms.topk_then_nms(torch.empty((80, 4), device="meta"), meta,
                            torch.empty((80,), dtype=torch.bool, device="meta"), 10, 5, 0.45)


# ------------------------------------------------------------ per-image losses
def _yolo_heads(rng, grids, k):
    return [rng.normal(0, 1.5, (s, s, k * (NUM_CLASSES + 5))).astype(np.float32)
            for s in grids]


def _chw(x):
    return torch.tensor(np.transpose(x, (2, 0, 1)))


@pytest.mark.parametrize("consistent", [False, True])
@pytest.mark.parametrize("family", ["v2", "v3"])
def test_yolo_image_loss_matches_tpudet(family, consistent):
    """One image at the drivers' grids (YOLOv2 480, YOLOv3 448), gts from
    ``torch_yolo_common.gt_batch``: two in one cell, one out-of-range class
    id, some on every YOLOv3 head; and an image with no gt."""
    rng = np.random.default_rng(5)
    scales = (1.0, 1.0, 5.0, 1.0)
    if family == "v2":
        heads = _yolo_heads(rng, (15,), 5)
        gts = gt_batch(rng, 480.0, 3, 20)
    else:
        heads = _yolo_heads(rng, (14, 28, 56), 3)
        gts = gt_batch(rng, 448.0, 3, 20)
        priors = priors_per_head(V3_PRIORS, consistent)
    for gt in (gts[0], gts[-1]):
        if family == "v2":
            want = jax.jit(lambda p, g: jax_yolo.yolov2_image_loss(
                p, V2_PRIORS, g, NUM_CLASSES, 32.0, scales, consistent))(
                    jnp.asarray(heads[0]), jnp.asarray(gt))
            got = t_yolo.yolov2_image_loss(_chw(heads[0]), V2_PRIORS, torch.tensor(gt),
                                           NUM_CLASSES, 32.0, scales, consistent)
        else:
            want = jax.jit(lambda p, g: jax_yolo.yolov3_image_loss(
                p, priors, g, NUM_CLASSES, scales, consistent))(
                    [jnp.asarray(h) for h in heads], jnp.asarray(gt))
            got = t_yolo.yolov3_image_loss([_chw(h) for h in heads], priors,
                                           torch.tensor(gt), NUM_CLASSES, scales, consistent)
        assert got.shape == ()
        assert float(got) == pytest.approx(float(want), rel=1e-5)


def _fcos_anchor_free_case():
    """``tests/test_anchor_free.py``'s FCOS image: 3 classes, levels 8x8 to
    1x1, one gt (and the empty gt)."""
    rng = np.random.default_rng(0)
    preds = []
    for fh, fw in [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]:
        preds.append((rng.normal(size=(fh, fw, 3)).astype(np.float32),
                      np.exp(rng.normal(size=(fh, fw, 4)).astype(np.float32) * 0.2),
                      rng.normal(size=(fh, fw, 1)).astype(np.float32)))
    gt = -np.ones((6, 5), np.float32)
    gt[0] = [32, 32, 24, 30, 1]
    return preds, gt, 3


def _fcos_consistent_case(seed):
    """``tests/test_fcos_consistent.py``'s ``_rand_case``: 6 classes, levels
    12x16 to 1x1, four gts of 20-700 px in a 2000 px field."""
    rng = np.random.default_rng(seed)
    preds = []
    for fh, fw in [(12, 16), (6, 8), (3, 4), (2, 2), (1, 1)]:
        preds.append((rng.normal(size=(fh, fw, 6)).astype(np.float32),
                      np.exp(rng.normal(size=(fh, fw, 4))).astype(np.float32) * 3.0,
                      rng.normal(size=(fh, fw, 1)).astype(np.float32)))
    gt = -np.ones((8, 5), np.float32)
    for k in range(4):
        h, w = rng.uniform(20, 700, 2)
        gt[k] = [rng.uniform(h / 2, 2000 - h / 2), rng.uniform(w / 2, 2000 - w / 2),
                 h, w, rng.integers(0, 6)]
    return preds, gt, 6


@pytest.mark.parametrize("case", ["anchor_free", "anchor_free_empty", "consistent_0",
                                  "consistent_3"])
@pytest.mark.parametrize("consistent", [False, True])
def test_fcos_image_loss_matches_tpudet(case, consistent, monkeypatch):
    monkeypatch.setenv("TPUDET_SSD_CONF_LAYOUT", "ca")
    if case.startswith("anchor_free"):
        preds, gt, classes = _fcos_anchor_free_case()
        if case.endswith("empty"):
            gt = -np.ones_like(gt)
    else:
        preds, gt, classes = _fcos_consistent_case(int(case[-1]))
    want = jax.jit(partial(jax_fcos.fcos_image_loss, num_classes=classes,
                           consistent=consistent))(
        [tuple(jnp.asarray(t) for t in lv) for lv in preds], jnp.asarray(gt))
    got = t_fcos.fcos_image_loss([tuple(_chw(t) for t in lv) for lv in preds],
                                 torch.tensor(gt), classes, consistent=consistent)
    assert got.shape == ()
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    if case == "anchor_free_empty" and not consistent:
        assert float(got) == 0.0


@pytest.mark.parametrize("case", ["perfect", "bad", "random"])
def test_centernet_image_loss_matches_tpudet(case, monkeypatch):
    """``tests/test_anchor_free.py``'s 16x16, 3-class image (the perfect
    prediction and the flat one) and a random one with three gts."""
    monkeypatch.setenv("TPUDET_SSD_CONF_LAYOUT", "ca")
    h = w = 16
    gt = -np.ones((4, 5), np.float32)
    gt[0] = [32, 32, 16, 16, 1]
    keyp = np.full((h, w, 3), -10.0 if case == "perfect" else 0.0, np.float32)
    offset = np.zeros((h, w, 2), np.float32)
    size = np.zeros((h, w, 2), np.float32)
    if case == "perfect":
        keyp[8, 8, 1] = 10.0
        size[8, 8] = [4.0, 4.0]
    if case == "random":
        rng = np.random.default_rng(3)
        keyp = rng.normal(0, 2, (h, w, 3)).astype(np.float32)
        offset = rng.uniform(0, 1, (h, w, 2)).astype(np.float32)
        size = rng.uniform(0, 8, (h, w, 2)).astype(np.float32)
        gt[1] = [12, 50, 10, 22, 0]
        gt[2] = [40, 9, 30, 12, 2]
    want = jax.jit(partial(jax_center.centernet_image_loss, num_classes=3))(
        *map(jnp.asarray, (keyp, offset, size, gt)))
    got = t_center.centernet_image_loss(_chw(keyp), _chw(offset), _chw(size),
                                        torch.tensor(gt), 3)
    assert got.shape == ()
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_per_image_losses_average_to_the_batched_ones():
    """The batched losses are the mean of the per-image ones (YOLOv3 half
    of it), on a batch of three."""
    rng = np.random.default_rng(6)
    preds = [[rng.normal(size=(2, c, s, s)).astype(np.float32) for c in (3, 4, 1)]
             for s in (8, 4, 2, 1, 1)]
    gt = -np.ones((2, 6, 5), np.float32)
    gt[0, 0] = [32, 32, 24, 30, 1]
    gt[1, :2] = [[20, 40, 30, 12, 2], [50, 10, 20, 18, 0]]
    tp = [[torch.tensor(t) for t in lv] for lv in preds]
    for lv in tp:
        lv[1] = torch.exp(0.2 * lv[1])
    per = [t_fcos.fcos_image_loss([[t[i] for t in lv] for lv in tp], torch.tensor(gt[i]), 3)
           for i in range(2)]
    assert float(t_fcos.fcos_loss(tp, torch.tensor(gt), 3)) == pytest.approx(
        float(sum(per) / 2), rel=1e-6)
    heads = [torch.tensor(rng.normal(0, 1.5, (2, 3 * (NUM_CLASSES + 5), s, s)).astype(
        np.float32)) for s in (14, 28, 56)]
    gts = torch.tensor(gt_batch(rng, 448.0, 2, 20))
    priors = priors_per_head(V3_PRIORS, False)
    per = [t_yolo.yolov3_image_loss([h[i] for h in heads], priors, gts[i], NUM_CLASSES,
                                    (1.0, 1.0, 5.0, 1.0)) for i in range(2)]
    assert float(t_yolo.yolov3_loss(heads, priors, gts, NUM_CLASSES,
                                    (1.0, 1.0, 5.0, 1.0))) == pytest.approx(
        float(0.25 * sum(per)), rel=1e-6)


# ------------------------------------------------------------ LHRCNNTrunk
def test_lhrcnn_trunk_matches_the_ports_net():
    """tpudet's ``LHRCNNTrunk`` (flat scopes) at 192x320 in eval mode, its
    variables drawn as ``tests/test_torch_lhrcnn.py`` draws ``LHRCNNNet``'s,
    against the port's ``LHRCNNNet`` loaded through
    ``transfer.lhrcnn_trunk_from_flax``: every trunk entry loads (only the
    RoI head is left), and the three maps agree to that file's tolerance."""
    from test_torch_lhrcnn import HW, NUM_CLASSES as LH_CLASSES, lhrcnn_variables

    variables = lhrcnn_variables(JaxNet(num_classes_total=LH_CLASSES + 1),
                                 np.random.default_rng(11), HW)
    flat = {c: {"feature_extractor": tree["feature_extractor"], **tree["rpn"],
                **{k: v for k, v in tree["rcnn"].items() if k.startswith("state5")}}
            for c, tree in variables.items()}
    image = np.random.default_rng(7).uniform(0, 255, (1, *HW, 3)).astype(np.float32)
    x = image / 127.5 - 1.0
    trunk = jax_lh.LHRCNNTrunk()
    want = jax.jit(lambda v, x: trunk.apply(v, x, False))(flat, jnp.asarray(x))
    net = LHRCNNNet(LH_CLASSES + 1).eval()
    missing, unexpected = net.load_state_dict(transfer.lhrcnn_trunk_from_flax(flat),
                                              strict=False)
    assert not unexpected and missing and all(k.startswith("rcnn.head.") for k in missing)
    with torch.no_grad():
        got = net(nchw(x))
        with torch.backends.mkldnn.flags(enabled=False):
            other = net(nchw(x))
    check_outputs(got, want, 1e-4, other)
    with pytest.raises(KeyError, match="no LHRCNNNet scope"):
        transfer.lhrcnn_trunk_from_flax({"params": {"roi_feat_dense": {}}})
