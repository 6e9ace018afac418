"""The CUDA kernels (NMS, anchor assignment) against their plain PyTorch
versions, on the card.

Every test here is marked ``cuda`` and skips where no CUDA device exists. The
file imports no JAX, so it runs on a GPU machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from tpudet_torch.heads import retina as t_retina
from tpudet_torch.heads import ssd as t_ssd
from tpudet_torch.models.retinanet import pyramid_shapes
from tpudet_torch.models.ssd import SSD300, _ssd_feat_shapes
from tpudet_torch.ops import matching as t_matching
from tpudet_torch.ops import nms as t_nms
from tpudet_torch.ops.cuda import assign_kernel, nms_kernel
from torch_assign_cases import CASES as ASSIGN_CASES
from torch_assign_cases import assign_case, rand_gt, voc_like_gt
from torch_nms_cases import NAMES as CASES
from torch_nms_cases import nms_case, retina_decode_case


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("pretopk", [False, True])
@pytest.mark.parametrize("path", ["sorted_scan", "per_pick"])
def test_cuda_kernel_equals_plain(cuda_device, monkeypatch, name, pretopk, path):
    """Both designs: ``per_pick`` lowers the sorted scan's width limit to 0."""
    if path == "per_pick":
        monkeypatch.setattr(nms_kernel, "SORTED_SCAN_MAX_WIDTH", 0)
    boxes, scores, ns, max_out, thr = nms_case(name)
    cpu = [torch.from_numpy(a) for a in (boxes, scores, ns)]
    if pretopk:
        want = nms_kernel.batched_greedy_nms_pretopk(*cpu, max_out, thr)
    else:
        want = t_nms.batched_greedy_nms(*cpu, max_out, thr)
    fn = nms_kernel.batched_greedy_nms_pretopk if pretopk else nms_kernel.nms_rows
    taken = path if pretopk else nms_kernel.scan_path(scores.shape[1])
    before = dict(nms_kernel.launches_by_path)
    sel, val = fn(*(t.to(cuda_device) for t in cpu), max_out, thr)
    torch.cuda.synchronize()
    assert nms_kernel.launches_by_path[taken] > before[taken]
    np.testing.assert_array_equal(val.cpu().numpy(), want[1].numpy())
    np.testing.assert_array_equal(sel.cpu().numpy(), want[0].numpy())


@pytest.mark.cuda
def test_cuda_wrapper_rejects_wrong_dtypes(cuda_device):
    boxes = torch.zeros((8, 4), device=cuda_device)
    scores = torch.zeros((2, 8), device=cuda_device)
    with pytest.raises(TypeError):
        nms_kernel.nms_rows(boxes, scores, torch.zeros(2, device=cuda_device), 4, 0.5)
    with pytest.raises(TypeError):
        nms_kernel.nms_rows(boxes.double(), scores,
                            torch.zeros(2, dtype=torch.int32, device=cuda_device), 4, 0.5)


def _retina_anchors():
    """RetinaNet's 47961 anchors at 500x500."""
    return t_retina.build_anchors(500, pyramid_shapes(500, 500, 4))


def _assign_inputs(name):
    if name == "ssd300":
        anc = t_ssd.build_anchors(300, _ssd_feat_shapes(300, SSD300.extra_strides))
        gt, ay1, ay2 = voc_like_gt(0), anc.y1x1.numpy(), anc.y2x2.numpy()
    elif name == "retinanet":  # [32, 60] gts over 47 blocks of anchors an image
        anc = _retina_anchors()
        gt = rand_gt(np.random.default_rng(4), 32, 60, 10, size=500.0, n_valid_min=1)
        ay1, ay2 = anc.y1x1.numpy(), anc.y2x2.numpy()
    else:
        gt, ay1, ay2 = assign_case(name)
    g = t_matching.unpack_gt(torch.from_numpy(gt))
    return [g.y1x1.contiguous(), g.y2x2.contiguous(), g.valid,
            torch.from_numpy(ay1), torch.from_numpy(ay2)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ASSIGN_CASES + ("ssd300", "retinanet"))
def test_assign_kernel_equals_plain(cuda_device, name):
    """Exact: indices and flags equal, best_iou equal bit for bit."""
    cpu = _assign_inputs(name)
    want = t_matching.assign_plain(*cpu)
    before = assign_kernel.launches
    got = assign_kernel.assign_anchors(*(t.to(cuda_device) for t in cpu))
    torch.cuda.synchronize()
    assert assign_kernel.launches == before + 1
    for n, g, w in zip(t_matching.Assignment._fields, got, want):
        g = g.cpu()
        assert g.dtype == w.dtype, n
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), n


@pytest.mark.cuda
def test_assign_kernel_scratch_is_zero_between_calls_of_other_shapes(cuda_device):
    """One launch a call leaves the shared keys and counters at zero, so calls
    of other [B, G] (and the first again) stay equal to the plain version."""
    for name in ("ssd300", "random_shared", "ties", "ssd300"):
        cpu = _assign_inputs(name)
        want = t_matching.assign_plain(*cpu)
        got = assign_kernel.assign_anchors(*(t.to(cuda_device) for t in cpu))
        torch.cuda.synchronize()
        for n, g, w in zip(t_matching.Assignment._fields, got, want):
            g = g.cpu()
            if g.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            assert torch.equal(g, w), (name, n)
        keys, arrivals = assign_kernel.scratch(got.best_iou.device, 1, 1)
        assert not keys.any() and not arrivals.any(), name


@pytest.mark.cuda
def test_assign_wrapper_rejects_wrong_dtypes_and_devices(cuda_device):
    args = [t.to(cuda_device) for t in _assign_inputs("random_shared")]
    with pytest.raises(TypeError):
        assign_kernel.assign_anchors(*args[:2], args[2].int(), *args[3:])
    with pytest.raises(TypeError):
        assign_kernel.assign_anchors(*args[:3], args[3].double(), args[4].double())
    with pytest.raises(ValueError, match="different devices"):
        assign_kernel.assign_anchors(*args[:3], args[3].cpu(), args[4].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("run_out", [False, True])
def test_retina_decode_pool_equals_plain(cuda_device, run_out):
    """RetinaNet's decode shape [20, 47961] through the pool: the sorted scan on
    the pool; with ``run_out`` row 0 exhausts its pool and the rows rerun at
    full width through the per-pick kernel. Equal to the plain version."""
    anc = _retina_anchors()
    corners = torch.cat([anc.y1x1, anc.y2x2], -1).numpy()
    boxes, scores, ns, max_out, thr = retina_decode_case(corners, run_out)
    cpu = [torch.from_numpy(a) for a in (boxes, scores, ns)]
    want = t_nms.batched_greedy_nms(*cpu, max_out, thr)
    before = dict(nms_kernel.launches_by_path)
    sel, val = nms_kernel.batched_greedy_nms_pretopk(
        *(t.to(cuda_device) for t in cpu), max_out, thr)
    torch.cuda.synchronize()
    used = {k: v - before[k] for k, v in nms_kernel.launches_by_path.items()}
    assert used == {"sorted_scan": 1, "per_pick": 1 if run_out else 0}
    np.testing.assert_array_equal(val.cpu().numpy(), want[1].numpy())
    np.testing.assert_array_equal(sel.cpu().numpy(), want[0].numpy())
    if run_out:
        assert int(want[1][0].sum()) > 1  # row 0 picks beyond its pool


# ------------------------------------------------------------ RefineDet / PFPNet
def _refine_inputs(family, b=4, seed=0):
    """Head tensors and gt at 320x320 (6375 anchors) for ``family``'s anchors."""
    from tpudet_torch.heads import refine as t_refine
    from tpudet_torch.models.refinedet import _pfpnet_feat_shapes, _refine_feat_shapes

    shapes = {"refinedet": _refine_feat_shapes, "pfpnet": _pfpnet_feat_shapes}[family](320)
    anc = t_refine.build_anchors(shapes)
    a = anc.yx.shape[0]
    rng = np.random.default_rng(seed)
    heads = [rng.normal(0, s, (b, a, c)).astype(np.float32)
             for s, c in ((0.5, 2), (0.5, 2), (2, 2), (0.5, 2), (0.5, 2), (2, 21))]
    gt = rand_gt(rng, b, 60, 10, size=320.0, n_valid_min=1)
    return anc, [torch.from_numpy(h) for h in heads], torch.from_numpy(gt)


def _to(anc, dev):
    return type(anc)(*(t.to(dev) for t in anc))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["refinedet", "pfpnet"])
def test_refine_loss_with_kernels_equals_plain(cuda_device, monkeypatch, family):
    """``refine_loss`` on the card: one assignment launch and the mining pool's
    NMS launch, equal exactly to the loss with both plain versions."""
    from tpudet_torch.heads import refine as t_refine

    anc, heads, gt = _refine_inputs(family)
    anc, heads, gt = _to(anc, cuda_device), [h.to(cuda_device) for h in heads], gt.to(
        cuda_device)
    before = (assign_kernel.launches, nms_kernel.launches)
    with_kernels = t_refine.refine_loss(*heads, anc, gt, 21, neg_sel_cap=384)
    torch.cuda.synchronize()
    used = (assign_kernel.launches - before[0], nms_kernel.launches - before[1])
    assert used[0] == 1 and used[1] >= 1
    monkeypatch.setattr(assign_kernel, "assign_anchors", t_matching.assign_plain)
    monkeypatch.setattr(nms_kernel, "nms_rows", nms_kernel.plain_rows)
    with_plain = t_refine.refine_loss(*heads, anc, gt, 21, neg_sel_cap=384)
    assert torch.isfinite(with_kernels) and torch.equal(with_kernels, with_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["refinedet", "pfpnet"])
def test_refine_decode_pool_equals_plain(cuda_device, monkeypatch, family):
    """``refine_decode`` of one image on the card: the decode pool [20, 512] of
    [20, 6375] through the sorted scan, equal to the plain version."""
    from tpudet_torch.heads import refine as t_refine

    anc, heads, _ = _refine_inputs(family, b=1, seed=1)
    anc = _to(anc, cuda_device)
    heads = [h[0].to(cuda_device) for h in heads]
    before = dict(nms_kernel.launches_by_path)
    got = t_refine.refine_decode(*heads, anc, 21, 0.1, 0.45, 20)
    torch.cuda.synchronize()
    assert nms_kernel.launches_by_path["sorted_scan"] == before["sorted_scan"] + 1
    monkeypatch.setattr(nms_kernel, "nms_rows", nms_kernel.plain_rows)
    want = t_refine.refine_decode(*heads, anc, 21, 0.1, 0.45, 20)
    assert int(want[3].sum()) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["ssd", "retinanet", "refinedet"])
def test_out_of_range_class_id_gives_nan_on_the_card(cuda_device, family):
    """A gt class id >= num_classes makes the loss NaN on the card, as in
    tpudet, with no device-side assert: the context stays usable after."""
    from tpudet_torch.heads import refine as t_refine

    anc, heads, gt = _refine_inputs("refinedet", b=2, seed=2)
    gt[0, 0, 4] = 30  # 21 classes with the background
    anc, gt = _to(anc, cuda_device), gt.to(cuda_device)
    heads = [h.to(cuda_device) for h in heads]
    if family == "refinedet":
        loss = t_refine.refine_loss(*heads, anc, gt, 21)
    elif family == "ssd":
        loss = t_ssd.ssd_loss(heads[5], heads[3], heads[4], anc, gt, 21)
    else:
        loss = t_retina.retina_loss(heads[5], heads[3], heads[4], anc, gt, 21, 0.25, 2.0)
    assert torch.isnan(loss)
    x = torch.arange(8.0, device=cuda_device)
    assert float((x * 2).sum()) == 56.0
    torch.cuda.synchronize()


# ------------------------------------------------------------ YOLO / SSD512
V2_PRIORS = [[1.08, 1.19], [3.42, 4.41], [6.63, 11.38], [9.42, 5.11], [16.62, 10.52]]
V3_PRIORS = [[[10.0, 13.0], [16, 30.0], [33.0, 23.0]],
             [[30.0, 61.0], [62.0, 45.0], [59.0, 119.0]],
             [[116.0, 90.0], [156.0, 198.0], [373.0, 326.0]]]


def _yolo_heads(family, b, seed):
    """NCHW head tensors at the training scripts' sizes: YOLOv2 480 (15x15, 5 priors),
    YOLOv3 448 (14/28/56, 3 priors), 20 classes."""
    rng = np.random.default_rng(seed)
    grids, k = ((15,), 5) if family == "v2" else ((14, 28, 56), 3)
    return [torch.from_numpy(rng.normal(0, 1.5, (b, k * 25, s, s)).astype(np.float32))
            for s in grids]


def _yolo_decode(family, heads, consistent=False):
    from tpudet_torch.heads import yolo as t_yolo
    from tpudet_torch.models.yolo import priors_per_head

    if family == "v2":
        return t_yolo.yolov2_decode(heads[0][0], V2_PRIORS, 20, 32.0, 0.5, 0.5, 10,
                                    consistent=consistent)
    return t_yolo.yolov3_decode([h[0] for h in heads], priors_per_head(V3_PRIORS, consistent),
                                20, 0.5, 0.5, 10, consistent=consistent)


@pytest.mark.cuda
@pytest.mark.parametrize("consistent", [False, True])
@pytest.mark.parametrize("family", ["v2", "v3"])
def test_yolo_decode_pool_equals_plain(cuda_device, monkeypatch, family, consistent):
    """One image's decode on the card at the training script's thresholds: the pool
    [20, 512] of [20, 1125] (YOLOv2) or of [20, 12348] (YOLOv3) through the
    sorted scan, one NMS launch, equal to the plain version."""
    heads = [h.to(cuda_device) for h in _yolo_heads(family, 1, 3)]
    before = (nms_kernel.launches, dict(nms_kernel.launches_by_path))
    calls = []
    real = nms_kernel.nms_rows
    monkeypatch.setattr(nms_kernel, "nms_rows",
                        lambda *a: calls.append(tuple(a[1].shape)) or real(*a))
    got = _yolo_decode(family, heads, consistent)
    torch.cuda.synchronize()
    assert calls == [(20, 1125 if family == "v2" else 12348)]
    assert nms_kernel.launches == before[0] + 1
    assert nms_kernel.launches_by_path["sorted_scan"] == before[1]["sorted_scan"] + 1
    monkeypatch.setattr(nms_kernel, "nms_rows", nms_kernel.plain_rows)
    want = _yolo_decode(family, heads, consistent)
    assert int(want[3].sum()) > 20
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("label", [-1, 20, 25])
@pytest.mark.parametrize("family", ["v2", "v3"])
def test_yolo_out_of_range_label_gives_a_finite_loss_on_the_card(cuda_device, family,
                                                                 label):
    """A valid gt whose class id is outside [0, 20) adds a zero one-hot row: the
    loss is finite and equal to the CPU's, nothing asserts on the card, and
    the context stays usable after."""
    from tpudet_torch.heads import yolo as t_yolo
    from tpudet_torch.models.yolo import priors_per_head

    size = 480.0 if family == "v2" else 448.0
    heads = _yolo_heads(family, 2, 4)
    gt = torch.from_numpy(rand_gt(np.random.default_rng(5), 2, 60, 10, size=size,
                                  n_valid_min=2))
    gt[0, 0, 4] = label

    def loss(hs, g):
        if family == "v2":
            return t_yolo.yolov2_loss(hs[0], V2_PRIORS, g, 20, 32.0, (1.0, 1.0, 5.0, 1.0))
        return t_yolo.yolov3_loss(hs, priors_per_head(V3_PRIORS), g, 20,
                                  (1.0, 1.0, 5.0, 1.0))

    on_card = loss([h.to(cuda_device) for h in heads], gt.to(cuda_device))
    assert torch.isfinite(on_card)
    np.testing.assert_allclose(float(on_card), float(loss(heads, gt)), rtol=1e-5)
    x = torch.arange(8.0, device=cuda_device)
    assert float((x * 2).sum()) == 56.0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_ssd512_loss_with_kernels_equals_plain(cuda_device, monkeypatch):
    """``ssd_loss`` over SSD512's 24,912 anchors at batch 4 on the card: one
    assignment launch and the mining pool [4, 768] of [4, 24912], equal
    exactly to the loss with both plain versions."""
    from tpudet_torch.models.ssd import SSD512

    shapes = _ssd_feat_shapes(512, SSD512.extra_strides)
    anc = t_ssd.build_anchors(512, shapes, SSD512.aspect_ratios, SSD512.scale_pairs,
                              device=cuda_device)
    rng = np.random.default_rng(6)
    heads = [torch.from_numpy(rng.normal(0, s, (4, 24912, c)).astype(np.float32))
             .to(cuda_device) for s, c in ((2.0, 21), (0.5, 2), (0.5, 2))]
    gt = torch.from_numpy(rand_gt(rng, 4, 60, 10, size=512.0, n_valid_min=1)).to(
        cuda_device)
    before = (assign_kernel.launches, nms_kernel.launches)
    with_kernels = t_ssd.ssd_loss(*heads, anc, gt, 21, neg_sel_cap=384)
    torch.cuda.synchronize()
    assert (assign_kernel.launches - before[0], nms_kernel.launches - before[1] >= 1) == (
        1, True)
    monkeypatch.setattr(assign_kernel, "assign_anchors", t_matching.assign_plain)
    monkeypatch.setattr(nms_kernel, "nms_rows", nms_kernel.plain_rows)
    with_plain = t_ssd.ssd_loss(*heads, anc, gt, 21, neg_sel_cap=384)
    assert torch.isfinite(with_kernels) and torch.equal(with_kernels, with_plain)


def _fcos_heads(seed):
    """One image's FCOS level outputs at 800x1200 (100x150 ... 7x10), NCHW:
    logits, positive distances, centerness logits."""
    rng = np.random.default_rng(seed)
    shapes = [(-(-800 // s), -(-1200 // s)) for s in (8, 16, 32, 64, 128)]
    return [tuple(torch.from_numpy(a.astype(np.float32)) for a in (
        rng.normal(-1.0, 1.5, (20, h, w)), np.exp(rng.normal(1.0, 1.0, (4, h, w))),
        rng.normal(0.0, 1.5, (1, h, w)))) for h, w in shapes]


@pytest.mark.cuda
def test_fcos_decode_pool_equals_plain(cuda_device, monkeypatch):
    """One FCOS image's decode on the card: 19 classes (Q9) over 20,017
    locations, one NMS launch (the sorted scan on the pool [19, 512]), equal
    to the plain version."""
    from tpudet_torch.heads import fcos as t_fcos

    heads = [tuple(t.to(cuda_device) for t in lvl) for lvl in _fcos_heads(3)]
    before = (nms_kernel.launches, dict(nms_kernel.launches_by_path))
    calls = []
    real = nms_kernel.nms_rows
    monkeypatch.setattr(nms_kernel, "nms_rows",
                        lambda *a: calls.append(tuple(a[1].shape)) or real(*a))
    got = t_fcos.fcos_decode(heads, 20, 0.55, 0.45, 10)
    torch.cuda.synchronize()
    assert calls == [(19, 20017)]
    assert nms_kernel.launches == before[0] + 1
    assert nms_kernel.launches_by_path["sorted_scan"] == before[1]["sorted_scan"] + 1
    monkeypatch.setattr(nms_kernel, "nms_rows", nms_kernel.plain_rows)
    want = t_fcos.fcos_decode(heads, 20, 0.55, 0.45, 10)
    assert int(want[3].sum()) > 20
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("label", [-1, 20, -21])
def test_centernet_out_of_range_label_gives_a_finite_loss_on_the_card(cuda_device, label):
    """A valid gt labelled outside [0, 20): tpudet wraps -1 to 19 and drops
    20 and -21 at the center cells; nothing asserts on the card, the loss is
    finite and equal to the CPU's, and the context stays usable after."""
    from tpudet_torch.heads import centernet as t_center

    rng = np.random.default_rng(4)
    heads = [torch.from_numpy(rng.normal(m, s, (2, c, 96, 96)).astype(np.float32))
             for m, s, c in ((-2.0, 1.5, 20), (0.5, 0.3, 2), (3.0, 2.0, 2))]
    gt = torch.from_numpy(rand_gt(np.random.default_rng(5), 2, 60, 10, size=384.0,
                                  n_valid_min=2))
    gt[0, 0, 4] = label
    on_card = t_center.centernet_loss(*[h.to(cuda_device) for h in heads],
                                      gt.to(cuda_device), 20)
    assert torch.isfinite(on_card)
    np.testing.assert_allclose(float(on_card), float(t_center.centernet_loss(*heads, gt, 20)),
                               rtol=1e-5)
    x = torch.arange(8.0, device=cuda_device)
    assert float((x * 2).sum()) == 56.0
    torch.cuda.synchronize()


def _lhrcnn_rows(device, b=4, hw=(448, 704)):
    """LH-RCNN's sampling NMS inputs at 448x704 (a 14x22 grid, 2265 kept
    anchors): seeded RPN outputs and 1-10 gts an image (image 0 none)."""
    from tpudet_torch.heads import lhrcnn as t_lh

    anc, keep = t_lh.build_anchors(-(-hw[0] // 32), -(-hw[1] // 32), 32.0, *hw,
                                   device=device)
    a = int(keep.sum())
    rng = np.random.default_rng(8)
    pconf = torch.from_numpy((2.0 * rng.normal(size=(b, a, 2))).astype(np.float32))
    gt = rand_gt(rng, b, 60, 10, size=float(min(hw)), n_valid_min=1)
    gt[0] = -1
    return anc, t_lh.rpn_rows(pconf.to(device), anc, torch.from_numpy(gt).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["positive", "negative"])
def test_lhrcnn_sampling_pools_equal_plain(cuda_device, pool):
    """LH-RCNN's two sampling NMS calls on the card at reduced width, each
    through its 512-wide pool (one sorted scan, with a per-pick rerun where
    a pool runs out) and equal to the plain version: the positives over
    per-row boxes [4, 60 + 2265, 4] with per-row budgets ``chosen_pos``, the
    negatives over the shared anchors with budgets ``256 - chosen_pos``."""
    from tpudet_torch.heads import lhrcnn as t_lh

    anc, rows = _lhrcnn_rows(cuda_device)
    if pool == "positive":
        boxes, active, budget, cap = rows.row_boxes, rows.row_valid, rows.chosen_pos, 128
        assert boxes.dim() == 3
    else:
        boxes = torch.cat([anc.y1x1, anc.y2x2], -1)
        active, budget, cap = rows.neg, rows.chosen_neg, 256
        assert (budget[1:] == 256 - rows.chosen_pos[1:]).all() and budget[0] == 256
    scores = torch.where(active, rows.row_obj_prob if pool == "positive" else rows.neg_ce,
                         t_nms.NEG).contiguous()
    before = dict(nms_kernel.launches_by_path)
    got = nms_kernel.batched_greedy_nms_pretopk(boxes.contiguous(), scores, budget, cap, 0.7)
    torch.cuda.synchronize()
    assert nms_kernel.launches_by_path["sorted_scan"] == before["sorted_scan"] + 1
    want = t_nms.batched_greedy_nms(boxes.cpu(), scores.cpu(), budget.cpu(), cap, 0.7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    sel = t_lh.rpn_select(rows, anc)
    assert torch.equal(sel[0 if pool == "positive" else 2], got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("run_out", [False, True])
def test_lhrcnn_proposal_pool_equals_plain(cuda_device, run_out):
    """The decode's proposal NMS: 500 picks through a 1000-wide pool (a
    16-word mask row) of one row of 2265 proposals, the sorted scan on the
    card == the plain version; with ``run_out`` the top 1008 proposals are
    near-copies of one box, so the pool runs out and the per-pick kernel
    reruns the row at full width."""
    rng = np.random.default_rng(9)
    n = 2265
    yx = rng.uniform(0, 700, (n, 2))
    hw = rng.uniform(8, 300, (n, 2))
    boxes = np.concatenate([yx - hw / 2, yx + hw / 2], -1).astype(np.float32)[None]
    scores = rng.uniform(0, 1, (1, n)).astype(np.float32)
    if run_out:
        idx = rng.permutation(n)[:1008]
        boxes[0, idx] = [100.0, 100.0, 200.0, 220.0] + np.linspace(0, 0.5, 1008)[:, None]
        scores[0, idx] = 3.0 - np.linspace(0, 2, 1008)
    cpu = [torch.from_numpy(boxes), torch.from_numpy(scores),
           torch.tensor([500], dtype=torch.int32)]
    assert nms_kernel.mask_stride(1000) == 16
    before = dict(nms_kernel.launches_by_path)
    got = nms_kernel.batched_greedy_nms_pretopk(*(t.to(cuda_device) for t in cpu), 500, 0.7)
    torch.cuda.synchronize()
    used = {k: v - before[k] for k, v in nms_kernel.launches_by_path.items()}
    assert used == {"sorted_scan": 1, "per_pick": int(run_out)}
    want = t_nms.batched_greedy_nms(*cpu, 500, 0.7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    assert int(want[1].sum()) > (1 if run_out else 400)


@pytest.mark.cuda
@pytest.mark.parametrize("phase,step", [("rpn", 0), ("rcnn", 3)])
def test_lhrcnn_train_step_on_the_card(cuda_device, phase, step):
    """One LHRCNN step per phase at 192x320, batch 2, on the card: exactly
    two NMS launches' worth of calls (the two sampling pools), no
    assignment, a finite loss, and the other phase's parameters and
    velocities unchanged."""
    from tpudet_torch.models import LHRCNN
    from tpudet_torch.models.lhrcnn import RCNN_SCOPES, RPN_SCOPES

    cfg = {"mode": "train", "data_shape": [192, 320, 3], "data_format": "channels_last",
           "num_classes": 4, "weight_decay": 1e-4, "batch_size": 2, "rpn_first_step": 3,
           "rcnn_first_step": 5, "rpn_second_step": 7, "compute_dtype": "bfloat16",
           "seed": 3}
    model = LHRCNN(cfg)
    model.global_step = step
    rng = np.random.default_rng(10)
    images = rng.uniform(0, 255, (2, 192, 320, 3)).astype(np.float32)
    gt = rand_gt(rng, 2, 60, 6, size=192.0, n_valid_min=1)
    gt[..., 4] = np.where(gt[..., 0] >= 0, gt[..., 4] % 4, -1)
    off = RCNN_SCOPES if phase == "rpn" else RPN_SCOPES
    params = dict(model.net.named_parameters())
    keys = [k for k in params if k.split(".", 1)[0] in off]
    before = {k: (params[k].detach().clone(), model.velocity[k].clone()) for k in keys}
    counts = (nms_kernel.launches, dict(nms_kernel.launches_by_path), assign_kernel.launches)
    loss = model.train_step(*model._to_device(images, gt), 0.003)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(loss))
    assert nms_kernel.launches_by_path["sorted_scan"] == counts[1]["sorted_scan"] + 2
    assert nms_kernel.launches - counts[0] == 2 + (
        nms_kernel.launches_by_path["per_pick"] - counts[1]["per_pick"])
    assert assign_kernel.launches == counts[2]
    for k, (p, v) in before.items():
        assert torch.equal(params[k], p) and torch.equal(model.velocity[k], v), k


@pytest.mark.cuda
def test_metrics_trace_and_block_until_ready_on_the_card(cuda_device, tmp_path):
    import os

    from tpudet_torch.runtime import metrics

    x = torch.ones(256, 256, device=cuda_device)
    tree = {"a": x, "b": [torch.zeros(3, device=cuda_device), (x.sum(),)]}
    with metrics.trace(str(tmp_path)) as prof:
        y = x @ x
        assert metrics.block_until_ready({"y": y, "tree": tree})["y"] is y
    (name,) = os.listdir(tmp_path)
    assert name.endswith(".json")
    device_events = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    assert device_events, "the trace must hold the card's kernels"


@pytest.mark.cuda
def test_ssd300_evaluates_the_mini_voc_set_on_the_card(cuda_device):
    """``evaluate_model`` on the card: one decode pool an image, a finite mAP."""
    from pathlib import Path

    from tpudet_torch.data import example_proto, voc
    from tpudet_torch.runtime import evaluate

    mini = Path(__file__).resolve().parent / "torch_data" / "voc_mini"
    records = []
    for xml in sorted((mini / "Annotations").glob("*.xml")):
        feats = voc.xml_to_features(str(xml), str(mini / "JPEGImages"))
        image, _, gt = voc.parse_voc_record(example_proto.encode_example(feats))
        records.append((image, gt))
    model = SSD300({"mode": "test", "data_format": "channels_last", "num_classes": 20,
                    "batch_size": 1, "weight_decay": 5e-4, "nms_score_threshold": 0.01,
                    "nms_max_boxes": 20, "nms_iou_threshold": 0.5, "seed": 0},
                   device=cuda_device)
    before = dict(nms_kernel.launches_by_path)
    mAP, _ = evaluate.evaluate_model(model, records)
    assert nms_kernel.launches_by_path["sorted_scan"] - before["sorted_scan"] == 8
    assert np.isfinite(mAP) and 0.0 <= mAP <= 1.0


# ------------------------------------------------------------ the resident feed
AUGMENT = {"flip_prob": [0.5, 0.5], "color_jitter_prob": 0.5}


def _resident_set(n, hw=64, pad=6, seed=3):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, hw, hw, 3)).astype(np.uint8)
    images[:, 0, 0, 0] = np.arange(n)  # each row's id in its first pixel
    gt = rand_gt(rng, n, pad, 5, size=float(hw), n_valid_min=1)
    return images, gt


@pytest.mark.cuda
def test_device_augment_on_the_card_equals_the_cpu(cuda_device):
    """The same draws: flips and gt exactly, colour within 2e-3 of the CPU's
    (the CPU tests' tolerance against tpudet)."""
    from tpudet_torch.data import device_augment, prng

    images, gt = _resident_set(8)
    x = torch.from_numpy(images).permute(0, 3, 1, 2).float()
    g = torch.from_numpy(gt)
    for step in range(3):
        d = device_augment.draws(prng.fold_in(prng.key(7), step), 8, AUGMENT)
        for cfg, atol in (({"flip_prob": AUGMENT["flip_prob"]}, 0.0), (AUGMENT, 2e-3)):
            card = device_augment.apply_draws(x.to(cuda_device), g.to(cuda_device),
                                              device_augment.to_device(d, cuda_device), cfg)
            cpu = device_augment.apply_draws(x, g, device_augment.to_device(d, "cpu"), cfg)
            assert card[0].is_cuda and card[1].is_cuda
            torch.testing.assert_close(card[1].cpu(), cpu[1], rtol=0, atol=0)
            torch.testing.assert_close(card[0].cpu(), cpu[0], rtol=0, atol=atol)


@pytest.mark.cuda
def test_device_dataset_on_the_card_yields_card_batches(cuda_device):
    from tpudet_torch.data.device_dataset import DeviceDataset

    images, gt = _resident_set(12)
    ds = DeviceDataset(images, gt, batch=4, seed=7)  # device None: the card
    twin = DeviceDataset(images, gt, batch=4, seed=7, device="cpu")
    assert ds.device.type == "cuda" and ds.images.is_cuda
    for _ in range(5):
        bi, bg = next(ds)
        ti, tg = next(twin)
        assert bi.is_cuda and bg.is_cuda and bi.dtype == torch.uint8
        torch.testing.assert_close(bi.cpu(), ti, rtol=0, atol=0)
        torch.testing.assert_close(bg.cpu(), tg, rtol=0, atol=0)
    idx = ds.scan_indices(3)
    assert idx.is_cuda and torch.equal(idx.cpu(), twin.scan_indices(3))


@pytest.mark.cuda
def test_chunked_refresh_lands_on_the_card(cuda_device):
    """24 rows, chunks of 8, 16 resident, a rotation every 2nd pin: each
    pinned chunk on the card holds its slot's rows, and after the
    background refreshes rows of the pool are among them."""
    from tpudet_torch.data.device_dataset import DeviceDataset

    images, gt = _resident_set(24, hw=16)
    per = 16 * 16 * 3
    ds = DeviceDataset(images, gt, batch=4, seed=0, max_bytes=16 * per,
                       chunk_bytes=8 * per, rotate_every=2)
    resident = set(np.concatenate(ds._slot_rows).tolist())
    seen = set()
    for _ in range(8):
        ds.scan_indices(2)
        rows = ds.images[:, 0, 0, 0].cpu().numpy()
        assert ds.images.is_cuda
        np.testing.assert_array_equal(rows, ds.slot_rows)
        torch.testing.assert_close(ds.gt.cpu(), torch.from_numpy(gt[ds.slot_rows]))
        seen.update(rows.tolist())
    ds.close()
    assert any(u["background"] for u in ds.uploads) and seen - resident


@pytest.mark.cuda
def test_ssd300_step_from_a_resident_batch(cuda_device):
    """One bf16 SSD300 step (300x300, batch 2) on a resident batch with the
    device augment: one assignment launch, one mining pool, a finite loss."""
    from tpudet_torch.data.device_dataset import DeviceDataset

    images, gt = _resident_set(4, hw=300, pad=60)
    ds = DeviceDataset(images, gt, batch=2, seed=1)
    model = SSD300({"mode": "train", "data_format": "channels_last", "num_classes": 20,
                    "batch_size": 2, "weight_decay": 1e-4, "nms_score_threshold": 0.5,
                    "nms_max_boxes": 20, "nms_iou_threshold": 0.5,
                    "compute_dtype": "bfloat16", "device_augment": AUGMENT, "seed": 0},
                   {"num_train": 2, "train_generator": ds})
    counts = (assign_kernel.launches, dict(nms_kernel.launches_by_path))
    loss = model.train_step(*model._to_device(*next(ds)), 0.01)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(loss)) and model.global_step == 1
    assert assign_kernel.launches == counts[0] + 1
    assert nms_kernel.launches_by_path["sorted_scan"] == counts[1]["sorted_scan"] + 1
