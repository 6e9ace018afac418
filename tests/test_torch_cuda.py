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
from torch_nms_cases import corners, nms_case, retina_decode_case


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("pretopk", [False, True])
@pytest.mark.parametrize("path", ["pool", "small_pool"])
def test_cuda_kernel_equals_plain(cuda_device, monkeypatch, name, pretopk, path):
    """``small_pool`` cuts every pool to 8 positions and the continuation's
    tile to 16, so most rows run out and continue across several tiles."""
    if path == "small_pool":
        monkeypatch.setattr(nms_kernel, "SORTED_SCAN_MAX_WIDTH", 8)
        monkeypatch.setattr(nms_kernel, "TILE", 16)
    boxes, scores, ns, max_out, thr = nms_case(name)
    cpu = [torch.from_numpy(a) for a in (boxes, scores, ns)]
    want = t_nms.batched_greedy_nms(*cpu, max_out, thr)
    fn = nms_kernel.batched_greedy_nms_pretopk if pretopk else nms_kernel.nms_rows
    kernels = nms_kernel.pool_kernels(scores.shape[1],
                                      nms_kernel.pretopk_pool(max_out) if pretopk else None)
    before = dict(nms_kernel.launches_by_path)
    sel, val = fn(*(t.to(cuda_device) for t in cpu), max_out, thr)
    torch.cuda.synchronize()
    used = {k: v - before[k] for k, v in nms_kernel.launches_by_path.items()}
    assert used == {k: int(k in kernels) for k in used}
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
    with pytest.raises(ValueError, match="order"):  # the card selects its pool itself
        nms_kernel.nms_rows(boxes, scores, torch.zeros(2, dtype=torch.int32,
                                                       device=cuda_device), 4, 0.5,
                            torch.zeros((2, 8), dtype=torch.int32, device=cuda_device))


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
    the pool; with ``run_out`` row 0 exhausts its pool and the continuation
    takes it on (one row continued). Equal to the plain version."""
    anc = _retina_anchors()
    corners = torch.cat([anc.y1x1, anc.y2x2], -1).numpy()
    boxes, scores, ns, max_out, thr = retina_decode_case(corners, run_out)
    cpu = [torch.from_numpy(a) for a in (boxes, scores, ns)]
    want = t_nms.batched_greedy_nms(*cpu, max_out, thr)
    before = dict(nms_kernel.launches_by_path)
    continued = nms_kernel.continued_rows(cuda_device)
    continued.zero_()
    sel, val = nms_kernel.batched_greedy_nms_pretopk(
        *(t.to(cuda_device) for t in cpu), max_out, thr)
    torch.cuda.synchronize()
    used = {k: v - before[k] for k, v in nms_kernel.launches_by_path.items()}
    assert used == {"select": 1, "mask": 1, "scan": 1, "continue": 1}
    assert int(continued) == int(run_out)
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
    assert nms_kernel.launches_by_path["scan"] == before["scan"] + 1
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
    assert nms_kernel.launches_by_path["scan"] == before[1]["scan"] + 1
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
    assert nms_kernel.launches_by_path["scan"] == before[1]["scan"] + 1
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
    through its 512-wide pool (one select, scan and continuation) and equal to the plain version: the positives over
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
    assert nms_kernel.launches_by_path["scan"] == before["scan"] + 1
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
    near-copies of one box, so the pool runs out and the continuation takes
    the row on past it."""
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
    continued = nms_kernel.continued_rows(cuda_device)
    continued.zero_()
    got = nms_kernel.batched_greedy_nms_pretopk(*(t.to(cuda_device) for t in cpu), 500, 0.7)
    torch.cuda.synchronize()
    used = {k: v - before[k] for k, v in nms_kernel.launches_by_path.items()}
    assert used == {"select": 1, "mask": 1, "scan": 1, "continue": 1}
    assert int(continued) == int(run_out)
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
    assert nms_kernel.launches_by_path["scan"] == counts[1]["scan"] + 2
    assert nms_kernel.launches - counts[0] == 2
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
    assert nms_kernel.launches_by_path["scan"] - before["scan"] == 8
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
    assert nms_kernel.launches_by_path["scan"] == counts[1]["scan"] + 1


@pytest.mark.cuda
def test_one_rank_nccl_step_is_the_step_without_a_group(cuda_device, tmp_path):
    """At world size 1 every reduction is the identity and weight decay counts
    once: SSD300 (at 76x76, bf16, batch 4) through a one-rank NCCL group
    equals the same model without a group, bit for bit, over 2 steps: losses,
    parameters, BatchNorm statistics and velocities."""
    from tpudet_torch.runtime import mesh as mesh_lib

    class SSD76(SSD300):
        input_size = 76

    rng = np.random.default_rng(12)
    images = rng.uniform(0, 255, (4, 76, 76, 3)).astype(np.float32)
    gt = rand_gt(rng, 4, 60, 6, size=76.0, n_valid_min=1)
    config = {"mode": "train", "data_format": "channels_last", "num_classes": 20,
              "batch_size": 4, "weight_decay": 1e-4, "nms_score_threshold": 0.5,
              "nms_max_boxes": 20, "nms_iou_threshold": 0.5, "hard_neg_cap": 384,
              "compute_dtype": "bfloat16", "seed": 5}

    def two_steps():
        model = SSD76(config, device=cuda_device)
        losses = [model.train_step(*model._to_device(images, gt), 0.01) for _ in range(2)]
        state = {**model.net.state_dict(), **{f"v/{k}": v for k, v in model.velocity.items()}}
        return model, [float(x) for x in losses], {k: v.cpu() for k, v in state.items()}

    plain, want_losses, want = two_steps()
    assert plain.mesh.group is None
    mesh_lib.initialize("nccl", init_method=f"file://{tmp_path}/store", world_size=1,
                        rank=0, device="cuda:0")
    try:
        model, losses, got = two_steps()
        assert model.mesh.group is not None and model.mesh.world == 1
    finally:
        mesh_lib.shutdown()
    assert losses == want_losses
    assert [k for k in want if not torch.equal(got[k], want[k])] == []


# ------------------------------------------------------------ the pool without a host sync
def _select_case(name):
    """``(scores [B, N] float32, p)`` of the select kernel's main-path shapes
    and edges."""
    rng = np.random.default_rng(31)
    if name == "mining":  # SSD300's mining pool: 768 of 8828
        scores = rng.exponential(1.0, (32, 8828)).astype(np.float32)
        scores[rng.uniform(size=scores.shape) < 0.05] = t_nms.NEG
        return scores, 768
    if name == "retina_decode":  # 512 of RetinaNet's 47961
        scores = rng.uniform(0, 1, (20, 47961)).astype(np.float32)
        scores[rng.uniform(size=scores.shape) < 0.3] = t_nms.NEG
        return scores, 512
    if name == "ties_across_edge":  # one tenth-step value straddles position 768
        return np.round(rng.uniform(0, 1, (4, 6000)), 1).astype(np.float32), 768
    if name == "signed_zeros_nan_inf":
        vals = np.asarray([-0.0, 0.0, np.nan, np.inf, -np.inf, 0.5, -1e30], np.float32)
        return rng.choice(vals, (3, 3000)), 1000
    if name == "dead_rows":  # all dead, and fewer live than the pool
        scores = rng.uniform(0, 1, (3, 2000)).astype(np.float32)
        scores[0] = t_nms.NEG
        scores[1, 100:] = t_nms.NEG
        return scores, 512
    if name == "whole_row":  # p == N: the whole stable order
        return np.round(rng.uniform(0, 1, (5, 300)), 2).astype(np.float32), 300
    if name == "centernet":  # 100 of 96x96 peaks, most of them 0
        scores = rng.uniform(0, 1, (1, 96 * 96)).astype(np.float32)
        scores[rng.uniform(size=scores.shape) < 0.9] = 0.0
        return scores, 100
    if name == "retina_one_row":  # one row of RetinaNet's 47961: a cluster of 8 blocks
        scores = rng.uniform(0, 1, (1, 47961)).astype(np.float32)
        scores[rng.uniform(size=scores.shape) < 0.3] = t_nms.NEG
        return scores, 512
    if name in ("past_shared_memory", "past_shared_memory_one_row"):
        # rows wider than the cluster's shared memory holds: the slices stream
        rows = 20 if name == "past_shared_memory" else 1
        scores = np.round(rng.exponential(1.0, (rows, 400_000)), 3).astype(np.float32)
        scores[rng.uniform(size=scores.shape) < 0.2] = t_nms.NEG
        return scores, 1000
    raise KeyError(name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mining", "retina_decode", "ties_across_edge",
                                  "signed_zeros_nan_inf", "dead_rows", "whole_row",
                                  "centernet", "retina_one_row", "past_shared_memory",
                                  "past_shared_memory_one_row"])
def test_select_kernel_equals_stable_order_head(cuda_device, name):
    scores, p = _select_case(name)
    want = nms_kernel.stable_order(torch.from_numpy(scores))[:, :p]
    before = nms_kernel.launches_by_path["select"]
    got = nms_kernel.select_top(torch.from_numpy(scores).to(cuda_device), p)
    torch.cuda.synchronize()
    assert nms_kernel.launches_by_path["select"] == before + 1
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [1024, 16])
def test_run_out_continues_across_tiles_and_counts_the_row(cuda_device, monkeypatch, tile):
    """The exhaustion scene: its one row uses up its 1024-wide pool and the
    continuation picks on (in 16-wide tiles: ~11 tiles), == plain, one row
    continued; a batch of rows that do not run out continues none."""
    monkeypatch.setattr(nms_kernel, "TILE", tile)
    continued = nms_kernel.continued_rows(cuda_device)
    for name, rows in (("exhaustion", 1), ("pretopk", 0), ("nan_row", 0)):
        boxes, scores, ns, max_out, thr = nms_case(name)
        cpu = [torch.from_numpy(a) for a in (boxes, scores, ns)]
        continued.zero_()
        got = nms_kernel.batched_greedy_nms_pretopk(*(t.to(cuda_device) for t in cpu),
                                                    max_out, thr)
        torch.cuda.synchronize()
        assert int(continued) == rows, name
        want = t_nms.batched_greedy_nms(*cpu, max_out, thr)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


def _long_run_out_case(seed=21):
    """Row 0's top 2600 candidates are near-copies of one box: its 512-wide
    pool (max_out 150) gives one pick and each tile of copies after it none,
    so the tiles grow from the 149 picks owed (160, 320, 640, 1024) before
    the rest of the row fills them; row 1 does not run out."""
    rng = np.random.default_rng(seed)
    n = 12000
    boxes = corners(rng, (n,), 0, 600, 4, 40)
    scores = rng.uniform(0, 1, (2, n)).astype(np.float32)
    idx = rng.permutation(n)[:2600]
    boxes[idx] = np.asarray([100, 100, 200, 220], np.float32) + np.linspace(
        0, 0.5, 2600, dtype=np.float32)[:, None]
    scores[0, idx] = 2.0 + np.linspace(1, 0, 2600, dtype=np.float32)
    return boxes, scores, np.full(2, 150, np.int32), 150, 0.5


@pytest.mark.cuda
def test_run_out_owing_picks_over_several_sized_tiles(cuda_device):
    """The continuation takes row 0 through tiles that grow from the picks
    owed: == plain, one row continued."""
    boxes, scores, ns, max_out, thr = _long_run_out_case()
    cpu = [torch.from_numpy(a) for a in (boxes, scores, ns)]
    continued = nms_kernel.continued_rows(cuda_device)
    continued.zero_()
    got = nms_kernel.batched_greedy_nms_pretopk(*(t.to(cuda_device) for t in cpu),
                                                max_out, thr)
    torch.cuda.synchronize()
    want = t_nms.batched_greedy_nms(*cpu, max_out, thr)
    assert int(continued) == 1 and int(want[1][0].sum()) == 150
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
def test_pool_call_that_continues_a_row_replays_in_a_cuda_graph(cuda_device):
    """A pool call whose row 0 runs out, captured in a CUDA graph and replayed
    on a second draw of the same scene copied into its inputs: == plain, one
    row continued each replay."""
    boxes, scores, ns, max_out, thr = _long_run_out_case()
    other = _long_run_out_case(seed=22)
    static = [torch.from_numpy(a).to(cuda_device) for a in (boxes, scores, ns)]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # warm-up: build, load
        nms_kernel.batched_greedy_nms_pretopk(*static, max_out, thr)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        sel, val = nms_kernel.batched_greedy_nms_pretopk(*static, max_out, thr)
    continued = nms_kernel.continued_rows(cuda_device)
    for case in (other, (boxes, scores, ns, max_out, thr)):
        for dst, src in zip(static, case[:3]):
            dst.copy_(torch.from_numpy(src).to(cuda_device))
        continued.zero_()
        graph.replay()
        torch.cuda.synchronize()
        want = t_nms.batched_greedy_nms(*(torch.from_numpy(a) for a in case[:3]), max_out, thr)
        assert int(continued) == 1
        assert torch.equal(val.cpu(), want[1]) and torch.equal(sel.cpu(), want[0])


def _ssd300_loss_inputs(dev, b=8, seed=12):
    anc = t_ssd.build_anchors(300, _ssd_feat_shapes(300, SSD300.extra_strides), device=dev)
    rng = np.random.default_rng(seed)
    heads = [torch.from_numpy(rng.normal(0, s, (b, 8828, c)).astype(np.float32))
             .to(dev).requires_grad_() for s, c in ((2.0, 21), (0.5, 2), (0.5, 2))]
    gt = torch.from_numpy(rand_gt(rng, b, 60, 10, size=300.0, n_valid_min=1)).to(dev)
    return heads, anc, gt


@pytest.mark.cuda
def test_pool_ssd_loss_rpn_select_and_decode_never_sync_the_host(cuda_device):
    """Under ``torch.cuda.set_sync_debug_mode("error")`` (any synchronising
    call raises): a mining pool call, ``ssd_loss`` forward and backward,
    LH-RCNN's ``rpn_select`` and ``per_class_nms``, each after one warm-up
    call outside the mode."""
    from tpudet_torch.heads import lhrcnn as t_lh

    boxes, scores, ns, max_out, thr = (t.to(cuda_device) if isinstance(t, torch.Tensor)
                                       else t for t in _mining_pool_case())
    heads, anc, gt = _ssd300_loss_inputs(cuda_device)
    lh_anc, rows = _lhrcnn_rows(cuda_device)
    corners = torch.cat([anc.y1x1, anc.y2x2], -1).contiguous()
    class_scores = torch.sigmoid(heads[0][0].detach().T[1:]).contiguous()

    def calls():
        nms_kernel.batched_greedy_nms_pretopk(boxes, scores, ns, max_out, thr)
        loss = t_ssd.ssd_loss(*heads, anc, gt, 21, neg_sel_cap=384)
        torch.autograd.grad(loss, heads)
        t_lh.rpn_select(rows, lh_anc)
        t_nms.per_class_nms(corners, class_scores, 0.01, 200, 0.45)

    calls()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        calls()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _mining_pool_case(b=32, seed=14):
    """SSD300's mining pool inputs on the CPU: [b, 8828] scores over the
    shared anchors, budgets under the cap 384, IoU 0.7."""
    anc = t_ssd.build_anchors(300, _ssd_feat_shapes(300, SSD300.extra_strides))
    rng = np.random.default_rng(seed)
    scores = rng.exponential(1.0, (b, 8828)).astype(np.float32)
    scores[rng.uniform(size=scores.shape) < 0.05] = t_nms.NEG
    ns = rng.integers(0, 400, b).astype(np.int32)
    return (torch.cat([anc.y1x1, anc.y2x2], -1).contiguous(), torch.from_numpy(scores),
            torch.from_numpy(ns), 384, 0.7)


@pytest.mark.cuda
def test_pool_call_replays_in_a_cuda_graph(cuda_device):
    """One mining pool call captured in a CUDA graph, replayed on a second
    set of scores copied into its input: == plain, and the wrapper counts
    the capture once, not the replays."""
    boxes, scores, ns, max_out, thr = _mining_pool_case()
    _, other, _, _, _ = _mining_pool_case(seed=15)
    boxes, ns = boxes.to(cuda_device), ns.to(cuda_device)
    static = scores.to(cuda_device)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # warm-up: build, load, the counter
        nms_kernel.batched_greedy_nms_pretopk(boxes, static, ns, max_out, thr)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = nms_kernel.launches
    with torch.cuda.graph(graph):
        sel, val = nms_kernel.batched_greedy_nms_pretopk(boxes, static, ns, max_out, thr)
    for src in (other, scores):
        static.copy_(src.to(cuda_device))
        graph.replay()
        torch.cuda.synchronize()
        want = t_nms.batched_greedy_nms(boxes.cpu(), src, ns.cpu(), max_out, thr)
        assert torch.equal(val.cpu(), want[1]) and torch.equal(sel.cpu(), want[0])
    assert nms_kernel.launches == before + 1


@pytest.mark.cuda
def test_centernet_top_k_takes_the_select_kernel(cuda_device, monkeypatch):
    """``centernet_decode``'s top 100 of a 96x96 map on the card: one select
    launch, whose picks == the sort's head of the same scores."""
    from tpudet_torch.heads import centernet as t_center

    rng = np.random.default_rng(16)
    heads = [torch.from_numpy(rng.normal(0, s, (c, 96, 96)).astype(np.float32))
             .to(cuda_device) for s, c in ((2.0, 20), (0.3, 2), (3.0, 2))]
    seen = []
    real = nms_kernel.select_top
    monkeypatch.setattr(nms_kernel, "select_top",
                        lambda s, p: seen.append((s, real(s, p))) or seen[-1][1])
    before = nms_kernel.launches_by_path["select"]
    got = t_center.centernet_decode(*heads, 0.1, 100)
    torch.cuda.synchronize()
    assert nms_kernel.launches_by_path["select"] == before + 1 and len(seen) == 1
    flat, top = seen[0]
    assert top.shape == (1, 100)
    assert torch.equal(top.cpu(), nms_kernel.stable_order(flat.cpu())[:, :100])
    assert int((flat == 0).sum()) > 100  # most cells are not peaks: ties at 0
    assert all(bool(torch.isfinite(g).all()) for g in got[:2])


def _class_row(cuda_device, seed=17, n_active=None):
    """One SSD300 decode class row on the card: the 8828 anchors' corners,
    seeded scores (every score over 0.5 active, or the top ``n_active``)."""
    boxes, scores, _, _, _ = _mining_pool_case(b=1, seed=seed)
    scores = torch.sigmoid(scores[0] - 1.0)
    thr = 0.5 if n_active is None else float(torch.sort(scores, descending=True)
                                              .values[n_active - 1])
    return boxes.to(cuda_device), scores.to(cuda_device), (scores >= thr).to(cuda_device)


@pytest.mark.cuda
def test_greedy_nms_runs_the_kernels_with_no_host_sync(cuda_device):
    """``greedy_nms`` of one SSD300 class row (8828 candidates, 200 picks,
    a device budget) on the card: the pool's select, mask, scan and
    continuation launch once each, nothing synchronises, and the picks ==
    the plain loop's on the CPU."""
    boxes, scores, active = _class_row(cuda_device)
    budget = torch.tensor(150, device=cuda_device)
    t_nms.greedy_nms(boxes, scores, 200, 0.45, active, budget)  # build and load
    torch.cuda.synchronize()
    before = dict(nms_kernel.launches_by_path)
    torch.cuda.set_sync_debug_mode("error")
    try:
        sel, valid = t_nms.greedy_nms(boxes, scores, 200, 0.45, active, budget)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    used = {k: v - before[k] for k, v in nms_kernel.launches_by_path.items()}
    assert used == {"select": 1, "mask": 1, "scan": 1, "continue": 1}
    want = t_nms.plain_greedy_nms(boxes.cpu(), scores.cpu(), 200, 0.45, active.cpu(), 150)
    assert torch.equal(sel.cpu(), want[0]) and torch.equal(valid.cpu(), want[1])
    assert int(valid.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("pre_topk,n_active", [(200, None), (200, 150), (1200, None),
                                               (8828, None)])
def test_topk_then_nms_on_the_card_equals_plain(cuda_device, pre_topk, n_active):
    """``topk_then_nms`` of an SSD300 class row on the card with no host
    sync: at ``pre_topk`` 200 the select kernel takes the top 200 and the
    pool's kernels run over them (truncated where more than 200 are active,
    not where 150 are); past the select's width (1200, and all 8828) the
    whole row goes to the pool. Every output == ``plain_topk_then_nms`` on
    the CPU."""
    boxes, scores, active = _class_row(cuda_device, n_active=n_active)
    args = (boxes, scores, active, pre_topk, 100, 0.45)
    t_nms.topk_then_nms(*args)
    torch.cuda.synchronize()
    before = dict(nms_kernel.launches_by_path)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = t_nms.topk_then_nms(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    used = {k: v - before[k] for k, v in nms_kernel.launches_by_path.items()}
    if pre_topk <= nms_kernel.SORTED_SCAN_MAX_WIDTH:  # top k, then its pool
        assert used == {"select": 2, "mask": 1, "scan": 1, "continue": 0}
    else:  # the first candidate, then the whole row's pool
        assert used == {"select": 2, "mask": 1, "scan": 1, "continue": 1}
    want = t_nms.plain_topk_then_nms(*(a.cpu() if isinstance(a, torch.Tensor) else a
                                       for a in args))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert bool(got[3]) == (pre_topk < 8828 and int(active.sum()) > pre_topk)


@pytest.mark.cuda
def test_profile_model_launches_by_design_and_never_syncs(cuda_device, monkeypatch):
    """``scripts/profile_model_torch.py::profile_model`` on SSD300 at 76,
    batch 2, on the card: in every phase the device ran kernels; ``fwd``
    launches neither kernel, ``fwd+loss``, ``grad`` and ``step`` one
    assignment and one mining pool a call; no phase makes a synchronising
    call."""
    import importlib.util
    from pathlib import Path

    import tpudet_torch.models as t_models

    path = Path(__file__).resolve().parents[1] / "scripts" / "profile_model_torch.py"
    spec = importlib.util.spec_from_file_location("_profile_model_torch", path)
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)

    class SSD76(SSD300):
        input_size = 76

    monkeypatch.setattr(t_models, "SSD300", SSD76)
    bench = prof._specs()["SSD300"]
    small = dict(bench, batch=2, shape=(76, 76), config=dict(bench["config"], batch_size=2))
    record = prof.profile_model("SSD300", small, n=2, warmup=1)
    assert list(record["phases"]) == ["fwd", "fwd+loss", "grad", "step"]
    for label, fig in record["phases"].items():
        want = 0 if label == "fwd" else 1
        launches = fig["launches"]
        assert (launches["assign"], launches["nms_rows"], launches["scan"]) == (
            want, want, want), (label, launches)
        assert fig["syncs"] == 0, label
        assert fig["device_ms"] > 0 and fig["kernels"] > 0 and fig["host_ms"] > 0, label
    assert record["device"] != "cpu"
