"""Decode and VOC07 evaluation at a trained net's mAP, against tpudet.

Random weights score mAP 0 at IoU 0.5, so the other evaluation tests never
reach the regime of a trained net: many confident, nearly equal detections
that match the ground truth. Here head outputs are made from ground truth
as a trained net would give them, then go through each package's decode and
``evaluate_detections``:

  * CenterNet (``centernet_decode``): a Gaussian peak of each gt's class at
    its centre cell, offsets and sizes from the gt at the cells around it,
    seeded noise everywhere; every output rounded to bfloat16, as the
    trained nets' heads give them, so that plateaus (two cells that are both
    peaks) and ties between classes and cells occur;
  * RetinaNet's ``ssd_decode``: RetinaNet's anchors at 128x128; each anchor
    whose IoU with a gt passes 0.4 gets that gt's class logit and the gt's
    encoding against it, with noise; the rest lean to the background.

The detections must be identical: the same picks (valid flags and classes
exactly) with their boxes and scores to 1e-6 relative (XLA fuses the box
decode's multiply-add, and its ``exp``, ``sigmoid`` and ``softmax`` may round
an ulp from PyTorch's); and the mAP@0.5 equal, above 0.5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.heads import centernet as j_center
from tpudet.heads import ssd as j_ssd
from tpudet.runtime import evaluate as j_eval
from tpudet_torch.heads import centernet as t_center
from tpudet_torch.heads import retina as t_retina
from tpudet_torch.heads import ssd as t_ssd
from tpudet_torch.ops import boxes as t_boxes
from tpudet_torch.runtime import evaluate as t_eval

NUM_CLASSES = 20
IMAGES = 24
SIZE = 128


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def gt_boxes(rng, n_max=6):
    """1..n_max corner boxes ``[y1, x1, y2, x2, class]`` inside SIZE x SIZE."""
    n = int(rng.integers(1, n_max + 1))
    hw = rng.uniform(14, 80, (n, 2))
    y1x1 = rng.uniform(0, SIZE - hw)
    return np.concatenate([y1x1, y1x1 + hw, rng.integers(0, NUM_CLASSES, (n, 1))],
                          -1).astype(np.float32)


def centernet_heads(rng, gt, stride=4):
    """NHWC ``keypoints [h, w, C]``, ``offset`` and ``size [h, w, 2]`` of a
    trained CenterNet for ``gt``, rounded to bfloat16."""
    h = w = SIZE // stride
    keyp = rng.normal(-5.0, 0.6, (h, w, NUM_CLASSES))
    offset = rng.normal(0.0, 0.15, (h, w, 2))
    size = np.abs(rng.normal(6.0, 3.0, (h, w, 2)))
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    for y1, x1, y2, x2, c in gt:
        cy, cx = (y1 + y2) / 2 / stride, (x1 + x2) / 2 / stride
        bh, bw = (y2 - y1) / stride, (x2 - x1) / stride
        iy, ix = int(cy), int(cx)
        sigma = max(0.6, min(bh, bw) / 6)
        peak = rng.uniform(0.3, 0.97)
        p = peak * np.exp(-((yy - iy) ** 2 + (xx - ix) ** 2) / (2 * sigma ** 2))
        logit = np.log(np.maximum(p, 1e-6) / (1 - p))
        keyp[..., int(c)] = np.maximum(keyp[..., int(c)], logit)
        near = (np.abs(yy - iy) <= 1) & (np.abs(xx - ix) <= 1)
        offset[near] = np.stack([cy - yy[near], cx - xx[near]], -1) + rng.normal(
            0, 0.05, (near.sum(), 2))
        size[near] = np.asarray([bh, bw]) * rng.normal(1, 0.06, (near.sum(), 2))
    return bf16(keyp), bf16(offset), bf16(size)


def _dets(scores, boxes, cids, valid):
    return [(float(s), np.asarray(b, np.float64), int(c))
            for s, b, c, v in zip(scores, boxes, cids, valid) if v]


def _gts(gt):
    return gt[:, [0, 1, 2, 3, 4]]


def check_same(got, want):
    """Valid flags and classes exactly; at the valid slots (the padding's
    contents differ) boxes and scores to 1e-6 relative (boxes 1e-4 px
    absolute near 0)."""
    valid = want[3]
    np.testing.assert_array_equal(got[3], valid)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1][valid], want[1][valid], rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got[0][valid], want[0][valid], rtol=1e-6)


def _evaluate(dets, gts):
    maps = [mod.evaluate_detections(d, gts, NUM_CLASSES, 0.5, True)[0]
            for mod, d in ((j_eval, dets[0]), (t_eval, dets[1]))]
    return maps


def test_centernet_decode_and_evaluation_at_a_trained_map():
    rng = np.random.default_rng(15)
    decode = jax.jit(j_center.centernet_decode, static_argnums=(3, 4))
    dets, gts, plateaus, ties = ([{}, {}]), {}, 0, 0
    for i in range(IMAGES):
        gt = gt_boxes(rng)
        keyp, offset, size = centernet_heads(rng, gt)
        want = [np.asarray(t) for t in decode(jnp.asarray(keyp), jnp.asarray(offset),
                                              jnp.asarray(size), 0.05, 40)]
        got = [t.numpy() for t in t_center.centernet_decode(
            *[torch.from_numpy(a.transpose(2, 0, 1).copy()) for a in (keyp, offset, size)],
            0.05, 40)]
        check_same(got, want)
        best = keyp.max(-1)
        plateaus += int((best[:, 1:] == best[:, :-1]).sum())
        ties += len(want[0][want[3]]) - len(np.unique(want[0][want[3]]))
        dets[0][i], dets[1][i] = _dets(*want), _dets(*got)
        gts[i] = _gts(gt)
    assert plateaus > 0 and ties > 0
    j_map, t_map = _evaluate(dets, gts)
    assert j_map == t_map and t_map > 0.5, (j_map, t_map)


def retina_anchors():
    feats = [(SIZE // s, SIZE // s) for s in (8, 16, 32, 64, 128)]
    anc = t_retina.build_anchors(SIZE, feats)
    return anc, j_ssd.AnchorSet(*[jnp.asarray(t.numpy()) for t in anc])


def retina_heads(rng, gt, anc):
    """``pconf [A, C + 1]``, ``pyx``, ``phw [A, 2]`` of a trained RetinaNet
    for ``gt``, rounded to bfloat16."""
    a = anc.yx.shape[0]
    pconf = rng.normal(0.0, 1.0, (a, NUM_CLASSES + 1))
    pconf[:, -1] += 5.0
    pyx = rng.normal(0, 0.2, (a, 2))
    phw = rng.normal(0, 0.2, (a, 2))
    a_y1x1, a_y2x2 = anc.y1x1.numpy(), anc.y2x2.numpy()
    inter = np.clip(np.minimum(a_y2x2[:, None], gt[None, :, 2:4])
                    - np.maximum(a_y1x1[:, None], gt[None, :, 0:2]), 0, None).prod(-1)
    area = lambda y1x1, y2x2: (y2x2 - y1x1).prod(-1)  # noqa: E731
    iou = inter / (area(a_y1x1, a_y2x2)[:, None] + area(gt[:, 0:2], gt[:, 2:4])[None]
                   - inter)
    best, arg = iou.max(1), iou.argmax(1)
    for j in np.nonzero(best > 0.4)[0]:
        g = gt[arg[j]]
        pconf[j, int(g[4])] = 6.0 + 4.0 * best[j] + rng.normal(0, 0.5)
        g_yx = torch.tensor((g[0:2] + g[2:4]) / 2)[None]
        g_hw = torch.tensor(g[2:4] - g[0:2])[None]
        t_yx, t_hw = t_boxes.encode(g_yx, g_hw, anc.yx[j:j + 1], anc.hw[j:j + 1])
        pyx[j] = t_yx[0].numpy() + rng.normal(0, 0.03, 2)
        phw[j] = t_hw[0].numpy() + rng.normal(0, 0.03, 2)
    return bf16(pconf), bf16(pyx), bf16(phw)


def test_ssd_decode_and_evaluation_at_a_trained_map_on_retinanet_outputs():
    rng = np.random.default_rng(16)
    t_anc, j_anc = retina_anchors()
    decode = jax.jit(j_ssd.ssd_decode, static_argnums=(4, 5, 6, 7))
    dets, gts, reruns = ([{}, {}]), {}, 0
    for i in range(IMAGES):
        gt = gt_boxes(rng)
        pconf, pyx, phw = retina_heads(rng, gt, t_anc)
        pre_topk = 32  # tpudet's retry: doubled until no class row is cut
        while True:
            *want, trunc = decode(jnp.asarray(pconf), jnp.asarray(pyx), jnp.asarray(phw),
                                  j_anc, 0.05, 0.45, 40, pre_topk)
            if not bool(trunc):
                break
            pre_topk *= 2
            reruns += 1
        want = [np.asarray(t) for t in want]
        got = [t.numpy() for t in t_ssd.ssd_decode(
            torch.from_numpy(pconf), torch.from_numpy(pyx), torch.from_numpy(phw), t_anc,
            0.05, 0.45, 40)]
        check_same(got, want)
        dets[0][i], dets[1][i] = _dets(*want), _dets(*got)
        gts[i] = _gts(gt)
    assert reruns > 0
    j_map, t_map = _evaluate(dets, gts)
    assert j_map == t_map and t_map > 0.5, (j_map, t_map)
