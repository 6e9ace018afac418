"""NMS inputs shared by the port's CPU and GPU tests (numpy only, no JAX).

The cases are those of tests/test_pallas_nms.py, plus a scene of tied scores and
a batch with a NaN score in one row (that row selects nothing).
"""

import numpy as np


def corners(rng, shape, lo=0, hi=100, smin=0.5, smax=40):
    yx = rng.uniform(lo, hi, shape + (2,))
    hw = rng.uniform(smin, smax, shape + (2,))
    return np.concatenate([yx - hw / 2, yx + hw / 2], -1).astype(np.float32)


def nms_case(name):
    """The inputs of tests/test_pallas_nms.py, by name:
    (boxes, scores, num_select, max_out, iou_threshold)."""
    if name in ("random0", "random1"):
        rng = np.random.default_rng(int(name[-1]))
        b, n = 3, 200
        boxes = corners(rng, (n,), 0, 100, 5, 40)
        scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
        active = rng.uniform(size=(b, n)) < 0.7
        scores = np.where(active, scores, -1e30).astype(np.float32)
        return boxes, scores, np.asarray([5, 17, 200], np.int32), 32, 0.5
    if name == "per_row_boxes":
        rng = np.random.default_rng(7)
        boxes = corners(rng, (5, 300), 0, 100, 5, 40)
        scores = rng.uniform(0, 1, (5, 300)).astype(np.float32)
        return boxes, scores, np.asarray([0, 3, 40, 300, 17], np.int32), 48, 0.5
    if name == "pretopk":
        rng = np.random.default_rng(11)
        b, n = 4, 1600
        boxes = corners(rng, (n,), 0, 400, 5, 40)
        scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
        active = rng.uniform(size=(b, n)) < 0.5
        scores = np.where(active, scores, -1e30).astype(np.float32)
        return boxes, scores, np.asarray([3, 25, 90, 0], np.int32), 96, 0.5
    if name == "exhaustion":
        rng = np.random.default_rng(13)
        n = 1200
        boxes = np.zeros((n, 4), np.float32)
        boxes[:1100] = [50, 50, 90, 90] + rng.uniform(-0.5, 0.5, (1100, 4)).astype(
            np.float32)
        for k in range(100):
            y, x = divmod(k, 10)
            boxes[1100 + k] = [200 + 50 * y, 200 + 50 * x, 230 + 50 * y, 230 + 50 * x]
        scores = np.zeros((1, n), np.float32)
        scores[0, :1100] = rng.uniform(0.8, 1.0, 1100)
        scores[0, 1100:] = rng.uniform(0.1, 0.2, 100)
        return boxes, scores, np.asarray([60], np.int32), 512, 0.5
    if name == "zero_area":
        boxes = np.zeros((4, 4), np.float32)
        scores = np.asarray([[0.9, 0.8, 0.7, 0.6]], np.float32)
        return boxes, scores, np.asarray([4], np.int32), 4, 0.5
    if name == "ties":
        rng = np.random.default_rng(5)
        boxes = corners(rng, (2, 64), 0, 60, 5, 30)
        scores = np.round(rng.uniform(0, 1, (2, 64)), 1).astype(np.float32)
        return boxes, scores, np.asarray([64, 9], np.int32), 64, 0.3
    if name == "nan_row":
        rng = np.random.default_rng(17)
        boxes = corners(rng, (300,), 0, 100, 5, 40)
        scores = rng.uniform(0, 1, (3, 300)).astype(np.float32)
        scores[1, 123] = np.nan
        scores[2, rng.uniform(size=300) < 0.4] = -1e30  # holes
        return boxes, scores, np.full(3, 50, np.int32), 50, 0.5
    raise KeyError(name)


NAMES = ("random0", "random1", "per_row_boxes", "pretopk", "exhaustion", "zero_area",
         "ties", "nan_row")


def retina_decode_case(anchor_corners, run_out=False, pool=512):
    """RetinaNet's decode shape: 20 classes over its shared anchors (47961 at
    500x500), quota 10, IoU 0.45. With ``run_out``, row 0's top ``pool`` + 8
    candidates are near-copies of one box, so the pre-top-k pool runs out
    after its first pick and the rows rerun at full width."""
    rng = np.random.default_rng(19)
    boxes = np.array(anchor_corners, np.float32)
    n = boxes.shape[0]
    scores = rng.uniform(0, 1, (20, n)).astype(np.float32)
    scores[rng.uniform(size=scores.shape) < 0.3] = -1e30
    if run_out:
        idx = rng.permutation(n)[:pool + 8]
        boxes[idx] = np.asarray([100, 100, 200, 220], np.float32) + np.linspace(
            0, 0.5, pool + 8, dtype=np.float32)[:, None]
        scores[0, idx] = 2.0 + np.linspace(1, 0, pool + 8, dtype=np.float32)
    return boxes, scores, np.full(20, 10, np.int32), 10, 0.45
