"""Anchor-assignment inputs shared by the port's CPU and GPU tests and by
chip_smoke.py (numpy only, no JAX).

The cases are those of tests/test_assign_kernel.py, drawn with the same
generators in the same order, plus SSD300's training shape. Each case is
``(gt [B, G, 5], a_y1x1, a_y2x2)``: gt rows ``[y, x, h, w, class]`` padded with
-1, anchors ``[A, 2]`` (shared) or ``[B, A, 2]`` (per image), all float32.
"""

import numpy as np

CASES = ("random_shared", "dense60", "no_valid_gt", "ties", "per_image", "zero_area")


def rand_gt(rng, b, g, n_valid_max, size=300.0, n_valid_min=0):
    """``b`` images of 0..n_valid_max boxes (8 px to 70% of the image a side)."""
    gt = -np.ones((b, g, 5), np.float32)
    for i in range(b):
        n = rng.integers(n_valid_min, n_valid_max + 1)
        for k in range(n):
            h = rng.uniform(8, size * 0.7)
            w = rng.uniform(8, size * 0.7)
            gt[i, k] = [rng.uniform(h / 2, size - h / 2),
                        rng.uniform(w / 2, size - w / 2), h, w, rng.integers(0, 20)]
    return gt


def rand_anchors(rng, a, size=300.0):
    yx = rng.uniform(0, size, (a, 2)).astype(np.float32)
    hw = rng.uniform(8, size / 2, (a, 2)).astype(np.float32)
    return yx - hw / 2, yx + hw / 2


def voc_like_gt(seed, b=32, g=60):
    """SSD300's training batch: 1-10 VOC-like boxes an image, padded to 60 rows."""
    return rand_gt(np.random.default_rng(seed), b, g, 10, n_valid_min=1)


def assign_case(name):
    """The inputs of tests/test_assign_kernel.py, by name."""
    if name == "random_shared":
        rng = np.random.default_rng(0)
        gt = rand_gt(rng, 5, 60, 6)
        return (gt, *rand_anchors(rng, 333))  # A not a multiple of 128
    if name == "dense60":
        rng = np.random.default_rng(1)
        gt = rand_gt(rng, 3, 60, 60)
        return (gt, *rand_anchors(rng, 640))
    if name == "no_valid_gt":
        rng = np.random.default_rng(2)
        gt = rand_gt(rng, 4, 24, 4)
        gt[2] = -1.0  # image 2: no object
        return (gt, *rand_anchors(rng, 256))
    if name == "ties":
        # duplicate anchors: a gt's tie goes to the LOWEST anchor index;
        # duplicate gts: an anchor's tie goes to the LOWEST gt index
        gt = -np.ones((1, 8, 5), np.float32)
        gt[0, 0] = [50, 50, 20, 20, 3]
        gt[0, 1] = [50, 50, 20, 20, 5]
        anc = np.tile(np.asarray([[40, 40, 60, 60]], np.float32), (140, 1))
        return gt, anc[:, :2].copy(), anc[:, 2:].copy()
    if name == "per_image":
        rng = np.random.default_rng(3)
        gt = rand_gt(rng, 4, 24, 5)
        boxes = [rand_anchors(rng, 200) for _ in range(4)]
        return gt, np.stack([b[0] for b in boxes]), np.stack([b[1] for b in boxes])
    if name == "zero_area":
        # valid gts whose h, or h and w, are 0
        rng = np.random.default_rng(5)
        gt = rand_gt(rng, 3, 24, 4)
        gt[0, 0] = [120.0, 80.0, 0.0, 40.0, 7.0]
        gt[1, 1] = [10.0, 10.0, 0.0, 0.0, 2.0]
        return (gt, *rand_anchors(rng, 333))
    raise KeyError(name)
