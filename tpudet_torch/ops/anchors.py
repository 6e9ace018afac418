"""Anchor / prior grid generation (counterpart of ``tpudet/ops/anchors.py``).

A numpy copy: the port imports nothing of tpudet. Anchors come out in
(row, col, prior) order, matching the NHWC reshape of the head predictions
(``[H, W, K*(C+4)] -> [H*W*K, C+4]``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def grid_anchors(
    fh: int,
    fw: int,
    priors_hw: Sequence[Sequence[float]],
    cell_px_y: float,
    cell_px_x: float,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Anchors at cell centers ``(i + 0.5) * cell_px`` with the given prior sizes.

    Returns ``(y1x1, y2x2, yx, hw)`` each ``[fh*fw*K, 2]`` float32,
    (row, col, prior)-major.
    """
    priors = np.asarray(priors_hw, np.float32).reshape(1, 1, -1, 2)
    cy = (np.arange(fh, dtype=np.float32) + 0.5) * cell_px_y
    cx = (np.arange(fw, dtype=np.float32) + 0.5) * cell_px_x
    centers = np.stack(np.meshgrid(cy, cx, indexing="ij"), axis=-1)  # [fh, fw, 2]
    centers = centers[:, :, None, :]
    y1x1 = (centers - priors / 2.0).reshape(-1, 2)
    y2x2 = (centers + priors / 2.0).reshape(-1, 2)
    yx = (y1x1 + y2x2) / 2.0
    hw = y2x2 - y1x1
    return y1x1, y2x2, yx, hw


def ssd_scale_pairs(input_size: float, num_levels: int = 6, s_min: float = 0.2,
                    s_max: float = 0.9) -> List[List[float]]:
    """SSD size pairs ``[s_k, sqrt(s_k * s_{k+1})]`` per level, with
    ``s_k = (s_min + (s_max - s_min)/5 * (k-1)) * input_size``."""
    s = [(s_min + (s_max - s_min) / 5.0 * (i - 1)) * input_size
         for i in range(1, num_levels + 2)]
    return [[s[i], float(np.sqrt(s[i] * s[i + 1]))] for i in range(num_levels)]


def ssd_priors(size_pair: Sequence[float],
               aspect_ratios: Sequence[float]) -> List[List[float]]:
    """Per-cell prior ``[h, w]`` list for one SSD level: ``[s0, s0]``, ``[s1, s1]``,
    then ``[s0*sqrt(ar), s0/sqrt(ar)]`` for each aspect ratio."""
    s0, s1 = float(size_pair[0]), float(size_pair[1])
    priors = [[s0, s0], [s1, s1]]
    for ar in aspect_ratios:
        r = float(np.sqrt(ar))
        priors.append([s0 * r, s0 / r])
    return priors


def concat_levels(per_level: Sequence[Tuple[np.ndarray, ...]]):
    """Concatenate per-level ``(y1x1, y2x2, yx, hw)`` tuples along the anchor axis."""
    return tuple(np.concatenate([lvl[i] for lvl in per_level], axis=0)
                 for i in range(4))


def retina_priors(area_size: float, aspect_ratios: Sequence[float],
                  size_multipliers: Sequence[float]) -> List[List[float]]:
    """RetinaNet per-cell priors: for each ratio ``ar`` and size multiplier ``m``
    (ratio-major), a box of side ``area_size*m`` with ``h = side*sqrt(ar)``,
    ``w = side/sqrt(ar)``."""
    priors = []
    for ar in aspect_ratios:
        r = float(np.sqrt(ar))
        for m in size_multipliers:
            side = area_size * m
            priors.append([side * r, side / r])
    return priors
