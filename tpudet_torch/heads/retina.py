"""RetinaNet head: anchors, the per-level subnets, flatten and the focal loss
(counterpart of ``tpudet/heads/retina.py``).

Matching, as tpudet's (the SSD machinery with RetinaNet's rules):
  * positives: each valid gt's best anchor, plus the other anchors whose best
    gt IoU is > 0.5;
  * negatives: the other anchors whose best IoU is < 0.4 (the 0.4-0.5 band
    is ignored);
  * confidence loss: the softmax focal term ``-alpha (1-p)^gamma log p`` on
    positives and negatives, summed and divided by the positive count;
  * coordinate loss: smooth-L1 summed over positives, divided the same way;
  * no hard-negative mining, so the loss launches no NMS.
The focal terms use the plain ``[A, C]`` layout (tpudet's ``ac``). Decode is
SSD's (``heads/ssd.py::ssd_decode``).

Anchors: 9 a cell, ratio-major {1, 1/2, 2} x size {2^0, 2^(1/3), 2^(2/3)} on
base sides {32, 64, 128, 256, 512}; the pitch is ``input_h / feat_h`` for
both axes (tpudet's quirk).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from tpudet_torch.heads.ssd import AnchorSet, _gather_anchors
from tpudet_torch.nn.layers import BNActConv
from tpudet_torch.ops import anchors as anchor_ops
from tpudet_torch.ops import boxes as box_ops
from tpudet_torch.ops import losses as loss_ops
from tpudet_torch.ops import matching

ANCHOR_AREAS = (32.0, 64.0, 128.0, 256.0, 512.0)
ASPECT_RATIOS = (1.0, 1.0 / 2.0, 2.0)
SIZE_MULTIPLIERS = (2 ** 0, 2 ** (1 / 3), 2 ** (2 / 3))
NUM_ANCHORS = len(ASPECT_RATIOS) * len(SIZE_MULTIPLIERS)


def build_anchors(input_h: int, feat_shapes: Sequence[Sequence[int]],
                  areas: Sequence[float] = ANCHOR_AREAS,
                  device: torch.device | str = "cpu") -> AnchorSet:
    """Anchors over the pyramid's ``feat_shapes``; 47961 at 500x500."""
    levels = []
    for (fh, fw), area in zip(feat_shapes, areas):
        priors = anchor_ops.retina_priors(area, ASPECT_RATIOS, SIZE_MULTIPLIERS)
        rate = input_h / fh  # the height's pitch for both axes
        levels.append(anchor_ops.grid_anchors(fh, fw, priors, rate, rate))
    arrs = anchor_ops.concat_levels(levels)
    return AnchorSet(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                       for a in arrs))


class RetinaSubnets(nn.Module):
    """Per-level class and box towers of 4 pre-activation convs and a
    prediction conv. The levels do not share weights. The class prediction's
    bias starts at ``-log((1-pi)/pi)``."""

    def __init__(self, num_levels: int, num_classes_total: int, in_ch: int = 256,
                 feature_size: int = 256, pi: float = 0.01,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_levels = num_levels
        bias0 = -math.log((1.0 - pi) / pi)

        def unit(i, o, **kw):
            return BNActConv(i, o, 3, 1, generator=generator, dtype=dtype, **kw)

        for i in range(num_levels):  # flax's creation order
            for j in range(4):
                self.add_module(f"cls{i}_conv{j}",
                                unit(in_ch if j == 0 else feature_size, feature_size))
            self.add_module(f"cls{i}_pred",
                            unit(feature_size, num_classes_total * NUM_ANCHORS,
                                 bias_init_const=bias0))
            for j in range(4):
                self.add_module(f"box{i}_conv{j}",
                                unit(in_ch if j == 0 else feature_size, feature_size))
            self.add_module(f"box{i}_pred", unit(feature_size, 4 * NUM_ANCHORS))

    def forward(self, levels):
        preds = []
        for i, f in enumerate(levels):
            c = f
            for j in range(4):
                c = getattr(self, f"cls{i}_conv{j}")(c)
            r = f
            for j in range(4):
                r = getattr(self, f"box{i}_conv{j}")(r)
            preds.append((getattr(self, f"cls{i}_pred")(c),
                          getattr(self, f"box{i}_pred")(r)))
        return preds


def flatten_preds(preds, num_classes_total: int):
    """``[(predc [B, 9*C, H, W], predr [B, 36, H, W])]`` per level ->
    ``(pconf [B, A, C], pyx [B, A, 2], phw [B, A, 2])`` in float32, anchors in
    (row, col, prior) order: NCHW is permuted to NHWC before the reshape."""
    confs, yxs, hws = [], [], []
    for predc, predr in preds:
        b = predc.shape[0]
        pc = predc.permute(0, 2, 3, 1).reshape(b, -1, num_classes_total)
        pr = predr.permute(0, 2, 3, 1).reshape(b, -1, 4)
        confs.append(pc)
        yxs.append(pr[..., :2])
        hws.append(pr[..., 2:])
    return (torch.cat(confs, 1).float(), torch.cat(yxs, 1).float(),
            torch.cat(hws, 1).float())


def _focal_rowwise(pconf, labels, alpha: float, gamma: float):
    """``-alpha (1-p)^gamma log p`` of each row's ``labels`` class, with ``p``
    clipped to [1e-8, 1]; NaN for a class id out of range, as in tpudet."""
    p = loss_ops.take_last(torch.softmax(pconf, -1), labels)
    p = torch.clamp(p, 1e-8, 1.0)
    return -alpha * torch.pow(1.0 - p, gamma) * torch.log(p)


def _image_terms(pyx, phw, pconf, anc: AnchorSet, g: matching.GtArrays,
                 assign: matching.Assignment, num_classes_total: int,
                 alpha: float, gamma: float):
    """tpudet's per-image focal loss, batched: returns the loss of each image
    ``[B]``."""
    best_anchor, best_agiou, rg, best_set = assign
    ba = best_anchor.long()
    vmask = g.valid.to(torch.float32)
    t_yx, t_hw = box_ops.encode(g.yx, torch.clamp(g.hw, min=1e-8), anc.yx[ba], anc.hw[ba])
    best_coord = (
        torch.sum(loss_ops.smooth_l1(_gather_anchors(pyx, best_anchor) - t_yx), -1)
        + torch.sum(loss_ops.smooth_l1(_gather_anchors(phw, best_anchor) - t_hw), -1))

    other = ~best_set
    pos_f = (other & (best_agiou > 0.5)).to(torch.float32)
    neg_f = (other & (best_agiou < 0.4)).to(torch.float32)

    rg_label, rg_yx, rg_hw = matching.gather_gt_rows(rg, g.label, g.yx, g.hw)
    best_focal = _focal_rowwise(_gather_anchors(pconf, best_anchor), g.label, alpha,
                                gamma)
    po_focal = _focal_rowwise(pconf, rg_label, alpha, gamma)
    bg_label = torch.full(pconf.shape[:-1], num_classes_total - 1, dtype=torch.int64,
                          device=pconf.device)
    bg_focal = _focal_rowwise(pconf, bg_label, alpha, gamma)
    po_t_yx, po_t_hw = box_ops.encode(rg_yx, torch.clamp(rg_hw, min=1e-8),
                                      anc.yx, anc.hw)
    po_coord = (torch.sum(loss_ops.smooth_l1(pyx - po_t_yx), -1)
                + torch.sum(loss_ops.smooth_l1(phw - po_t_hw), -1))

    num_pos = g.count.to(torch.float32) + torch.sum(pos_f, -1)
    denom = torch.clamp(num_pos, min=1e-8)
    conf_loss = (torch.sum(best_focal * vmask, -1) + torch.sum(po_focal * pos_f, -1)
                 + torch.sum(bg_focal * neg_f, -1)) / denom
    coord_loss = (torch.sum(best_coord * vmask, -1)
                  + torch.sum(po_coord * pos_f, -1)) / denom
    return conf_loss + coord_loss


def retina_loss(pconf, pyx, phw, anc: AnchorSet, gt, num_classes_total: int,
                alpha: float, gamma: float, sample_weight=None):
    """Batched focal loss: the mean of the per-image losses.

    Args are the flattened float32 head outputs, the anchors, and ``gt [B, G,
    5]`` padded with -1. The assignment goes through the assignment kernel's
    wrapper (its plain version on CPU tensors). An image with no valid gt
    divides its negatives' focal sum by 1e-8, as in tpudet.
    """
    g = matching.unpack_gt(gt)
    assign = matching.assign_batch(g.y1x1, g.y2x2, g.valid, anc.y1x1, anc.y2x2)
    per_image = _image_terms(pyx, phw, pconf, anc, g, assign, num_classes_total,
                             alpha, gamma)
    return loss_ops.weighted_mean(per_image, sample_weight)
