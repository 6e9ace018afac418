"""SSD head: anchors, prediction convs, flatten and decode
(counterpart of ``tpudet/heads/ssd.py``; ``ssd_loss`` comes with the training
slice).

Head outputs are NCHW inside the port; :func:`flatten_preds` permutes them to
NHWC before the reshape, so anchors stay in (row, col, prior) order. Each
prior's channels are ``[conf(C+1), yx(2), hw(2)]``, and background is the LAST
class (index ``C``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from tpudet_torch.nn.backbones.vgg import SSDVGGExtractor
from tpudet_torch.nn.layers import ConvBN, L2NormScale
from tpudet_torch.ops import anchors as anchor_ops
from tpudet_torch.ops import boxes as box_ops
from tpudet_torch.ops import nms


class AnchorSet(NamedTuple):
    y1x1: torch.Tensor  # [A, 2]
    y2x2: torch.Tensor  # [A, 2]
    yx: torch.Tensor    # [A, 2]
    hw: torch.Tensor    # [A, 2]


SSD_ASPECT_RATIOS = ([2, 1 / 2], [2, 1 / 2, 3, 1 / 3], [2, 1 / 2, 3, 1 / 3],
                     [2, 1 / 2, 3, 1 / 3], [2, 1 / 2], [2, 1 / 2])


def build_anchors(input_size: int, feat_shapes: Sequence[Sequence[int]],
                  aspect_ratios: Optional[Sequence[Sequence[float]]] = None,
                  scale_pairs: Optional[Sequence[Sequence[float]]] = None,
                  device: torch.device | str = "cpu") -> AnchorSet:
    """Anchor set over the head feature shapes. SSD300's maps are
    38/19/10/5/5/3 (conv10_2 has stride 1): 8828 anchors."""
    n = len(feat_shapes)
    if aspect_ratios is None:
        aspect_ratios = SSD_ASPECT_RATIOS[:n]
    if scale_pairs is None:
        scale_pairs = anchor_ops.ssd_scale_pairs(float(input_size), n)
    levels = []
    for (fh, fw), pair, ars in zip(feat_shapes, scale_pairs, aspect_ratios):
        priors = anchor_ops.ssd_priors(pair, ars)
        levels.append(anchor_ops.grid_anchors(
            fh, fw, priors, input_size / fh, input_size / fw))
    arrs = anchor_ops.concat_levels(levels)
    return AnchorSet(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                       for a in arrs))


def num_priors_per_level(aspect_ratios: Sequence[Sequence[float]]):
    """k = len(ratios) + 2 (two square priors + one per ratio)."""
    return [len(ars) + 2 for ars in aspect_ratios]


class SSDPredHead(nn.Module):
    """Per-level 3x3 ConvBN emitting ``k*(C+1+4)`` channels (BN on heads)."""

    def __init__(self, in_channels: Sequence[int], num_classes_total: int,
                 priors_per_level: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for i, (c, k) in enumerate(zip(in_channels, priors_per_level)):
            self.add_module(f"pred{i + 1}",
                            ConvBN(c, k * (num_classes_total + 4), 3,
                                   generator=generator))

    def forward(self, feats):
        return [getattr(self, f"pred{i + 1}")(f) for i, f in enumerate(feats)]


def flatten_preds(preds, num_classes_total: int):
    """NCHW ``[B, K*(C+5), H, W]`` per level -> concatenated
    ``(pconf [B, A, C+1], pyx [B, A, 2], phw [B, A, 2])``."""
    confs, yxs, hws = [], [], []
    for p in preds:
        b = p.shape[0]
        p = p.permute(0, 2, 3, 1).reshape(b, -1, num_classes_total + 4)
        confs.append(p[..., :num_classes_total])
        yxs.append(p[..., num_classes_total:num_classes_total + 2])
        hws.append(p[..., num_classes_total + 2:])
    return (torch.cat(confs, 1).float(), torch.cat(yxs, 1).float(),
            torch.cat(hws, 1).float())


def ssd_decode(pconf, pyx, phw, anc: AnchorSet, score_threshold: float,
               iou_threshold: float, max_boxes: int):
    """Single-image decode: softmax, the "argmax is not background" filter, box
    decode and per-class NMS, all on the tensors' device.

    Args are the ``[A, ...]`` flattened head outputs of ONE image. Returns padded
    ``(scores [C*max], boxes [C*max, 4], class_id [C*max], valid [C*max])``, the
    per-class blocks concatenated in class order.
    """
    num_classes_total = pconf.shape[-1]
    c = num_classes_total - 1
    conf = torch.softmax(pconf, dim=-1)
    not_bg = torch.argmax(conf, dim=-1) < c  # background is the last class
    class_scores = conf[:, :c].T             # [C, A]
    byx, bhw = box_ops.decode(pyx, phw, anc.yx, anc.hw)
    y1x1, y2x2 = box_ops.center_to_corners(byx, bhw)
    boxes4 = torch.cat([y1x1, y2x2], -1)
    sel_boxes, sel_scores, sel_valid = nms.per_class_nms(
        boxes4, class_scores, score_threshold, max_boxes, iou_threshold,
        class_active=not_bg)
    class_id = torch.arange(c, dtype=torch.int32, device=pconf.device)
    class_id = class_id[:, None].expand(c, max_boxes)
    return (sel_scores.reshape(-1), sel_boxes.reshape(-1, 4),
            class_id.reshape(-1), sel_valid.reshape(-1))


class SSDNet(nn.Module):
    """VGG extractor + conv4_3 L2-norm + prediction heads; returns the per-level
    NCHW prediction tensors."""

    def __init__(self, num_classes_total: int,
                 aspect_ratios: Sequence[Sequence[float]] = SSD_ASPECT_RATIOS,
                 extra_widths: Sequence[int] = (512, 256, 256, 256),
                 extra_strides: Sequence[int] = (2, 2, 1, 2),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.feature_extractor = SSDVGGExtractor(extra_widths, extra_strides,
                                                 generator)
        self.l2_norm = L2NormScale(init=20.0)
        self.regressor = SSDPredHead(self.feature_extractor.out_channels,
                                     num_classes_total,
                                     num_priors_per_level(aspect_ratios), generator)

    def forward(self, x):
        feats = self.feature_extractor(x)
        feats[0] = self.l2_norm(feats[0])
        return self.regressor(feats)
