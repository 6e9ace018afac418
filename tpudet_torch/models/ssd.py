"""SSD300 / SSD512 (counterpart of ``tpudet/models/ssd.py``).

SSD300's head feature maps are 38/19/10/5/5/3 under SAME padding (8828
anchors); SSD512's are 64/32/16/8/8/4/2.
"""

from __future__ import annotations

import math

from tpudet_torch.heads import ssd as ssd_head
from tpudet_torch.models.base import DetectorBase
from tpudet_torch.runtime import pretrain


def _ssd_feat_shapes(input_size: int, extra_strides):
    """Head feature sizes under SAME padding: conv4_3 at /8, conv7 at /16, then
    the extra stages' strides."""
    s8 = input_size
    for _ in range(3):
        s8 = math.ceil(s8 / 2)
    sizes = [s8, math.ceil(s8 / 2)]
    cur = sizes[-1]
    for s in extra_strides:
        cur = math.ceil(cur / s)
        sizes.append(cur)
    return [(s, s) for s in sizes]


class _SSDFamily(DetectorBase):
    aspect_ratios = None
    extra_widths = None
    extra_strides = None
    scale_pairs = None

    def _build(self):
        self.net = ssd_head.SSDNet(
            num_classes_total=self.num_classes,
            aspect_ratios=self.aspect_ratios,
            extra_widths=self.extra_widths,
            extra_strides=self.extra_strides,
            generator=self.generator,
            dtype=self.compute_dtype,
        )
        feat_shapes = _ssd_feat_shapes(self.input_size, self.extra_strides)
        self.anchors = ssd_head.build_anchors(
            self.input_size, feat_shapes, self.aspect_ratios, self.scale_pairs,
            device=self.device)

    def _load_pretraining(self):
        self.load_pretraining_weight(self.config.get("pretraining_weight"))

    def load_pretraining_weight(self, path):
        pretrain.inject_vgg16(self.net.feature_extractor.vgg, pretrain.load_vgg16(path))

    def _loss_from_outputs(self, outputs, gt, sample_weight=None):
        pconf, pyx, phw = ssd_head.flatten_preds(outputs, self.num_classes)
        return ssd_head.ssd_loss(pconf, pyx, phw, self.anchors, gt, self.num_classes,
                                 neg_sel_cap=int(self.config.get("hard_neg_cap", 384)),
                                 sample_weight=sample_weight)

    def _decode_outputs(self, outputs):
        pconf, pyx, phw = ssd_head.flatten_preds(outputs, self.num_classes)
        return ssd_head.ssd_decode(
            pconf[0], pyx[0], phw[0], self.anchors,
            self.nms_score_threshold, self.nms_iou_threshold, self.nms_max_boxes)


class SSD300(_SSDFamily):
    """SSD-300 on VGG-16: 6 scales, priors from s in [0.2, 0.9]."""

    input_size = 300
    aspect_ratios = ssd_head.SSD_ASPECT_RATIOS
    extra_widths = (512, 256, 256, 256)
    extra_strides = (2, 2, 1, 2)
    scale_pairs = None  # default [0.2..0.9] pairs


def _ssd512_scale_pairs(input_size: float):
    """s = [0.07] + [0.15 .. 0.9] (8 scales, 7 pairs)."""
    s = [0.07 * input_size]
    s += [(0.15 + (0.9 - 0.15) / 5.0 * (i - 1)) * input_size for i in range(1, 8)]
    return [[s[i], (s[i] * s[i + 1]) ** 0.5] for i in range(7)]


class SSD512(_SSDFamily):
    """SSD-512: conv12 extra stage, 7 scales, k = 4,6,6,6,6,4,4."""

    input_size = 512
    aspect_ratios = ([2, 1 / 2], [2, 1 / 2, 3, 1 / 3], [2, 1 / 2, 3, 1 / 3],
                     [2, 1 / 2, 3, 1 / 3], [2, 1 / 2, 3, 1 / 3], [2, 1 / 2], [2, 1 / 2])
    extra_widths = (512, 256, 256, 256, 256)
    extra_strides = (2, 2, 1, 2, 2)
    scale_pairs = _ssd512_scale_pairs(512.0)
