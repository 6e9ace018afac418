"""RefineDet320 and PFPNet-R (counterpart of ``tpudet/models/refinedet.py``).

Both share the ARM/TCB/ODM cascade head (``heads/refine.py``); PFPNet swaps
the feature extractor for the MSCA parallel pyramid and needs ``input_size``
to be a multiple of 64. Extra config keys beyond the common set:
``input_size`` and ``hard_neg_cap`` (default 384).
"""

from __future__ import annotations

import math

from tpudet_torch.heads import refine as refine_head
from tpudet_torch.models.base import DetectorBase
from tpudet_torch.runtime import pretrain


def _refine_feat_shapes(input_size: int):
    """Strides 8/16/32/64 under SAME padding: conv4_3 at /8, then each
    stride-2 stage halves, rounding up (40/20/10/5 at 320)."""
    s = input_size
    for _ in range(3):
        s = math.ceil(s / 2)
    sizes = [s]
    for _ in range(3):
        sizes.append(math.ceil(sizes[-1] / 2))
    return [(v, v) for v in sizes]


def _pfpnet_feat_shapes(input_size: int):
    """PFPNet's levels halve conv4_3 by integer division."""
    s8 = input_size
    for _ in range(3):
        s8 = math.ceil(s8 / 2)
    return [(s8 // k, s8 // k) for k in (1, 2, 4, 8)]


class _RefineFamily(DetectorBase):
    extractor = "refinedet"

    def __init__(self, config, data_provider=None, device=None):
        self.input_size = int(config["input_size"])
        super().__init__(config, data_provider, device)

    def _build(self):
        self.net = refine_head.RefineNet(self.num_classes, self.extractor,
                                         self.generator, self.compute_dtype)
        shapes = (_refine_feat_shapes if self.extractor == "refinedet"
                  else _pfpnet_feat_shapes)(self.input_size)
        self.anchors = refine_head.build_anchors(shapes, device=self.device)

    def _load_pretraining(self):
        self.load_pretraining_weight(self.config.get("pretraining_weight"))

    def load_pretraining_weight(self, path):
        """VGG-16 from a local ``.npz`` into ``feature_extractor.vgg``."""
        pretrain.inject_vgg16(self.net.feature_extractor.vgg, pretrain.load_vgg16(path))

    def _loss_from_outputs(self, outputs, gt, sample_weight=None):
        flat = refine_head.flatten_preds(*outputs, self.num_classes)
        return refine_head.refine_loss(
            *flat, self.anchors, gt, self.num_classes,
            neg_sel_cap=int(self.config.get("hard_neg_cap", 384)),
            sample_weight=sample_weight)

    def _decode_outputs(self, outputs):
        flat = refine_head.flatten_preds(*outputs, self.num_classes)
        return refine_head.refine_decode(
            *(t[0] for t in flat), self.anchors, self.num_classes,
            self.nms_score_threshold, self.nms_iou_threshold, self.nms_max_boxes)


class RefineDet320(_RefineFamily):
    """RefineDet on VGG-16 (input 320 or 512): 6375 anchors at 320."""

    extractor = "refinedet"


# tpudet keeps both names: the reference's class is RefineDet320 at any size
RefineDet = RefineDet320


class PFPNetR(_RefineFamily):
    """PFPNet-R: VGG-16 to conv4_3 and the MSCA pyramid."""

    extractor = "pfpnet"

    def __init__(self, config, data_provider=None, device=None):
        if int(config["input_size"]) % 64:
            raise ValueError(f"PFPNetR needs an input_size that is a multiple of 64, "
                             f"got {config['input_size']}")
        super().__init__(config, data_provider, device)
