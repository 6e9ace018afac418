"""FCOS (counterpart of ``tpudet/models/fcos.py``).

Config keys beyond the common set: ``data_shape`` (``[h, w, 3]``, or
``[3, h, w]`` for channels_first; the training script's is 800x1200, not
square) and the opt-in ``consistent_objective`` (the FCOS paper's loss, and
decode over every class: see :mod:`tpudet_torch.heads.fcos`).
``num_classes`` counts no background class. The backbone is the bottleneck
``[3, 4, 6, 3]`` GroupNorm ResNet with stages ``16 * 2^i`` wide, so the net
has no BatchNorm and no running statistics. ``load_pretrained_weight``
(tpudet's spelling) restores the ``backone`` scope.
"""

from __future__ import annotations

from tpudet_torch.heads import fcos as fcos_head
from tpudet_torch.models.base import DetectorBase, data_shape_hw


class FCOS(DetectorBase):
    def __init__(self, config, data_provider=None, device=None):
        self.data_shape_hw = data_shape_hw(config)
        self.consistent = bool(config.get("consistent_objective", False))
        super().__init__(config, data_provider, device)
        self.num_classes = config["num_classes"]  # no background channel

    def _build(self):
        self.raw_classes = self.config["num_classes"]
        self.net = fcos_head.FCOSNet(self.raw_classes, generator=self.generator,
                                     dtype=self.compute_dtype)

    def _loss_from_outputs(self, outputs, gt, sample_weight=None):
        return fcos_head.fcos_loss(outputs, gt, self.raw_classes,
                                   sample_weight=sample_weight, consistent=self.consistent)

    def _decode_outputs(self, outputs):
        return fcos_head.fcos_decode(
            [tuple(t[0] for t in lvl) for lvl in outputs], self.raw_classes,
            self.nms_score_threshold, self.nms_iou_threshold, self.nms_max_boxes,
            emit_all_classes=self.consistent)

    def load_pretrained_weight(self, path: str):
        """Restore the ``backone`` scope's parameters from tpudet's
        ``.tpudet`` or the port's ``.pt`` (an exact file, a ``path-step``
        prefix or a bare prefix)."""
        fname = self._load_scopes(path, ("backone",), with_stats=False)
        print("load pretrained weight", fname, "successfully")
