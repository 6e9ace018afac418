"""YOLOv2 / YOLOv3 (counterpart of ``tpudet/models/yolo.py``).

Config keys beyond the common set: ``data_shape`` (``[h, w, 3]``, or
``[3, h, w]`` for channels_first), ``coord_scale``, ``class_scale``,
``obj_scale``, ``noobj_scale``, ``priors`` (YOLOv2: ``[[h, w], ...]`` in grid
units; YOLOv3: three lists in pixels, divided by strides (8, 16, 32), quirk
Q4), ``num_priors`` (YOLOv3), ``rescore_confidence`` (accepted, unused: quirk
Q13). ``num_classes`` counts no background class.

Opt-ins, off by default as in tpudet: ``consistent_geometry`` (decode inverts
the training encoding, and the no-object mask uses the real anchor boxes)
and ``raw_prediction_conv`` (a plain conv + bias prediction layer).
"""

from __future__ import annotations

from tpudet_torch.heads import yolo as yolo_head
from tpudet_torch.models.base import DetectorBase, data_shape_hw


def priors_per_head(priors, consistent: bool = False):
    """YOLOv3's pixel priors in each head's grid units, heads at strides 32,
    16 and 8. Q4: the three lists are divided by 8, 16 and 32, in order.
    ``consistent``: the large priors go to the stride-32 head, each list
    divided by its own head's stride, so decode inverts training."""
    if consistent:
        head_strides = (32.0, 16.0, 8.0)
        priors = list(reversed(priors))
    else:
        head_strides = (8.0, 16.0, 32.0)  # the divisors (quirk Q4)
    return [[[p[0] / s, p[1] / s] for p in head_priors]
            for head_priors, s in zip(priors, head_strides)]


class _YOLOBase(DetectorBase):
    def __init__(self, config, data_provider=None, device=None):
        self.data_shape_hw = data_shape_hw(config)
        self.consistent = bool(config.get("consistent_geometry", False))
        self.scales = (float(config.get("coord_scale", 1.0)),
                       float(config.get("class_scale", 1.0)),
                       float(config.get("obj_scale", 1.0)),
                       float(config.get("noobj_scale", 1.0)))
        super().__init__(config, data_provider, device)
        # YOLO heads have no background class: num_classes stays raw
        self.num_classes = config["num_classes"]

    def load_pretraining_weight(self, path: str):
        """Restore the ``backone`` scope, parameters and (where the file has
        them) BatchNorm statistics, from tpudet's ``.tpudet`` or the port's
        ``.pt`` (an exact file, a ``path-step`` prefix or a bare prefix)."""
        fname = self._load_scopes(path, ("backone",), with_stats=True)
        print(">> load pretraining weight", fname, "successfully")


class YOLOv2(_YOLOBase):
    """Single-scale grid regression on DarkNet-19."""

    def _build(self):
        cfg = self.config
        self.raw_classes = cfg["num_classes"]
        self.priors_hw = [list(map(float, p)) for p in cfg["priors"]]
        self.downsampling_rate = 32.0
        self.net = yolo_head.YOLOv2Net(
            final_units=(self.raw_classes + 5) * len(self.priors_hw),
            raw_pred=bool(cfg.get("raw_prediction_conv", False)),
            generator=self.generator, dtype=self.compute_dtype)

    def _loss_from_outputs(self, outputs, gt, sample_weight=None):
        return yolo_head.yolov2_loss(outputs, self.priors_hw, gt, self.raw_classes,
                                     self.downsampling_rate, self.scales,
                                     sample_weight=sample_weight,
                                     consistent=self.consistent)

    def _decode_outputs(self, outputs):
        return yolo_head.yolov2_decode(
            outputs[0], self.priors_hw, self.raw_classes, self.downsampling_rate,
            self.nms_score_threshold, self.nms_iou_threshold, self.nms_max_boxes,
            consistent=self.consistent)


class YOLOv3(_YOLOBase):
    """Three-scale DarkNet-53 detector, quirks Q3-Q5 kept."""

    def _build(self):
        cfg = self.config
        self.raw_classes = cfg["num_classes"]
        self.priors_per_head = priors_per_head(cfg["priors"], self.consistent)
        num_priors = int(cfg.get("num_priors", len(cfg["priors"][0])))
        self.net = yolo_head.YOLOv3Net(
            final_units=(self.raw_classes + 5) * num_priors,
            raw_pred=bool(cfg.get("raw_prediction_conv", False)),
            generator=self.generator, dtype=self.compute_dtype)

    def _loss_from_outputs(self, outputs, gt, sample_weight=None):
        return yolo_head.yolov3_loss(outputs, self.priors_per_head, gt, self.raw_classes,
                                     self.scales, sample_weight=sample_weight,
                                     consistent=self.consistent)

    def _decode_outputs(self, outputs):
        return yolo_head.yolov3_decode(
            [o[0] for o in outputs], self.priors_per_head, self.raw_classes,
            self.nms_score_threshold, self.nms_iou_threshold, self.nms_max_boxes,
            consistent=self.consistent)
