"""Config validation (a copy of ``tpudet/runtime/config.py``).

``validate(config, model)`` checks the common keys and the per-model extras
early, with readable errors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

_COMMON_REQUIRED = ("mode", "data_format", "num_classes", "batch_size")

_MODEL_REQUIRED = {
    "SSD300": ("weight_decay", "nms_score_threshold", "nms_max_boxes",
               "nms_iou_threshold"),
    "SSD512": ("weight_decay", "nms_score_threshold", "nms_max_boxes",
               "nms_iou_threshold"),
    "YOLOv2": ("data_shape", "coord_scale", "noobj_scale", "obj_scale",
               "class_scale", "priors"),
    "YOLOv3": ("data_shape", "coord_scale", "noobj_scale", "obj_scale",
               "class_scale", "priors", "num_priors"),
    "RetinaNet": ("data_shape", "is_bottleneck", "residual_block_list",
                  "gamma", "alpha"),
    "RefineDet320": ("input_size",),
    "PFPNetR": ("input_size",),
    "CenterNet": ("input_size",),
    "FCOS": ("data_shape",),
    "LHRCNN": ("data_shape", "rpn_first_step", "rcnn_first_step", "rpn_second_step"),
}


@dataclass
class CommonConfig:
    mode: str
    data_format: str
    num_classes: int
    batch_size: int
    weight_decay: float = 0.0
    keep_prob: float = 1.0  # accepted everywhere, dropout never applied
    nms_score_threshold: float = 0.5
    nms_max_boxes: int = 20
    nms_iou_threshold: float = 0.5
    compute_dtype: str = "float32"
    seed: int = 0

    def __post_init__(self):
        if self.mode not in ("train", "test"):
            raise ValueError(f"mode must be 'train' or 'test', got {self.mode!r}")
        if self.data_format not in ("channels_last", "channels_first"):
            raise ValueError(f"bad data_format {self.data_format!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"bad compute_dtype {self.compute_dtype!r}")
        if self.num_classes <= 0 or self.batch_size <= 0:
            raise ValueError("num_classes and batch_size must be positive")


def validate(config: Dict[str, Any], model: Optional[str] = None) -> CommonConfig:
    """Raise early on malformed configs; returns the parsed common subset."""
    missing = [k for k in _COMMON_REQUIRED if k not in config]
    if model is not None:
        missing += [k for k in _MODEL_REQUIRED.get(model, ()) if k not in config]
    if missing:
        raise KeyError(f"config missing required keys for {model or 'common'}: {missing}")
    common_keys = CommonConfig.__dataclass_fields__.keys()
    return CommonConfig(**{k: config[k] for k in common_keys if k in config})
