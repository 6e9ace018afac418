"""YOLOv3 training driver of the port (tpudet's: drivers/testYOLOv3.py;
reference: testYOLOv3.py)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from drivers_torch._common import run  # noqa: E402
from tpudet_torch.models import YOLOv3  # noqa: E402

config = {
    "mode": "train", "data_shape": [448, 448, 3], "num_classes": 20,
    "weight_decay": 5e-4, "keep_prob": 0.5, "data_format": "channels_last",
    "batch_size": 12,
    "coord_scale": 1, "noobj_scale": 1, "obj_scale": 5.0, "class_scale": 1.0,
    "num_priors": 3,
    "nms_score_threshold": 0.5, "nms_max_boxes": 10, "nms_iou_threshold": 0.5,
    "priors": [[[10.0, 13.0], [16, 30.0], [33.0, 23.0]],
               [[30.0, 61.0], [62.0, 45.0], [59.0, 119.0]],
               [[116.0, 90.0], [156.0, 198.0], [373.0, 326.0]]],
    "compute_dtype": "bfloat16",
}
image_augmentor_config = {
    "data_format": "channels_last", "output_shape": [448, 448],
    "flip_prob": [0.0, 0.5], "fill_mode": "BILINEAR", "keep_aspect_ratios": False,
    "constant_values": 0.0, "pad_truth_to": 60,
}

if __name__ == "__main__":
    run(YOLOv3, config, image_augmentor_config, [448, 448, 3],
        batch_size=12, buffer_size=256, epochs=160, lr=0.001,
        save_path="./yolov3/test")
