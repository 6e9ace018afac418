"""FCOS training driver of the port (tpudet's: drivers/testfcos.py;
reference: testfcos.py)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from drivers_torch._common import run  # noqa: E402
from tpudet_torch.models import FCOS  # noqa: E402

config = {
    "mode": "train", "data_shape": [800, 1200, 3], "data_format": "channels_last",
    "num_classes": 20, "weight_decay": 1e-4, "keep_prob": 0.5, "batch_size": 8,
    "nms_score_threshold": 0.5, "nms_max_boxes": 10, "nms_iou_threshold": 0.45,
    "compute_dtype": "bfloat16",
}
image_augmentor_config = {
    "data_format": "channels_last", "output_shape": [800, 1200],
    "flip_prob": [0.0, 0.5], "fill_mode": "BILINEAR", "keep_aspect_ratios": False,
    "pad_truth_to": 60,
}

if __name__ == "__main__":
    run(FCOS, config, image_augmentor_config, [800, 1200, 3],
        batch_size=8, buffer_size=256, epochs=160, lr=0.01,
        save_path="./fcos/test")
