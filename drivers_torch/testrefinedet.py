"""RefineDet320 training driver of the port (tpudet's: drivers/testrefinedet.py;
reference: testrefinedet.py)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from drivers_torch._common import run  # noqa: E402
from tpudet_torch.models import RefineDet320  # noqa: E402

config = {
    "mode": "train", "input_size": 320, "data_format": "channels_last",
    "num_classes": 20, "weight_decay": 1e-4, "keep_prob": 0.5, "batch_size": 32,
    "nms_score_threshold": 0.1, "nms_max_boxes": 20, "nms_iou_threshold": 0.45,
    "pretraining_weight": "./vgg_16.ckpt", "compute_dtype": "bfloat16",
}
image_augmentor_config = {
    "data_format": "channels_last", "output_shape": [320, 320],
    "zoom_size": [330, 330], "crop_method": "random", "flip_prob": [0.0, 0.5],
    "fill_mode": "BILINEAR", "keep_aspect_ratios": False, "constant_values": 0.0,
    "color_jitter_prob": 0.5, "pad_truth_to": 60,
}

if __name__ == "__main__":
    run(RefineDet320, config, image_augmentor_config, [320, 320, 3],
        batch_size=32, buffer_size=1024, epochs=300, lr=0.0001,
        save_path="./refinedet/test")
