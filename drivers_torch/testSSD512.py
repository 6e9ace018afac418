"""SSD512 training driver of the port (tpudet's: drivers/testSSD512.py;
reference: testSSD512.py)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from drivers_torch._common import run  # noqa: E402
from tpudet_torch.models import SSD512  # noqa: E402

config = {
    "mode": "train", "data_format": "channels_last", "num_classes": 20,
    "weight_decay": 1e-4, "keep_prob": 0.5, "batch_size": 32,
    "nms_score_threshold": 0.5, "nms_max_boxes": 20, "nms_iou_threshold": 0.5,
    "pretraining_weight": "./vgg_16.ckpt", "compute_dtype": "bfloat16",
}
image_augmentor_config = {
    "data_format": "channels_last", "output_shape": [512, 512],
    "crop_method": "random", "flip_prob": [0.0, 0.5], "fill_mode": "BILINEAR",
    "keep_aspect_ratios": False, "constant_values": 0.0, "color_jitter_prob": 0.5,
    "rotate": [0.5, -5.0, -5.0], "pad_truth_to": 60,
}

if __name__ == "__main__":
    run(SSD512, config, image_augmentor_config, [512, 512, 3], data_dir="./data/",
        num_train=5000, batch_size=32, epochs=160, lr=0.01,
        reduce_lr_epoch=[50, 150], save_path="./ssd512/test")
