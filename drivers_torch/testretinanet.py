"""RetinaNet training driver of the port (tpudet's: drivers/testretinanet.py;
reference: testretinanet.py)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from drivers_torch._common import run  # noqa: E402
from tpudet_torch.models import RetinaNet  # noqa: E402

config = {
    "is_bottleneck": True, "residual_block_list": [3, 4, 6, 3],
    "init_conv_filters": 16,
    "mode": "train", "is_pretraining": False, "data_shape": [500, 500, 3],
    "num_classes": 20, "weight_decay": 1e-4, "keep_prob": 0.5,
    "data_format": "channels_last", "batch_size": 32,
    "gamma": 2.0, "alpha": 0.25,
    "nms_score_threshold": 0.8, "nms_max_boxes": 10, "nms_iou_threshold": 0.45,
    "compute_dtype": "bfloat16",
}
image_augmentor_config = {
    "data_format": "channels_last", "output_shape": [500, 500],
    "flip_prob": [0.0, 0.5], "fill_mode": "BILINEAR", "keep_aspect_ratios": False,
    "constant_values": 0.0, "pad_truth_to": 60,
}

if __name__ == "__main__":
    run(RetinaNet, config, image_augmentor_config, [500, 500, 3],
        batch_size=32, buffer_size=1024, epochs=280, lr=0.01,
        reduce_lr_epoch=[120, 250], save_path="./retinanet/test")
