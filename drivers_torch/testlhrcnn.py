"""Light-Head R-CNN training driver of the port (tpudet's: drivers/testlhrcnn.py;
reference: testlhrcnn.py)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from drivers_torch._common import run  # noqa: E402
from tpudet_torch.models import LHRCNN  # noqa: E402

config = {
    "data_shape": [700, 1100, 3], "mode": "train", "is_pretraining": False,
    "data_format": "channels_last", "num_classes": 20, "weight_decay": 1e-4,
    "keep_prob": 0.5, "batch_size": 32,
    "rpn_first_step": 60000,    # iters 0..rpn_first_step: train rpn only
    "rcnn_first_step": 100000,  # then rcnn only
    "rpn_second_step": 160000,  # then rpn again; afterwards rcnn
    "nms_score_threshold": 0.5, "nms_max_boxes": 20, "nms_iou_threshold": 0.45,
    "post_nms_proposal": 500,
    "compute_dtype": "bfloat16",
}
image_augmentor_config = {
    "data_format": "channels_last", "output_shape": [700, 1100],
    "zoom_size": [720, 1120], "crop_method": "random", "flip_prob": [0.0, 0.5],
    "fill_mode": "BILINEAR", "keep_aspect_ratios": False, "constant_values": 0.0,
    "pad_truth_to": 60,
}

if __name__ == "__main__":
    run(LHRCNN, config, image_augmentor_config, [700, 1100, 3],
        batch_size=32, buffer_size=1024, epochs=1500, lr=0.003,
        save_path="./lhrcnn/test")
