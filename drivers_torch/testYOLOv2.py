"""YOLOv2 training driver of the port (tpudet's: drivers/testYOLOv2.py;
reference: testYOLOv2.py)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from drivers_torch._common import run  # noqa: E402
from tpudet_torch.models import YOLOv2  # noqa: E402

config = {
    "mode": "train", "is_pretraining": False, "data_shape": [480, 480, 3],
    "num_classes": 20, "weight_decay": 1e-4, "keep_prob": 0.5,
    "data_format": "channels_last", "batch_size": 32,
    "coord_scale": 1, "noobj_scale": 1, "obj_scale": 5.0, "class_scale": 1.0,
    "nms_score_threshold": 0.5, "nms_max_boxes": 10, "nms_iou_threshold": 0.5,
    "rescore_confidence": False,
    "priors": [[1.08, 1.19], [3.42, 4.41], [6.63, 11.38], [9.42, 5.11],
               [16.62, 10.52]],
    "compute_dtype": "bfloat16",
}
image_augmentor_config = {
    "data_format": "channels_last", "output_shape": [480, 480],
    "flip_prob": [0.0, 0.5], "fill_mode": "BILINEAR", "keep_aspect_ratios": False,
    "constant_values": 0.0, "pad_truth_to": 60,
}

if __name__ == "__main__":
    run(YOLOv2, config, image_augmentor_config, [480, 480, 3],
        batch_size=32, buffer_size=1024, epochs=280, lr=0.005,
        save_path="./yolov2/test")
