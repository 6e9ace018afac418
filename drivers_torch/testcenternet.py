"""CenterNet training driver of the port (tpudet's: drivers/testcenternet.py;
reference: testcenternet.py)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from drivers_torch._common import run  # noqa: E402
from tpudet_torch.models import CenterNet  # noqa: E402

config = {
    "mode": "train", "input_size": 384, "data_format": "channels_last",
    "num_classes": 20, "weight_decay": 1e-4, "keep_prob": 0.5, "batch_size": 15,
    "score_threshold": 0.1, "top_k_results_output": 100,
    "compute_dtype": "bfloat16",
}
image_augmentor_config = {
    "data_format": "channels_last", "output_shape": [384, 384],
    "zoom_size": [400, 400], "crop_method": "random", "flip_prob": [0.0, 0.5],
    "fill_mode": "BILINEAR", "keep_aspect_ratios": False, "constant_values": 0.0,
    "color_jitter_prob": 0.5, "rotate": [0.5, -5.0, -5.0], "pad_truth_to": 60,
}

if __name__ == "__main__":
    run(CenterNet, config, image_augmentor_config, [384, 384, 3],
        batch_size=15, buffer_size=256, epochs=160, lr=0.001,
        save_path="./centernet/test")
