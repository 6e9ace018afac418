"""SSD300 training driver of the port — tpudet's drivers/testSSD300.py with
the port's model and loader. Edit paths/configs and run."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpudet_torch.data import pipeline as voc_utils  # noqa: E402
from tpudet_torch.models import SSD300  # noqa: E402

lr = 0.01
batch_size = 32
buffer_size = 1024
epochs = 160
reduce_lr_epoch = [50, 150]
ckpt_path = os.path.join(".", "vgg_16.ckpt")

config = {
    "mode": "train",                   # 'train', 'test'
    "data_format": "channels_last",    # 'channels_last' 'channels_first'
    "num_classes": 20,
    "weight_decay": 1e-4,
    "keep_prob": 0.5,                  # accepted, unused (quirk Q17)
    "batch_size": batch_size,
    "nms_score_threshold": 0.5,
    "nms_max_boxes": 20,
    "nms_iou_threshold": 0.5,
    "pretraining_weight": ckpt_path,
    "compute_dtype": "bfloat16",       # tpudet extra: bf16 activations
}

image_augmentor_config = {
    "data_format": "channels_last",
    "output_shape": [300, 300],
    "crop_method": "random",
    "flip_prob": [0.0, 0.5],
    "fill_mode": "BILINEAR",
    "keep_aspect_ratios": False,
    "constant_values": 0.0,
    "color_jitter_prob": 0.5,
    "rotate": [0.5, -5.0, -5.0],
    "pad_truth_to": 60,
}


def main():
    data = [os.path.join("./data/", name) for name in os.listdir("./data/")]
    train_gen = voc_utils.get_generator(data, batch_size, buffer_size,
                                        image_augmentor_config)
    trainset_provider = {
        "data_shape": [300, 300, 3],
        "num_train": 5000,
        "num_val": 0,
        "train_generator": train_gen,
        "val_generator": None,
    }
    ssd300 = SSD300(config, trainset_provider)
    for i in range(epochs):
        print("-" * 25, "epoch", i, "-" * 25)
        global lr
        if i in reduce_lr_epoch:
            lr = lr / 10.0
            print("reduce lr, lr=", lr, "now")
        mean_loss = ssd300.train_one_epoch(lr)
        print(">> mean loss", mean_loss)
        ssd300.save_weight("latest", "./ssd/test")


if __name__ == "__main__":
    main()
