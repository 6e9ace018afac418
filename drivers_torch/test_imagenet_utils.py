"""ImageNet TFRecord conversion driver of the port (tpudet's:
drivers/test_imagenet_utils.py; reference: utils/test_imagenet_utils.py)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpudet_torch.data import imagenet  # noqa: E402

if __name__ == "__main__":
    tfrecords = imagenet.dataset2tfrecord("./ILSVRC2012_img_train/", "./imagenet/",
                                          "train", 50)
    print(tfrecords)
