"""VOC TFRecord conversion driver of the port (tpudet's:
drivers/test_voc_utils.py; reference: utils/test_voc_utils.py)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpudet_torch.data import voc  # noqa: E402

if __name__ == "__main__":
    tfrecords = voc.dataset2tfrecord(
        "./VOC2007/Annotations/", "./VOC2007/JPEGImages/", "./data/", "train", 5)
    print(tfrecords)
