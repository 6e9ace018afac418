"""ImageNet classification dataset authoring + pipeline (tfrecord_imagenet_utils.py),
used by the RetinaNet backbone-pretraining mode (RetinaNet.py:61-69); counterpart of
``tpudet/data/imagenet.py``.

Record schema kept identical to the reference (tfrecord_imagenet_utils.py:87-94):
  image -> raw JPEG bytes, shape -> int32[3] raw bytes, label -> int64.
"""

from __future__ import annotations

import math
import os
import random
import sys
import warnings
from typing import Dict, List, Sequence

import numpy as np

from tpudet_torch.data import example_proto, tfrecord, voc
from tpudet_torch.data.augment import image_augmentor
from tpudet_torch.data.classes import imagenet_classname_to_ids
from tpudet_torch.data.pipeline import _RecordIndex


def dataset2tfrecord(img_dir: str, output_dir: str, name: str,
                     total_shards: int = 50) -> List[str]:
    if not os.path.exists(output_dir):
        os.makedirs(output_dir)
        print(output_dir, "does not exist, create it done")
    elif os.listdir(output_dir):
        warnings.warn(output_dir + " is not empty!", UserWarning)
    class_to_id = imagenet_classname_to_ids(img_dir)
    imglist = []
    for cls in class_to_id:
        d = os.path.join(img_dir, cls)
        imglist += [os.path.join(d, f) for f in os.listdir(d)]
    random.shuffle(imglist)
    outputfiles = []
    num_per_shard = int(math.ceil(len(imglist) / float(total_shards)))
    for shard_id in range(total_shards):
        outputname = os.path.join(
            output_dir, "%s_%05d-of-%05d.tfrecord" % (name, shard_id + 1, total_shards))
        outputfiles.append(outputname)
        with tfrecord.TFRecordWriter(outputname) as writer:
            lo = shard_id * num_per_shard
            hi = min((shard_id + 1) * num_per_shard, len(imglist))
            for i in range(lo, hi):
                sys.stdout.write("\r>> Converting image %d/%d shard %d/%d" % (
                    i + 1, len(imglist), shard_id + 1, total_shards))
                sys.stdout.flush()
                with open(imglist[i], "rb") as f:
                    data = f.read()
                shape = np.asarray(voc.decode_jpeg(data).shape, np.int32)
                label = class_to_id[os.path.basename(os.path.dirname(imglist[i]))]
                writer.write(example_proto.encode_example({
                    "image": [data],
                    "shape": [shape.tobytes()],
                    "label": [int(label)],
                }))
            sys.stdout.write("\n")
    return outputfiles


def parse_imagenet_record(record: bytes):
    feats = example_proto.decode_example(record)
    shape = np.frombuffer(feats["shape"][0], np.int32)
    label = int(feats["label"][0])
    image = voc.decode_jpeg(feats["image"][0]).astype(np.float32)
    return image, shape, label


class ImageNetLoader:
    """Infinite (images, labels) batches with the shared augmentor (no gt path)."""

    def __init__(self, tfrecords: Sequence[str], batch_size: int, buffer_size: int,
                 image_preprocess_config: Dict, seed: int = 0):
        del buffer_size
        self.index = _RecordIndex(tfrecords)
        self.batch_size = batch_size
        self.aug_config = dict(image_preprocess_config)
        self.rng = np.random.default_rng(seed)
        self._order = None
        self._pos = 0
        self.reset()

    def reset(self):
        self._order = np.arange(len(self.index))
        self.rng.shuffle(self._order)
        self._pos = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._pos + self.batch_size > len(self._order):
            self.reset()
        ids = self._order[self._pos:self._pos + self.batch_size]
        self._pos += self.batch_size
        images, labels = [], []
        for i in ids:
            image, shape, label = parse_imagenet_record(self.index.read(int(i)))
            img = image_augmentor(image=image, input_shape=shape, rng=self.rng,
                                  **self.aug_config)
            images.append(img)
            labels.append(label)
        return np.stack(images), np.asarray(labels, np.int64)


def get_generator(tfrecords, batch_size, buffer_size, image_preprocess_config,
                  **kwargs):
    loader = ImageNetLoader(tfrecords, batch_size, buffer_size,
                            image_preprocess_config, **kwargs)
    return loader.reset, loader
