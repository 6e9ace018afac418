"""Shared driver plumbing of the port: dataset listing, generator build,
epoch loop (the counterpart of ``drivers/_common.py``).

Each driver file keeps its own config dicts and calls :func:`run` with them.
The drivers import this module as ``drivers_torch._common``, not as
``_common``: tpudet's drivers hold a module of that bare name too, and a
process that loads drivers of both would get whichever was cached first.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpudet_torch.data import pipeline as voc_utils  # noqa: E402


def tfrecords_in(data_dir):
    return [os.path.join(data_dir, name) for name in os.listdir(data_dir)]


def run(model_cls, config, image_augmentor_config, data_shape, data_dir="./voc2007/",
        num_train=5011, batch_size=32, buffer_size=1024, epochs=160, lr=0.01,
        reduce_lr_epoch=(), save_path="./ckpt/model", device=None):
    """tpudet's driver loop; ``device`` goes to the model (None: the card)."""
    train_gen = voc_utils.get_generator(
        tfrecords_in(data_dir), batch_size, buffer_size, image_augmentor_config)
    trainset_provider = {
        "data_shape": data_shape,
        "num_train": num_train,
        "num_val": 0,
        "train_generator": train_gen,
        "val_generator": None,
    }
    model = model_cls(config, trainset_provider, device=device)
    for i in range(epochs):
        print("-" * 25, "epoch", i, "-" * 25)
        if i in reduce_lr_epoch:
            lr = lr / 10.0
            print("reduce lr, lr=", lr, "now")
        mean_loss = model.train_one_epoch(lr)
        print(">> mean loss", mean_loss)
        model.save_weight("latest", save_path)
    return model
