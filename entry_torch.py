"""The port's entry points (the counterpart of ``__graft_entry__.py``).

``entry(device=None)`` returns the flagship model's forward pass, SSD300's
``SSDNet`` (20 classes + background, eval mode, on the card unless the caller
passes ``device="cpu"``), and its example args: one ``[1, 3, 300, 300]``
float32 zero image, NCHW because the port's net runs NCHW.

``dryrun_multichip(n, device=None)`` runs one data-parallel SSD training step
over ``n`` ranks on tiny shapes, then a scanned epoch from a distributed
device-resident dataset, as tpudet's does over an n-device mesh: by default
one rank a card on NCCL, with ``device="cpu"`` on gloo.

``python entry_torch.py`` runs the forward once on the card and prints the
output shapes: the counterpart of tpudet's compile check. ``python
entry_torch.py dryrun [n]`` runs ``dryrun_multichip(n)`` (default: every card).
"""

from __future__ import annotations

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpudet_torch import device as device_lib  # noqa: E402
from tpudet_torch.heads.ssd import SSDNet  # noqa: E402
from tpudet_torch.runtime import mesh as mesh_lib  # noqa: E402


def entry(device=None):
    """SSD300's forward (feature extractor + heads) and example args."""
    dev = device_lib.resolve(device)
    net = SSDNet(num_classes_total=21, generator=torch.Generator().manual_seed(0))
    net = net.to(dev).eval()
    example_args = (torch.zeros((1, 3, 300, 300), dtype=torch.float32, device=dev),)
    return net, example_args


def _ssd_config(num_classes=20, batch_size=1):
    """``__graft_entry__._ssd_config``'s dict."""
    return {"mode": "train", "data_format": "channels_last", "num_classes": num_classes,
            "weight_decay": 1e-4, "keep_prob": 1.0, "batch_size": batch_size,
            "nms_score_threshold": 0.5, "nms_max_boxes": 20, "nms_iou_threshold": 0.5,
            "pretraining_weight": None, "hard_neg_cap": 96}


def _dryrun_rank(rank, n_devices):
    """One rank of ``dryrun_multichip``: its losses and a checksum of its
    parameters after each of the two runs."""
    from tpudet_torch.data.device_dataset import DeviceDataset
    from tpudet_torch.models.ssd import SSD300

    class SSD64(SSD300):
        """The flagship at 64x64: the same layers and sharding, a quick step."""

        input_size = 64

    dev = mesh_lib.local_device()
    rng = np.random.default_rng(0)
    # not divisible by the ranks (tpudet's YOLOv3 batch 12 case): the batch is
    # padded to the mesh and the padding rows are masked out of the loss
    batch = n_devices + max(1, n_devices // 2) if n_devices > 1 else 1
    images = rng.uniform(0, 255, (batch, 64, 64, 3)).astype(np.float32)
    gt = -np.ones((batch, 8, 5), np.float32)
    gt[:, 0] = [32, 32, 20, 24, 1]

    def batches():
        while True:
            yield images, gt

    provider = {"data_shape": [64, 64, 3], "num_train": batch, "num_val": 0,
                "train_generator": (lambda: None, batches()), "val_generator": None}
    model = SSD64(_ssd_config(batch_size=batch), provider, device=dev)
    if model.mesh.shape["data"] != n_devices or model.device_batch % n_devices:
        raise AssertionError(f"{model.mesh}, device batch {model.device_batch}")
    loss = model.train_one_epoch(0.01)

    # the device-resident feed, distributed: each rank holds its block of the
    # set and gathers its rows, the epoch scanned
    n = 4 * n_devices
    images2 = rng.uniform(0, 255, (n, 64, 64, 3)).astype(np.uint8)
    gt2 = -np.ones((n, 8, 5), np.float32)
    gt2[:, 0] = [32, 32, 20, 24, 1]
    feeder = DeviceDataset(images2, gt2, batch=n_devices, seed=3, device=dev)
    provider2 = {"data_shape": [64, 64, 3], "num_train": 2 * n_devices, "num_val": 0,
                 "train_generator": feeder, "val_generator": None}
    model2 = SSD64(_ssd_config(batch_size=n_devices), provider2, device=dev)
    feeder.distribute(model2.mesh, model2.device_batch)
    loss2 = model2.train_one_epoch(0.01)
    if not np.isfinite([loss, loss2]).all() or model2.last_epoch != "scanned":
        raise AssertionError(f"losses {loss}, {loss2}; the {model2.last_epoch} epoch ran")
    return dict(loss=loss, loss2=loss2, batch=batch, device_batch=model.device_batch,
                params=[float(sum(torch.sum(p.detach().double() ** 2) for p in m.net.parameters()))
                        for m in (model, model2)])


def dryrun_multichip(n_devices: int, device=None) -> list:
    """One data-parallel SSD step over ``n_devices`` ranks (a non-divisible
    batch ``n + n // 2``, padded and masked), then a scanned epoch of 2 steps
    from a distributed ``DeviceDataset``. ``device=None``: one card a rank on
    NCCL (raises with fewer cards than ranks); ``"cpu"``: gloo. Returns each
    rank's result; raises unless every rank agrees."""
    dev = device_lib.resolve(device)
    if dev.type == "cuda":
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) runs a rank a card on NCCL; "
                               f"{torch.cuda.device_count()} cards")
        backend, devices = "nccl", [f"cuda:{r}" for r in range(n_devices)]
    else:
        backend, devices = "gloo", ["cpu"] * n_devices
    with tempfile.TemporaryDirectory() as tmp:
        results = mesh_lib.launch(_dryrun_rank, n_devices, tmp, n_devices,
                                  backend=backend, devices=devices)
    first = results[0]
    for r in results[1:]:
        if r != first:
            raise AssertionError(f"the ranks disagree: {results}")
    print(f"dryrun_multichip({n_devices}): one DP step over {n_devices} ranks on {backend} "
          f"(batch {first['batch']} padded to {first['device_batch']}), "
          f"loss={first['loss']:.4f}; distributed-dataset scanned epoch (2 steps), "
          f"loss={first['loss2']:.4f}")
    return results


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "dryrun":
        dryrun_multichip(int(sys.argv[2]) if len(sys.argv) > 2 else torch.cuda.device_count())
    else:
        fn, args = entry()
        with torch.inference_mode():
            outputs = fn(*args)
        torch.cuda.synchronize()
        for i, out in enumerate(outputs):
            print(f"level {i}: {tuple(out.shape)} {out.dtype}")
        print("entry() ran OK on", torch.cuda.get_device_name(0))
