"""The port's data-parallel SSD step from the device-resident feed, over
gloo ranks on the CPU, against tpudet on a mesh of as many CPU devices
(``test_torch_mesh_step.py`` holds the host feed; helpers and tolerances
are ``torch_mesh_common``'s).
"""

import pytest
import torch

import torch_dp_worker as worker
from torch_mesh_common import check, launch, tpudet_model, weights_of
from tpudet.data.device_dataset import DeviceDataset as JaxDeviceDataset

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["scanned", "per-step", "whole"])
def test_resident_epoch_over_ranks_matches_tpudet(monkeypatch, tmp_path, mode):
    """A ``DeviceDataset`` (seed 9) feeding an epoch of 2 steps over 2 ranks,
    against tpudet's epoch on 2 devices from the same feed: distributed
    (each rank draws its device's stream and gathers from its own block),
    scanned or per step; or the whole set on every rank, per step (each
    rank gathers the device batch and keeps its rows)."""
    images, gt = worker.scan_dataset()
    feeder = JaxDeviceDataset(images, gt, batch=worker.SCAN_BATCH, seed=9)
    provider = {"data_shape": [64, 64, 3],
                "num_train": worker.SCAN_ITERS * worker.SCAN_BATCH, "num_val": 0,
                "train_generator": feeder, "val_generator": None}
    model = tpudet_model(monkeypatch, 2, worker.SCAN_BATCH, provider,
                         no_scan_epoch=mode != "scanned")
    weights = weights_of(model)
    if mode != "whole":
        feeder.distribute(model.mesh, model.device_batch)
    loss = model.train_one_epoch(0.01)
    assert ((worker.SCAN_ITERS, True) in model._train_scan_cache) == (mode == "scanned")
    ranks = launch(worker.resident_rank, 2, tmp_path, weights, mode)
    assert all(r["path"] == ("scanned" if mode == "scanned" else "per-step")
               for r in ranks)
    check(ranks, loss, model)
