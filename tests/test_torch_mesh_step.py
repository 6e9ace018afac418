"""The port's data-parallel SSD step over gloo ranks on the CPU against
tpudet's step on a mesh of as many CPU devices: ``tests/test_distributed.py``'s
SSD64 config and batch, from tpudet's initial weights.

tpudet's side runs in this process on ``conftest.py``'s CPU devices, its
mesh cut to R devices; the port's ranks are spawned by ``mesh.launch``
(``torch_dp_worker``, which imports no JAX), each fed its node's whole
batch. Tolerances are ``torch_mesh_common``'s (tpudet's own for its
8-device step); a one-rank group's step is held to the step without a group
bit for bit. tpudet's conf CE runs in its ``ac`` layout
(``TPUDET_SSD_CONF_LAYOUT``), the port's.
"""

import numpy as np
import pytest
import torch

import torch_dp_worker as worker
from torch_mesh_common import check, host_provider, launch, tpudet_model, weights_of

torch.set_num_threads(1)

@pytest.mark.parametrize("world,batch", [(2, 8), (4, 6)])
def test_ssd_step_over_ranks_matches_tpudet(monkeypatch, tmp_path, world, batch):
    """SSD64 at R ranks against tpudet on R devices: batch 8 over 2 ranks,
    and batch 6 over 4 ranks, padded to 8 with two repeated rows masked out
    of the loss (and kept in the BatchNorm statistics)."""
    model = tpudet_model(monkeypatch, world, batch, host_provider(batch))
    assert model.mesh.shape["data"] == world and model.device_batch == 8
    weights = weights_of(model)
    loss = model.train_one_epoch(0.01)
    ranks = launch(worker.ssd_step_rank, world, tmp_path, weights, batch)
    mask = model._sample_weight()
    for r, rank in enumerate(ranks):
        assert rank["device_batch"] == model.device_batch
        assert rank["mesh"] == (("data",), {"data": world}, 1)
        if mask is None:
            assert rank["weight"] is None
        else:
            per = 8 // world
            np.testing.assert_array_equal(rank["weight"],
                                          np.asarray(mask)[r * per:(r + 1) * per])
    check(ranks, loss, model)


def test_two_nodes_match_one(monkeypatch, tmp_path):
    """4 ranks laid out as 2 nodes (a ``('dcn', 'data')`` mesh of 2x2), each
    node's feed yielding its half of the batch, against tpudet's step on 4
    devices of one process."""
    model = tpudet_model(monkeypatch, 4, 8, host_provider(8))
    weights = weights_of(model)
    loss = model.train_one_epoch(0.01)
    halves = [np.arange(4), np.arange(4, 8)]
    ranks = launch(worker.ssd_step_rank, 4, tmp_path, weights, 8, halves, nodes=2)
    assert all(r["mesh"] == (("dcn", "data"), {"dcn": 2, "data": 2}, 2) for r in ranks)
    check(ranks, loss, model)


def test_one_rank_group_is_the_step_without_a_group(tmp_path):
    """At world size 1 every reduction is the identity and weight decay
    counts once: a one-rank gloo group's step equals the step without a
    group bit for bit (state and loss)."""
    weights = worker._ssd64()(worker.ssd_config(4), device="cpu").net.state_dict()
    (ranked,) = launch(worker.ssd_step_rank, 1, tmp_path, weights, 4)
    plain = worker.ssd_step_rank(0, weights, 4)
    assert ranked["digest"] == plain["digest"]
    assert ranked["loss"] == plain["loss"]
