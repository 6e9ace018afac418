"""Helpers of the port's data-parallel step tests (``test_torch_mesh_step.py``,
``test_torch_mesh_feed.py``): tpudet's SSD64 on a mesh cut to R CPU devices,
its weights as the port's state dict, the launch of the port's gloo ranks
and the check of their result.

Tolerances are tpudet's own for its 8-device step against its 1-device step
(``tests/test_distributed.py``): the loss within 2e-4 relative, every
parameter within 5e-4 absolute; the ranks' states are compared bit for bit.
"""

import jax
import numpy as np

import torch_dp_worker as worker
from tpudet.models.ssd import SSD300 as JaxSSD300
from tpudet.runtime import mesh as jax_mesh
from tpudet_torch.runtime import mesh as t_mesh
from tpudet_torch.runtime import transfer

LOSS_RTOL = 2e-4
PARAM_ATOL = 5e-4


class JaxSSD64(JaxSSD300):
    input_size = worker.SSD_SIZE


def tpudet_model(monkeypatch, world, batch, provider, **config):
    """tpudet's SSD64 on a mesh of ``world`` CPU devices, its conf CE in the
    port's ``ac`` layout."""
    real = jax_mesh.data_mesh
    monkeypatch.setattr(jax_mesh, "data_mesh", lambda *a, **k: real(num_devices=world))
    monkeypatch.setenv("TPUDET_SSD_CONF_LAYOUT", "ac")
    return JaxSSD64(worker.ssd_config(batch, **config), provider)


def host_provider(batch):
    images, gt = worker.global_batch(batch)

    def batches():
        while True:
            yield images, gt

    return {"data_shape": [64, 64, 3], "num_train": batch, "num_val": 0,
            "train_generator": (lambda: None, batches()), "val_generator": None}


def weights_of(model):
    """tpudet's variables as the port's state dict."""
    return transfer.from_flax({"params": jax.device_get(model.params),
                               "batch_stats": jax.device_get(model.batch_stats)})


def launch(fn, world, tmp_path, *args, **kw):
    return t_mesh.launch(fn, world, tmp_path, *args, backend="gloo",
                         devices=["cpu"] * world, threads=1, timeout=300, **kw)


def check(ranks, loss, model):
    """The ranks agree bit for bit, and rank 0 is tpudet's step."""
    assert len({r["digest"] for r in ranks}) == 1
    assert len({r["loss"] for r in ranks}) == 1
    np.testing.assert_allclose(ranks[0]["loss"], loss, rtol=LOSS_RTOL)
    want = weights_of(model)
    worst = max(float(np.max(np.abs(ranks[0]["state"][k] - want[k].numpy())))
                for k in want if not k.endswith((".mean", ".var")))
    assert worst < PARAM_ATOL, worst
