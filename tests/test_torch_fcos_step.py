"""The port's FCOS train step against tpudet's on the same numpy inputs, at
the training script's full width and batch 2: float32 at 128x192 (levels
16x24 ... 1x2) and bfloat16 at 64x96 (8x12 ... 1x1; the port's second
summation order, PyTorch's own bfloat16 convolutions, is slow on the CPU).
Tolerances and their reasons are in ``tests/torch_anchor_free_common.py``.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.heads import fcos as jax_fcos
from tpudet.models.fcos import FCOS as JaxFCOS
from tpudet.runtime import optim as jax_optim
from test_torch_fcos import HW, NUM_CLASSES, batch, config, port_model
from torch_anchor_free_common import check_step, seeded_pair

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return seeded_pair(JaxFCOS, config(mode="test"), HW)


@pytest.mark.parametrize("dtype,hw", [("float32", HW), ("bfloat16", (64, 96))])
def test_fcos_train_step_matches_tpudet(pair, dtype, hw):
    """One Momentum step at lr 0.01, weight decay 1e-4, from the same
    variables and a non-zero velocity, with gts on the levels the input can
    hold and an out-of-range label."""
    jm, variables = pair
    jm = copy.copy(jm)
    jm.net = jax_fcos.FCOSNet(num_classes=NUM_CLASSES, dtype=getattr(jnp, dtype))
    jm._optimizer = jax_optim.Momentum(0.9)
    pm = port_model(variables, compute_dtype=dtype, data_shape=[*hw, 3])
    assert np.isfinite(check_step(jm, pm, variables, *batch(8, hw), 0.01, 1e-4, dtype))
