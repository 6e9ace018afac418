"""The port's YOLOv3 train step against tpudet's on the same numpy inputs, at
input 64, batch 2 and the training script's full width, in float32 and bfloat16 (a
file of its own: each step jits tpudet's 58M-parameter step). Tolerances and
their reasons are in ``tests/torch_yolo_common.py``.
"""

import pytest
import torch

from tpudet_torch.ops.cuda import assign_kernel, nms_kernel
from torch_yolo_common import check_train_step, tpudet_pair

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return tpudet_pair("v3")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_yolov3_train_step_matches_tpudet(pair, dtype):
    """The train-mode outputs, the loss and the state after one step at the
    training script's lr; no kernel on the step."""
    jm, variables, _ = pair
    launches = (assign_kernel.launches, nms_kernel.launches)
    check_train_step(jm, "v3", variables, dtype, lr=0.001)
    assert (assign_kernel.launches, nms_kernel.launches) == launches
