"""The port's whole YOLOv2 against tpudet's on the same numpy inputs, at input
64 and the training script's full width: DarkNet-19's levels, the net with and without
``raw_prediction_conv`` and in bfloat16, the train step in float32 and
bfloat16, ``test_one_image`` in both data formats, ``train_one_epoch``, and
tpudet's ``.tpudet`` files. Tolerances and their reasons are in
``tests/torch_yolo_common.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.nn.backbones import darknet as jax_darknet
from tpudet_torch.models import YOLOv2
from tpudet_torch.nn.backbones import darknet as t_darknet
from tpudet_torch.ops.cuda import assign_kernel, nms_kernel
from tpudet_torch.runtime import transfer
from torch_refine_common import PIXEL_MEAN, nchw, nhwc, rel
from torch_yolo_common import (check_eval_forward, check_test_one_image, check_tpudet_file,
                               check_train_step, config, images, port_model, tpudet_pair)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return tpudet_pair("v2")


def test_darknet19_levels_match_flax(pair):
    """Eval mode, float32: conv18 and the conv17 passthrough, both stride 32."""
    _, variables, image = pair
    sub = {c: variables[c]["backone"] for c in variables}
    x = image - PIXEL_MEAN
    want = jax_darknet.DarkNet19().apply(sub, jnp.asarray(x), False)
    net = t_darknet.DarkNet19()
    transfer.load_flax(net, sub)
    with torch.no_grad():
        got = net.eval()(nchw(x))
    assert [tuple(g.shape[1:]) for g in got] == [(1024, 2, 2), (512, 2, 2)]
    for g, w in zip(got, want):
        assert rel(nhwc(g), np.asarray(w)) < 1e-4


@pytest.mark.parametrize("raw_pred", [False, True])
def test_yolov2_net_matches_tpudet(raw_pred, pair):
    """Eval mode, float32, with the reference's ConvBN prediction layer and
    with ``raw_prediction_conv``."""
    jm, variables, image = tpudet_pair("v2", seed=1, raw_prediction_conv=True) \
        if raw_pred else pair
    check_eval_forward(jm, "v2", variables, image, raw_prediction_conv=raw_pred)


def test_yolov2_net_matches_tpudet_in_bf16(pair):
    jm, variables, image = pair
    check_eval_forward(jm, "v2", variables, image, dtype="bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_yolov2_train_step_matches_tpudet(pair, dtype):
    """The train-mode outputs, the loss and the state after one step; no
    kernel on the step (and on the CPU none would launch anyway)."""
    jm, variables, _ = pair
    launches = (assign_kernel.launches, nms_kernel.launches)
    check_train_step(jm, "v2", variables, dtype)
    assert (assign_kernel.launches, nms_kernel.launches) == launches


def test_yolov2_test_one_image_matches_tpudet(pair):
    jm, variables, image = pair
    check_test_one_image(jm, "v2", variables, image)


def test_yolov2_tpudet_checkpoint_loads_into_the_port(tmp_path, pair):
    jm, variables, image = pair
    check_tpudet_file(tmp_path, jm, "v2", variables, image)


def test_yolov2_channels_first_matches_channels_last(pair):
    _, variables, image = pair
    last = port_model("v2", variables, mode="test")
    first = port_model("v2", variables, mode="test", data_format="channels_first",
                       data_shape=[3, 64, 64])
    assert first.data_shape_hw == last.data_shape_hw == (64, 64)
    for g, w in zip(first.test_one_image(np.transpose(image, (0, 3, 1, 2))),
                    last.test_one_image(image)):
        np.testing.assert_array_equal(g, w)


def test_yolov2_train_one_epoch_and_serving():
    """The loss falls on one fixed batch through ``train_one_epoch`` at the
    training script's lr; serving after training returns scores in [0, 1]
    and class ids in range. (Three steps leave the running statistics near their
    initial mean 0 and variance 1, so the eval-mode head outputs of the
    random net are large and some boxes overflow to inf, as in tpudet.)"""
    b = images(8)

    def feed():
        while True:
            yield b

    pm = YOLOv2(config("v2"), {"num_train": 6, "train_generator": feed()}, device="cpu")
    losses = []

    class Writer:
        def add_summary(self, loss, global_step):
            losses.append(float(loss))

    pm.train_one_epoch(0.005, Writer())
    assert len(losses) == 3 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    scores, boxes, cid = pm.test_one_image(b[0][:1])
    assert len(scores) > 0 and boxes.shape == (len(scores), 4) and cid.shape == scores.shape
    assert ((scores >= 0.3) & (scores <= 1)).all() and ((cid >= 0) & (cid < 20)).all()


def test_yolov2_load_pretraining_weight_from_a_pt_file(tmp_path, pair):
    """The port's own ``.pt`` (a bare prefix: the newest step): the
    ``backone`` parameters and statistics come over, the head keeps its own."""
    _, variables, _ = pair
    src = port_model("v2", variables)
    src.global_step = 3
    src.save_weight("latest", str(tmp_path / "darknet"))
    dst = YOLOv2(config("v2", seed=12), device="cpu")
    before = {k: v.clone() for k, v in dst.net.state_dict().items()}
    dst.load_pretraining_weight(str(tmp_path / "darknet"))
    want = src.net.state_dict()
    for k, v in dst.net.state_dict().items():
        assert torch.equal(v, want[k] if k.startswith("backone.") else before[k]), k
