"""The port's whole YOLOv3 against tpudet's on the same numpy inputs, at input
64 and the training script's full width: DarkNet-53's levels and init, the net with
and without ``raw_prediction_conv`` and in bfloat16, ``test_one_image``, and
tpudet's ``.tpudet`` files (the train steps are in
``tests/test_torch_yolov3_step.py``). Tolerances and their
reasons are in ``tests/torch_yolo_common.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.nn.backbones import darknet as jax_darknet
from tpudet_torch.nn.backbones import darknet as t_darknet
from tpudet_torch.runtime import transfer
from torch_refine_common import PIXEL_MEAN, nchw, nhwc, rel
from torch_yolo_common import (check_eval_forward, check_test_one_image, check_tpudet_file,
                               tpudet_pair)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return tpudet_pair("v3")


def test_darknet53_levels_match_flax(pair):
    """Eval mode, float32: block5, block4 and block3 at strides 32, 16, 8."""
    _, variables, image = pair
    sub = {c: variables[c]["backone"] for c in variables}
    x = image - PIXEL_MEAN
    want = jax_darknet.DarkNet53().apply(sub, jnp.asarray(x), False)
    net = t_darknet.DarkNet53()
    transfer.load_flax(net, sub)
    with torch.no_grad():
        got = net.eval()(nchw(x))
    assert [tuple(g.shape[1:]) for g in got] == [(1024, 2, 2), (512, 4, 4), (256, 8, 8)]
    for g, w in zip(got, want):
        assert rel(nhwc(g), np.asarray(w)) < 1e-4


def test_darknet_conv_init_is_flaxs_he_truncated_normal():
    """``variance_scaling(2.0, "fan_in", "truncated_normal")``: std
    sqrt(2 / fan_in) after the cut at +-2 std, from the caller's generator."""
    conv = t_darknet._DarkConv(256, 512, 3, generator=torch.Generator().manual_seed(0))
    w = conv.conv.weight.detach().numpy()
    std = np.sqrt(2.0 / (256 * 9))
    assert abs(w.std() / std - 1) < 0.02
    assert np.abs(w).max() <= 2 * std / 0.87962566103423978
    again = t_darknet._DarkConv(256, 512, 3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.conv.weight, conv.conv.weight)


@pytest.mark.parametrize("raw_pred", [False, True])
def test_yolov3_net_matches_tpudet(raw_pred, pair):
    """Eval mode, float32: Q5's BN + leaky prediction convs, and
    ``raw_prediction_conv``'s plain conv + bias."""
    jm, variables, image = tpudet_pair("v3", seed=1, raw_prediction_conv=True) \
        if raw_pred else pair
    check_eval_forward(jm, "v3", variables, image, raw_prediction_conv=raw_pred)


def test_yolov3_net_matches_tpudet_in_bf16(pair):
    """The concatenations and the nearest upsample stay in bf16."""
    jm, variables, image = pair
    check_eval_forward(jm, "v3", variables, image, dtype="bfloat16")


def test_yolov3_test_one_image_matches_tpudet(pair):
    jm, variables, image = pair
    check_test_one_image(jm, "v3", variables, image)


def test_yolov3_tpudet_checkpoint_loads_into_the_port(tmp_path, pair):
    jm, variables, image = pair
    check_tpudet_file(tmp_path, jm, "v3", variables, image)
