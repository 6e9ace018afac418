"""The port's SSD serving path against tpudet's on the same numpy inputs.

Layers and the whole SSDNet are compared after copying the flax variables into
the port (``runtime/transfer.py``). Tolerances: the port's convolutions (oneDNN)
and XLA's sum in another order, so conv outputs agree to ~1e-5 relative; NMS
picks are discrete and must be identical when fed identical inputs.

The whole-model tests run at input size 76: its 19 -> 10 max-pool and its
2 -> 1 stride-2 conv pad asymmetrically (bottom/right only), as SSD300's
75 -> 38 pool and 10 -> 5 conv9_2 do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from tpudet.heads import ssd as jax_ssd
from tpudet.models.ssd import SSD300 as JaxSSD300
from tpudet.models.ssd import SSD512 as JaxSSD512
from tpudet.models.ssd import _ssd_feat_shapes as jax_feat_shapes
from tpudet.nn import layers as jax_layers
from tpudet.runtime import config as jax_config
from tpudet_torch.heads import ssd as t_ssd
from tpudet_torch.models.ssd import SSD300, SSD512, _ssd_feat_shapes
from tpudet_torch.nn import layers as t_layers
from tpudet_torch.ops.cuda import nms_kernel
from tpudet_torch.runtime import checkpoint, pretrain, transfer
from tpudet_torch.runtime import config as t_config

torch.set_num_threads(1)


def _config(**kw):
    cfg = {"mode": "test", "data_format": "channels_last", "num_classes": 20,
           "batch_size": 1, "weight_decay": 5e-4, "nms_score_threshold": 0.15,
           "nms_max_boxes": 10, "nms_iou_threshold": 0.45,
           "pretraining_weight": None, "seed": 3}
    cfg.update(kw)
    return cfg


def _nchw(x):
    return torch.tensor(np.transpose(x, (0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _random_stats(tree, rng):
    """Non-trivial running statistics, so BN's mean/var transfer is exercised."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random_stats(v, rng)
        elif k == "var":
            out[k] = rng.uniform(0.5, 2.0, np.shape(v)).astype(np.float32)
        else:
            out[k] = rng.normal(0.0, 0.2, np.shape(v)).astype(np.float32)
    return out


# ------------------------------------------------------------ layers
@pytest.mark.parametrize("size,window,stride", [(75, 2, 2), (19, 2, 2), (10, 3, 1),
                                                (5, 3, 1), (9, 3, 2), (7, 2, 2)])
def test_max_pool_same_matches_flax(size, window, stride):
    x = np.random.default_rng(size).normal(-3.0, 1.0, (2, size, size + 2, 3))
    x = x.astype(np.float32)
    want = np.asarray(jax_layers.max_pool_same(jnp.asarray(x), window, stride))
    got = _nhwc(t_layers.max_pool_same(_nchw(x), window, stride))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_same_pads_are_tf_same():
    assert t_layers.same_pads(75, 2, 2) == (0, 1)    # pool3: 75 -> 38
    assert t_layers.same_pads(10, 3, 2) == (0, 1)    # conv9_2: 10 -> 5
    assert t_layers.same_pads(19, 3, 1) == (1, 1)    # pool5: 3x3 stride 1
    assert t_layers.same_pads(19, 3, 1, 2) == (2, 2)  # conv6: dilation 2


@pytest.mark.parametrize("size,kernel,stride,dilation", [
    (10, 3, 2, 1), (5, 3, 2, 1), (2, 3, 2, 1), (9, 3, 1, 1), (7, 3, 1, 2),
    (6, 1, 1, 1), (11, 3, 2, 1)])
def test_same_conv_bn_matches_flax(size, kernel, stride, dilation):
    rng = np.random.default_rng(100 + size)
    x = rng.normal(-0.5, 1.0, (2, size, size, 5)).astype(np.float32)
    mod = jax_layers.ConvBN(6, kernel, stride=stride, dilation=dilation,
                            activation=fnn.relu)
    variables = jax.device_get(mod.init(jax.random.PRNGKey(size), jnp.asarray(x), False))
    variables = {"params": variables["params"],
                 "batch_stats": _random_stats(variables["batch_stats"], rng)}
    want = np.asarray(mod.apply(variables, jnp.asarray(x), False))
    port = t_layers.ConvBN(5, 6, kernel, stride, dilation, activation=torch.relu).eval()
    transfer.load_flax(port, variables)
    got = _nhwc(port(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_l2norm_scale_matches_flax():
    x = np.random.default_rng(4).normal(size=(2, 6, 5, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0  # the 1e-12 clamp
    mod = jax_layers.L2NormScale(init=20.0)
    variables = {"params": {"scale": np.asarray([17.5], np.float32)}}
    want = np.asarray(mod.apply(variables, jnp.asarray(x)))
    port = t_layers.L2NormScale(20.0)
    with torch.no_grad():
        port.scale.fill_(17.5)
    np.testing.assert_allclose(_nhwc(port(_nchw(x))), want, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ weight transfer
def test_from_flax_rejects_unknown_and_missing_leaves():
    mod = jax_layers.ConvBN(4, 3)
    variables = jax.device_get(mod.init(jax.random.PRNGKey(0), jnp.zeros((1, 5, 5, 3)),
                                        False))
    port = t_layers.ConvBN(3, 4, 3).eval()
    transfer.load_flax(port, variables)
    extra = {"params": {**variables["params"], "gamma": np.zeros(4, np.float32)},
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError):
        transfer.from_flax(extra)
    with pytest.raises(RuntimeError, match="Missing"):
        transfer.load_flax(port, {"params": variables["params"]})


# ------------------------------------------------------------ anchors/config
@pytest.mark.parametrize("jax_cls,port_cls", [(JaxSSD300, SSD300), (JaxSSD512, SSD512)])
def test_ssd_anchors_match_tpudet(jax_cls, port_cls):
    shapes = _ssd_feat_shapes(port_cls.input_size, port_cls.extra_strides)
    assert shapes == jax_feat_shapes(jax_cls.input_size, jax_cls.extra_strides)
    want = jax_ssd.build_anchors(jax_cls.input_size, shapes, jax_cls.aspect_ratios,
                                 jax_cls.scale_pairs)
    got = t_ssd.build_anchors(port_cls.input_size, shapes, port_cls.aspect_ratios,
                              port_cls.scale_pairs)
    if port_cls is SSD300:
        assert got.yx.shape == (8828, 2)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("cfg,model", [
    (_config(), "SSD300"),
    ({"mode": "test", "data_format": "channels_last", "num_classes": 20,
      "batch_size": 1}, "SSD300"),
    (_config(mode="serve"), None),
    (_config(compute_dtype="float16"), None),
])
def test_config_validate_matches_tpudet(cfg, model):
    try:
        want = jax_config.validate(cfg, model)
    except (KeyError, ValueError) as e:
        with pytest.raises(type(e)):
            t_config.validate(cfg, model)
        return
    assert vars(t_config.validate(cfg, model)) == vars(want)


def test_model_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SSD300(_config())


# ------------------------------------------------------------ the whole SSD
class _JaxSSD76(JaxSSD300):
    input_size = 76


class SSD76(SSD300):
    input_size = 76


@pytest.fixture(scope="module")
def pair():
    """tpudet's SSD at 76 with perturbed BN statistics, and the port's copy."""
    jm = _JaxSSD76(_config())
    rng = np.random.default_rng(0)
    jm.batch_stats = _random_stats(jax.device_get(jm.batch_stats), rng)
    variables = {"params": jax.device_get(jm.params), "batch_stats": jm.batch_stats}
    pm = SSD76(_config(), device="cpu")
    transfer.load_flax(pm.net, variables)
    image = rng.uniform(0, 255, (1, 76, 76, 3)).astype(np.float32)
    return jm, pm, variables, image


def test_ssdnet_levels_match_flax(pair):
    jm, pm, variables, image = pair
    x = image - np.asarray([123.68, 116.779, 103.979], np.float32)
    want = jm.net.apply(variables, jnp.asarray(x), False)
    with torch.no_grad():
        got = pm.net(_nchw(x))
    assert [tuple(w.shape[1:3]) for w in want] == [(10, 10), (5, 5), (3, 3), (2, 2),
                                                     (2, 2), (1, 1)]
    for w, g in zip(want, got):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_ssd_decode_matches_tpudet_on_the_same_head_outputs(pair):
    jm, pm, variables, image = pair
    x = image - np.asarray([123.68, 116.779, 103.979], np.float32)
    outs = jm.net.apply(variables, jnp.asarray(x), False)
    pconf, pyx, phw = (np.asarray(a)[0] for a in jax_ssd.flatten_preds(outs, 21))
    want = jax_ssd.ssd_decode(jnp.asarray(pconf), jnp.asarray(pyx), jnp.asarray(phw),
                              jm.anchors, 0.15, 0.45, 10)
    port_outs = [_nchw(np.asarray(o)) for o in outs]
    t_pconf, t_pyx, t_phw = (a[0] for a in t_ssd.flatten_preds(port_outs, 21))
    np.testing.assert_array_equal(t_pconf.numpy(), pconf)
    got = t_ssd.ssd_decode(t_pconf, t_pyx, t_phw, pm.anchors, 0.15, 0.45, 10)
    scores, boxes, cid, valid = (t.numpy() for t in got)
    w_valid = np.asarray(want[3])
    np.testing.assert_array_equal(valid, w_valid)
    assert 0 < w_valid.sum() < w_valid.size
    np.testing.assert_array_equal(cid[valid], np.asarray(want[2])[w_valid])
    np.testing.assert_allclose(scores[valid], np.asarray(want[0])[w_valid], atol=1e-5)
    np.testing.assert_allclose(boxes[valid], np.asarray(want[1])[w_valid], atol=1e-5)


def test_test_one_image_matches_tpudet(pair):
    jm, pm, _, image = pair
    want = jm.test_one_image(image)
    got = pm.test_one_image(image)
    assert len(got[0]) == len(want[0]) > 0
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), atol=1e-4, rtol=1e-4)


def test_channels_first_matches_channels_last(pair):
    _, pm, variables, image = pair
    pf = SSD76(_config(data_format="channels_first"), device="cpu")
    transfer.load_flax(pf.net, variables)
    want = pm.test_one_image(image)
    got = pf.test_one_image(np.transpose(image, (0, 3, 1, 2)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_serving_goes_through_the_kernel_wrapper(pair, monkeypatch):
    _, pm, _, image = pair
    calls = []
    real = nms_kernel.nms_rows
    monkeypatch.setattr(nms_kernel, "nms_rows",
                        lambda *a: calls.append((a[1].shape, a[5].shape)) or real(*a))
    pm.test_one_image(image)
    assert calls == [((20, 648), (20, 512))]  # 648 anchors at 76: the 512-candidate pool


def test_save_and_load_weight_round_trip(pair, tmp_path):
    _, pm, _, image = pair
    want = pm.test_one_image(image)
    pm.save_weight("latest", str(tmp_path / "ssd" / "model"))
    pm.global_step = 7
    pm.save_weight("latest", str(tmp_path / "ssd" / "model"))
    other = SSD76(_config(seed=11), device="cpu")
    other.load_weight(str(tmp_path / "ssd" / "model"))  # newest step wins
    assert other.global_step == 7
    for w, g in zip(want, other.test_one_image(image)):
        np.testing.assert_array_equal(g, w)
    pm.global_step = 0
    with pytest.raises(FileNotFoundError):
        checkpoint.load_state(str(tmp_path / "nothing"))


def test_pretrained_vgg16_is_injected_from_npz(tmp_path):
    rng = np.random.default_rng(9)
    w = {"vgg_16/conv1/conv1_1/weights": rng.normal(size=(3, 3, 3, 64)),
         "vgg_16/conv1/conv1_1/biases": rng.normal(size=(64,)),
         "vgg_16/conv5/conv5_3/weights": rng.normal(size=(3, 3, 512, 512)),
         "vgg_16/conv5/conv5_3/biases": rng.normal(size=(512,))}
    path = tmp_path / "vgg_16.npz"
    np.savez(path, **{k: v.astype(np.float32) for k, v in w.items()})
    with pytest.warns(UserWarning, match="missing"):
        m = SSD76(_config(pretraining_weight=str(path)), device="cpu")
    trunk = m.net.feature_extractor.vgg
    np.testing.assert_array_equal(trunk.conv1_1.conv.weight.detach().numpy(),
                                  w["vgg_16/conv1/conv1_1/weights"].astype(np.float32)
                                  .transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(trunk.conv5_3.conv.bias.detach().numpy(),
                                  w["vgg_16/conv5/conv5_3/biases"].astype(np.float32))
    ckpt = tmp_path / "vgg_16.ckpt"
    ckpt.write_bytes(b"")
    with pytest.warns(UserWarning, match="could not read TF checkpoint"):
        assert pretrain.load_vgg16(str(ckpt)) is None
