"""The port's RetinaNet slice against tpudet's on the same numpy inputs.

Modules are compared after copying the flax variables into the port
(``runtime/transfer.py``). Tolerances, each with its reason:
  * float32 module outputs and a whole float32 step: 1e-4 relative, normwise
    (oneDNN and XLA sum the convolutions in other orders);
  * bfloat16: 1e-2 relative (bf16 rounds after every convolution, and the two
    frameworks round in other places of a sum);
  * the focal loss on identical head outputs: 1e-5 relative (the same
    formulas, reductions in other orders);
  * the bilinear upsampling and the anchors: the same float32 operations,
    equal to 1e-6 or exactly;
  * decode picks on identical head outputs: identical.

The whole-model tests run a 64x64 RetinaNet with one unit a stage over three
stages, ``init_conv_filters`` 8, as ``tests/test_retinanet.py`` does; the
modules also run at odd sizes, where TF's SAME padding is asymmetric.
tpudet's focal terms run in its ``ac`` layout (``TPUDET_SSD_CONF_LAYOUT``),
the port's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.heads import refine as jax_refine
from tpudet.heads import retina as jax_retina
from tpudet.heads import ssd as jax_ssd
from tpudet.models import base as jax_base
from tpudet.models.retinanet import RetinaNet as JaxRetinaNet
from tpudet.models.retinanet import _stage_shapes as jax_stage_shapes
from tpudet.nn import layers as jax_layers
from tpudet.nn.backbones.resnet import PreActResNet as JaxResNet
from tpudet.nn.necks.fpn import RetinaFPN as JaxFPN
from tpudet.ops import losses as jax_losses
from tpudet.runtime import optim as jax_optim
from tpudet_torch.heads import refine as t_refine
from tpudet_torch.heads import retina as t_retina
from tpudet_torch.heads import ssd as t_ssd
from tpudet_torch.models import RetinaNet
from tpudet_torch.models.retinanet import _stage_shapes, pyramid_shapes
from tpudet_torch.nn import layers as t_layers
from tpudet_torch.nn.backbones.resnet import PreActResNet
from tpudet_torch.nn.necks.fpn import RetinaFPN
from tpudet_torch.ops.cuda import assign_kernel, nms_kernel
from tpudet_torch.runtime import transfer
from torch_assign_cases import rand_gt

torch.set_num_threads(1)

PIXEL_MEAN = np.asarray([123.68, 116.779, 103.979], np.float32)
DTYPES = [("float32", 1e-4), ("bfloat16", 1e-2)]


def _config(**kw):
    cfg = {"mode": "train", "data_format": "channels_last", "num_classes": 4,
           "weight_decay": 1e-4, "keep_prob": 1.0, "batch_size": 2,
           "nms_score_threshold": 0.2, "nms_max_boxes": 5, "nms_iou_threshold": 0.45,
           "data_shape": [64, 64, 3], "is_bottleneck": True,
           "residual_block_list": [1, 1, 1], "init_conv_filters": 8,
           "is_pretraining": False, "alpha": 0.25, "gamma": 2.0, "nms_pre_topk": 1024,
           "seed": 3}
    cfg.update(kw)
    return cfg


def _nchw(x):
    return torch.tensor(np.transpose(np.asarray(x, np.float32), (0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _rel(got, want):
    """Normwise relative difference."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _tree_like(tree, fn):
    return {k: _tree_like(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _random_stats(tree, rng):
    return _tree_like(tree, lambda v: rng.uniform(0.5, 2.0, np.shape(v)).astype(np.float32))


def _flax_pair(mod, port, x, rng, *args):
    """Init ``mod`` on ``x``, perturb its BN statistics, copy it into ``port``."""
    variables = jax.device_get(mod.init(jax.random.PRNGKey(4), *args, False))
    variables = {"params": variables["params"],
                 "batch_stats": _random_stats(variables["batch_stats"], rng)}
    transfer.load_flax(port, variables)
    return variables


# ------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("train", [False, True])
def test_bnactconv_matches_flax(dtype, tol, train):
    """Output and (train) updated running statistics, stride 2 at an odd size,
    with the prior bias."""
    rng = np.random.default_rng(11)
    x = rng.normal(-0.3, 1.0, (2, 9, 9, 5)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    mod = jax_layers.BNActConv(6, 3, 2, bias_init_const=-4.59, dtype=jdt)
    port = t_layers.BNActConv(5, 6, 3, 2, bias_init_const=-4.59,
                              dtype=getattr(torch, dtype))
    variables = _flax_pair(mod, port, x, rng, jnp.asarray(x))
    want, mut = mod.apply(variables, jnp.asarray(x), train, mutable=["batch_stats"])
    got = port.train(train)(_nchw(x))
    assert got.dtype == getattr(torch, dtype) and want.dtype == jdt
    assert _rel(_nhwc(got), np.asarray(want, np.float32)) < tol
    for k in ("mean", "var"):
        assert _rel(getattr(port.bn, k).numpy(), mut["batch_stats"]["bn"][k]) < tol / 10


def test_bnactconv_init_is_flaxs_variance_scaling():
    """Truncated normal at +-2 std, std = sqrt(2 / fan_in) / 0.8796 before the
    cut (so ~sqrt(2 / fan_in) after it), the constant bias, drawn from the
    generator; ``norm="gn"`` (FCOS) normalises with a GroupNorm named ``gn``,
    and any other norm raises."""
    gen = torch.Generator().manual_seed(0)
    unit = t_layers.BNActConv(64, 128, 3, bias_init_const=-4.59, generator=gen)
    w = unit.conv.weight.detach().numpy()
    fan_in = 64 * 9
    assert abs(w.std() / np.sqrt(2.0 / fan_in) - 1) < 0.02
    assert np.abs(w).max() <= 2 * np.sqrt(2.0 / fan_in) / t_layers.TRUNC_NORMAL_STD
    assert np.all(unit.conv.bias.detach().numpy() == np.float32(-4.59))
    again = t_layers.BNActConv(64, 128, 3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.conv.weight, unit.conv.weight)
    assert not again.conv.bias.any()
    gn_unit = t_layers.BNActConv(64, 128, 3, norm="gn",
                                 generator=torch.Generator().manual_seed(0))
    assert isinstance(gn_unit.gn, t_layers.GroupNorm) and not hasattr(gn_unit, "bn")
    assert torch.equal(gn_unit.conv.weight, unit.conv.weight)
    with pytest.raises(ValueError, match="norm"):
        t_layers.BNActConv(4, 4, 3, norm="ln")


@pytest.mark.parametrize("size_in,size_out,dtype", [
    ((32, 32), (63, 63), "float32"), ((16, 16), (32, 32), "float32"),
    ((8, 5), (15, 13), "float32"), ((7, 7), (7, 7), "float32"),
    ((16, 16), (32, 32), "bfloat16"), ((32, 32), (63, 63), "bfloat16")])
def test_resize_bilinear_matches_tpudet(size_in, size_out, dtype):
    """TF1's rule with no half-pixel offset, equal to 1e-6; bf16 in gives
    float32 out on both sides (identity keeps the input)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, *size_in, 3)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = jax_layers.resize_bilinear(jx, *size_out)
    got = t_layers.resize_bilinear(_nchw(np.asarray(jx, np.float32)).to(
        getattr(torch, dtype)), *size_out)
    same = size_in == size_out
    want_dtype = dtype if same else "float32"
    assert want.dtype == getattr(jnp, want_dtype)
    assert got.dtype == getattr(torch, want_dtype)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want, np.float32), rtol=1e-6,
                               atol=1e-6)


def test_resize_bilinear_is_not_half_pixel():
    """``F.interpolate(align_corners=False)`` is another function."""
    x = torch.arange(16.0).reshape(1, 1, 4, 4)
    ours = t_layers.resize_bilinear(x, 8, 8)
    torch.testing.assert_close(ours[0, 0, 0, :3], torch.tensor([0.0, 0.5, 1.0]))
    half = torch.nn.functional.interpolate(x, (8, 8), mode="bilinear",
                                           align_corners=False)
    assert not torch.allclose(ours, half)


# ------------------------------------------------------------ backbone, FPN, subnets
@pytest.mark.parametrize("bottleneck,dtype,train,blocks,size", [
    (True, "float32", True, (2, 1, 1, 1), 29), (False, "float32", True, (2, 1, 1, 1), 29),
    (True, "bfloat16", False, (2, 1, 1, 1), 29), (True, "bfloat16", True, (1, 1, 1), 77)])
def test_resnet_matches_flax(bottleneck, dtype, train, blocks, size):
    """The three endpoints and (train) the updated statistics; SAME pads
    asymmetrically at 8 -> 4 -> 2 -> 1 (29) and 20 -> 10 (77). The basic net
    starts 7 wide so that its stride-1 identity adds. In bf16 train mode the
    batch statistics amplify rounding differences with depth (~0.4% a block
    here, against 1e-5 in fp32), so that case is three blocks deep."""
    rng = np.random.default_rng(5)
    init = 16 if bottleneck else 7
    tol = 1e-4 if dtype == "float32" else 1e-2
    x = rng.normal(0, 50, (2, size, size, 3)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    mod = JaxResNet(blocks, init, 7, bottleneck, dtype=jdt)
    port = PreActResNet(blocks, init, 7, bottleneck, dtype=getattr(torch, dtype))
    variables = _flax_pair(mod, port, x, rng, jnp.asarray(x))
    want, mut = mod.apply(variables, jnp.asarray(x), train, mutable=["batch_stats"])
    got = port.train(train)(_nchw(x))
    widths = [w * (4 if bottleneck else 1) for w in (7, 14, 28, 56)][len(blocks) - 3:
                                                                    len(blocks)]
    sizes = (4, 2, 1) if size == 29 else (20, 10, 5)
    assert port.out_channels == widths
    assert [tuple(g.shape[1:]) for g in got] == [(w, s, s) for w, s in zip(widths, sizes)]
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        assert _rel(_nhwc(g), np.asarray(w, np.float32)) < tol
    if train:
        stats = transfer.from_flax({"batch_stats": mut["batch_stats"]})
        worst = max(_rel(port.state_dict()[k].numpy(), v.numpy())
                    for k, v in stats.items())
        assert worst < tol


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_fpn_matches_flax(dtype, tol):
    """P3..P7 at 500x500's odd pyramid (63/32/16 -> 8 -> 4), train mode; in
    bf16 the top-down sums that feed p4_conv and p3_conv are float32."""
    rng = np.random.default_rng(6)
    c = [rng.normal(size=(1, s, s, ch)).astype(np.float32)
         for s, ch in ((63, 28), (32, 56), (16, 112))]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    mod = JaxFPN(dtype=jdt)
    port = RetinaFPN((28, 56, 112), dtype=tdt)
    jc = [jnp.asarray(a, jdt) for a in c]
    variables = _flax_pair(mod, port, c, rng, *jc)
    want, mut = mod.apply(variables, *jc, True, mutable=["batch_stats"])
    seen = {}
    for name in ("p4_conv", "p3_conv", "p6_conv"):
        getattr(port, name).register_forward_pre_hook(
            lambda m, a, name=name: seen.__setitem__(name, a[0].dtype))
    got = port.train()(*(_nchw(a).to(tdt) for a in c))
    assert seen == {"p4_conv": torch.float32, "p3_conv": torch.float32, "p6_conv": tdt}
    assert [g.shape[-1] for g in got] == [63, 32, 16, 8, 4]
    for g, w in zip(got, want):
        assert g.dtype == tdt
        assert _rel(_nhwc(g), np.asarray(w, np.float32)) < tol
    stats = transfer.from_flax({"batch_stats": mut["batch_stats"]})
    worst = max(_rel(port.state_dict()[k].numpy(), v.numpy()) for k, v in stats.items())
    assert worst < tol


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_subnets_match_flax(dtype, tol):
    """Five levels with their own weights, eval mode, and the flatten order
    (anchor-major groups of C classes, yx before hw)."""
    rng = np.random.default_rng(7)
    levels = [rng.normal(size=(1, s, s, 256)).astype(np.float32) for s in (5, 3, 2, 1, 1)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    mod = jax_retina.RetinaSubnets(6, dtype=jdt)
    port = t_retina.RetinaSubnets(5, 6, dtype=getattr(torch, dtype))
    jl = [jnp.asarray(a, jdt) for a in levels]
    variables = _flax_pair(mod, port, levels, rng, jl)
    assert not torch.equal(port.cls0_conv0.conv.weight, port.cls1_conv0.conv.weight)
    want = mod.apply(variables, jl, False)
    got = port.eval()([_nchw(a).to(getattr(torch, dtype)) for a in levels])
    for (gc, gr), (wc, wr) in zip(got, want):
        assert _rel(_nhwc(gc), np.asarray(wc, np.float32)) < tol
        assert _rel(_nhwc(gr), np.asarray(wr, np.float32)) < tol
    flat_want = jax_retina.flatten_preds(want, 6)
    flat_got = t_retina.flatten_preds(
        [(_nchw(np.asarray(c, np.float32)), _nchw(np.asarray(r, np.float32)))
         for c, r in want], 6)
    for g, w in zip(flat_got, flat_want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert flat_got[0].shape == (1, 9 * (25 + 9 + 4 + 1 + 1), 6)


@pytest.mark.parametrize("size", [500, 64])
def test_retina_anchors_match_tpudet(size):
    """Exactly; 47961 anchors at 500 (63/32/16/8/4)."""
    shapes = pyramid_shapes(size, size, 4 if size == 500 else 3)
    stages = jax_stage_shapes(size, size, 4 if size == 500 else 3)
    assert _stage_shapes(size, size, 4 if size == 500 else 3) == stages
    want = jax_retina.build_anchors(size, shapes)
    got = t_retina.build_anchors(size, shapes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if size == 500:
        assert shapes == [(63, 63), (32, 32), (16, 16), (8, 8), (4, 4)]
        assert got.yx.shape == (47961, 2)


# ------------------------------------------------------------ the focal loss
def _gt(rng, b, g, n_max, size, num_classes=4):
    """``rand_gt`` with class ids below ``num_classes``."""
    gt = rand_gt(rng, b, g, n_max, size=size, n_valid_min=1)
    gt[..., 4] = np.where(gt[..., 0] >= 0, gt[..., 4] % num_classes, -1)
    return gt


def _loss_case(name, rng):
    gt = _gt(rng, 3, 12, 6, 64.0)
    if name == "duplicated_best":
        gt[0, 1] = gt[0, 0]  # two gts claim the same best anchor
        gt[1, 1] = gt[1, 0]
        gt[1, 1, 4] = (gt[1, 0, 4] + 1) % 4
    if name == "no_gt":
        gt[2] = -1.0
    return gt


@pytest.fixture(scope="module")
def anchors64():
    shapes = pyramid_shapes(64, 64, 3)
    return jax_retina.build_anchors(64, shapes), t_retina.build_anchors(64, shapes)


@pytest.mark.parametrize("name", ["band", "duplicated_best", "no_gt"])
def test_retina_loss_matches_tpudet(monkeypatch, anchors64, name):
    """fp32 on identical head outputs: the loss to 1e-5 relative and its
    gradients to 1e-5 of their largest entry; anchors in the ignored 0.4-0.5
    band exist; a duplicated best anchor; an image with no gt."""
    monkeypatch.setenv("TPUDET_SSD_CONF_LAYOUT", "ac")
    janc, tanc = anchors64
    rng = np.random.default_rng({"band": 0, "duplicated_best": 1, "no_gt": 2}[name])
    a = tanc.yx.shape[0]
    heads = [rng.normal(0, 2, (3, a, 5)).astype(np.float32),
             rng.normal(0, 0.5, (3, a, 2)).astype(np.float32),
             rng.normal(0, 0.5, (3, a, 2)).astype(np.float32)]
    gt = _loss_case(name, rng)

    def jax_loss(c, y, h):
        return jax_retina.retina_loss(c, y, h, janc, jnp.asarray(gt), 5, 0.25, 2.0)

    want, wgrads = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, heads))
    tt = [torch.tensor(h, requires_grad=True) for h in heads]
    launches = nms_kernel.launches
    got = t_retina.retina_loss(*tt, tanc, torch.from_numpy(gt), 5, 0.25, 2.0)
    grads = torch.autograd.grad(got, tt)
    assert nms_kernel.launches == launches
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for g, w in zip(grads, wgrads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
    g = t_retina.matching.unpack_gt(torch.from_numpy(gt))
    asg = t_retina.matching.assign_plain(g.y1x1, g.y2x2, g.valid, tanc.y1x1, tanc.y2x2)
    band = (asg.best_iou >= 0.4) & (asg.best_iou <= 0.5) & ~asg.best_set
    assert int(band.sum()) > 0
    if name == "duplicated_best":
        assert int(asg.best_anchor[0, 0]) == int(asg.best_anchor[0, 1])
    if name == "no_gt":
        assert float(got.detach()) > 1e6  # the negatives' sum over a 1e-8 denominator


def _out_of_range_losses(family, rng, a):
    """(tpudet's loss, the port's loss on the same head tensors, the port's
    head tensors) for ``family``; 5 classes with the background."""
    if family == "refinedet":
        heads = [rng.normal(0, s, (1, a, c)).astype(np.float32)
                 for s, c in ((0.5, 2), (0.5, 2), (2, 2), (0.5, 2), (0.5, 2), (2, 5))]
        jax_fn, port_fn = jax_refine.refine_loss, t_refine.refine_loss
    else:
        heads = [rng.normal(0, 2, (1, a, 5)).astype(np.float32),
                 rng.normal(0, 0.5, (1, a, 2)).astype(np.float32),
                 rng.normal(0, 0.5, (1, a, 2)).astype(np.float32)]
        jax_fn, port_fn = {"ssd": (jax_ssd.ssd_loss, t_ssd.ssd_loss),
                           "retinanet": (jax_retina.retina_loss, t_retina.retina_loss)}[
                               family]
    extra = (0.25, 2.0) if family == "retinanet" else ()
    return jax_fn, port_fn, heads, extra


@pytest.mark.parametrize("family", ["ssd", "retinanet", "refinedet"])
def test_out_of_range_class_id_raises_where_tpudet_gives_nan(monkeypatch, anchors64,
                                                             family):
    """A gt class id >= num_classes: tpudet's ``take_along_axis`` fills NaN
    and its loss is NaN (``tpudet/heads/retina.py:102``,
    ``tpudet/ops/losses.py:29,45``); the port's gathers read the class with
    the same semantics (``ops/losses.py::take_last``), so its SSD, RetinaNet
    and RefineDet losses are NaN too, and nothing raises. The gradients of
    the head tensors agree, NaN where tpudet's are NaN."""
    monkeypatch.setenv("TPUDET_SSD_CONF_LAYOUT", "ac")
    janc, tanc = anchors64
    rng = np.random.default_rng(3)
    gt = _gt(rng, 1, 4, 2, 64.0)
    gt[0, 0, 4] = 7  # 5 classes with the background
    jax_fn, port_fn, heads, extra = _out_of_range_losses(family, rng, tanc.yx.shape[0])

    def jax_loss(*h):
        return jax_fn(*h, janc, jnp.asarray(gt), 5, *extra)

    want, wgrads = jax.value_and_grad(jax_loss, argnums=tuple(range(len(heads))))(
        *map(jnp.asarray, heads))
    tt = [torch.tensor(h, requires_grad=True) for h in heads]
    got = port_fn(*tt, tanc, torch.from_numpy(gt), 5, *extra)
    assert np.isnan(float(want)) and torch.isnan(got)
    for g, w in zip(torch.autograd.grad(got, tt), wgrads):
        w = np.asarray(w)
        scale = np.nanmax(np.abs(w)) if np.isfinite(w).any() else 1.0
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * scale,
                                   equal_nan=True)


# ------------------------------------------------------------ the whole model
def _batch(seed, b=2, size=64):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 255, (b, size, size, 3)).astype(np.float32)
    return images, _gt(rng, b, 8, 4, float(size))


@pytest.fixture(scope="module")
def pair():
    """tpudet's small RetinaNet with perturbed BN statistics, and the port's copy."""
    jm = JaxRetinaNet(_config(mode="test"))
    rng = np.random.default_rng(0)
    jm.batch_stats = _random_stats(jax.device_get(jm.batch_stats), rng)
    variables = {"params": jax.device_get(jm.params), "batch_stats": jm.batch_stats}
    pm = RetinaNet(_config(mode="test"), device="cpu")
    transfer.load_flax(pm.net, variables)
    image = rng.uniform(0, 255, (1, 64, 64, 3)).astype(np.float32)
    return jm, pm, variables, image


def test_retinanet_forward_matches_tpudet(pair):
    """fp32 eval forward, 1e-4 normwise per output; the anchors are equal."""
    jm, pm, variables, image = pair
    want = jm.net.apply(variables, jnp.asarray(image - PIXEL_MEAN), False)
    with torch.no_grad():
        got = pm.net(_nchw(image - PIXEL_MEAN))
    assert len(got) == 5
    for (gc, gr), (wc, wr) in zip(got, want):
        assert _rel(_nhwc(gc), np.asarray(wc)) < 1e-4
        assert _rel(_nhwc(gr), np.asarray(wr)) < 1e-4
    for g, w in zip(pm.anchors, jm.anchors):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert sum(p.numel() for p in pm.net.parameters()) == sum(
        np.size(v) for v in jax.tree.leaves(variables["params"]))


def test_retinanet_decode_matches_tpudet(pair):
    """The same head outputs through both decodes: identical picks."""
    jm, pm, variables, image = pair
    outs = jm.net.apply(variables, jnp.asarray(image - PIXEL_MEAN), False)
    want = jax.device_get(jm._decode_outputs(outs, 1024))
    assert not bool(want[4])  # tpudet's pool did not truncate
    port_outs = [(_nchw(np.asarray(c)), _nchw(np.asarray(r))) for c, r in outs]
    scores, boxes, cid, valid = (t.numpy() for t in pm._decode_outputs(port_outs))
    np.testing.assert_array_equal(valid, want[3])
    assert want[3].sum() > 0
    np.testing.assert_array_equal(cid[valid], want[2][want[3]])
    np.testing.assert_allclose(scores[valid], want[0][want[3]], rtol=1e-6)
    np.testing.assert_allclose(boxes[valid], want[1][want[3]], rtol=1e-5, atol=1e-4)
    got = pm.test_one_image(image)
    ref = jm.test_one_image(image)
    np.testing.assert_array_equal(got[2], np.asarray(ref[2]))
    np.testing.assert_allclose(got[0], np.asarray(ref[0]), atol=1e-4, rtol=1e-4)


def test_channels_first_matches_channels_last(pair):
    _, pm, variables, image = pair
    pf = RetinaNet(_config(mode="test", data_format="channels_first",
                           data_shape=[3, 64, 64]), device="cpu")
    transfer.load_flax(pf.net, variables)
    want = pm.test_one_image(image)
    got = pf.test_one_image(np.transpose(image, (0, 3, 1, 2)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def _jax_step(jm, params, bstats, velocity, images, labels, lr, wd, pretraining=False):
    def forward_loss(p, s):
        x = jnp.asarray(images) - PIXEL_MEAN.reshape(1, 1, 1, 3)
        outputs, mut = jm.net.apply({"params": p, "batch_stats": s}, x, True,
                                    mutable=["batch_stats"])
        if pretraining:
            loss = jnp.mean(jax_losses.softmax_cross_entropy(outputs, jnp.asarray(labels)))
        else:
            loss = jm._loss_from_outputs(outputs, jnp.asarray(labels), None)
        return loss + wd * jax_base.global_l2(p), mut["batch_stats"]

    def step(p, s, v):
        (loss, stats), grads = jax.value_and_grad(forward_loss, has_aux=True)(p, s)
        new_p, new_opt = jax_optim.Momentum(0.9).update(
            grads, jax_optim.MomentumState(v), p, jnp.float32(lr))
        return loss, new_p, stats, new_opt.velocity

    return jax.device_get(jax.jit(step)(params, bstats, velocity))


def _step_pair(dtype, rng, **kw):
    jm = JaxRetinaNet(_config(mode="test", compute_dtype=dtype, **kw))
    params = jax.device_get(jm.params)
    bstats = _random_stats(jax.device_get(jm.batch_stats), rng)
    velocity = _tree_like(params, lambda v: (0.01 * rng.normal(size=np.shape(v)))
                          .astype(np.float32))
    pm = RetinaNet(_config(compute_dtype=dtype, **kw), device="cpu")
    transfer.load_flax(pm.net, {"params": params, "batch_stats": bstats})
    for k, v in transfer.velocity_from_flax(velocity).items():
        pm.velocity[k].copy_(v)
    return jm, pm, params, bstats, velocity


def _global_rel(got, want):
    """Normwise relative difference over a whole tree of tensors."""
    num = sum(np.sum((got[k].double().numpy() - want[k].double().numpy()) ** 2)
              for k in want)
    return np.sqrt(num / sum(np.sum(want[k].double().numpy() ** 2) for k in want))


def _check_step(pm, w_params, w_stats, w_vel, dtype):
    """fp32: the parameters and the running statistics after the step to 1e-4,
    normwise over the tree; the velocity (the gradient plus momentum) to 1e-2.
    The gradient of this small pre-activation net with train-mode BatchNorm
    over batch 2 is ill-conditioned: tpudet's own float32 gradient is 0.6%
    from its float64 one over the tree (2.3% on some BatchNorm vectors), and
    the port's 0.28%, so neither float32 step fixes the gradient to 1e-4.
    bf16: the running statistics to 1e-2 per tensor."""
    got = pm.net.state_dict()
    want = transfer.from_flax({"params": w_params, "batch_stats": w_stats})
    stats = [k for k in want if k.endswith((".mean", ".var"))]
    if dtype == "float32":
        assert _global_rel(got, {k: want[k] for k in want if k not in stats}) < 1e-4
        assert _global_rel(got, {k: want[k] for k in stats}) < 1e-4
        w_v = transfer.velocity_from_flax(w_vel)
        assert _global_rel(pm.velocity, w_v) < 1e-2
    else:
        worst = max(_rel(got[k].numpy(), want[k].numpy()) for k in stats)
        assert worst < 1e-2, worst


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_train_step_matches_tpudet(monkeypatch, dtype, tol):
    """One step from transferred params, perturbed statistics and a non-zero
    velocity (batch 2, 64x64): the loss to 1e-4 (fp32) or 1e-2 (bf16), the
    state after the step as :func:`_check_step` says."""
    monkeypatch.setenv("TPUDET_SSD_CONF_LAYOUT", "ac")
    rng = np.random.default_rng(21)
    jm, pm, params, bstats, velocity = _step_pair(dtype, rng)
    images, gt = _batch(5)
    w_loss, w_params, w_stats, w_vel = _jax_step(jm, params, bstats, velocity, images,
                                                 gt, 0.01, 1e-4)
    launches = (assign_kernel.launches, nms_kernel.launches)
    loss = pm.train_step(*pm._to_device(images, gt), 0.01)
    assert (assign_kernel.launches, nms_kernel.launches) == launches  # CPU: plain
    assert pm.global_step == 1
    np.testing.assert_allclose(float(loss), float(w_loss), rtol=tol)
    _check_step(pm, w_params, w_stats, w_vel, dtype)


def test_pretraining_step_matches_tpudet():
    """One fp32 pretraining step on integer labels (the logits are the last
    stage's channels: 112 with [1, 1, 1], 224 at the driver's [3, 4, 6, 3]):
    the loss to 1e-4, the state after the step as :func:`_check_step` says."""
    rng = np.random.default_rng(22)
    jm, pm, params, bstats, velocity = _step_pair("float32", rng, is_pretraining=True)
    images, _ = _batch(6)
    labels = np.asarray([3, 17], np.int32)
    w_loss, w_params, w_stats, w_vel = _jax_step(jm, params, bstats, velocity, images,
                                                 labels, 0.01, 1e-4, pretraining=True)
    x, y = pm._to_device(images, labels)
    assert y.dtype == torch.int64
    with torch.no_grad():
        assert pm.net.eval()(pm._preprocess(x)).shape == (2, 112)
    loss, acc = pm.train_step(x, y, 0.01)
    np.testing.assert_allclose(float(loss), float(w_loss), rtol=1e-4)
    assert 0.0 <= float(acc) <= 1.0
    _check_step(pm, w_params, w_stats, w_vel, "float32")
    pred = pm.test_one_image(images[:1])
    assert pred.shape == (1,) and 0 <= pred[0] < 112


class _Writer:
    def __init__(self):
        self.losses = []

    def add_summary(self, loss, global_step):
        self.losses.append(float(loss))


def _fixed_feed(batch):
    while True:
        yield batch


def test_train_one_epoch_and_pretraining_epoch(tmp_path):
    """Detection: the loss falls on one fixed batch. Pretraining: (loss, acc),
    and its checkpoint holds the feature extractor only."""
    batch = _batch(8)
    pm = RetinaNet(_config(), {"num_train": 8, "train_generator": _fixed_feed(batch)},
                   device="cpu")
    writer = _Writer()
    pm.train_one_epoch(0.01, writer)
    assert len(writer.losses) == 4 and writer.losses[-1] < writer.losses[0]

    labels = np.asarray([1, 2])
    pre = RetinaNet(_config(is_pretraining=True),
                    {"num_train": 4, "train_generator": _fixed_feed((batch[0], labels))},
                    device="cpu")
    loss, acc = pre.train_one_epoch(0.01)
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0 and pre.global_step == 2
    pre.save_weight("latest", str(tmp_path / "pre" / "ckpt"))
    det = RetinaNet(_config(seed=9), device="cpu")
    fpn = {k: v.clone() for k, v in det.net.feature_extractor.fpn.state_dict().items()}
    det.load_pretraining_weight(str(tmp_path / "pre" / "ckpt"))
    for k, v in pre.net.feature_extractor.backbone.state_dict().items():
        assert torch.equal(det.net.feature_extractor.backbone.state_dict()[k], v), k
    for k, v in det.net.feature_extractor.fpn.state_dict().items():
        assert torch.equal(fpn[k], v), k


def test_load_pretraining_weight_from_a_tpudet_file(tmp_path):
    """tpudet's pretraining ``save_weight`` (feature extractor only, msgpack)
    -> the port's detection model: backbone parameters and statistics equal."""
    jpre = JaxRetinaNet(_config(mode="test", is_pretraining=True))
    rng = np.random.default_rng(3)
    jpre.batch_stats = _random_stats(jax.device_get(jpre.batch_stats), rng)
    jpre.global_step = 5
    jpre.save_weight("latest", str(tmp_path / "pre" / "ckpt"))
    assert (tmp_path / "pre" / "ckpt-5.tpudet").is_file()
    det = RetinaNet(_config(), device="cpu")
    det.load_pretraining_weight(str(tmp_path / "pre" / "ckpt"))
    want = transfer.from_flax({"params": jax.device_get(jpre.params),
                               "batch_stats": jpre.batch_stats})
    got = det.net.state_dict()
    assert want and all(k.startswith("feature_extractor.backbone.") for k in want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_retinanet_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RetinaNet(_config())
