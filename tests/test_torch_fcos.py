"""The port's FCOS against tpudet's on the same numpy inputs: GroupNorm
(float32 and bfloat16, a 1x1 level included), the GroupNorm ResNet's levels,
FCOSNet at 128x192 (non-square, all five levels 16x24 ... 1x2) and the
training script's full width, ``fcos_loss`` in tpudet's default ``[G, P]``
form, its ``[fh, fw, G]`` form and ``consistent_objective``, with gts on the
band edges (Q10), a minimum-area tie and out-of-range labels, the decode's
picks (Q9), ``test_one_image``, ``train_one_epoch`` and the checkpoints
(the train steps are in ``tests/test_torch_fcos_step.py``). Network and step
tolerances and their reasons are in ``tests/torch_anchor_free_common.py``;
the others are stated in each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from tpudet.heads import fcos as jax_fcos
from tpudet.models.fcos import FCOS as JaxFCOS
from tpudet.nn.backbones.resnet import PreActResNet as JaxPreActResNet
from tpudet.runtime import optim as jax_optim
from tpudet_torch.heads import fcos as t_fcos
from tpudet_torch.models import FCOS
from tpudet_torch.nn.layers import GroupNorm
from tpudet_torch.runtime import transfer
from torch_anchor_free_common import check_outputs, leaves, seeded_pair
from torch_refine_common import PIXEL_MEAN, nchw, nhwc, rel, tree_like

torch.set_num_threads(1)

HW = (128, 192)
NUM_CLASSES = 20
DRIVER_HW = (800, 1200)


def config(**kw):
    """``drivers/testfcos.py``'s config at 128x192 and batch 2, with a score
    threshold that random weights pass."""
    cfg = {"mode": "train", "data_shape": [*HW, 3], "data_format": "channels_last",
           "num_classes": NUM_CLASSES, "weight_decay": 1e-4, "keep_prob": 0.5,
           "batch_size": 2, "nms_score_threshold": 0.3, "nms_max_boxes": 10,
           "nms_iou_threshold": 0.45, "seed": 3}
    cfg.update(kw)
    return cfg


@pytest.fixture(scope="module")
def pair():
    jm, variables = seeded_pair(JaxFCOS, config(mode="test"), HW)
    image = np.random.default_rng(7).uniform(0, 255, (1, *HW, 3)).astype(np.float32)
    return jm, variables, image


def port_model(variables, **kw):
    pm = FCOS(config(**kw), device="cpu")
    transfer.load_flax(pm.net, variables)
    return pm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 16, 24, 64), (2, 1, 2, 256), (2, 1, 1, 256)])
def test_group_norm_matches_flax(shape, dtype):
    """flax's ``nn.GroupNorm(8, epsilon=1e-5, dtype)`` on the same input and
    parameters, fed in ``dtype``: float32 to 1e-5 normwise (the statistics
    are sums in other orders); bfloat16 to 4e-3 normwise (one bf16 rounding
    of the output, 2^-8 relative, may land the other way)."""
    rng = np.random.default_rng(shape[-1])
    x = rng.normal(0.5, 2.0, shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    bias = rng.normal(0, 0.1, shape[-1]).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = flax_nn.GroupNorm(num_groups=8, epsilon=1e-5, dtype=jdt).apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x).astype(jdt))
    gn = GroupNorm(shape[-1], dtype=tdt)
    gn.load_state_dict({"scale": torch.tensor(scale), "bias": torch.tensor(bias)})
    with torch.no_grad():
        got = gn(nchw(x).to(tdt))
    assert got.dtype == tdt
    assert rel(nhwc(got), np.asarray(want.astype(jnp.float32))) < (
        1e-5 if dtype == "float32" else 4e-3)
    # a float32 input to a bfloat16 GroupNorm (the FPN's top-down sums) still
    # comes back in bfloat16, as flax's does
    assert gn(nchw(x)).dtype == tdt


def test_gn_resnet_levels_match_flax(pair):
    """The bottleneck [3, 4, 6, 3] GroupNorm ResNet (stem conv with a bias,
    init_gn, ReLU, max-pool), eval mode, float32: its three levels at
    16x24, 8x12 and 4x6 to 1e-4."""
    _, variables, image = pair
    sub = {"params": variables["params"]["backone"]}
    x = image - PIXEL_MEAN
    net = JaxPreActResNet(block_list=(3, 4, 6, 3), init_conv_filters=16, width_base=16,
                          is_bottleneck=True, norm="gn")
    want = jax.jit(lambda v, x: net.apply(v, x, False))(sub, jnp.asarray(x))
    pm = port_model(variables, mode="test")
    with torch.no_grad():
        got = pm.net.backone(nchw(x))
    assert [tuple(g.shape[1:]) for g in got] == [(128, 16, 24), (256, 8, 12),
                                                  (512, 4, 6)]
    for g, w in zip(got, want):
        assert rel(nhwc(g), np.asarray(w)) < 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fcos_net_matches_tpudet(pair, dtype):
    """Eval mode at 128x192: the five levels' (pconf, preg, pcenter), and
    the parameter counts agree. bfloat16 rounds after every one of ~60
    convolutions: the port's own two summation orders differ by 3-7% at the
    heads, so bfloat16 is held to 4x that, per output."""
    jm, variables, image = pair
    x = image - PIXEL_MEAN
    net = jax_fcos.FCOSNet(num_classes=NUM_CLASSES, dtype=getattr(jnp, dtype))
    want = jax.jit(lambda v, x: net.apply(v, x, False))(variables, jnp.asarray(x))
    pm = port_model(variables, mode="test", compute_dtype=dtype)
    with torch.no_grad():
        got = pm.net(nchw(x))
        with torch.backends.mkldnn.flags(enabled=False):  # the other summation order
            other = pm.net(nchw(x))
    assert [tuple(lvl[0].shape[2:]) for lvl in got] == [(16, 24), (8, 12), (4, 6), (2, 3),
                                                         (1, 2)]
    assert all(t.dtype == torch.float32 for t in leaves(got))
    check_outputs(got, want, 1e-4 if dtype == "float32" else 2e-2, other)
    assert sum(p.numel() for p in pm.net.parameters()) == sum(
        np.size(v) for v in jax.tree.leaves(variables["params"]))
    assert not dict(pm.net.named_buffers())  # GroupNorm keeps no statistics


def _level_shapes(h, w):
    """P3..P7 sizes under SAME padding (the stem and pool /4, then /2)."""
    out = []
    for stride in t_fcos.STRIDES:
        out.append((-(-h // stride), -(-w // stride)))
    return out


def _heads(rng, b, hw):
    """Random NHWC level outputs: logits, positive distances (``exp`` of a
    normal) and centerness logits."""
    return [(rng.normal(-1.0, 1.5, (b, fh, fw, NUM_CLASSES)).astype(np.float32),
             np.exp(rng.normal(1.0, 1.0, (b, fh, fw, 4))).astype(np.float32),
             rng.normal(0.0, 1.5, (b, fh, fw, 1)).astype(np.float32))
            for fh, fw in _level_shapes(*hw)]


def _edge_gt():
    """``gt [2, 12, 5]`` at 800x1200: gts whose ``sqrt(h w)`` is exactly 64,
    128, 256 and 512 (each trains two levels, Q10), two of equal area on the
    same center (a minimum-area tie: both kept), one above 512, labels 20
    and -1 (out of range: zero one-hot rows), and a second image of two
    ordinary gts."""
    gt = -np.ones((2, 12, 5), np.float32)
    gt[0, :9] = [[200, 300, 64, 64, 1],
                 [400, 600, 128, 128, 2],
                 [500, 500, 256, 256, 3],
                 [600, 900, 100, 200, 4],
                 [600, 900, 200, 100, 5],
                 [400, 600, 512, 512, 6],
                 [420, 640, 600, 700, 7],
                 [100, 100, 40, 60, NUM_CLASSES],
                 [700, 1100, 90, 120, -1]]
    gt[1, :2] = [[300, 300, 150, 90, 0], [650, 1000, 40, 30, 19]]
    return gt


@pytest.mark.parametrize("form", ["ca", "ac", "consistent"])
def test_fcos_loss_matches_tpudet(form, monkeypatch):
    """``fcos_loss`` on the same head tensors at the training script's 800x1200
    (levels 100x150 ... 7x10), batch 2, against tpudet's default ``[G, P]``
    form (``ca``), its ``[fh, fw, G]`` form (``ac``) and the
    ``consistent_objective`` loss: the value to 1e-5 relative and the
    gradients of every head tensor to 1e-5 of their largest entry (the same
    formulas, sums in other orders)."""
    monkeypatch.setenv("TPUDET_SSD_CONF_LAYOUT", "ac" if form == "ac" else "ca")
    consistent = form == "consistent"
    heads = _heads(np.random.default_rng(4), 2, DRIVER_HW)
    gt = _edge_gt()

    def jax_loss(flat):
        lv = [tuple(flat[3 * i:3 * i + 3]) for i in range(len(heads))]
        return jax_fcos.fcos_loss(lv, jnp.asarray(gt), NUM_CLASSES, consistent=consistent)

    flat = [jnp.asarray(t) for lvl in heads for t in lvl]
    want, want_g = jax.jit(jax.value_and_grad(jax_loss))(flat)
    ts = [nchw(t).requires_grad_() for lvl in heads for t in lvl]
    got = t_fcos.fcos_loss([tuple(ts[3 * i:3 * i + 3]) for i in range(len(heads))],
                           torch.tensor(gt), NUM_CLASSES, consistent=consistent)
    got_g = torch.autograd.grad(got, ts)
    assert np.isfinite(float(want)) and float(want) > 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for g, w in zip(got_g, want_g):
        w = np.asarray(w)
        assert np.abs(nhwc(g) - w).max() <= 1e-5 * max(np.abs(w).max(), 1e-30)


def test_fcos_loss_ties_and_band_edges_route_as_tpudet():
    """The routing itself: a gt of size exactly 64 (and 512) trains two
    levels, and at a location inside both tied gts the targets mix their
    distances (ties keep all minima) as tpudet's do, exactly."""
    from tpudet.ops import matching as jax_matching
    from tpudet_torch.ops import matching as t_matching

    gt = _edge_gt()
    heads = _heads(np.random.default_rng(5), 2, DRIVER_HW)
    g_j = jax_matching.unpack_gt(jnp.asarray(gt[0]))
    g_t = t_matching.unpack_gt(torch.tensor(gt[:1]))
    for lvl, band, stride in zip(heads, t_fcos.SIZE_BANDS, t_fcos.STRIDES):
        pconf, preg, pcen = (t[:1] for t in lvl)
        want = jax.jit(lambda a, b, c: jax_fcos._level_loss(
            a, b, c, g_j, band, float(stride), NUM_CLASSES, consistent=True))(
            jnp.asarray(pconf[0]), jnp.asarray(preg[0]), jnp.asarray(pcen[0]))
        got = t_fcos._level_loss(nchw(pconf), nchw(preg), nchw(pcen), g_t, band,
                                 float(stride), NUM_CLASSES, consistent=True)
        assert float(got[3][0]) == float(want[3])  # positive locations, exactly
        np.testing.assert_allclose([float(t[0]) for t in got[:3]],
                                   [float(t) for t in want[:3]], rtol=1e-5)
    size = np.sqrt(gt[0, :7, 2] * gt[0, :7, 3])
    assert {64.0, 128.0, 256.0, 512.0} <= set(size.tolist())


@pytest.mark.parametrize("emit_all", [False, True])
@pytest.mark.parametrize("hw", [HW, DRIVER_HW])
def test_fcos_decode_picks_match_tpudet(hw, emit_all):
    """One image's decode on the same head tensors (the 512 rows of 128x192,
    the 20,017 of 800x1200), tpudet's with a pre-top-k wide enough that it
    does not truncate: the valid flags and class ids exactly (19 classes,
    Q9; 20 with ``emit_all_classes``), scores to 1e-6 and boxes to 1e-5
    relative (``sigmoid`` may round differently by an ulp)."""
    heads = _heads(np.random.default_rng(6), 1, hw)
    thr = 0.3 if hw == HW else 0.55
    want = jax_fcos.fcos_decode([tuple(jnp.asarray(t[0]) for t in lvl) for lvl in heads],
                                NUM_CLASSES, thr, 0.45, 10, pre_topk=4096,
                                emit_all_classes=emit_all)
    assert not bool(want[4])
    got = t_fcos.fcos_decode([tuple(nchw(t)[0] for t in lvl) for lvl in heads],
                             NUM_CLASSES, thr, 0.45, 10, emit_all_classes=emit_all)
    c_emit = NUM_CLASSES if emit_all else NUM_CLASSES - 1
    assert got[0].shape == (c_emit * 10,)
    w_scores, w_boxes, w_cid, w_valid = (np.asarray(t) for t in want[:4])
    valid = got[3].numpy()
    np.testing.assert_array_equal(valid, w_valid)
    assert valid.sum() > 20
    np.testing.assert_array_equal(got[2].numpy()[valid], w_cid[w_valid])
    np.testing.assert_allclose(got[0].numpy()[valid], w_scores[w_valid], rtol=1e-6)
    np.testing.assert_allclose(got[1].numpy()[valid], w_boxes[w_valid], rtol=1e-5,
                               atol=1e-3)


def test_fcos_test_one_image_matches_tpudet(pair):
    """``test_one_image`` on both sides at 128x192: the same classes, scores
    to 1e-4 (the same picks: the network outputs differ by float32
    rounding)."""
    jm, variables, image = pair
    pm = port_model(variables, mode="test")
    got = pm.test_one_image(image)
    want = [np.asarray(w) for w in jm.test_one_image(image)]
    assert len(want[0]) > 0
    assert want[2].max() < NUM_CLASSES - 1  # Q9
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-5)
    # a box is a location minus exp(regression), times up to 128 pixels: the
    # outputs' float32 rounding moves it by ~1e-5 of the boxes' scale
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4,
                               atol=1e-4 * np.abs(want[1]).max())


def batch(seed, hw=HW):
    """Two seeded ``hw`` images with gts on every level that 128x192 can
    hold (scaled with ``hw``), and one out-of-range label."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 255, (2, *hw, 3)).astype(np.float32)
    gt = -np.ones((2, 8, 5), np.float32)
    gt[0, :4] = [[40, 60, 32, 40, 1], [64, 96, 64, 64, 2], [70, 100, 100, 150, 3],
                 [30, 150, 20, 30, NUM_CLASSES]]
    gt[1, :3] = [[60, 90, 120, 170, 4], [20, 20, 16, 16, 5], [90, 40, 50, 60, 19]]
    gt[..., :4] *= hw[0] / HW[0]
    gt[gt[..., 0] < 0] = -1
    return images, gt


def test_fcos_train_one_epoch_runs_and_saves(tmp_path):
    """``train_one_epoch`` over a two-step feed, then the port's ``.pt``
    round trip: the net, the velocity and the step restore exactly."""
    images, gt = batch(9)

    def batches():
        while True:
            yield images, gt

    pm = FCOS(config(), {"num_train": 4, "train_generator": batches()}, device="cpu")
    mean = pm.train_one_epoch(0.01)
    assert np.isfinite(mean) and pm.global_step == 2
    pm.save_weight("latest", str(tmp_path / "fcos"))
    other = FCOS(config(seed=5), device="cpu")
    other.load_weight(str(tmp_path / "fcos"))
    for k, v in pm.net.state_dict().items():
        assert torch.equal(other.net.state_dict()[k], v), k
    for k, v in pm.velocity.items():
        assert torch.equal(other.velocity[k], v), k
    assert other.global_step == 2


def test_tpudet_fcos_file_loads_into_the_port(tmp_path, pair):
    """tpudet's ``save_weight`` (GroupNorm params, empty ``batch_stats``, a
    non-zero Momentum velocity, step 7) through the port's ``load_weight``:
    the same tensors, velocity and step; its ``backone`` through
    ``load_pretrained_weight`` into a port model of other weights, which
    keeps the rest."""
    jm, variables, _ = pair
    rng = np.random.default_rng(1)
    velocity = tree_like(variables["params"],
                         lambda v: rng.normal(size=np.shape(v)).astype(np.float32))
    jm.opt_state = jax_optim.MomentumState(velocity)
    jm.global_step = 7
    try:
        jm.save_weight("latest", str(tmp_path / "model"))
    finally:
        jm.opt_state, jm.global_step = None, 0
    want = transfer.from_flax(variables)
    assert any(k.endswith(".gn.scale") for k in want) and "backone.init_gn.bias" in want

    pm = FCOS(config(seed=11), device="cpu")
    pm.load_weight(str(tmp_path / "model"))
    got = pm.net.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    for k, v in transfer.velocity_from_flax(velocity).items():
        assert torch.equal(pm.velocity[k], v), k
    assert pm.global_step == 7

    other = FCOS(config(seed=12), device="cpu")
    before = {k: v.clone() for k, v in other.net.state_dict().items()}
    other.load_pretrained_weight(str(tmp_path / "model"))
    after = other.net.state_dict()
    for k in want:
        assert torch.equal(after[k], want[k] if k.startswith("backone.") else before[k]), k


def test_fcos_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FCOS(config())
