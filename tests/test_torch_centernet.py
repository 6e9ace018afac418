"""The port's CenterNet against tpudet's on the same numpy inputs, at input 64
and the training script's full width: the DLA levels and the deconvolution
neck, the net in float32 and bfloat16, the basic block's shortcut
statistics (the quirk), ``centernet_loss`` in both of tpudet's layouts with
out-of-range labels, the tie-stable decode, one TF-style Adam update bit for
bit, float32 and bfloat16 train steps with Adam, ``test_one_image`` and
tpudet's ``.tpudet`` files with Adam's state. Network and step tolerances
and their reasons are in ``tests/torch_anchor_free_common.py``; the others
are stated in each test.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.heads import centernet as jax_center
from tpudet.models.centernet import CenterNet as JaxCenterNet
from tpudet.nn.backbones import dla as jax_dla
from tpudet.runtime import optim as jax_optim
from tpudet_torch.heads import centernet as t_center
from tpudet_torch.models import CenterNet
from tpudet_torch.nn.backbones import dla as t_dla
from tpudet_torch.runtime import optim as t_optim
from tpudet_torch.runtime import transfer
from torch_anchor_free_common import (check_outputs, check_step, port_opt_state,
                                      random_opt_state, seeded_pair)
from torch_refine_common import nchw, nhwc, rel, tree_like

torch.set_num_threads(1)

SIZE = 64
NUM_CLASSES = 20
DRIVER_MAP = 96  # 384 / 4


def config(**kw):
    """``drivers/testcenternet.py``'s config at input 64 and batch 2."""
    cfg = {"mode": "train", "input_size": SIZE, "data_format": "channels_last",
           "num_classes": NUM_CLASSES, "weight_decay": 1e-4, "keep_prob": 0.5,
           "batch_size": 2, "score_threshold": 0.1, "top_k_results_output": 100,
           "seed": 3}
    cfg.update(kw)
    return cfg


@pytest.fixture(scope="module")
def pair():
    jm, variables = seeded_pair(JaxCenterNet, config(mode="test"), (SIZE, SIZE))
    image = np.random.default_rng(7).uniform(0, 255, (1, SIZE, SIZE, 3)).astype(np.float32)
    return jm, variables, image


def port_model(variables, **kw):
    pm = CenterNet(config(**kw), device="cpu")
    transfer.load_flax(pm.net, variables)
    return pm


def _x(jm, image):
    """tpudet's preprocessing: ``(x / 255 - mean) / std``."""
    return np.asarray(jm._preprocess(jnp.asarray(image)))


def test_dla_levels_and_neck_match_flax(pair):
    """Eval mode, float32, at 64x64: stages 4-6 (8x8, 4x4, 2x2) and the
    stride-4 neck output (16x16x256) to 1e-4."""
    jm, variables, image = pair
    x = jnp.asarray(_x(jm, image))
    sub = {c: variables[c]["backone"] for c in variables}
    up = {c: variables[c]["upsampling"] for c in variables}
    want = jax.jit(lambda v, x: jax_dla.DLABackbone().apply(v, x, False))(sub, x)
    want_f = jax.jit(lambda v, s: jax_dla.DLAUp().apply(v, *s, False))(up, want)
    backone, neck = t_dla.DLABackbone(), t_dla.DLAUp()
    transfer.load_flax(backone, sub)
    transfer.load_flax(neck, up)
    with torch.no_grad():
        got = backone.eval()(nchw(np.asarray(x)))
        got_f = neck.eval()(*got)
    assert [tuple(g.shape[1:]) for g in got] == [(128, 8, 8), (256, 4, 4), (512, 2, 2)]
    assert tuple(got_f.shape[1:]) == (256, 16, 16)
    for g, w in zip(list(got) + [got_f], list(want) + [want_f]):
        assert rel(nhwc(g), np.asarray(w)) < 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_centernet_net_matches_tpudet(pair, dtype):
    """Eval mode: keypoints, offset and size at 16x16 in float32; parameter
    and statistics counts agree."""
    jm, variables, image = pair
    x = _x(jm, image)
    net = jax_center.CenterNetNet(num_classes=NUM_CLASSES, dtype=getattr(jnp, dtype))
    want = jax.jit(lambda v, x: net.apply(v, x, False))(variables, jnp.asarray(x))
    pm = port_model(variables, mode="test", compute_dtype=dtype)
    with torch.no_grad():
        got = pm.net(nchw(x))
        with torch.backends.mkldnn.flags(enabled=False):  # the other summation order
            other = pm.net(nchw(x))
    assert [tuple(t.shape[1:]) for t in got] == [(NUM_CLASSES, 16, 16), (2, 16, 16),
                                                  (2, 16, 16)]
    assert all(t.dtype == torch.float32 for t in got)
    check_outputs(got, want, 1e-4 if dtype == "float32" else 2e-2, other)
    assert sum(p.numel() for p in pm.net.parameters()) == sum(
        np.size(v) for v in jax.tree.leaves(variables["params"]))
    assert sum(b.numel() for b in pm.net.buffers()) == sum(
        np.size(v) for v in jax.tree.leaves(variables["batch_stats"]))


def test_dla_shortcut_statistics_move_as_tpudets(pair):
    """One train-mode forward at batch 2: every running statistic matches
    tpudet's to 1e-4 (per tensor, normwise), those of the shortcut ConvBNs
    that a block computes and then drops for the identity included, and
    those moved (the quirk, ``tpudet/nn/backbones/dla.py:48-51``)."""
    jm, variables, image = pair
    rng = np.random.default_rng(3)
    images = rng.uniform(0, 255, (2, SIZE, SIZE, 3)).astype(np.float32)
    x = _x(jm, images)
    _, mut = jax.jit(lambda v, x: jm.net.apply(v, x, True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    want = transfer.from_flax({"batch_stats": jax.device_get(mut["batch_stats"])})
    before = transfer.from_flax({"batch_stats": variables["batch_stats"]})
    pm = port_model(variables)
    with torch.no_grad():
        pm.net.train()(nchw(x))
    got = pm.net.state_dict()
    dropped = [k for k in want if ".block2.shortcut.bn." in k]
    assert "backone.stage3.block2.shortcut.bn.mean" in dropped
    for k in dropped:
        assert not torch.equal(want[k], before[k]), k
    for k in want:
        assert rel(got[k].numpy(), want[k].numpy()) < 1e-4, k


def _heads(rng, b, n=DRIVER_MAP):
    return [rng.normal(m, s, (b, n, n, c)).astype(np.float32)
            for m, s, c in ((-2.0, 1.5, NUM_CLASSES), (0.5, 0.3, 2), (3.0, 2.0, 2))]


def _gt_with_bad_labels():
    """``gt [2, 10, 5]`` at 384x384: ordinary gts and valid ones labelled -1
    and -20 (tpudet wraps them to 19 and 0 at the center cell), 20 and -21
    (dropped there); every label outside [0, 20) adds nothing to the
    per-class reduction."""
    gt = -np.ones((2, 10, 5), np.float32)
    gt[0, :6] = [[100, 120, 60, 80, 3], [200, 250, 120, 40, -1], [300, 80, 30, 30, 20],
                 [50, 300, 70, 90, -21], [150, 150, 200, 180, 7], [250, 330, 40, 50, -20]]
    gt[1, :3] = [[192, 192, 100, 100, 0], [40, 60, 30, 20, 19], [330, 300, 50, 60, 5]]
    return gt


@pytest.mark.parametrize("layout", ["ca", "ac"])
def test_centernet_loss_matches_tpudet(layout, monkeypatch):
    """``centernet_loss`` on the same head tensors at the training script's 96x96
    map, batch 2, against tpudet's ``[C, P]`` (default) and ``[h, w, C]``
    layouts, with the out-of-range labels of :func:`_gt_with_bad_labels`:
    the value to 3e-5 relative and the gradients to 1e-5 of their largest
    entry (the same formulas, sums in other orders: over these 184,320
    focal terms an image, tpudet's two layouts differ by 1.3e-5 between
    themselves, and the port's float64 loss is within 1e-8 of the ``[C,
    P]`` one)."""
    monkeypatch.setenv("TPUDET_SSD_CONF_LAYOUT", layout)
    heads = _heads(np.random.default_rng(4), 2)
    gt = _gt_with_bad_labels()
    want, want_g = jax.jit(jax.value_and_grad(
        lambda h: jax_center.centernet_loss(*h, jnp.asarray(gt), NUM_CLASSES)))(
        [jnp.asarray(h) for h in heads])
    ts = [nchw(h).requires_grad_() for h in heads]
    got = t_center.centernet_loss(*ts, torch.tensor(gt), NUM_CLASSES)
    got_g = torch.autograd.grad(got, ts)
    assert np.isfinite(float(want))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=3e-5)
    for g, w in zip(got_g, want_g):
        w = np.asarray(w)
        assert np.abs(nhwc(g) - w).max() <= 1e-5 * np.abs(w).max()


def test_zero_size_gt_gives_nan_as_tpudet():
    """A valid gt of zero height makes the image's sigma 0: tpudet's loss is
    NaN, and the port's too (no guard)."""
    heads = _heads(np.random.default_rng(5), 1, 24)
    gt = -np.ones((1, 4, 5), np.float32)
    gt[0, :2] = [[40, 40, 0, 20, 1], [60, 50, 20, 20, 2]]
    want = jax_center.centernet_loss(*[jnp.asarray(h) for h in heads], jnp.asarray(gt),
                                     NUM_CLASSES)
    got = t_center.centernet_loss(*[nchw(h) for h in heads], torch.tensor(gt), NUM_CLASSES)
    assert np.isnan(float(want)) and np.isnan(float(got))


def test_centernet_decode_matches_top_k_with_ties():
    """One image's decode at 96x96 with logits on a coarse grid, so that many
    peaks tie: the picks in ``jax.lax.top_k``'s order (ties to the lowest
    index), their classes (``jnp.argmax``'s first maximum) and valid flags
    exactly; scores to 1e-6 and boxes to 1e-5 relative (``sigmoid`` may
    round differently by an ulp)."""
    rng = np.random.default_rng(6)
    heads = _heads(rng, 1)
    heads[0] = np.round(heads[0] * 2.0) / 2.0  # ties within and across cells
    want = [np.asarray(t) for t in jax_center.centernet_decode(
        *[jnp.asarray(h[0]) for h in heads], 0.1, 100)]
    got = [t.numpy() for t in t_center.centernet_decode(*[nchw(h)[0] for h in heads],
                                                        0.1, 100)]
    assert len(np.unique(want[0])) < 50  # the 100 scores hold ties
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-4)
    assert got[3].sum() > 10


def test_adam_update_equals_tpudets_bit_for_bit():
    """Three TF-style Adam updates on float32 trees with gradients over seven
    decades: parameters, moments and count equal tpudet's exactly."""
    rng = np.random.default_rng(8)
    params = {"a": {"conv": {"kernel": rng.normal(size=(3, 3, 4, 8)).astype(np.float32),
                             "bias": rng.normal(size=(8,)).astype(np.float32)}},
              "b": {"gn": {"scale": rng.normal(size=(8,)).astype(np.float32)}}}
    jax_adam, port_adam = jax_optim.Adam(), t_optim.Adam()
    j_params, j_state = params, jax_adam.init(params)
    t_params = transfer.velocity_from_flax(params)
    t_state = port_adam.init(t_params)
    for _ in range(3):
        grads = tree_like(params, lambda v: (rng.normal(size=np.shape(v))
                                             * 10.0 ** rng.uniform(-6, 1, np.shape(v)))
                          .astype(np.float32))
        j_params, j_state = jax_adam.update(grads, j_state, j_params, jnp.float32(1e-3))
        port_adam.update(transfer.velocity_from_flax(grads), t_state, t_params, 1e-3)
    want = port_opt_state(j_state)
    assert int(t_state["count"]) == int(want["count"]) == 3
    for got, exp in ((t_params, transfer.velocity_from_flax(jax.device_get(j_params))),
                     (t_state["mu"], want["mu"]), (t_state["nu"], want["nu"])):
        for k in exp:
            assert torch.equal(got[k], exp[k]), k


def _batch(seed, size=SIZE):
    """Two seeded images with gts scaled to ``size``, labels -1 and 20 among
    them."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 255, (2, size, size, 3)).astype(np.float32)
    gt = -np.ones((2, 6, 5), np.float32)
    gt[0, :3] = [[20, 30, 16, 20, 1], [40, 40, 30, 24, 3], [50, 12, 10, 12, -1]]
    gt[1, :2] = [[32, 32, 40, 36, 19], [12, 50, 8, 10, NUM_CLASSES]]
    gt[..., :4] *= size / SIZE
    gt[gt[..., 0] < 0] = -1
    return images, gt


@pytest.mark.parametrize("dtype,size", [("float32", 128), ("bfloat16", SIZE)])
def test_centernet_train_step_matches_tpudet(pair, dtype, size):
    """One Adam step at batch 2, lr 1e-3, weight decay 1e-4, from the same
    variables and moments (count 3), held as ``torch_anchor_free_common``
    says: the statistics of the dropped shortcuts and Adam's moments of
    their parameters included. float32 runs at 128x128: Adam normalises
    every update, so the rounding noise of gradients that are 0 in exact
    arithmetic (a conv bias before BatchNorm) becomes a full-size step, and
    at 64x64 train-mode BatchNorm over batch 2 at stage 6's 2x2 map moves
    that noise by 5x what the port's own two orders show (at 128x128, by
    1.3x)."""
    jm, variables, _ = pair
    jm = copy.copy(jm)
    jm.net = jax_center.CenterNetNet(num_classes=NUM_CLASSES, dtype=getattr(jnp, dtype))
    jm._optimizer = jax_optim.Adam()
    pm = port_model(variables, compute_dtype=dtype, input_size=size)
    assert np.isfinite(check_step(jm, pm, variables, *_batch(9, size), 1e-3, 1e-4, dtype))


def test_centernet_test_one_image_matches_tpudet(pair):
    """``test_one_image`` on both sides: the same classes, scores to 1e-4,
    boxes to 1e-4 of their scale (the network outputs differ by float32
    rounding)."""
    jm, variables, image = pair
    pm = port_model(variables, mode="test")
    got = pm.test_one_image(image)
    want = [np.asarray(w) for w in jm.test_one_image(image)]
    assert len(want[0]) > 0
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4,
                               atol=1e-4 * np.abs(want[1]).max())


def test_tpudet_centernet_file_loads_into_the_port(tmp_path, pair):
    """tpudet's ``save_weight`` (statistics, Adam's count 5 and moments, step
    7) through the port's ``load_weight``: the same tensors, state and step;
    the port's ``.pt`` round trip keeps Adam's state; and
    ``load_pretrained_weight`` takes the ``backone`` parameters only, as
    tpudet's does, so the port's statistics stay."""
    jm, variables, _ = pair
    rng = np.random.default_rng(1)
    state = random_opt_state(jm, variables["params"], rng)._replace(count=np.int32(5))
    jm.opt_state, jm.global_step = state, 7
    try:
        jm.save_weight("latest", str(tmp_path / "model"))
    finally:
        jm.opt_state, jm.global_step = None, 0
    want = transfer.from_flax(variables)
    want_state = port_opt_state(state)

    pm = CenterNet(config(seed=11), device="cpu")
    pm.load_weight(str(tmp_path / "model"))
    got = pm.net.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert int(pm.opt_state["count"]) == 5 and pm.global_step == 7
    for part in ("mu", "nu"):
        for k, v in want_state[part].items():
            assert torch.equal(pm.opt_state[part][k], v), (part, k)

    pm.save_weight("latest", str(tmp_path / "port"))
    other = CenterNet(config(seed=12), device="cpu")
    other.load_weight(str(tmp_path / "port"))
    assert int(other.opt_state["count"]) == 5
    for part in ("mu", "nu"):
        for k, v in pm.opt_state[part].items():
            assert torch.equal(other.opt_state[part][k], v), (part, k)

    fresh = CenterNet(config(seed=13), device="cpu")
    before = {k: v.clone() for k, v in fresh.net.state_dict().items()}
    fresh.load_pretrained_weight(str(tmp_path / "model"))
    after = fresh.net.state_dict()
    params = dict(fresh.net.named_parameters())
    for k in want:
        moved = k.startswith("backone.") and k in params
        assert torch.equal(after[k], want[k] if moved else before[k]), k


def test_centernet_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CenterNet(config())


def test_centernet_keeps_no_kernel_on_its_paths(pair, monkeypatch):
    """Neither the loss nor the decode reaches a kernel wrapper: both run
    with the NMS and assignment wrappers made to raise."""
    from tpudet_torch.ops.cuda import assign_kernel, nms_kernel

    def boom(*a, **k):
        raise AssertionError("a kernel wrapper was called")

    monkeypatch.setattr(nms_kernel, "nms_rows", boom)
    monkeypatch.setattr(assign_kernel, "assign_anchors", boom)
    heads = [nchw(h) for h in _heads(np.random.default_rng(2), 2, 16)]
    gt = torch.tensor(_batch(3)[1])
    assert torch.isfinite(t_center.centernet_loss(*heads, gt, NUM_CLASSES))
    t_center.centernet_decode(*[h[0] for h in heads], 0.1, 100)
