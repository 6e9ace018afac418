"""The port's SSD training slice against tpudet's on the same numpy inputs.

tpudet's step is built here from its parts (``net.apply(..., mutable=
["batch_stats"])``, ``_loss_from_outputs``, ``global_l2``, ``optim.Momentum``
under ``jax.value_and_grad``): its ``DetectorBase`` pads a batch up to the
8-device CPU mesh of ``conftest.py`` with duplicate rows, which would enter the
BatchNorm statistics. tpudet's conf CE runs in its ``ac`` layout (set with
``TPUDET_SSD_CONF_LAYOUT``), the port's layout, so both sides mine on the same
scores up to float32 rounding.

Tolerances, each with its reason:
  * loss terms on identical head outputs: 1e-5 relative (XLA and PyTorch sum
    in other orders; the mining picks are the same);
  * a whole float32 step: 1e-4 relative, normwise per tensor (convolutions
    sum in another order through forward and backward);
  * a whole bfloat16 step: 1e-2 relative on the loss and running statistics
    (bf16 rounds after every convolution, in other places in the two
    frameworks, and mining then picks on differently rounded scores; the
    parameters' gradients are not compared in bf16, since for small tensors
    such as biases they differ by tens of percent).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from tpudet.heads import ssd as jax_ssd
from tpudet.models import base as jax_base
from tpudet.models.ssd import SSD300 as JaxSSD300
from tpudet.nn import layers as jax_layers
from tpudet.ops import losses as jax_losses
from tpudet.runtime import optim as jax_optim
from tpudet_torch.heads import ssd as t_ssd
from tpudet_torch.models import base as t_base
from tpudet_torch.models.ssd import SSD300, _ssd_feat_shapes
from tpudet_torch.nn import layers as t_layers
from tpudet_torch.ops import losses as t_losses
from tpudet_torch.ops.cuda import assign_kernel, nms_kernel
from tpudet_torch.runtime import optim as t_optim
from tpudet_torch.runtime import transfer
from torch_assign_cases import rand_gt

torch.set_num_threads(1)

PIXEL_MEAN = np.asarray([123.68, 116.779, 103.979], np.float32)


class _JaxSSD76(JaxSSD300):
    input_size = 76


class SSD76(SSD300):
    input_size = 76


def _config(**kw):
    cfg = {"mode": "train", "data_format": "channels_last", "num_classes": 20,
           "batch_size": 2, "weight_decay": 1e-4, "nms_score_threshold": 0.5,
           "nms_max_boxes": 20, "nms_iou_threshold": 0.5, "pretraining_weight": None,
           "hard_neg_cap": 384, "seed": 3}
    cfg.update(kw)
    return cfg


def _batch(seed, b=2, size=76):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 255, (b, size, size, 3)).astype(np.float32)
    return images, rand_gt(rng, b, 60, 6, size=float(size), n_valid_min=1)


def _nchw(x):
    return torch.tensor(np.transpose(x, (0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _rel(got, want):
    """Normwise relative difference."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _tree_like(tree, fn):
    return {k: _tree_like(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


# ------------------------------------------------------------ losses
def test_loss_primitives_match_tpudet():
    """1e-6: the same elementwise formulas in float32."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (4, 7, 21)).astype(np.float32)
    labels = rng.integers(0, 21, (4, 7)).astype(np.int32)
    w = np.asarray([1, 1, 0, 1], np.float32)
    pairs = [
        (t_losses.smooth_l1(torch.from_numpy(x)), jax_losses.smooth_l1(jnp.asarray(x))),
        (t_losses.log_softmax(torch.from_numpy(x)), jax_losses.log_softmax(jnp.asarray(x))),
        (t_losses.ce_from_log_probs(t_losses.log_softmax(torch.from_numpy(x)),
                                    torch.from_numpy(labels)),
         jax_losses.ce_from_log_probs(jax_losses.log_softmax(jnp.asarray(x)),
                                      jnp.asarray(labels))),
        (t_losses.softmax_cross_entropy(torch.from_numpy(x), torch.from_numpy(labels)),
         jax_losses.softmax_cross_entropy(jnp.asarray(x), jnp.asarray(labels))),
        (t_losses.weighted_mean(torch.from_numpy(x[:, 0, 0]), torch.from_numpy(w)),
         jax_losses.weighted_mean(jnp.asarray(x[:, 0, 0]), jnp.asarray(w))),
        (t_losses.weighted_mean(torch.from_numpy(x[:, 0, 0])),
         jax_losses.weighted_mean(jnp.asarray(x[:, 0, 0]))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_take_last_matches_take_along_axis():
    """Indices in [-C, C) wrap, others give NaN and a zero gradient, as
    ``jnp.take_along_axis`` does; nothing raises."""
    x = np.arange(10, dtype=np.float32).reshape(2, 5)
    idx = np.asarray([[-1, -5, -6, 5, 7, 0], [4, 2, -2, 9, -7, 3]], np.int32)

    def jax_take(v):
        return jnp.take_along_axis(v, jnp.asarray(idx), axis=-1)

    want = np.asarray(jax_take(jnp.asarray(x)))
    tx = torch.tensor(x, requires_grad=True)
    got = torch.stack([t_losses.take_last(tx, torch.from_numpy(idx[:, k]))
                       for k in range(idx.shape[1])], -1)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    assert np.isnan(want).sum() == 5
    w = np.asarray(jax.grad(lambda v: jnp.nansum(jax_take(v)))(jnp.asarray(x)))
    g = torch.autograd.grad(torch.nansum(got), tx)[0].numpy()
    np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def anchors76():
    shapes = _ssd_feat_shapes(76, SSD300.extra_strides)
    return jax_ssd.build_anchors(76, shapes), t_ssd.build_anchors(76, shapes)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ssd_loss_and_gradients_match_tpudet(monkeypatch, anchors76, seed):
    """fp32, on the same head outputs (B 2, input 76, cap 384): loss to 1e-5
    relative, gradients w.r.t. pconf/pyx/phw to 1e-5 of their largest entry."""
    monkeypatch.setenv("TPUDET_SSD_CONF_LAYOUT", "ac")
    janc, tanc = anchors76
    rng = np.random.default_rng(seed)
    a = tanc.yx.shape[0]
    heads = [rng.normal(0, 2, (2, a, 21)).astype(np.float32),
             rng.normal(0, 0.5, (2, a, 2)).astype(np.float32),
             rng.normal(0, 0.5, (2, a, 2)).astype(np.float32)]
    gt = rand_gt(rng, 2, 60, 6, size=76.0, n_valid_min=1)

    def jax_loss(c, y, h):
        return jax_ssd.ssd_loss(c, y, h, janc, jnp.asarray(gt), 21, neg_sel_cap=384)

    want, wgrads = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, heads))

    picks = []
    real = nms_kernel.batched_greedy_nms_pretopk
    monkeypatch.setattr(nms_kernel, "batched_greedy_nms_pretopk",
                        lambda *a: picks.append(real(*a)) or picks[-1])
    tt = [torch.tensor(h, requires_grad=True) for h in heads]
    got = t_ssd.ssd_loss(*tt, tanc, torch.from_numpy(gt), 21, neg_sel_cap=384)
    grads = torch.autograd.grad(got, tt)
    assert len(picks) == 1 and int(picks[0][1].sum()) > 0  # mining picked negatives
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for g, w in zip(grads, wgrads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
    # the gradient reaches the background logit only at positives and picks
    bg_grad = grads[0][..., 20].numpy()
    assert 0 < (bg_grad != 0).sum() < bg_grad.size


# ------------------------------------------------------------ layers
def _random_stats(tree, rng):
    return _tree_like(tree, lambda v: rng.uniform(0.5, 2.0, np.shape(v)).astype(np.float32))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_train_mode_conv_bn_matches_flax(dtype, tol):
    """Output and updated running statistics: 1e-5 in fp32; bf16 rounds the
    conv output, so 1e-2 there (normwise)."""
    rng = np.random.default_rng(12)
    x = rng.normal(-0.5, 1.0, (3, 9, 9, 5)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    mod = jax_layers.ConvBN(6, 3, stride=2, activation=fnn.relu, dtype=jdt)
    variables = jax.device_get(mod.init(jax.random.PRNGKey(4), jnp.asarray(x), False))
    variables = {"params": variables["params"],
                 "batch_stats": _random_stats(variables["batch_stats"], rng)}
    want, mut = mod.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    port = t_layers.ConvBN(5, 6, 3, 2, activation=torch.relu,
                           dtype=getattr(torch, dtype))
    transfer.load_flax(port, variables)
    got = port.train()(_nchw(x))
    assert got.dtype == getattr(torch, dtype)
    assert _rel(_nhwc(got), np.asarray(want, np.float32)) < tol
    for k in ("mean", "var"):
        assert _rel(getattr(port.bn, k).numpy(), mut["batch_stats"]["bn"][k]) < tol / 10


def test_batchnorm_variance_is_flaxs_biased_fast_form():
    """The batch variance is max(0, E[x^2] - E[x]^2), and the running update
    uses it with momentum 0.99 (torch's BatchNorm2d would use the unbiased one)."""
    x = torch.tensor([[[[1.0, 3.0]]], [[[5.0, 7.0]]]])  # [2, 1, 1, 2]: mean 4, var 5
    bn = t_layers.BatchNorm(1).train()
    y = bn(x)
    torch.testing.assert_close(bn.mean, torch.tensor([0.04]))
    torch.testing.assert_close(bn.var, torch.tensor([0.99 + 0.05]))
    torch.testing.assert_close(y, (x - 4.0) * torch.rsqrt(torch.tensor(5.0 + 1e-3)))


def test_bf16_l2norm_matches_flax():
    """bf16 in, bf16 out; 1e-2 for bf16 rounding."""
    x = np.random.default_rng(4).normal(size=(2, 6, 5, 16)).astype(np.float32)
    want = jax_layers.L2NormScale(init=20.0).apply(
        {"params": {"scale": np.asarray([17.5], np.float32)}},
        jnp.asarray(x, jnp.bfloat16))
    port = t_layers.L2NormScale(20.0)
    with torch.no_grad():
        port.scale.fill_(17.5)
    got = port(_nchw(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert _rel(_nhwc(got), np.asarray(want, np.float32)) < 1e-2


# ------------------------------------------------------------ optimizer
def test_momentum_matches_tpudet_over_three_steps():
    """1e-6 relative: the same two roundings per update."""
    rng = np.random.default_rng(6)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    opt = jax_optim.Momentum(0.9)
    jp, js = {k: jnp.asarray(v) for k, v in params.items()}, None
    js = opt.init(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    topt = t_optim.Momentum(0.9)
    tv = topt.init(tp)
    for step, lr in enumerate((0.01, 0.01, 0.001)):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        jp, js = opt.update({k: jnp.asarray(v) for k, v in grads.items()}, js, jp,
                            jnp.float32(lr))
        topt.update({k: torch.tensor(v) for k, v in grads.items()}, tv, tp, lr)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6)
            np.testing.assert_allclose(tv["velocity"][k].numpy(), np.asarray(js.velocity[k]),
                                       rtol=1e-6)


# ------------------------------------------------------------ the whole step
def _jax_step(jm, params, bstats, velocity, images, gt, lr, wd):
    def forward_loss(p, s):
        x = jnp.asarray(images) - PIXEL_MEAN.reshape(1, 1, 1, 3)
        outputs, mut = jm.net.apply({"params": p, "batch_stats": s}, x, True,
                                    mutable=["batch_stats"])
        loss = jm._loss_from_outputs(outputs, jnp.asarray(gt), None)
        return loss + wd * jax_base.global_l2(p), mut["batch_stats"]

    def step(p, s, v):
        (loss, stats), grads = jax.value_and_grad(forward_loss, has_aux=True)(p, s)
        new_p, new_opt = jax_optim.Momentum(0.9).update(
            grads, jax_optim.MomentumState(v), p, jnp.float32(lr))
        return loss, new_p, stats, new_opt.velocity

    return jax.device_get(jax.jit(step)(params, bstats, velocity))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_tpudet(monkeypatch, dtype):
    """One step from transferred params, perturbed running statistics and a
    non-zero velocity, at input 76, batch 2. fp32: loss, params, running
    statistics and velocity to 1e-4 relative (normwise per tensor). bf16: loss
    and running statistics to 1e-2."""
    monkeypatch.setenv("TPUDET_SSD_CONF_LAYOUT", "ac")
    jm = _JaxSSD76(_config(mode="test", compute_dtype=dtype))
    rng = np.random.default_rng(21)
    params = jax.device_get(jm.params)
    bstats = _random_stats(jax.device_get(jm.batch_stats), rng)
    velocity = _tree_like(params, lambda v: (0.01 * rng.normal(size=np.shape(v)))
                          .astype(np.float32))
    images, gt = _batch(5)
    lr, wd = 0.01, 1e-4
    w_loss, w_params, w_stats, w_vel = _jax_step(jm, params, bstats, velocity, images,
                                                 gt, lr, wd)

    pm = SSD76(_config(compute_dtype=dtype), device="cpu")
    transfer.load_flax(pm.net, {"params": params, "batch_stats": bstats})
    for k, v in transfer.velocity_from_flax(velocity).items():
        pm.velocity[k].copy_(v)
    launches = (assign_kernel.launches, nms_kernel.launches)
    loss = pm.train_step(*pm._to_device(images, gt), lr)
    assert (assign_kernel.launches, nms_kernel.launches) == launches  # CPU: plain
    assert pm.global_step == 1
    got = pm.net.state_dict()
    want = transfer.from_flax({"params": w_params, "batch_stats": w_stats})
    if dtype == "float32":
        np.testing.assert_allclose(float(loss), float(w_loss), rtol=1e-4)
        worst = max(_rel(got[k].numpy(), want[k].numpy()) for k in want)
        assert worst < 1e-4, worst
        w_v = transfer.velocity_from_flax(w_vel)
        worst = max(_rel(pm.velocity[k].numpy(), w_v[k].numpy()) for k in w_v)
        assert worst < 1e-4, worst
    else:
        np.testing.assert_allclose(float(loss), float(w_loss), rtol=1e-2)
        worst = max(_rel(got[k].numpy(), want[k].numpy()) for k in want
                    if k.endswith((".mean", ".var")))
        assert worst < 1e-2, worst


def test_bf16_net_levels_match_flax_bf16():
    """compute_dtype bfloat16 builds a bf16 net for serving too: eval-mode head
    outputs within 3e-2 normwise of flax's bf16 net."""
    jm = _JaxSSD76(_config(mode="test", compute_dtype="bfloat16"))
    variables = {"params": jax.device_get(jm.params),
                 "batch_stats": jax.device_get(jm.batch_stats)}
    pm = SSD76(_config(mode="test", compute_dtype="bfloat16"), device="cpu")
    transfer.load_flax(pm.net, variables)
    images, _ = _batch(2, b=1)
    x = images - PIXEL_MEAN
    want = jm.net.apply(variables, jnp.asarray(x), False)
    with torch.no_grad():
        got = pm.net(_nchw(x))
    for w, g in zip(want, got):
        assert g.dtype == torch.bfloat16
        assert _rel(_nhwc(g), np.asarray(w, np.float32)) < 3e-2
    scores, boxes, cid = pm.test_one_image(images)
    assert np.isfinite(scores).all() and boxes.shape == (len(scores), 4)


# ------------------------------------------------------------ the trainer
class _Writer:
    def __init__(self):
        self.losses = []

    def add_summary(self, loss, global_step):
        self.losses.append((float(loss), global_step))


class _ResettableFeed:
    def __init__(self, batch):
        self.batch, self.resets = batch, 0

    def reset(self):
        self.resets += 1

    def __iter__(self):
        return self

    def __next__(self):
        return self.batch


def _fixed_feed(batch):
    while True:
        yield batch


@pytest.mark.parametrize("shape", ["tuple", "reset"])
def test_train_one_epoch_takes_both_feed_shapes(shape, capsys):
    """global_step, the exact epoch mean of the step losses, the progress line,
    and the loss falling on one fixed batch."""
    batch = _batch(7)
    inits = []
    if shape == "tuple":
        feed = (lambda: inits.append(1), _fixed_feed(batch))
    else:
        feed = _ResettableFeed(batch)
    pm = SSD76(_config(loss_sync_every=2), {"num_train": 7, "train_generator": feed},
               device="cpu")
    writer = _Writer()
    means = [pm.train_one_epoch(0.01, writer) for _ in range(2)]
    assert pm.global_step == 6  # 7 // 2 = 3 steps an epoch
    assert [s for _, s in writer.losses] == [1, 2, 3, 4, 5, 6]
    assert (len(inits) if shape == "tuple" else feed.resets) == 2
    losses = [lo for lo, _ in writer.losses]
    np.testing.assert_allclose(means, [np.mean(losses[:3]), np.mean(losses[3:])],
                               rtol=1e-6)
    assert losses[-1] < losses[0]
    assert f">> iters 2/3 loss {np.float32(losses[-1])}" in capsys.readouterr().out


def test_save_load_resume_continues_identically(tmp_path):
    """Exact: the checkpoint carries the net, BN statistics, velocity and step."""
    batch = _batch(9)
    provider = {"num_train": 4, "train_generator": (None, _fixed_feed(batch))}
    a = SSD76(_config(), provider, device="cpu")
    a.train_one_epoch(0.01)
    a.save_weight("latest", str(tmp_path / "ssd" / "model"))
    want = a.train_step(*a._to_device(*batch), 0.01)

    b = SSD76(_config(seed=11), provider, device="cpu")
    b.load_weight(str(tmp_path / "ssd" / "model"))
    assert b.global_step == 2
    got = b.train_step(*b._to_device(*batch), 0.01)
    assert float(got) == float(want)
    for k, v in a.net.state_dict().items():
        torch.testing.assert_close(b.net.state_dict()[k], v, rtol=0, atol=0)
    for k, v in a.velocity.items():
        torch.testing.assert_close(b.velocity[k], v, rtol=0, atol=0)


def test_serving_after_training_switches_modes():
    batch = _batch(3)
    pm = SSD76(_config(), device="cpu")
    pm.train_step(*pm._to_device(*batch), 0.01)
    assert pm.net.training
    scores, boxes, cid = pm.test_one_image(batch[0][:1])
    assert not pm.net.training and boxes.shape == (len(scores), 4)
    stats = pm.net.regressor.pred1.bn.mean.clone()
    pm.train_step(*pm._to_device(*batch), 0.01)
    assert pm.net.training and not torch.equal(stats, pm.net.regressor.pred1.bn.mean)


def test_to_device_takes_uint8_and_channels_first():
    images, gt = _batch(4)
    images = np.round(images)
    pm = SSD76(_config(), device="cpu")
    want, want_gt = pm._to_device(images, gt)
    assert want.shape == (2, 3, 76, 76) and want.is_contiguous()
    u8 = SSD76(_config(input_dtype="uint8"), device="cpu")
    torch.testing.assert_close(u8._to_device(images.astype(np.uint8), gt)[0], want,
                               rtol=0, atol=0)
    cf = SSD76(_config(data_format="channels_first"), device="cpu")
    got, got_gt = cf._to_device(np.transpose(images, (0, 3, 1, 2)), gt)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got_gt, want_gt, rtol=0, atol=0)


@pytest.mark.parametrize("key", sorted(t_base.UNPORTED_KEYS))
def test_unported_trainer_keys_raise(key):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        SSD76(_config(**{key: 2}), device="cpu")


def test_device_resident_feed_raises():
    """A tensor batch must sit on the model's device with ``batch_size``
    rows: anything else raises ``ValueError`` and is never moved. A right
    one (NHWC, any dtype) becomes float32 NCHW there."""
    images, gt = _batch(4)
    images = np.round(images).astype(np.uint8)
    feed = _fixed_feed((torch.from_numpy(images[:1]), torch.from_numpy(gt[:1])))
    pm = SSD76(_config(), {"num_train": 2, "train_generator": feed}, device="cpu")
    with pytest.raises(ValueError, match="1 rows"):
        pm.train_one_epoch(0.01)
    with pytest.raises(ValueError, match="tensor on cpu"):
        pm._to_device(torch.from_numpy(images), gt)
    with pytest.raises(ValueError, match="tensor on cpu"):
        pm._to_device(torch.from_numpy(images).to("meta"), torch.from_numpy(gt))
    x, g = pm._to_device(torch.from_numpy(images), torch.from_numpy(gt))
    assert x.dtype == torch.float32 and x.shape == (2, 3, 76, 76) and x.is_contiguous()
    np.testing.assert_array_equal(x.permute(0, 2, 3, 1).numpy(), images)
    assert pm.global_step == 0


def test_training_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SSD300(_config(compute_dtype="bfloat16"))
