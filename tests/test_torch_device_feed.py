"""The port's device-resident feed against tpudet's on the same numpy inputs:
the PRNG, the device augmentation, ``DeviceDataset``'s index streams, and
epochs trained from a ``DeviceDataset`` with ``device_augment`` on.

Tolerances, each with its reason:
  * PRNG keys and draws: bit for bit (the same integer hash; the uniform's
    one rounding taken as XLA's fused multiply-add takes it);
  * flips and flipped gt: exact (a reversal and ``(dim - 1) - c``);
  * colour jitter: 2e-3 absolute on 0-255 pixels, 8e-6 of the range (float32
    through the HSV round trip, where XLA contracts products into fused
    multiply-adds and sums the mean in another order);
  * a YOLOv2 epoch of 2 steps: each loss and the state after the epoch as
    ``torch_yolo_common.check_step`` holds the state after one step: 4x the
    port's own difference between its two summation orders, or 1e-4 where
    that is larger (the first loss is 1e-4 by that rule; random weights at
    batch 8 over 2x2 maps move the port's own second loss by ~0.07%
    between the two orders);
  * an SSD300 step at 76 with flips: as ``test_torch_train.py``'s float32
    step, 1e-4 per tensor. Flips give both sides the same pixels; the colour
    jitter's rounding (above) moves a mining pick of this ill-conditioned
    step, so the colour reaches whole steps through the YOLOv2 epoch.

tpudet's side runs jitted, on one device. ``torch.set_num_threads(1)``:
the file takes ~65 s on one worker with a cold JAX cache, ~22 s of it
tpudet's XLA compiles of the YOLOv2 epoch and the SSD300 step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.data import device_augment as jax_augment
from tpudet.data.device_dataset import DeviceDataset as JaxDeviceDataset
from tpudet.models import base as jax_base
from tpudet.models.ssd import SSD300 as JaxSSD300
from tpudet.models.yolo import YOLOv2 as JaxYOLOv2
from tpudet.runtime import optim as jax_optim
from tpudet_torch.data import device_augment, prng
from tpudet_torch.data.device_dataset import DeviceDataset
from tpudet_torch.models import YOLOv2
from tpudet_torch.models.lhrcnn import LHRCNN
from tpudet_torch.models.ssd import SSD300
from tpudet_torch.ops.cuda import assign_kernel, nms_kernel
from tpudet_torch.runtime import mesh as t_mesh
from tpudet_torch.runtime import transfer
from torch_refine_common import numpy_variables, tree_like, tree_rel

import torch_yolo_common as yolo_common

torch.set_num_threads(1)

AUG_SALT = 0x5EED
BOTH = {"flip_prob": [0.5, 0.5], "color_jitter_prob": 0.5}
FLIPS = {"flip_prob": [0.5, 0.5]}
CONFIGS = {"flip": FLIPS, "jitter": {"color_jitter_prob": 0.5},
           "both": BOTH}
COLOUR_ATOL = 2e-3
PIXEL_MEAN = np.asarray([123.68, 116.779, 103.979], np.float32)


def _images(n, hw, pad, seed=3):
    """``n`` uint8 images ``[n, h, w, 3]`` and gt ``[n, pad, 5]`` with 1 to
    ``pad - 1`` valid rows (the rest -1) inside the image."""
    h, w = hw
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)
    gt = -np.ones((n, pad, 5), np.float32)
    for i in range(n):
        k = int(rng.integers(1, pad))
        hw_box = rng.uniform(4, min(h, w) / 2, (k, 2))
        yx = rng.uniform(hw_box / 2, np.asarray([h, w]) - hw_box / 2)
        gt[i, :k] = np.concatenate([yx, hw_box, rng.integers(0, 20, (k, 1))], -1)
    return images, gt


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


class _Writer:
    def __init__(self):
        self.losses = []

    def add_summary(self, loss, global_step):
        self.losses.append((float(loss), global_step))


# ------------------------------------------------------------------ PRNG
def test_keys_fold_in_and_split_match_jax():
    for seed in (0, 3, 5 ^ AUG_SALT, 2 ** 31 - 1):
        want = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(prng.key(seed), np.asarray(want))
        for step in (0, 1, 2, 17, 1000, 2 ** 31 - 1):
            folded = jax.random.fold_in(want, step)
            np.testing.assert_array_equal(prng.fold_in(prng.key(seed), step),
                                          np.asarray(folded))
            np.testing.assert_array_equal(prng.split(prng.fold_in(prng.key(seed), step), 6),
                                          np.asarray(jax.random.split(folded, 6)))


# tpudet's six draws (device_augment.py:86-107): split index, shape, range
DRAWS = {"td": (0, (1000,), 0.0, 1.0), "lr": (1, (1000,), 0.0, 1.0),
         "jitter": (2, (1000, 3), 0.0, 1.0), "brightness": (3, (1000,), 0.0, 0.3),
         "contrast": (4, (1000,), 0.8, 1.2), "hue": (5, (1000,), -0.1, 0.1)}


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_uniform_draws_match_jax_bit_for_bit(name):
    """Over 4 seeds x 4 steps of ``fold_in``: 16,000 or 48,000 draws."""
    index, shape, lo, hi = DRAWS[name]

    @jax.jit
    def want(seed, step):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
        return jax.random.uniform(jax.random.split(key, 6)[index], shape, minval=lo,
                                  maxval=hi)

    for seed in (0, 3 ^ AUG_SALT, 5 ^ AUG_SALT, 12345):
        for step in (0, 1, 9, 60000):
            key = prng.split(prng.fold_in(prng.key(seed), step), 6)[index]
            got = prng.uniform(key, shape, lo, hi)
            assert got.dtype == np.float32 and got.shape == shape
            np.testing.assert_array_equal(got, np.asarray(want(seed, step)))


# ------------------------------------------------------------------ augmentation
@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_augmentation_matches_tpudet(which):
    """64x64, batch 8, gt padded to 6 with -1 rows, steps 0-3 of seed 5:
    the draws equal tpudet's, flips and gt exactly, colour within
    ``COLOUR_ATOL``; padding rows untouched."""
    cfg = CONFIGS[which]
    images, gt = _images(8, (64, 64), 6)
    images = images.astype(np.float32)
    fn = jax.jit(lambda k, i, g: jax_augment.apply(k, i, g, cfg))
    flipped = 0
    for step in range(4):
        jkey = jax.random.fold_in(jax.random.PRNGKey(5 ^ AUG_SALT), step)
        want_i, want_g = jax.device_get(fn(jkey, images, gt))
        key = prng.fold_in(prng.key(5 ^ AUG_SALT), step)
        d = device_augment.draws(key, 8, cfg)
        keys = jax.random.split(jkey, 6)
        if "flip_prob" in cfg:
            np.testing.assert_array_equal(d["td"], np.asarray(jax.random.uniform(keys[0], (8,))) < 0.5)
            flipped += int(d["td"].sum() + d["lr"].sum())
        if "color_jitter_prob" in cfg:
            do = np.asarray(jax.random.uniform(keys[2], (8, 3))) < 0.5
            want_h = np.where(do[:, 2], jax.random.uniform(keys[5], (8,), minval=-0.1,
                                                           maxval=0.1), 0.0)
            np.testing.assert_array_equal(d["hue"], want_h.astype(np.float32))
        got_i, got_g = device_augment.apply_draws(
            _nchw(images), torch.from_numpy(gt), device_augment.to_device(d, "cpu"), cfg)
        got_i = got_i.permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(got_g.numpy(), want_g)
        np.testing.assert_array_equal(got_g.numpy()[gt[..., 0] < 0], -1.0)
        if "color_jitter_prob" in cfg:
            np.testing.assert_allclose(got_i, want_i, rtol=0, atol=COLOUR_ATOL)
        else:
            np.testing.assert_array_equal(got_i, want_i)
    if "flip_prob" in cfg:
        assert 0 < flipped < 64  # both outcomes occur


# ------------------------------------------------------------------ DeviceDataset
def _stream_pair(n=24, **kw):
    images, gt = _images(n, (8, 8), 4)
    return (images, gt, JaxDeviceDataset(images, gt, batch=4, seed=7, **kw),
            DeviceDataset(images, gt, batch=4, seed=7, device="cpu", **kw))


def _check_batch(got, want, images, gt):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].dtype == torch.uint8 and got[0].shape[1:] == images.shape[1:]


@pytest.mark.parametrize("mode", ["plain", "max_bytes"])
def test_resident_streams_match_tpudet(mode):
    """Plain and a ``max_bytes`` subset (16 of 24 rows): the same indices
    from ``next_indices``, ``scan_indices`` and ``__next__``, through
    ``reset``; the gathered rows are the numpy rows."""
    per = 8 * 8 * 3
    kw = {"max_bytes": 16 * per} if mode == "max_bytes" else {}
    images, gt, want, got = _stream_pair(**kw)
    assert got.n == want.n == (16 if kw else 24)
    host = np.asarray(want.images)
    np.testing.assert_array_equal(got.images.numpy(), host)
    for _ in range(2):
        np.testing.assert_array_equal(got.next_indices(3), want.next_indices(3))
        np.testing.assert_array_equal(got.scan_indices(2).numpy(),
                                      np.asarray(want.scan_indices(2)))
        for _ in range(5):
            _check_batch(next(got), next(want), images, gt)
        got.reset()
        want.reset()
    idx = got.next_indices(1)[0]
    np.testing.assert_array_equal(want.next_indices(1)[0], idx)
    batch = got.gather(torch.from_numpy(idx))
    np.testing.assert_array_equal(batch[0].numpy(), host[idx])
    np.testing.assert_array_equal(batch[1].numpy(), np.asarray(want.gt)[idx])


def test_chunked_streams_with_rotation_match_tpudet():
    """24 rows, chunks of 8, 16 resident, a rotation every 2nd pin: the
    same pins, slot rows, pools and indices through ``scan_indices``,
    ``__next__`` and ``reset``; each pinned chunk holds its slot's numpy
    rows, and rows of the pool reach the device."""
    per = 8 * 8 * 3
    images, gt, want, got = _stream_pair(max_bytes=16 * per, chunk_bytes=8 * per,
                                         rotate_every=2)
    assert (got.k_chunks, got.chunk_rows) == (want.k_chunks, want.chunk_rows) == (2, 8)
    resident = set(np.concatenate(got._slot_rows).tolist())
    seen = set()
    for epoch in range(10):
        if epoch == 6:
            got.reset()
            want.reset()
        np.testing.assert_array_equal(got.scan_indices(2).numpy(),
                                      np.asarray(want.scan_indices(2)))
        if got._prefetch is not None:  # compare after the refresh has landed
            got._prefetch[1].join(timeout=60)
            want._prefetch[1].join(timeout=60)
            assert not got._prefetch[1].is_alive() and not want._prefetch[1].is_alive()
        assert got._pin == want._pin and got._pool == want._pool
        for a, b in zip(got._slot_rows, want._slot_rows):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.images.numpy(), images[got.slot_rows])
        np.testing.assert_array_equal(got.gt.numpy(), gt[got.slot_rows])
        seen.update(got.slot_rows.tolist())
        for _ in range(3):
            _check_batch(next(got), next(want), images, gt)
    assert len(seen - resident) > 0
    # the log: one record a pin, ending at the pinned slot; every 2nd pin
    # rotates, joining the refresh started ahead or refreshing there
    assert [r["pin"] for r in got.pin_log] == list(range(1, got._pin_count + 1))
    assert got.pin_log[-1]["slot"] == got._pin
    assert all((r["refresh"] is not None) == (r["pin"] % 2 == 0) for r in got.pin_log)
    assert {r["refresh"] for r in got.pin_log} >= {"joined"}
    got.close()


def test_chunked_streams_at_lhrcnn_long_geometry_match_tpudet():
    """The chunked feed of the LHRCNN-long spec over its whole run: 5000
    rows of 700x1100x3 bytes in chunks of 1.3e9 bytes, 1e10 resident, a
    rotation every 6 pins, batch 8, 240 scanned epochs of 50 steps. Rows of
    3 bytes with the byte budgets scaled by the same factor give the same
    geometry (7 chunks of 562 rows, 3934 resident); every epoch draws
    tpudet's indices, and they gather the same dataset rows."""
    n, per, row = 5000, 3, 700 * 1100 * 3
    images = np.zeros((n, 1, 1, 3), np.uint8)
    gt = np.full((n, 24, 5), -1.0, np.float32)
    gt[:, 0, 0] = np.arange(n)
    kw = dict(batch=8, seed=1, max_bytes=10**10 // row * per,
              chunk_bytes=13 * 10**8 // row * per, rotate_every=6)
    want, got = JaxDeviceDataset(images, gt, **kw), DeviceDataset(images, gt, device="cpu",
                                                                  **kw)
    assert (got.k_chunks, got.chunk_rows) == (want.k_chunks, want.chunk_rows) == (7, 562)
    for _ in range(12000 // 50):
        w_idx, g_idx = np.asarray(want.scan_indices(50)), got.scan_indices(50).numpy()
        for ds in (want, got):  # compare after a refresh has landed
            if ds._prefetch is not None:
                ds._prefetch[1].join(timeout=60)
        np.testing.assert_array_equal(g_idx, w_idx)
        np.testing.assert_array_equal(got.gt.numpy()[g_idx, 0, 0],
                                      np.asarray(want.gt)[w_idx, 0, 0])
    assert got._pin_count == want._pin_count == 240
    got.close()


def test_device_dataset_without_device_needs_a_card(monkeypatch):
    images, gt = _images(8, (8, 8), 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceDataset(images, gt, batch=4)


def test_distribute_lays_out_rank_blocks():
    """Rank 1 of 2 holds block 1 of the set (rows 4-7 of 8) and draws batches
    of its 2 rows from it; ``reset`` restarts its stream (tpudet's against
    these in ``test_torch_mesh.py``)."""
    images, gt = _images(8, (8, 8), 4)
    ds = DeviceDataset(images, gt, batch=4, device="cpu")
    ds.distribute(t_mesh.Mesh(2, 1), 4)
    assert ds.distributed and (ds.n_shard, ds.per_dev, ds.batch) == (4, 2, 4)
    np.testing.assert_array_equal(ds.images.numpy(), images[4:])
    first = ds.next_indices(2)
    assert first.shape == (2, 2) and sorted(first.ravel()) == [0, 1, 2, 3]
    g_images, g_gt = next(ds)
    np.testing.assert_array_equal(g_gt.numpy(), gt[4:][ds._order[:2]])
    ds.reset()
    np.testing.assert_array_equal(ds.next_indices(1)[0], ds._order[:2])


# ------------------------------------------------------------------ YOLOv2 epoch
def _rel(got, want):
    """``tree_rel`` in float32 (a third of its time over YOLOv2's 50M
    values; float32 norms are good to ~1e-6 of a 1e-4 bound)."""
    num = sum(torch.linalg.vector_norm(got[k] - want[k]) ** 2 for k in want)
    return float(torch.sqrt(num / sum(torch.linalg.vector_norm(want[k]) ** 2 for k in want)))


def _yolo_epoch(variables, images, gt, mkldnn=True):
    cfg = yolo_common.config("v2", batch_size=8, device_augment=BOTH)
    ds = DeviceDataset(images, gt, batch=8, seed=5, device="cpu")
    pm = YOLOv2(cfg, {"num_train": 16, "train_generator": ds}, device="cpu")
    transfer.load_flax(pm.net, variables)
    writer = _Writer()
    with torch.backends.mkldnn.flags(enabled=mkldnn):
        mean = pm.train_one_epoch(0.01, writer)
    return (mean, writer.losses, {k: v.clone() for k, v in pm.net.state_dict().items()},
            {k: v.clone() for k, v in pm.velocity.items()}, pm.global_step)


def test_yolov2_epoch_from_a_device_dataset_matches_tpudet():
    """Full-width YOLOv2 at 64x64, batch 8 (the 8-device CPU mesh takes it
    unpadded), one scanned epoch of 2 steps from ``DeviceDataset(seed=5)``
    with flips and colour jitter, from the same variables on both sides."""
    rng = np.random.default_rng(0)

    class Seeded(JaxYOLOv2):
        def _init_variables(self):
            variables = numpy_variables(self.net, rng)
            self.params, self.batch_stats = variables["params"], variables["batch_stats"]
            self._optimizer = self._make_optimizer()
            self.opt_state = self._optimizer.init(self.params)

        def _setup_mesh(self):  # one device: compiles in a third of the time
            self.process_count = 1
            self.device_batch = self.batch_size

    images = rng.integers(0, 256, (16, 64, 64, 3)).astype(np.uint8)
    gt = yolo_common.gt_batch(rng, 64.0, 16)
    jm = Seeded(yolo_common.config("v2", batch_size=8, device_augment=BOTH),
                {"num_train": 16,
                 "train_generator": JaxDeviceDataset(images, gt, batch=8, seed=5)})
    variables = {"params": jax.device_get(jm.params),
                 "batch_stats": jax.device_get(jm.batch_stats)}
    j_writer = _Writer()
    j_mean = jm.train_one_epoch(0.01, j_writer)

    mean, losses, state, vel, steps = _yolo_epoch(variables, images, gt)
    _, losses_b, state_b, vel_b, _ = _yolo_epoch(variables, images, gt, mkldnn=False)
    assert steps == jm.global_step == 2
    assert [s for _, s in losses] == [s for _, s in j_writer.losses] == [1, 2]
    for (got, _), (other, _), (want, _) in zip(losses, losses_b, j_writer.losses):
        assert abs(got - want) <= max(1e-4, 4 * abs(other / got - 1)) * abs(want)
    assert abs(losses[0][0] - j_writer.losses[0][0]) <= 1e-4 * abs(j_writer.losses[0][0])
    np.testing.assert_allclose(mean, np.mean([lo for lo, _ in losses]), rtol=1e-6)
    assert np.isfinite(j_mean)
    want = transfer.from_flax({"params": jax.device_get(jm.params),
                               "batch_stats": jax.device_get(jm.batch_stats)})
    stats = [k for k in want if k.endswith((".mean", ".var"))]
    params = [k for k in want if k not in stats]
    for keys in (stats, params):
        sens = _rel({k: state_b[k] for k in keys}, {k: state[k] for k in keys})
        assert _rel(state, {k: want[k] for k in keys}) < max(1e-4, 4 * sens)
    w_vel = transfer.velocity_from_flax(jax.device_get(jm.opt_state.velocity))
    assert _rel(vel, w_vel) < max(1e-4, 4 * _rel(vel_b, vel))


# ------------------------------------------------------------------ the port's epochs
class SSD76(SSD300):
    input_size = 76


class _JaxSSD76(JaxSSD300):
    """tpudet's SSD300 at 76 with variables drawn from numpy (flax's eager
    initialisation takes ~25 s on the CPU) and no mesh."""
    input_size = 76

    def _init_variables(self):
        variables = numpy_variables(self.net, np.random.default_rng(8), (76, 76))
        self.params, self.batch_stats = variables["params"], variables["batch_stats"]
        self._optimizer = self._make_optimizer()
        self.opt_state = None

    def _setup_mesh(self):
        self.process_count, self.device_batch = 1, self.batch_size


def _ssd_config(**kw):
    cfg = {"mode": "train", "data_format": "channels_last", "num_classes": 20,
           "batch_size": 2, "weight_decay": 1e-4, "nms_score_threshold": 0.5,
           "nms_max_boxes": 20, "nms_iou_threshold": 0.5, "hard_neg_cap": 384,
           "seed": 3, "device_augment": BOTH}
    cfg.update(kw)
    return cfg


def _count_scans(ds):
    """Count ``ds.scan_indices`` calls in ``ds.scans``: one an epoch on the
    scanned path, none on the per-step one."""
    ds.scans = 0
    draw = ds.scan_indices

    def counted(k):
        ds.scans += 1
        return draw(k)

    ds.scan_indices = counted
    return ds


def _ssd_epoch(**kw):
    images, gt = _images(8, (76, 76), 60)
    ds = _count_scans(DeviceDataset(images, gt, batch=2, seed=5, device="cpu"))
    pm = SSD76(_ssd_config(**kw), {"num_train": 4, "train_generator": ds}, device="cpu")
    writer = _Writer()
    pm.train_one_epoch(0.01, writer)
    return writer.losses, pm.net.state_dict(), pm.velocity, ds.scans


@pytest.fixture(scope="module")
def scanned_ssd_epoch():
    return _ssd_epoch()


@pytest.mark.parametrize("key", ["no_scan_epoch", "device_augment_split"])
def test_per_step_and_split_epochs_equal_the_scanned_epoch(scanned_ssd_epoch, key):
    """Either key turns the scanned epoch off, and the epochs agree exactly
    on the CPU: the same batches, draws and steps in one order."""
    losses, state, vel, scans = scanned_ssd_epoch
    got_losses, got_state, got_vel, got_scans = _ssd_epoch(**{key: True})
    assert (scans, got_scans) == (1, 0)
    assert got_losses == losses and [s for _, s in losses] == [1, 2]
    for k, v in state.items():
        assert torch.equal(got_state[k], v), k
    for k, v in vel.items():
        assert torch.equal(got_vel[k], v), k


def test_ssd300_flipped_step_matches_tpudet(monkeypatch):
    """One fp32 step at input 76, batch 2, from tpudet's variables, with
    ``flip_prob`` [0.5, 0.5] at global_step 1 of seed 3 (image 1 flipped
    both ways, image 0 not): the assignment and the mining run on the
    flipped gt. Loss, parameters,
    running statistics and velocity to 1e-4 relative (normwise), from a
    non-zero velocity (conv biases ahead of a BatchNorm get no gradient but
    rounding)."""
    monkeypatch.setenv("TPUDET_SSD_CONF_LAYOUT", "ac")
    images, gt = _images(2, (76, 76), 60, seed=4)
    images = images.astype(np.float32)
    step = 1
    d = device_augment.draws(prng.fold_in(prng.key(3 ^ AUG_SALT), step), 2, FLIPS)
    assert d["td"].tolist() == d["lr"].tolist() == [False, True]
    jm = _JaxSSD76(_ssd_config(mode="test", device_augment=FLIPS))
    params, bstats = jax.device_get(jm.params), jax.device_get(jm.batch_stats)
    rng = np.random.default_rng(21)
    velocity = tree_like(params, lambda v: (0.01 * rng.normal(size=np.shape(v)))
                         .astype(np.float32))

    def forward_loss(p, s):
        key = jax.random.fold_in(jax.random.PRNGKey(3 ^ AUG_SALT), step)
        x, g = jax_augment.apply(key, jnp.asarray(images), jnp.asarray(gt), FLIPS)
        outputs, mut = jm.net.apply({"params": p, "batch_stats": s},
                                    x - PIXEL_MEAN.reshape(1, 1, 1, 3), True,
                                    mutable=["batch_stats"])
        loss = jm._loss_from_outputs(outputs, g, None)
        return loss + 1e-4 * jax_base.global_l2(p), mut["batch_stats"]

    def jax_step(p, s, v):
        (loss, stats), grads = jax.value_and_grad(forward_loss, has_aux=True)(p, s)
        new_p, new_opt = jax_optim.Momentum(0.9).update(
            grads, jax_optim.MomentumState(v), p, jnp.float32(0.01))
        return loss, new_p, stats, new_opt.velocity

    w_loss, w_params, w_stats, w_vel = jax.device_get(jax.jit(jax_step)(params, bstats,
                                                                       velocity))
    pm = SSD76(_ssd_config(device_augment=FLIPS), device="cpu")
    transfer.load_flax(pm.net, {"params": params, "batch_stats": bstats})
    pm.global_step = step
    for k, v in transfer.velocity_from_flax(velocity).items():
        pm.velocity[k].copy_(v)
    assigned = []
    real = assign_kernel.assign_anchors
    monkeypatch.setattr(assign_kernel, "assign_anchors",
                        lambda *a: assigned.append(a) or real(*a))
    launches = (assign_kernel.launches, nms_kernel.launches)
    loss = pm.train_step(*pm._to_device(images, gt), 0.01)
    assert (assign_kernel.launches, nms_kernel.launches) == launches  # CPU: plain
    assert len(assigned) == 1
    flipped = device_augment.apply_draws(torch.zeros(2, 3, 76, 76), torch.from_numpy(gt),
                                         device_augment.to_device(d, "cpu"), FLIPS)[1]
    assert not torch.equal(flipped, torch.from_numpy(gt))
    np.testing.assert_allclose(float(loss), float(w_loss), rtol=1e-4)
    got = pm.net.state_dict()
    want = transfer.from_flax({"params": w_params, "batch_stats": w_stats})
    assert max(tree_rel({k: got[k]}, {k: want[k]}) for k in want) < 1e-4
    w_v = transfer.velocity_from_flax(w_vel)
    assert max(tree_rel({k: pm.velocity[k]}, {k: w_v[k]}) for k in w_v) < 1e-4


# ------------------------------------------------------------------ LH-RCNN
def _lhrcnn_config(**kw):
    cfg = {"mode": "train", "data_shape": [192, 320, 3], "num_classes": 4,
           "weight_decay": 1e-4, "data_format": "channels_last", "batch_size": 2,
           "rpn_first_step": 60000, "rcnn_first_step": 120000,
           "rpn_second_step": 160000, "post_nms_proposal": 100,
           "nms_score_threshold": 0.3, "nms_max_boxes": 10, "nms_iou_threshold": 0.5,
           "seed": 2, "device_augment": BOTH}
    cfg.update(kw)
    return cfg


def test_lhrcnn_augments_inside_its_step_and_ignores_split():
    """192x320, batch 2: ``device_augment_split`` changes nothing (the
    scanned epoch is taken either way, as tpudet's LH-RCNN takes it); the step's
    first loss equals an unaugmented model's on the batch augmented
    beforehand with step 0's draws."""
    images, gt = _images(4, (192, 320), 8)
    gt[..., 4] = np.where(gt[..., 0] >= 0, gt[..., 4] % 4, -1)
    runs = {}
    for split in (False, True):
        ds = _count_scans(DeviceDataset(images, gt, batch=2, seed=5, device="cpu"))
        pm = LHRCNN(_lhrcnn_config(device_augment_split=split),
                    {"num_train": 4, "train_generator": ds}, device="cpu")
        writer = _Writer()
        pm.train_one_epoch(6e-5, writer)
        assert ds.scans == 1
        runs[split] = writer.losses
    assert runs[True] == runs[False] and len(runs[False]) == 2

    ds = DeviceDataset(images, gt, batch=2, seed=5, device="cpu")
    idx = torch.from_numpy(ds.scan_indices(1).numpy()[0])
    plain = LHRCNN(_lhrcnn_config(device_augment=None), device="cpu")
    x, g = plain._to_device(*ds.gather(idx))
    x, g = device_augment.apply(prng.fold_in(prng.key(2 ^ AUG_SALT), 0), x, g, BOTH)
    assert float(plain.train_step(x, g, 6e-5)) == runs[False][0][0]
