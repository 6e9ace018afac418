"""The port's data parallelism (``tpudet_torch/runtime/mesh.py``) against
tpudet's mesh, on gloo on the CPU.

tpudet's side runs on ``conftest.py``'s 8 CPU devices in this process. The
port's ranks are processes spawned by ``mesh.launch`` (``torch_dp_worker``,
which imports no JAX), joined through a ``FileStore`` in ``tmp_path``; each
launch has its own timeout, and each group a 60 s collective timeout.

Tolerances, each with its reason:
  * mesh shapes, device batches, masks, index streams and gathered rows:
    exact (the same integer arithmetic and numpy streams);
  * the augment's flips exact, its colour within 2e-3 on 0-255 pixels
    (``test_torch_device_feed.py``'s bound: float32 through tpudet's HSV);
  * BatchNorm, ``weighted_mean`` and ``rcnn_losses`` over 2 ranks against
    one process on the concatenated rows: 1e-5 relative (float32 sums taken
    per rank, then across the ranks).
"""

import types

import jax
import numpy as np
import pytest
import torch

import entry_torch
import torch_dp_worker as worker
from tpudet.data import device_augment as jax_augment
from tpudet.data.device_dataset import DeviceDataset as JaxDeviceDataset
from tpudet.models import base as jax_base
from tpudet.runtime import mesh as jax_mesh
from tpudet_torch.data import device_augment, prng
from tpudet_torch.data.device_dataset import DeviceDataset
from tpudet_torch.models import base as t_base
from tpudet_torch.runtime import mesh as t_mesh

torch.set_num_threads(1)

RTOL = 1e-5
COLOUR_ATOL = 2e-3


def _launch(fn, world, tmp_path, *args, **kw):
    return t_mesh.launch(fn, world, tmp_path, *args, backend="gloo",
                         devices=["cpu"] * world, threads=1, timeout=240, **kw)


# ------------------------------------------------------------------ the mesh
@pytest.mark.parametrize("world,dcn", [(8, None), (8, 2), (8, 4), (4, 2), (2, None)])
def test_mesh_shape_matches_tpudet(world, dcn):
    want = jax_mesh.data_mesh(num_devices=world, dcn_size=dcn)
    got = t_mesh.Mesh(world, dcn=dcn or 1)
    assert got.axis_names == want.axis_names
    assert got.shape == dict(want.shape)
    assert t_mesh.batch_axes(got) == jax_mesh.batch_axes(want)
    assert t_mesh.data_parallel_size(got) == jax_mesh.data_parallel_size(want) == world


def test_mesh_without_a_group_is_one_rank():
    mesh = t_mesh.data_mesh()
    assert (mesh.world, mesh.rank, mesh.nodes, mesh.group) == (1, 0, 1, None)
    assert mesh.axis_names == jax_mesh.data_mesh(num_devices=1).axis_names
    with pytest.raises(ValueError, match="num_devices=2"):
        t_mesh.data_mesh(num_devices=2)
    x = torch.ones(3, requires_grad=True)
    assert t_mesh.all_reduce_sum(x) is x  # no active mesh: the identity
    with pytest.raises(RuntimeError, match="without a process group"):
        t_mesh.all_reduce_sum(x, t_mesh.Mesh(2))


@pytest.mark.parametrize("world,dcn", [(8, 3), (4, 3), (2, 4)])
def test_dcn_size_must_divide_as_tpudet(world, dcn):
    with pytest.raises(ValueError, match="do not divide") as want:
        jax_mesh.data_mesh(num_devices=world, dcn_size=dcn)
    with pytest.raises(ValueError) as got:
        t_mesh.Mesh(world, dcn=dcn)
    assert str(got.value) == str(want.value)


def _tpudet_layout(monkeypatch, batch, world):
    """tpudet's ``device_batch`` and ``_sample_weight`` on a ``world``-device
    mesh, from its own ``_setup_mesh`` on a stand-in model."""
    real = jax_mesh.data_mesh
    monkeypatch.setattr(jax_mesh, "data_mesh", lambda *a, **k: real(num_devices=world))
    stub = types.SimpleNamespace(config={}, mode="train", batch_size=batch, params={},
                                 batch_stats={}, opt_state=None)
    jax_base.DetectorBase._setup_mesh(stub)
    weight = jax_base.DetectorBase._sample_weight(stub)
    return stub.device_batch, None if weight is None else np.asarray(weight)


def _port_layout(monkeypatch, batch, mesh):
    """The port's ``_setup_mesh`` on a stand-in model at ``mesh``'s rank."""
    monkeypatch.setattr(t_mesh, "data_mesh", lambda *a, **k: mesh)
    stub = types.SimpleNamespace(config={}, mode="train", batch_size=batch,
                                 device=torch.device("cpu"), _state_tensors=lambda: [])
    t_base.DetectorBase._setup_mesh(stub)
    return stub


@pytest.mark.parametrize("batch,world", [(8, 2), (6, 4), (12, 8), (3, 2)])
def test_device_batch_and_mask_match_tpudet(monkeypatch, batch, world):
    """The device batch, tpudet's mask and each rank's rows of it, through the
    models' ``_setup_mesh``; the host batch's rows each rank keeps."""
    want_db, want_w = _tpudet_layout(monkeypatch, batch, world)
    mesh0 = t_mesh.Mesh(world)
    assert t_mesh.device_batch(mesh0, batch) == want_db
    full = t_mesh.sample_weight(mesh0, batch)
    assert (full is None) == (want_w is None)
    if want_w is not None:
        np.testing.assert_array_equal(full, want_w)
    images = np.arange(batch, dtype=np.float32)[:, None]
    parts, rows = [], []
    for r in range(world):
        stub = _port_layout(monkeypatch, batch, t_mesh.Mesh(world, r))
        assert stub.device_batch == want_db and stub.process_count == 1
        w = t_base.DetectorBase._sample_weight(stub)
        parts.append(None if w is None else w.numpy())
        fit = t_base.DetectorBase._fit_host_batch(stub, images, images)
        rows.append(fit[0][:, 0])
    if want_w is None:
        assert all(p is None for p in parts)
    else:
        np.testing.assert_array_equal(np.concatenate(parts), want_w)
    np.testing.assert_array_equal(np.concatenate(rows), np.arange(want_db) % batch)


def test_batch_must_divide_over_nodes(monkeypatch):
    """tpudet's ``batch_size % process_count`` error, with nodes for
    processes, and the per-node mask (each node pads its own rows)."""
    mesh = t_mesh.Mesh(4, 1, nodes=2, dcn=2)
    with pytest.raises(ValueError, match="must divide over 2 processes"):
        _port_layout(monkeypatch, 3, mesh)
    stub = _port_layout(monkeypatch, 6, mesh)
    assert stub.device_batch == 8 and stub.process_count == 2
    np.testing.assert_array_equal(t_mesh.sample_weight(mesh, 6),
                                  np.tile([1, 1, 1, 0], 2).astype(np.float32))
    # rank 1 is node 0's second rank: the node's 3 rows cycled to 4, rows 2:4
    node = np.arange(3, dtype=np.float32)
    np.testing.assert_array_equal(
        t_base.DetectorBase._fit_host_batch(stub, node, node)[0], [2, 0])


# ------------------------------------------------------------------ the augment
@pytest.mark.parametrize("world", [2, 4])
def test_augment_rows_match_tpudet(world):
    """Each rank's rows of tpudet's ``device_augment.apply`` on the whole
    batch: draws made for the device batch, the rank's taken."""
    rng = np.random.default_rng(4)
    b = 8
    images = rng.integers(0, 256, (b, 16, 16, 3)).astype(np.float32)
    gt = -np.ones((b, 4, 5), np.float32)
    gt[:, 0] = [6, 8, 4, 4, 2]
    cfg = {"flip_prob": [0.5, 0.5], "color_jitter_prob": 0.5}
    key = prng.fold_in(prng.key(3 ^ 0x5EED), 7)
    w_img, w_gt = map(np.asarray, jax_augment.apply(jax.random.fold_in(
        jax.random.PRNGKey(3 ^ 0x5EED), 7), images, gt, cfg))
    for r in range(world):
        rows = t_mesh.rank_rows(t_mesh.Mesh(world, r), b)
        x = torch.from_numpy(images[rows].transpose(0, 3, 1, 2).copy())
        got, g_gt = device_augment.apply(key, x, torch.from_numpy(gt[rows]), cfg,
                                         batch=b, start=rows.start)
        np.testing.assert_array_equal(g_gt.numpy(), w_gt[rows])
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), w_img[rows],
                                   atol=COLOUR_ATOL, rtol=0)


# ------------------------------------------------------------------ the dataset
@pytest.mark.parametrize("world,n,batch", [(2, 12, 8), (4, 10, 6)])
def test_distributed_streams_and_rows_match_tpudet(world, n, batch):
    """``distribute`` over ``world`` ranks: each rank's stream (``next_indices``,
    ``scan_indices``, ``__next__``, through ``reset``) is tpudet's column of
    that device, and each rank's gathered rows are tpudet's rows of that
    device's shard."""
    rng = np.random.default_rng(8)
    images = rng.integers(0, 256, (n, 4, 4, 3)).astype(np.uint8)
    images[:, 0, 0, 0] = np.arange(n)
    gt = rng.normal(size=(n, 3, 5)).astype(np.float32)
    device_batch = -(-batch // world) * world
    want = JaxDeviceDataset(images, gt, batch=batch, seed=5)
    want.distribute(jax_mesh.data_mesh(num_devices=world), device_batch)
    w_idx = [want.next_indices(3), np.asarray(want.scan_indices(2))]
    w_rows = np.asarray(next(want)[0])[:, 0, 0, 0]
    w_last = np.asarray(want.scan_indices(1))[0]
    want.reset()
    w_after = want.next_indices(1)
    per = device_batch // world
    for r in range(world):
        mesh = t_mesh.Mesh(world, r)
        got = DeviceDataset(images, gt, batch=batch, seed=5, device="cpu")
        got.distribute(mesh, device_batch)
        assert (got.n_shard, got.per_dev, got.batch) == (want.n_shard, per, device_batch)
        np.testing.assert_array_equal(got.next_indices(3), w_idx[0][:, r])
        np.testing.assert_array_equal(got.scan_indices(2).numpy(), w_idx[1][:, r])
        g_images, g_gt = next(got)
        np.testing.assert_array_equal(g_images[:, 0, 0, 0].numpy(),
                                      w_rows[r * per:(r + 1) * per])
        shard = np.arange(r * want.n_shard, (r + 1) * want.n_shard) % n
        np.testing.assert_array_equal(got.images.numpy(), images[shard])
        idx = got.scan_indices(1)[0]
        np.testing.assert_array_equal(idx.numpy(), w_last[r])
        gi, gg = got.make_gather()(got.images, got.gt, idx)
        np.testing.assert_array_equal(gg.numpy(), gt[shard][idx.numpy()])
        got.reset()
        np.testing.assert_array_equal(got.next_indices(1), w_after[:, r])


def test_distribute_refuses_what_tpudet_refuses():
    images = np.zeros((8, 4, 4, 3), np.uint8)
    gt = np.zeros((8, 2, 5), np.float32)
    chunked = DeviceDataset(images, gt, batch=4, chunk_bytes=4 * 48, device="cpu")
    with pytest.raises(NotImplementedError, match="chunked residency"):
        chunked.distribute(t_mesh.Mesh(2), 4)
    started = DeviceDataset(images, gt, batch=4, device="cpu")
    next(started)
    with pytest.raises(RuntimeError, match="precede the first batch"):
        started.distribute(t_mesh.Mesh(2), 4)
    ds = DeviceDataset(images, gt, batch=3, device="cpu")
    with pytest.raises(ValueError, match="must divide over 2"):
        ds.distribute(t_mesh.Mesh(2), 3)
    with pytest.raises(RuntimeError, match="needs distribute"):
        ds.make_gather()


# ------------------------------------------------------------------ ops over 2 ranks
@pytest.fixture(scope="module")
def ops(tmp_path_factory):
    """Every op on 2 ranks (one launch), and on one process."""
    ranks = _launch(worker.ops_rank, 2, tmp_path_factory.mktemp("ops"))
    return ranks, worker.ops_rank(0)


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def test_batchnorm_over_ranks_is_one_process_on_all_rows(ops):
    """Outputs and input gradients of each rank's rows, the parameters'
    gradients summed over the ranks, and the running statistics (the same
    update on both ranks)."""
    ranks, one = ops
    a, b = ranks[0]["batchnorm"], ranks[1]["batchnorm"]
    want = one["batchnorm"]
    for k in ("y", "gx"):
        assert _rel(np.concatenate([a[k], b[k]]), want[k]) < RTOL, k
    for k in ("gscale", "gbias", "mean", "var"):
        np.testing.assert_array_equal(a[k], b[k])
        assert _rel(a[k], want[k]) < RTOL, k


@pytest.mark.parametrize("masked", [False, True])
def test_weighted_mean_over_ranks_is_one_process(ops, masked):
    ranks, one = ops
    key = f"weighted_mean_{masked}"
    want = one[key]
    assert ranks[0][key]["value"] == ranks[1][key]["value"]
    assert _rel(ranks[0][key]["value"], want["value"]) < RTOL
    got = np.concatenate([r[key]["grad"] for r in ranks])
    assert _rel(got, want["grad"]) < RTOL


@pytest.mark.parametrize("masked", [False, True])
def test_rcnn_losses_over_ranks_are_one_process(ops, masked):
    """The two batch-wide denominators global: the loss, the thin map's
    gradient rows and the head's gradient summed over the ranks."""
    ranks, one = ops
    key = f"rcnn_{masked}"
    want = one[key]
    for k in ("value", "ghead"):
        np.testing.assert_array_equal(ranks[0][key][k], ranks[1][key][k])
        assert _rel(ranks[0][key][k], want[k]) < RTOL, k
    got = np.concatenate([r[key]["gfeat"] for r in ranks])
    assert _rel(got, want["gfeat"]) < RTOL


def test_all_reduce_backward_sums_the_ranks_cotangents(ops):
    """``all_reduce_sum`` and ``torch.distributed.nn.functional.all_reduce``
    agree: the forward sums (1 + 2), and the gradient of ``Σ y * (r + 1)``
    summed over the ranks is 3 on both ranks."""
    ranks, _ = ops
    for r in ranks:
        for name in ("port", "dist_nn"):
            y, g = r["all_reduce"][name]
            np.testing.assert_array_equal(y, [3.0] * 3)
            np.testing.assert_array_equal(g, [3.0] * 3)


# ------------------------------------------------------------------ launching
def test_launch_stops_at_a_failed_rank(tmp_path):
    """A rank that raises ends the launch at once (the rank left waiting in
    a collective is killed, not left to its timeout)."""
    import time

    t = time.perf_counter()
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[[01, ]+\] of 2 failed"):
        _launch(worker.fail_rank, 2, tmp_path)
    assert time.perf_counter() - t < 40


def test_launch_reports_a_rank_seen_failed_only_after_all_ended(tmp_path, monkeypatch):
    """The parent's poll comes late, as on a loaded host: every wake-up
    waits until every rank has ended. The failure is reported in the same
    form as when a rank is seen failed beside a running one, naming the
    failed ranks and every exit code."""
    import time

    real_wait = t_mesh.multiprocessing.connection.wait

    def wait_for_every_rank(objects, timeout=None):
        pending = list(objects)
        deadline = time.monotonic() + 120
        while pending and time.monotonic() < deadline:
            ready = real_wait(pending, deadline - time.monotonic())
            pending = [o for o in pending if o not in ready]
        return list(objects)

    monkeypatch.setattr(t_mesh.multiprocessing.connection, "wait", wait_for_every_rank)
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[[01, ]+\] of 2 failed: exit codes \["):
        _launch(worker.fail_rank, 2, tmp_path)


def test_launch_takes_a_rank_that_saved_its_result_as_done(tmp_path):
    """A rank whose teardown aborts after its result is saved (here an
    ``atexit`` abort) has done its work: the launch returns the results."""
    assert _launch(worker.abort_at_exit_rank, 2, tmp_path) == [0, 1]


def test_launch_times_out(tmp_path):
    with pytest.raises(TimeoutError, match="did not end within 3"):
        t_mesh.launch(worker.sleep_rank, 2, tmp_path, 60, backend="gloo",
                      devices=["cpu"] * 2, threads=1, timeout=3)


def test_dryrun_multichip_on_gloo():
    """tpudet's ``dryrun_multichip``: one step of batch 3 padded to 4 over
    2 ranks, then a scanned epoch of a distributed dataset; the ranks agree."""
    results = entry_torch.dryrun_multichip(2, device="cpu")
    assert len(results) == 2 and results[0]["device_batch"] == 4
    assert all(np.isfinite([r["loss"], r["loss2"]]).all() for r in results)
