"""Ranks of the port's data-parallel tests (``tests/test_torch_mesh*.py``).

JAX-free, like ``tests/_dcn_worker.py`` for tpudet: the ranks are spawned by
``tpudet_torch.runtime.mesh.launch`` and import this module by name, so it
imports neither JAX nor tpudet. Each job runs on one rank of a gloo group on
the CPU and returns numpy arrays that the test compares, in the parent, with
the one-process result or with tpudet's step on the same mesh size.

Every input is made here from a numpy seed, so each rank and the parent make
the same arrays.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from tpudet_torch.runtime import mesh as mesh_lib

SSD_SIZE = 64
SCAN_N, SCAN_BATCH, SCAN_ITERS = 16, 8, 2
RCNN_HW = (192.0, 320.0)
RCNN_CLASSES = 5
BN_SHAPE = (4, 6, 5, 5)
ROWS = 8


# ------------------------------------------------------------------ inputs
def ssd_config(batch, **kw):
    """``tests/test_distributed.py``'s SSD64 config."""
    cfg = {"mode": "train", "data_format": "channels_last", "num_classes": 4,
           "weight_decay": 1e-4, "keep_prob": 1.0, "batch_size": batch,
           "nms_score_threshold": 0.3, "nms_max_boxes": 5, "nms_iou_threshold": 0.45,
           "pretraining_weight": None, "hard_neg_cap": 48, "seed": 7}
    cfg.update(kw)
    return cfg


def global_batch(batch):
    """``tests/test_distributed.py``'s global batch."""
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 255, (batch, SSD_SIZE, SSD_SIZE, 3)).astype(np.float32)
    return images, _gt(batch)


def scan_dataset():
    """A 16-image uint8 set for the scanned epoch."""
    rng = np.random.default_rng(42)
    images = rng.integers(0, 255, (SCAN_N, SSD_SIZE, SSD_SIZE, 3)).astype(np.uint8)
    return images, _gt(SCAN_N)


def _gt(n):
    gt = -np.ones((n, 8, 5), np.float32)
    gt[:, 0] = [32, 32, 20, 24, 1]
    gt[:, 1] = [16, 48, 12, 12, 3]
    return gt


def op_inputs():
    """The inputs of the op checks: BatchNorm's ``x``, cotangent, scale,
    bias and running statistics; ``weighted_mean``'s rows and mask; the
    RCNN stage's thin map, sample and head weights."""
    rng = np.random.default_rng(11)
    f32 = np.float32
    b = BN_SHAPE[0]
    d = dict(x=rng.normal(1.0, 2.0, BN_SHAPE).astype(f32),
             cot=rng.normal(size=BN_SHAPE).astype(f32),
             scale=rng.uniform(0.5, 1.5, BN_SHAPE[1]).astype(f32),
             bias=rng.normal(size=BN_SHAPE[1]).astype(f32),
             mean=rng.normal(size=BN_SHAPE[1]).astype(f32),
             var=rng.uniform(0.5, 2.0, BN_SHAPE[1]).astype(f32),
             rows=rng.normal(size=ROWS).astype(f32),
             mask=(np.arange(ROWS) % 4 < 3).astype(f32),
             feat=rng.normal(size=(b, 4, 6, 10)).astype(f32),
             head=rng.normal(0, 0.05, (7 * 7 * 4, RCNN_CLASSES + 1 + 4)).astype(f32))
    h, w = RCNN_HW
    for name, cap in (("pos", 128), ("neg", 256)):
        yx = rng.uniform([-20, -20], [h, w], (b, cap, 2))
        hw = rng.uniform(8, 120, (b, cap, 2))
        d[f"{name}_proposal"] = np.concatenate([yx, yx + hw], -1).astype(f32)
        d[f"{name}_valid"] = rng.uniform(size=(b, cap)) < 0.6
    d["pos_label"] = rng.integers(0, RCNN_CLASSES, (b, 128)).astype(np.int32)
    d["pos_truth"] = rng.normal(size=(b, 128, 4)).astype(f32)
    return d


# ------------------------------------------------------------------ checks
def batchnorm(d, mesh):
    """Train-mode BatchNorm over this rank's rows under ``mesh``: output, the
    gradient of ``Σ y·cot`` with respect to the rows, to scale and bias
    (summed over the ranks, as the step sums them) and the running
    statistics after."""
    from tpudet_torch.nn.layers import BatchNorm

    rows = mesh_lib.rank_rows(mesh, BN_SHAPE[0])
    bn = BatchNorm(BN_SHAPE[1]).train()
    with torch.no_grad():
        for k in ("scale", "bias", "mean", "var"):
            getattr(bn, k).copy_(torch.from_numpy(d[k]))
    x = torch.from_numpy(d["x"][rows]).requires_grad_()
    with mesh_lib.over(mesh):
        y = bn(x)
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(d["cot"][rows])),
                                [x, bn.scale, bn.bias])
    gx, gs, gb = grads[0], *mesh_lib.reduce_flat(mesh, grads[1:])
    return dict(y=y.detach().numpy(), gx=gx.numpy(), gscale=gs.numpy(), gbias=gb.numpy(),
                mean=bn.mean.numpy().copy(), var=bn.var.numpy().copy())


def weighted_mean(d, mesh, masked):
    """This rank's share of ``weighted_mean`` of its rows, summed over the
    ranks, and its gradient with respect to the rows."""
    from tpudet_torch.ops import losses

    rows = mesh_lib.rank_rows(mesh, ROWS)
    x = torch.from_numpy(d["rows"][rows]).requires_grad_()
    w = torch.from_numpy(d["mask"][rows]) if masked else None
    with mesh_lib.over(mesh):
        share = losses.weighted_mean(x, w)
    (g,) = torch.autograd.grad(share, x)
    (value,) = mesh_lib.reduce_flat(mesh, [share.detach()])
    return dict(value=value.numpy(), grad=g.numpy())


def rcnn_losses(d, mesh, masked):
    """LH-RCNN's ``rcnn_losses`` on this rank's images through a linear head
    (global value, the thin map's gradient, the head's gradient summed)."""
    from tpudet_torch.heads import lhrcnn

    b = BN_SHAPE[0]
    rows = mesh_lib.rank_rows(mesh, b)
    head = torch.from_numpy(d["head"]).requires_grad_()

    def head_fn(feats):
        out = feats.reshape(feats.shape[0], -1) @ head
        return out[:, :RCNN_CLASSES + 1], out[:, RCNN_CLASSES + 1:]

    feat = torch.from_numpy(d["feat"][rows]).requires_grad_()
    sample = lhrcnn.RPNSample(
        torch.zeros(b)[rows], *(torch.from_numpy(d[k][rows]) for k in (
            "pos_proposal", "pos_label", "pos_truth", "pos_valid", "neg_proposal",
            "neg_valid")))
    w = torch.from_numpy((np.arange(b) < b - 1).astype(np.float32)[rows]) if masked \
        else None
    with mesh_lib.over(mesh):
        share = lhrcnn.rcnn_losses(head_fn, feat, sample, *RCNN_HW, RCNN_CLASSES + 1,
                                   sample_weight=w)
    gf, gh = torch.autograd.grad(share, [feat, head])
    value, gh = mesh_lib.reduce_flat(mesh, [share.detach(), gh])
    return dict(value=value.numpy(), gfeat=gf.numpy(), ghead=gh.numpy())


def all_reduce_grads(mesh):
    """``Σ_r x_r`` weighted by a rank's own cotangent: the gradient with
    respect to ``x_r`` through ``mesh.all_reduce_sum`` and through
    ``torch.distributed.nn.functional.all_reduce``."""
    import warnings

    import torch.distributed.nn.functional as dist_fn

    out = {}
    for name, fn in (("port", lambda x: mesh_lib.all_reduce_sum(x, mesh)),
                     ("dist_nn", dist_fn.all_reduce)):
        x = torch.full((3,), float(mesh.rank + 1), requires_grad=True)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)  # dist_nn's deprecation
            y = fn(x)
        (g,) = torch.autograd.grad(torch.sum(y * (mesh.rank + 1)), x)
        out[name] = (y.detach().numpy(), g.numpy())
    return out


def ops_rank(rank):
    """Every op check on this rank (one group serves them all); called
    without a group, the one-process results."""
    mesh = mesh_lib.data_mesh()
    d = op_inputs()
    return dict(batchnorm=batchnorm(d, mesh),
                **{f"weighted_mean_{m}": weighted_mean(d, mesh, m) for m in (False, True)},
                **{f"rcnn_{m}": rcnn_losses(d, mesh, m) for m in (False, True)},
                all_reduce=None if mesh.group is None else all_reduce_grads(mesh))


# ------------------------------------------------------------------ steps
def _ssd64():
    from tpudet_torch.models.ssd import SSD300

    class SSD64(SSD300):
        input_size = SSD_SIZE

    return SSD64


def _state(model):
    """The net's state and velocity as numpy, and a digest of their bytes."""
    state = {k: v.detach().numpy().copy() for k, v in model.net.state_dict().items()}
    state.update({f"velocity/{k}": v.numpy().copy() for k, v in model.velocity.items()})
    digest = hashlib.sha256()
    for k in sorted(state):
        digest.update(state[k].tobytes())
    return state, digest.hexdigest()


def ssd_step_rank(rank, weights, batch, node_rows=None):
    """One epoch of one step of SSD64 from ``weights`` (a state dict) on
    ``global_batch(batch)``; the node's feed yields its rows ``node_rows``
    (default: the whole batch). Rank 0 returns its state."""
    images, gt = global_batch(batch)
    if node_rows is not None:
        mesh = mesh_lib.data_mesh()
        mine = node_rows[rank // mesh.ranks_per_node]
        images, gt = images[mine], gt[mine]

    def batches():
        while True:
            yield images, gt

    model = _ssd64()(ssd_config(batch), {"num_train": batch,
                                         "train_generator": (lambda: None, batches())},
                     device="cpu")
    model.net.load_state_dict(weights)
    loss = model.train_one_epoch(0.01)
    state, digest = _state(model)
    return dict(loss=loss, digest=digest, device_batch=model.device_batch,
                mesh=(model.mesh.axis_names, model.mesh.shape, model.process_count),
                weight=None if model._sample_weight() is None
                else model._sample_weight().numpy(),
                state=state if rank == 0 else None)


def resident_rank(rank, weights, mode):
    """An epoch of SCAN_ITERS steps from a DeviceDataset (seed 9) of
    ``scan_dataset()``: ``"scanned"`` and ``"per-step"`` distribute it over
    the ranks first, ``"whole"`` keeps the whole set on every rank, which
    gathers the device batch a step and keeps its rows (per step)."""
    from tpudet_torch.data.device_dataset import DeviceDataset

    images, gt = scan_dataset()
    ds = DeviceDataset(images, gt, batch=SCAN_BATCH, seed=9, device="cpu")
    config = ssd_config(SCAN_BATCH, no_scan_epoch=mode != "scanned")
    model = _ssd64()(config, {"num_train": SCAN_ITERS * SCAN_BATCH, "train_generator": ds},
                     device="cpu")
    model.net.load_state_dict(weights)
    if mode != "whole":
        ds.distribute(model.mesh, model.device_batch)
    loss = model.train_one_epoch(0.01)
    state, digest = _state(model)
    return dict(loss=loss, digest=digest, path=model.last_epoch,
                state=state if rank == 0 else None)


def fail_rank(rank):
    """Rank 1 raises; rank 0 waits in a collective that never completes."""
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    torch.distributed.all_reduce(torch.zeros(1))


def abort_at_exit_rank(rank):
    """Returns its rank, then aborts in the interpreter's teardown (a stand-in
    for a backend's thread that terminates a finished process)."""
    import atexit
    import os

    atexit.register(os.abort)
    return rank


def sleep_rank(rank, seconds):
    import time

    time.sleep(seconds)
