"""The port's anchor assignment against tpudet's on the same numpy inputs.

The plain assignment (what the CPU runs, and what the CUDA kernel is held
against in ``test_torch_cuda.py``) must equal tpudet's Pallas kernel in
interpret mode AND its vmapped XLA form exactly: the four products are
decisions, and ``best_iou`` is the same float32 arithmetic in the same order.
The cases are those of tests/test_assign_kernel.py (``torch_assign_cases.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.ops import matching as jax_matching
from tpudet.ops.pallas.assign_kernel import assign_anchors_pallas
from tpudet_torch.ops import matching as t_matching
from tpudet_torch.ops.cuda import assign_kernel
from torch_assign_cases import CASES, assign_case

torch.set_num_threads(1)

NAMES = ("best_anchor", "best_iou", "rg", "best_set")


def _jax_inputs(gt):
    gt = jnp.asarray(gt)
    yx, hw = gt[..., 0:2], gt[..., 2:4]
    valid = jax.vmap(lambda t: jnp.arange(t.shape[0]) < jax_matching.valid_gt_count(t))(gt)
    return yx - hw / 2.0, yx + hw / 2.0, valid


def _port_assign(gt, ay1, ay2):
    g = t_matching.unpack_gt(torch.from_numpy(gt))
    return t_matching.assign_batch(g.y1x1, g.y2x2, g.valid, torch.from_numpy(ay1),
                                   torch.from_numpy(ay2))


@pytest.mark.parametrize("name", CASES)
def test_plain_assignment_equals_pallas_interpret_and_xla(monkeypatch, name):
    """Exact equality (no tolerance) with both of tpudet's forms."""
    gt, ay1, ay2 = assign_case(name)
    gy1, gy2, valid = _jax_inputs(gt)
    pallas = assign_anchors_pallas(gy1, gy2, valid, jnp.asarray(ay1), jnp.asarray(ay2),
                                   interpret=True)
    monkeypatch.setenv("TPUDET_ASSIGN_IMPL", "xla")
    xla = jax_matching.assign_batch(gy1, gy2, valid, jnp.asarray(ay1), jnp.asarray(ay2))
    got = _port_assign(gt, ay1, ay2)
    for n, g, p, x in zip(NAMES, got, pallas, xla):
        assert g.dtype == {"best_anchor": torch.int32, "rg": torch.int32,
                           "best_iou": torch.float32, "best_set": torch.bool}[n]
        np.testing.assert_array_equal(g.numpy(), np.asarray(p), err_msg=n)
        np.testing.assert_array_equal(g.numpy(), np.asarray(x), err_msg=n)
    if name == "ties":
        assert got.best_anchor[0, :2].tolist() == [0, 0]  # the lowest anchor
        assert got.rg[0].unique().tolist() == [0]         # the lowest gt
    if name == "no_valid_gt":
        assert (got.best_iou[2] == -1).all() and not got.best_set[2].any()
    if name == "zero_area":
        assert torch.isfinite(got.best_iou).all()


def _gt_quirks():
    gt = -np.ones((5, 6, 5), np.float32)
    gt[0, :2] = [[30, 40, 10, 12, 3], [50, 20, 8, 9, 19]]       # 2 objects, then padding
    gt[1] = [[10 + i, 20, 5, 5, i] for i in range(6)]            # no padding: count G
    gt[2, 0] = [5, 5, 4, 4, 1]                                   # padding, then a real row:
    gt[2, 2] = [8, 8, 4, 4, 2]                                   # counted up to the first pad
    gt[4, :3] = [[0, 0, 0, 0, 4], [60, 60, 6, 6, 5], [0, 70, 3, 3, 6]]  # y = 0 ties
    return gt                                                    # image 3: no object


def test_valid_gt_count_and_unpack_gt_match_tpudet():
    """Exact: the count keeps tpudet's argmin-of-y quirk; padding labels are 0."""
    gt = _gt_quirks()
    want = jax.vmap(jax_matching.unpack_gt)(jnp.asarray(gt))
    got = t_matching.unpack_gt(torch.from_numpy(gt))
    assert got.count.tolist() == [2, 6, 1, 0, 3]
    np.testing.assert_array_equal(
        t_matching.valid_gt_count(torch.from_numpy(gt)).numpy(),
        np.asarray(jax.vmap(jax_matching.valid_gt_count)(jnp.asarray(gt))))
    for field in got._fields:
        w, g = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)


def test_gather_gt_rows_is_tpudets_take(monkeypatch):
    """Exact: the port's gather is tpudet's ``take`` branch, batched."""
    monkeypatch.setenv("TPUDET_GT_GATHER", "take")
    rng = np.random.default_rng(8)
    label = rng.integers(0, 21, (3, 7)).astype(np.int32)
    yx = rng.normal(size=(3, 7, 2)).astype(np.float32)
    rg = rng.integers(0, 7, (3, 50)).astype(np.int32)
    want = jax.vmap(jax_matching.gather_gt_rows)(jnp.asarray(rg), jnp.asarray(label),
                                                 jnp.asarray(yx))
    got = t_matching.gather_gt_rows(torch.from_numpy(rg), torch.from_numpy(label),
                                    torch.from_numpy(yx))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_assignment_wrapper_checks_inputs_on_every_device():
    gt, ay1, ay2 = assign_case("random_shared")
    g = t_matching.unpack_gt(torch.from_numpy(gt))
    args = [g.y1x1.contiguous(), g.y2x2.contiguous(), g.valid,
            torch.from_numpy(ay1), torch.from_numpy(ay2)]
    before = assign_kernel.launches
    assign_kernel.assign_anchors(*args)  # CPU: the plain version, no launch
    assert assign_kernel.launches == before
    with pytest.raises(TypeError):
        assign_kernel.assign_anchors(*args[:2], args[2].int(), *args[3:])
    with pytest.raises(TypeError):
        assign_kernel.assign_anchors(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        assign_kernel.assign_anchors(args[0].transpose(0, 1).contiguous().transpose(0, 1),
                                     *args[1:])
    with pytest.raises(ValueError, match="anchors"):
        assign_kernel.assign_anchors(*args[:3], args[3][:0], args[4][:0])
    with pytest.raises(ValueError, match="no assignment implementation"):
        assign_kernel.assign_anchors(*(a.to("meta") for a in args))
