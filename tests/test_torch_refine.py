"""The port's RefineDet slice against tpudet's on the same numpy inputs.

Modules are compared after copying the flax variables into the port
(``runtime/transfer.py``); whole-model pieces and their tolerances are in
``tests/torch_refine_common.py``. Here besides:
  * the anchors, the assignment and every NMS pick: exactly;
  * ``refine_loss`` on identical head tensors (not chained through convs):
    the value to 1e-5 relative, the gradients to 1e-5 of their largest entry
    (the same formulas, reductions in other orders);
  * ``_DeconvBN``: 1e-5 in float32, 1e-2 in bfloat16 (normwise).
tpudet's CE terms run in its ``ac`` layout (``TPUDET_SSD_CONF_LAYOUT``), the
port's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.heads import refine as jax_refine
from tpudet.models.refinedet import RefineDet320 as JaxRefineDet
from tpudet.models.refinedet import _pfpnet_feat_shapes as jax_pfpnet_shapes
from tpudet.models.refinedet import _refine_feat_shapes as jax_refine_shapes
from tpudet.ops import nms as jax_nms
from tpudet.ops.pallas.nms_kernel import batched_greedy_nms_pretopk as pallas_pretopk
from tpudet_torch.heads import refine as t_refine
from tpudet_torch.models import RefineDet, RefineDet320
from tpudet_torch.models.refinedet import _pfpnet_feat_shapes, _refine_feat_shapes
from tpudet_torch.ops import matching as t_matching
from tpudet_torch.ops import nms as t_nms
from tpudet_torch.ops.cuda import assign_kernel, nms_kernel
from tpudet_torch.runtime import transfer
from torch_refine_common import (batch, check_eval_forward, check_test_one_image,
                                 check_tpudet_file, check_train_step, config, gt_rows,
                                 nchw, nhwc, random_stats, rel, tpudet_pair)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _ac_layout(monkeypatch):
    monkeypatch.setenv("TPUDET_SSD_CONF_LAYOUT", "ac")


# ------------------------------------------------------------ anchors
@pytest.mark.parametrize("size", [320, 64])
@pytest.mark.parametrize("family", ["refinedet", "pfpnet"])
def test_anchors_match_tpudet(family, size):
    """Exactly, for both shape functions; 6375 anchors at 320 (40/20/10/5)."""
    ours, theirs = {"refinedet": (_refine_feat_shapes, jax_refine_shapes),
                    "pfpnet": (_pfpnet_feat_shapes, jax_pfpnet_shapes)}[family]
    shapes = ours(size)
    assert shapes == theirs(size)
    want = jax_refine.build_anchors(shapes)
    got = t_refine.build_anchors(shapes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if size == 320:
        assert shapes == [(40, 40), (20, 20), (10, 10), (5, 5)]
        assert got.yx.shape == (6375, 2)


# ------------------------------------------------------------ the deconvolution
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("train", [False, True])
def test_deconv_bn_matches_flax(dtype, tol, train):
    """Output 2x the input at an odd size, and (train) the updated running
    statistics, after ``from_flax``; the kernel transfers flipped."""
    rng = np.random.default_rng(11)
    x = rng.normal(-0.3, 1.0, (2, 5, 7, 6)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    mod = jax_refine._DeconvBN(8, dtype=jdt)
    variables = jax.device_get(mod.init(jax.random.PRNGKey(4), jnp.asarray(x), False))
    variables = {"params": variables["params"],
                 "batch_stats": random_stats(variables["batch_stats"], rng)}
    port = t_refine._DeconvBN(6, 8, dtype=getattr(torch, dtype))
    transfer.load_flax(port, variables)
    kernel = np.asarray(variables["params"]["dconv"]["kernel"])
    np.testing.assert_array_equal(port.dconv.weight.detach().numpy(),
                                  kernel.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
    want, mut = mod.apply(variables, jnp.asarray(x), train, mutable=["batch_stats"])
    got = port.train(train)(nchw(x))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 8, 10, 14)
    assert rel(nhwc(got), np.asarray(want, np.float32)) < tol
    for k in ("mean", "var"):
        assert rel(getattr(port.bn, k).numpy(), mut["batch_stats"]["bn"][k]) < tol / 10


def test_deconv_init_is_flaxs_lecun_normal():
    """A normal truncated at +-2 std, std 1/sqrt(16 * in_ch) after the cut,
    from the caller's generator; zero bias."""
    deconv = t_refine._DeconvBN(256, 64, torch.Generator().manual_seed(0)).dconv
    w = deconv.weight.detach().numpy()
    assert w.shape == (256, 64, 4, 4)
    assert abs(w.std() / np.sqrt(1.0 / (16 * 256)) - 1) < 0.02
    assert np.abs(w).max() <= 2 * np.sqrt(1.0 / (16 * 256)) / 0.87962566103423978
    again = t_refine._DeconvBN(256, 64, torch.Generator().manual_seed(0)).dconv
    assert torch.equal(again.weight, deconv.weight) and not deconv.bias.any()


# ------------------------------------------------------------ the loss
@pytest.fixture(scope="module")
def anchors64():
    shapes = _refine_feat_shapes(64)
    return jax_refine.build_anchors(shapes), t_refine.build_anchors(shapes)


def _heads(rng, b, a, num_classes_total=5):
    """Flattened head outputs; the ARM background logits spread across 0.99."""
    return [rng.normal(0, 0.5, (b, a, 2)).astype(np.float32),
            rng.normal(0, 0.5, (b, a, 2)).astype(np.float32),
            rng.normal(0, 2, (b, a, 2)).astype(np.float32),
            rng.normal(0, 0.5, (b, a, 2)).astype(np.float32),
            rng.normal(0, 0.5, (b, a, 2)).astype(np.float32),
            rng.normal(0, 2, (b, a, num_classes_total)).astype(np.float32)]


def _loss_case(name, rng):
    gt = gt_rows(rng, 3, 12, 6, 64.0)
    if name == "duplicated_best":
        gt[0, 1] = gt[0, 0]  # two gts claim the same best anchor
        gt[1, 1] = gt[1, 0]
        gt[1, 1, 4] = (gt[1, 0, 4] + 1) % 4
    if name == "no_gt":
        gt[2] = -1.0
    if name == "small_cap":
        gt[0, 1:] = -1.0  # one gt: few positives, a budget under the cap
    return gt


@pytest.fixture(scope="module")
def jax_loss_and_grad(anchors64):
    janc, _ = anchors64

    def make(cap):
        def loss(gt, *heads):
            return jax_refine.refine_loss(*heads, janc, gt, 5, neg_sel_cap=cap)

        return jax.jit(jax.value_and_grad(loss, argnums=tuple(range(1, 7))))

    return {384: make(384), 10: make(10)}


@pytest.mark.parametrize("name", ["band", "duplicated_best", "no_gt", "small_cap"])
def test_refine_loss_matches_tpudet(anchors64, jax_loss_and_grad, name):
    """fp32 on identical head tensors: the value and the gradients of all six
    outputs; ARM background logits on both sides of 0.99. ``band``: anchors in
    the ignored 0.4-0.5 band; a duplicated best anchor; an image with no gt;
    ``small_cap``: the mining budget above the cap in one image and below it
    in another."""
    _, tanc = anchors64
    seed = {"band": 0, "duplicated_best": 1, "no_gt": 2, "small_cap": 3}[name]
    rng = np.random.default_rng(seed)
    heads = _heads(rng, 3, tanc.yx.shape[0])
    gt = _loss_case(name, rng)
    cap = 10 if name == "small_cap" else 384
    want, wgrads = jax_loss_and_grad[cap](jnp.asarray(gt), *map(jnp.asarray, heads))

    tt = [torch.tensor(h, requires_grad=True) for h in heads]
    got = t_refine.refine_loss(*tt, tanc, torch.from_numpy(gt), 5, neg_sel_cap=cap)
    grads = torch.autograd.grad(got, tt)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for g, w in zip(grads, wgrads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())

    g = t_matching.unpack_gt(torch.from_numpy(gt))
    asg = t_matching.assign_plain(g.y1x1, g.y2x2, g.valid, tanc.y1x1, tanc.y2x2)
    band = (asg.best_iou >= 0.4) & (asg.best_iou <= 0.5) & ~asg.best_set
    terms = t_refine._image_terms(*map(torch.from_numpy, heads), tanc, g, asg, 5)
    chosen, bg_logit = terms[3], heads[2][..., 1]
    assert (bg_logit < 0.99).any() and (bg_logit >= 0.99).any()
    if name == "band":
        assert int(band.sum()) > 0
    if name == "duplicated_best":
        assert int(asg.best_anchor[0, 0]) == int(asg.best_anchor[0, 1])
    if name == "no_gt":
        assert int(chosen[2]) == 0 and np.isfinite(float(want))
    if name == "small_cap":
        assert int(chosen.max()) > cap > int(chosen.min()) > 0


def test_odm_coord_loss_reaches_the_arm_loc_outputs(anchors64):
    """The ODM box targets are built from the ARM-refined boxes without a
    stop-gradient (tpudet's ``refine.py:334-344``): the gradient at the ARM's
    loc outputs moves with the ODM's loc outputs, which only the ODM
    coordinate loss reads."""
    _, tanc = anchors64
    rng = np.random.default_rng(7)
    heads = [torch.from_numpy(h) for h in _heads(rng, 2, tanc.yx.shape[0])]
    gt = torch.from_numpy(gt_rows(rng, 2, 6, 3, 64.0))

    def arm_loc_grad(odm_yx):
        arm_yx = heads[0].clone().requires_grad_(True)
        loss = t_refine.refine_loss(arm_yx, *heads[1:3], odm_yx, *heads[4:], tanc, gt, 5)
        return torch.autograd.grad(loss, arm_yx)[0]

    first, second = arm_loc_grad(heads[3]), arm_loc_grad(heads[3] + 0.5)
    assert first.abs().sum() > 0 and not torch.equal(first, second)


def test_mining_picks_match_tpudet_exactly(monkeypatch):
    """The ARM's mining at 320 (6375 anchors, the pool taken: 768 of 6375):
    the port's pool, tpudet's ``nms.batched_greedy_nms`` and tpudet's Pallas
    pre-top-k pool (interpret mode) pick the same negatives on the same
    scores."""
    shapes = _refine_feat_shapes(320)
    tanc = t_refine.build_anchors(shapes)
    rng = np.random.default_rng(5)
    heads = _heads(rng, 2, tanc.yx.shape[0])
    gt = gt_rows(rng, 2, 60, 10, 320.0, n_min=4)
    g = t_matching.unpack_gt(torch.from_numpy(gt))
    asg = t_matching.assign_plain(g.y1x1, g.y2x2, g.valid, tanc.y1x1, tanc.y2x2)
    _, neg_ce, neg, chosen, _, _ = t_refine._image_terms(
        *map(torch.from_numpy, heads), tanc, g, asg, 5)
    corners = torch.cat([tanc.y1x1, tanc.y2x2], -1)
    scores = torch.where(neg, neg_ce, t_nms.NEG).contiguous()
    chosen = chosen.to(torch.int32)
    calls = []
    real = nms_kernel.nms_rows

    def spy(boxes, scores, ns, max_out, thr, order=None):
        calls.append(None if order is None else tuple(order.shape))
        return real(boxes, scores, ns, max_out, thr, order)

    monkeypatch.setattr(nms_kernel, "nms_rows", spy)
    got = nms_kernel.batched_greedy_nms_pretopk(corners, scores, chosen, 384, 0.7)
    assert calls == [(2, 768)]  # the pool, not the full rows
    assert int(chosen.min()) > 0 and int(got[1].sum()) > 0
    j = [jnp.asarray(t.numpy()) for t in (corners, neg_ce, chosen)]
    want = jax_nms.batched_greedy_nms(*j, 384, 0.7, active=jnp.asarray(neg.numpy()))
    pallas = pallas_pretopk(j[0], jnp.asarray(scores.numpy()), j[2], 384, 0.7,
                            interpret=True)
    for other in (want, pallas):
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(other[1]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(other[0]))


# ------------------------------------------------------------ the decode
def test_refine_decode_matches_tpudet():
    """The same head tensors of one image at 320 through both decodes (tpudet
    with a pre-top-k as wide as the anchors, so it does not truncate):
    identical picks. The ARM filter drops some anchors that would pass the
    score threshold: their ARM background probability is >= 0.99."""
    tanc = t_refine.build_anchors(_refine_feat_shapes(320))
    janc = jax_refine.build_anchors(_refine_feat_shapes(320))
    a = tanc.yx.shape[0]
    rng = np.random.default_rng(8)
    heads = [h[0] for h in _heads(rng, 1, a, 21)]
    drop = rng.uniform(size=a) < 0.3
    heads[2][drop, 1] += 8.0  # ARM background probability above 0.99
    want = jax_refine.refine_decode(*map(jnp.asarray, heads), janc, 21, 0.1, 0.45, 20,
                                    pre_topk=a)
    want = [np.asarray(w) for w in want]
    assert not bool(want[4])
    got = [t.numpy() for t in t_refine.refine_decode(*map(torch.from_numpy, heads), tanc,
                                                     21, 0.1, 0.45, 20)]
    valid = want[3]
    np.testing.assert_array_equal(got[3], valid)
    assert valid.sum() > 20
    np.testing.assert_array_equal(got[2][valid], want[2][valid])
    np.testing.assert_allclose(got[0][valid], want[0][valid], rtol=1e-6)
    np.testing.assert_allclose(got[1][valid], want[1][valid], rtol=1e-5, atol=1e-4)
    odmp = torch.softmax(torch.from_numpy(heads[5]), -1)
    flipped = (torch.softmax(torch.from_numpy(heads[2]), -1)[:, 1] >= 0.99) & (
        odmp.argmax(-1) < 20) & (odmp[:, :20].max(-1).values >= 0.1)
    assert int(flipped.sum()) > 0


# ------------------------------------------------------------ the whole model
@pytest.fixture(scope="module")
def pair():
    return tpudet_pair(JaxRefineDet, RefineDet320)


def test_refinenet_levels_match_tpudet(pair):
    """Eval mode after ``load_flax``, float32: the 16 per-level outputs; the
    anchors. (bfloat16 is held in ``tests/test_torch_pfpnet.py``, whose
    extractor promotes dtypes; here each layer's bf16 casts are ConvBN's and
    ``_DeconvBN``'s, held above and in ``tests/test_torch_train.py``.)"""
    jm, variables, image = pair
    pm = check_eval_forward(jm, RefineDet320, variables, image)
    for g, w in zip(pm.anchors, jm.anchors):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_test_one_image_matches_tpudet(pair):
    jm, variables, image = pair
    check_test_one_image(jm, RefineDet320, variables, image)


def test_train_step_matches_tpudet(pair):
    """Train-mode levels, the loss and the state after one float32 step."""
    jm, variables, _ = pair
    launches = (assign_kernel.launches, nms_kernel.launches)
    check_train_step(jm, RefineDet320, variables)
    assert (assign_kernel.launches, nms_kernel.launches) == launches  # CPU: plain


def test_tpudet_checkpoint_loads_into_the_port(tmp_path, pair):
    jm, variables, image = pair
    check_tpudet_file(tmp_path, jm, RefineDet320, variables, image)


def test_train_one_epoch_and_serving():
    """The loss falls on one fixed batch through ``train_one_epoch``; serving
    after training returns finite boxes; ``RefineDet`` is the same class."""
    assert RefineDet is RefineDet320
    b = batch(8)

    def feed():
        while True:
            yield b

    pm = RefineDet320(config(), {"num_train": 6, "train_generator": feed()},
                      device="cpu")
    losses = []

    class Writer:
        def add_summary(self, loss, global_step):
            losses.append(float(loss))

    pm.train_one_epoch(1e-4, Writer())
    assert len(losses) == 3 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    scores, boxes, cid = pm.test_one_image(b[0][:1])
    assert np.isfinite(boxes).all() and boxes.shape == (len(scores), 4)


def test_refinedet_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RefineDet320(config(compute_dtype="bfloat16"))
