"""The port's Light-Head R-CNN against tpudet's on the same numpy inputs:
the anchors and their border filter, ``crop_and_resize`` (values and
gradients, float32 and bfloat16, boxes partly and wholly outside the frame
and degenerate), the network at 192x320 (a 6x10 grid, 257 kept anchors, the
stride-2 SAME paddings all asymmetric) and the training script's full
width, ``rpn_loss_and_sample`` on identical head outputs (two gts that share
a best anchor, an image with no gt, a negative budget ``256 - chosen_pos``
under the cap), ``rcnn_losses``, ``lhrcnn_decode`` and ``test_one_image``
(picks exact) and the checkpoints (the train steps are in
``tests/test_torch_lhrcnn_step.py``). tpudet runs its CPU branches: the
NMS's XLA loop and the gather crop. Each tolerance is stated in its test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.heads import lhrcnn as jax_lh
from tpudet.models.lhrcnn import LHRCNN as JaxLHRCNN
from tpudet.models.lhrcnn import LHRCNNNet as JaxNet
from tpudet.ops import nms as jax_nms
from tpudet.ops import roi as jax_roi
from tpudet.runtime import optim as jax_optim
from tpudet_torch.heads import lhrcnn as t_lh
from tpudet_torch.models import LHRCNN
from tpudet_torch.ops import roi as t_roi
from tpudet_torch.runtime import transfer
from torch_anchor_free_common import check_outputs
from torch_refine_common import nchw, rel, tree_like

torch.set_num_threads(1)

HW = (192, 320)
DRIVER_HW = (700, 1100)
NUM_CLASSES = 4


def config(**kw):
    """``drivers/testlhrcnn.py``'s config at 192x320, batch 2 and 4 classes,
    with a short phase schedule and a score threshold that a 5-way softmax
    of random weights passes."""
    cfg = {"mode": "train", "data_shape": [*HW, 3], "data_format": "channels_last",
           "num_classes": NUM_CLASSES, "weight_decay": 1e-4, "keep_prob": 0.5,
           "batch_size": 2, "rpn_first_step": 3, "rcnn_first_step": 5,
           "rpn_second_step": 7, "nms_score_threshold": 0.2, "nms_max_boxes": 10,
           "nms_iou_threshold": 0.45, "post_nms_proposal": 500, "seed": 3}
    cfg.update(kw)
    return cfg


def lhrcnn_variables(net, rng, hw):
    """Variables of tpudet's ``LHRCNNNet`` at input ``hw``, trunk and RoI
    head, drawn from ``rng``: kernels normal with std ``sqrt(1 / fan_in)``,
    small biases, BatchNorm scales near 1, statistics mean ~N(0, 0.5) and
    var in [0.5, 2]."""
    def init_all(mdl, x, feats):
        return mdl(x, False), mdl.roi_head(feats)

    shapes = jax.eval_shape(
        lambda key: net.init(key, jnp.zeros((1, *hw, 3)), jnp.zeros((1, 7, 7, 490)),
                             method=init_all), jax.random.PRNGKey(0))

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            out = rng.normal(0, np.sqrt(1.0 / np.prod(shape[:-1])), shape)
        elif name == "scale":
            out = rng.uniform(0.5, 1.5, shape)
        elif name == "bias":
            out = rng.normal(0, 0.05, shape)
        elif name == "mean":
            out = rng.normal(0, 0.5, shape)
        else:
            out = rng.uniform(0.5, 2.0, shape)
        return out.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def tpudet_model(cfg, seed=0):
    """tpudet's LHRCNN from ``cfg`` with seeded numpy variables, on one
    device (no batch padding, so its step takes the batch as it is), and
    the variables."""
    rng = np.random.default_rng(seed)

    class Seeded(JaxLHRCNN):
        def _init_variables(self):
            v = lhrcnn_variables(self.net, rng, self.data_shape_hw)
            self.params, self.batch_stats = v["params"], v["batch_stats"]
            self._optimizer = self._make_optimizer()
            self.opt_state = None

        def _setup_mesh(self):
            self.device_batch = self.batch_size

    jm = Seeded(cfg)
    return jm, {"params": jax.device_get(jm.params),
                "batch_stats": jax.device_get(jm.batch_stats)}


def port_model(variables, **kw):
    pm = LHRCNN(config(**kw), device="cpu")
    transfer.load_flax(pm.net, variables)
    return pm


@pytest.fixture(scope="module")
def pair():
    jm, variables = tpudet_model(config(mode="test"))
    image = np.random.default_rng(7).uniform(0, 255, (1, *HW, 3)).astype(np.float32)
    return jm, variables, image


def gt_batch(rng, hw, n=6):
    """Two images: image 0 holds ``n`` gts, the first two nearly the same box
    (they share a best anchor); image 1 holds none."""
    h, w = hw
    gt = -np.ones((2, n + 2, 5), np.float32)
    gt[0, 0] = [0.45 * h, 0.4 * w, 0.35 * h, 0.25 * w, 1]
    gt[0, 1] = gt[0, 0] + [1.0, -1.0, 2.0, 1.0, 2]
    for k in range(2, n):
        bh, bw = rng.uniform(0.1, 0.6) * h, rng.uniform(0.1, 0.6) * w
        gt[0, k] = [rng.uniform(bh / 2, h - bh / 2), rng.uniform(bw / 2, w - bw / 2),
                    bh, bw, rng.integers(0, NUM_CLASSES)]
    return gt


def anchors_at(hw):
    fh, fw = -(-hw[0] // 32), -(-hw[1] // 32)
    return jax_lh.build_anchors(fh, fw, 32.0, *hw), t_lh.build_anchors(fh, fw, 32.0, *hw)


@pytest.mark.parametrize("hw,kept", [(HW, 257), (DRIVER_HW, 6818)])
def test_build_anchors_match_tpudet(hw, kept):
    """The keep mask and the kept corners and centres, exactly; 6818 of
    11,550 anchors at the training script's 700x1100."""
    (j_anc, j_keep), (t_anc, t_keep) = anchors_at(hw)
    np.testing.assert_array_equal(t_keep, j_keep)
    assert int(t_keep.sum()) == kept
    for got, want in zip(t_anc, j_anc):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_crop_and_resize_matches_tpudet(dtype):
    """tpudet's gather form, vmapped over 2 images, against the port's
    batched crop: values, and the gradients of a random projection of the
    crops with respect to the features and the boxes. Boxes inside, partly
    and wholly outside the frame, zero-height and flipped. float32: values
    and box gradients to 1e-6 normwise, feature gradients to 1e-6 (sums in
    other orders); bfloat16: values to one bf16 ulp (2^-7 relative)
    elementwise, since a float32 lerp a few ulps off rounds to the next bf16
    value, and gradients to 1e-2 normwise (tpudet scatter-adds the feature
    gradient in bfloat16, the port in float32)."""
    rng = np.random.default_rng(5)
    feat = rng.normal(size=(2, 6, 10, 16)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(-0.3, 1.3, (2, 12, 2)),
                            rng.uniform(-0.3, 1.3, (2, 12, 2))], -1).astype(np.float32)
    boxes[:, 0] = [0.1, 0.2, 0.6, 0.9]
    boxes[:, 1] = [1.2, 1.1, 1.5, 1.4]        # wholly outside
    boxes[:, 2] = [0.3, 0.2, 0.3, 0.8]        # zero height
    boxes[:, 3] = [0.8, 0.7, 0.2, 0.1]        # flipped
    cot = rng.normal(size=(2, 12, 7, 7, 16)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jax_loss(f, b):
        out = jax.vmap(lambda f_, b_: jax_roi._crop_gather(f_, b_, 7))(f, b)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, want), (g_feat, g_box) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(jnp.asarray(feat).astype(jdt),
                                                 jnp.asarray(boxes))
    f = nchw(feat).to(tdt).requires_grad_()
    b = torch.tensor(boxes, requires_grad=True)
    got = t_roi.crop_and_resize(f, b, 7)
    assert got.dtype == tdt and tuple(got.shape) == (2, 12, 7, 7, 16)
    t_feat, t_box = torch.autograd.grad(torch.sum(got.float() * torch.tensor(cot)), (f, b))
    want = np.asarray(want.astype(jnp.float32))
    got = got.detach().float().numpy()
    assert not got[:, 1].any()  # a box outside the frame crops zeros
    g_feat = np.asarray(g_feat.astype(jnp.float32)).transpose(0, 3, 1, 2)
    if dtype == "float32":
        assert rel(got, want) < 1e-6
        assert rel(t_feat.numpy(), g_feat) < 1e-6
        assert rel(t_box.numpy(), np.asarray(g_box)) < 1e-6
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)
        assert rel(t_feat.float().numpy(), g_feat) < 1e-2
        assert rel(t_box.numpy(), np.asarray(g_box)) < 1e-2


def test_lhrcnn_net_matches_tpudet(pair):
    """Eval mode, float32, at 192x320 and full width: the RPN maps and the
    thin feature map to 1e-4 normwise, or 4x the port's own difference
    between its two CPU summation orders; the RPN outputs split over the kept
    anchors equal tpudet's split of the same maps (a flax NHWC reshape
    numbers anchors (row, column, prior)); the RoI head on the same crops to
    1e-5 normwise."""
    jm, variables, image = pair
    x = image / 127.5 - 1.0
    net = JaxNet(num_classes_total=NUM_CLASSES + 1)
    want = jax.jit(lambda v, x: net.apply(v, x, False))(variables, jnp.asarray(x))
    pm = port_model(variables, mode="test")
    assert sum(p.numel() for p in pm.net.parameters()) == sum(
        np.size(v) for v in jax.tree.leaves(variables["params"]))
    with torch.no_grad():
        got = pm.net(nchw(x))
        with torch.backends.mkldnn.flags(enabled=False):  # the other summation order
            other = pm.net(nchw(x))
    assert [tuple(t.shape) for t in got] == [(1, 30, 6, 10), (1, 60, 6, 10),
                                             (1, 490, 6, 10)]
    check_outputs(got, want, 1e-4, other)

    split = [t.numpy() for t in pm._split_rpn(*(nchw(np.asarray(w)) for w in want[:2]))]
    for g, w in zip(split, jm._split_rpn(*want[:2])):
        np.testing.assert_array_equal(g, np.asarray(w))

    crops = np.random.default_rng(2).normal(size=(6, 7, 7, 490)).astype(np.float32)
    w_conf, w_box = jax.jit(lambda v, f: net.apply(v, f, method=JaxNet.roi_head))(
        variables, jnp.asarray(crops))
    with torch.no_grad():
        t_conf, t_box = pm.net.roi_head(torch.tensor(crops))
    assert rel(t_conf.numpy(), np.asarray(w_conf)) < 1e-5
    assert rel(t_box.numpy(), np.asarray(w_box)) < 1e-5


def rpn_heads(rng, a):
    """Seeded RPN outputs over ``a`` kept anchors, batch 2."""
    pyx = (0.2 * rng.normal(size=(2, a, 2))).astype(np.float32)
    phw = (0.2 * rng.normal(size=(2, a, 2))).astype(np.float32)
    pconf = (2.0 * rng.normal(size=(2, a, 2))).astype(np.float32)
    return pyx, phw, pconf


@pytest.mark.parametrize("hw", [HW, DRIVER_HW])
def test_rpn_loss_and_sample_matches_tpudet(hw):
    """Identical head outputs and gts: both sampling NMS calls' selections
    exactly (tpudet's own calls, ``heads/lhrcnn.py:268-273``), then every
    field of the sample to 1e-6 (relative; absolute 1e-4 for the proposals'
    corners, about an ulp of a coordinate near 1100, where a corner near 0
    is its centre minus half its size): the exp, log and softmax of the two
    frameworks differ in the last bit. At 700x1100 image 0's negative budget
    is ``256 - chosen_pos``, under the cap, and image 1 (no gt) samples no
    positive and 256 negatives. The single-image form gives image 0's
    sample."""
    (j_anc, _), (t_anc, _) = anchors_at(hw)
    rng = np.random.default_rng(11)
    heads = rpn_heads(rng, j_anc.yx.shape[0])
    gt = gt_batch(rng, hw, n=6 if hw == HW else 20)

    def jax_side(pyx, phw, pconf, gt):
        pre = jax.vmap(lambda c, g: jax_lh._rpn_pre_nms(None, None, c, j_anc, g))(
            pconf, gt)
        pos = jax_nms.batched_greedy_nms(pre.row_boxes, pre.row_obj_prob,
                                         pre.chosen_pos, jax_lh.POS_CAP, 0.7,
                                         active=pre.row_valid)
        corners = jnp.concatenate([j_anc.y1x1, j_anc.y2x2], -1)
        neg = jax_nms.batched_greedy_nms(corners, pre.neg_ce, pre.chosen_neg,
                                         jax_lh.TOTAL_CAP, 0.7, active=pre.neg)
        sample = jax_lh.rpn_loss_and_sample(pyx, phw, pconf, j_anc, gt)
        return (*pos, *neg), pre.chosen_pos, pre.chosen_neg, sample

    j_sel, j_pos, j_neg, j_sample = jax.device_get(jax.jit(jax_side)(*heads, gt))
    t_heads = [torch.tensor(h) for h in heads]
    rows = t_lh.rpn_rows(t_heads[2], t_anc, torch.tensor(gt))
    t_sel = t_lh.rpn_select(rows, t_anc)
    np.testing.assert_array_equal(rows.chosen_pos.numpy(), j_pos)
    np.testing.assert_array_equal(rows.chosen_neg.numpy(), j_neg)
    for g, w in zip(t_sel, j_sel):
        np.testing.assert_array_equal(g.numpy(), w)
    assert j_pos[0] > 0 and j_pos[1] == 0 and int(j_sel[1][1].sum()) == 0
    assert rows.row_anchor[0, 0] == rows.row_anchor[0, 1]  # a shared best anchor
    if hw == DRIVER_HW:
        assert j_neg[0] == 256 - j_pos[0] and j_neg[1] == 256

    got = t_lh.rpn_loss_and_sample(*t_heads, t_anc, torch.tensor(gt))
    one = t_lh.rpn_image_loss_and_sample(*(t[0] for t in t_heads), t_anc,
                                         torch.tensor(gt[0]))
    for g, w in zip(one, got):
        np.testing.assert_allclose(g.numpy(), w[0].numpy(), rtol=1e-6)
    for name, g, w in zip(got._fields, got, j_sample):
        g, w = g.numpy(), np.asarray(w)
        if g.dtype in (np.bool_, np.int32):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            atol = 1e-4 if name.endswith("proposal") else 1e-6
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=atol, err_msg=name)


def _jax_head_fn(net, variables):
    def fn(feats):
        return net.apply(variables, feats, method=JaxNet.roi_head)
    return fn


def test_rcnn_losses_matches_tpudet(pair):
    """The RCNN loss on tpudet's own sample of one image and the same thin
    map at 192x320 (its boxes partly outside the frame), float32: the loss to 1e-6
    relative and its gradient with respect to the thin map to 1e-5 normwise
    (the port's head sees the rows image by image, tpudet's positives
    first)."""
    jm, variables, _ = pair
    (j_anc, _), (t_anc, _) = anchors_at(HW)
    rng = np.random.default_rng(13)
    heads = [h[:1] for h in rpn_heads(rng, j_anc.yx.shape[0])]
    gt = gt_batch(rng, HW)[:1]
    sample = jax.device_get(jax.jit(lambda *a: jax_lh.rpn_loss_and_sample(
        *a, j_anc, gt))(*heads))
    feat = rng.normal(size=(1, 6, 10, 490)).astype(np.float32)
    net = JaxNet(num_classes_total=NUM_CLASSES + 1)

    def jax_loss(f):
        return jax_lh.rcnn_losses(_jax_head_fn(net, variables), f, sample,
                                  float(HW[0]), float(HW[1]), NUM_CLASSES + 1)

    w_loss, w_grad = jax.jit(jax.value_and_grad(jax_loss))(jnp.asarray(feat))
    pm = port_model(variables, mode="test")
    f = nchw(feat).requires_grad_()
    t_sample = t_lh.RPNSample(*(torch.tensor(np.asarray(s)) for s in sample))
    loss = t_lh.rcnn_losses(pm.net.roi_head, f, t_sample, float(HW[0]), float(HW[1]),
                            NUM_CLASSES + 1)
    (grad,) = torch.autograd.grad(loss, f)
    np.testing.assert_allclose(float(loss.detach()), float(w_loss), rtol=1e-6)
    assert rel(grad.numpy(), np.asarray(w_grad).transpose(0, 3, 1, 2)) < 1e-5


def test_lhrcnn_decode_matches_tpudet(pair, hw=DRIVER_HW):
    """One image's decode on identical head outputs at the training
    script's 700x1100 (``test_one_image`` below covers 192x320), float32: the valid
    picks' classes and the valid mask exactly, their scores and boxes to
    1e-5 relative and the boxes to 1e-5 relative or 1e-3 px (a corner is
    its centre minus half its size, which cancels; the RoI head's sums
    differ in the last bits). At 700x1100 the proposal NMS keeps 500 of
    6818 through a 1000-wide pool. tpudet's per-class top-k is as wide as
    the 500 proposals, so it does not truncate."""
    _, variables, _ = pair
    (j_anc, _), (t_anc, _) = anchors_at(hw)
    rng = np.random.default_rng(17)
    pyx, phw, pconf = (h[0] for h in rpn_heads(rng, j_anc.yx.shape[0]))
    fh, fw = -(-hw[0] // 32), -(-hw[1] // 32)
    feat = rng.normal(size=(fh, fw, 490)).astype(np.float32)
    net = JaxNet(num_classes_total=NUM_CLASSES + 1)
    args = (float(hw[0]), float(hw[1]), NUM_CLASSES + 1, 500, 0.2, 0.45, 10)
    want = jax.device_get(jax.jit(lambda f, y, h, c: jax_lh.lhrcnn_decode(
        _jax_head_fn(net, variables), f, y, h, c, j_anc, *args, pre_topk=500))(
            feat, pyx, phw, pconf))
    assert not want[4]
    pm = port_model(variables, mode="test")
    with torch.no_grad():
        got = t_lh.lhrcnn_decode(pm.net.roi_head, torch.tensor(feat).permute(2, 0, 1),
                                 *(torch.tensor(t) for t in (pyx, phw, pconf)), t_anc,
                                 *args)
    valid = np.asarray(want[3])
    assert valid.sum() > 0
    np.testing.assert_array_equal(got[3].numpy(), valid)
    np.testing.assert_array_equal(got[2].numpy()[valid], np.asarray(want[2])[valid])
    np.testing.assert_allclose(got[0].numpy()[valid], np.asarray(want[0])[valid],
                               rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy()[valid], np.asarray(want[1])[valid],
                               rtol=1e-5, atol=1e-3)


def test_test_one_image_matches_tpudet(pair):
    """The whole request at 192x320, float32: the same detections (classes
    exactly, scores and boxes to 1e-4, the network's sums in other orders)."""
    jm, variables, image = pair
    want = jm.test_one_image(image)
    got = port_model(variables, mode="test").test_one_image(image)
    assert len(want[0]) > 0
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-3)


def test_tpudet_lhrcnn_file_loads_into_the_port(tmp_path, pair):
    """tpudet's ``save_weight`` (params, statistics, a non-zero Momentum
    velocity, step 7) through the port's ``load_weight``, strictly: the same
    tensors, velocity and step. Then ``load_pretraining_weight``
    (``feature_extractor``'s parameters) and ``load_rpn_weight``
    (``feature_extractor`` and ``rpn`` with their statistics), in turn, from
    that ``.tpudet`` file and from the port's ``.pt``, into a model of other
    weights, which keeps the rest. (The two files are ~440 MB each: the RoI
    head's dense layer holds 49M of the 55M parameters.)"""
    jm, variables, _ = pair
    velocity = tree_like(variables["params"], lambda v: np.float32(0.5) * v - 0.01)
    jm.opt_state = jax_optim.MomentumState(velocity)
    jm.global_step = 7
    try:
        jm.save_weight("latest", str(tmp_path / "model"))
    finally:
        jm.opt_state, jm.global_step = None, 0
    want = transfer.from_flax(variables)
    assert "rcnn.head.roi_feat_dense.weight" in want
    assert "feature_extractor.stage2_sconv2.depthwise.weight" in want

    pm = LHRCNN(config(seed=11), device="cpu")
    pm.load_weight(str(tmp_path / "model"))
    got = pm.net.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    for k, v in transfer.velocity_from_flax(velocity).items():
        assert torch.equal(pm.velocity[k], v), k
    assert pm.global_step == 7
    pm.save_weight("latest", str(tmp_path / "port"))

    for path in ("model-7.tpudet", "port-7.pt"):
        other = LHRCNN(config(seed=12), device="cpu")
        before = {k: v.clone() for k, v in other.net.state_dict().items()}
        for loader, scopes in (("load_pretraining_weight", ("feature_extractor.",)),
                               ("load_rpn_weight", ("feature_extractor.", "rpn."))):
            getattr(other, loader)(str(tmp_path / path))
            after = other.net.state_dict()
            stats = loader == "load_rpn_weight"
            for k in want:
                moved = k.startswith(scopes) and (stats or not k.endswith((".mean", ".var")))
                assert torch.equal(after[k], want[k] if moved else before[k]), (loader, k)
    for f in tmp_path.iterdir():
        f.unlink()


def test_lhrcnn_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LHRCNN(config())
