"""Light-Head R-CNN: anchors, the Xception-lite trunk, the RoI head, RPN
sampling, the RCNN loss and the decode (counterpart of
``tpudet/heads/lhrcnn.py``).

Rules kept from tpudet:
  * 15 anchors a cell (scale-major, ratio-minor) and a STATIC border filter
    that keeps ``y2x2 <= (H-1) - 1``: 6818 of 11,550 anchors at 700x1100;
  * RPN matching: each gt's best anchor, then IoU > 0.5 positives and < 0.3
    negatives, the IoU's union carrying an epsilon of 1e-8; sampling is
    greedy NMS (IoU 0.7) on the objectness for at most 128 positives, over
    rows ``[G + A]`` of per-row boxes (the gts' best anchors, then every
    anchor), and NMS on the negative CE over the shared anchors for at most
    ``256 - chosen_pos`` negatives, both through the NMS kernel's pool;
  * the RCNN yx target divides by the proposal CENTRE (quirk Q12), and the
    clip bound and the crop normaliser are ``[h, w]``, not ``[h-1, w-1]``.

Maps are NCHW; the RoI head takes crops channels-last (``ops/roi.py``), so
it flattens in flax's (row, column, channel) order and its dense kernels
transfer as they are.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpudet_torch.heads.ssd import AnchorSet
from tpudet_torch.nn.layers import BatchNorm, ConvBN, lecun_normal_, max_pool_same
from tpudet_torch.ops import anchors as anchor_ops
from tpudet_torch.ops import boxes as box_ops
from tpudet_torch.ops import losses as loss_ops
from tpudet_torch.ops import matching, nms, roi
from tpudet_torch.ops.cuda import nms_kernel

ANCHOR_SCALES = (32.0, 64.0, 128.0, 256.0, 512.0)
ANCHOR_RATIOS = (0.5, 1.0, 2.0)
POS_CAP = 128
TOTAL_CAP = 256
CROP = 7
THIN_CHANNELS = 490


def build_anchors(fh: int, fw: int, stride: float, img_h: int, img_w: int,
                  device: torch.device | str = "cpu"):
    """15 anchors a cell, then the static border filter. Returns the
    AnchorSet of the KEPT anchors and the numpy keep mask over all
    ``fh * fw * 15``."""
    priors = [[size * (r ** 0.5), size / (r ** 0.5)]
              for size in ANCHOR_SCALES for r in ANCHOR_RATIOS]
    y1x1, y2x2, yx, hw = anchor_ops.grid_anchors(fh, fw, priors, stride, stride)
    h_lim, w_lim = float(img_h - 1), float(img_w - 1)
    keep = ((y1x1[:, 0] >= 0) & (y1x1[:, 1] >= 0)
            & (y2x2[:, 0] <= h_lim - 1) & (y2x2[:, 1] <= w_lim - 1))
    return AnchorSet(*(torch.from_numpy(np.ascontiguousarray(a[keep])).to(device)
                       for a in (y1x1, y2x2, yx, hw))), keep


class _KernelConv(nn.Module):
    """A bias-free SAME convolution of stride 1 and an odd ``kernel`` (flax's
    ``nn.Conv(..., use_bias=False)``; ``groups=in_ch`` is a depthwise one)
    with flax's default lecun-normal kernel, in compute ``dtype``."""

    def __init__(self, in_ch: int, filters: int, kernel, groups: int = 1,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(filters, in_ch // groups, *kernel))
        lecun_normal_(self.weight, generator)
        self.groups, self.compute_dtype = groups, dtype

    def forward(self, x):
        kh, kw = self.weight.shape[-2:]
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), padding=(kh // 2, kw // 2),
                        groups=self.groups)


class SeparableConvBN(nn.Module):
    """``tf.layers.separable_conv2d`` (depthwise ``kernel``, then pointwise
    1x1, no bias) -> BatchNorm -> ReLU."""

    def __init__(self, in_ch: int, filters: int, kernel,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depthwise = _KernelConv(in_ch, in_ch, kernel, in_ch, generator, dtype)
        self.pointwise = _KernelConv(in_ch, filters, (1, 1), 1, generator, dtype)
        self.bn = BatchNorm(filters)

    def forward(self, x):
        return torch.relu(self.bn(self.pointwise(self.depthwise(x))))


class XceptionLite(nn.Module):
    """The separable-conv stride-32 trunk: 576 channels out."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()

        def conv(name, cin, cout):
            self.add_module(name, ConvBN(cin, cout, 3, stride=2, activation=torch.relu,
                                         generator=generator, dtype=dtype))

        def seps(stage, width, count):
            for i in range(count):
                self.add_module(f"stage{stage}_sconv{i + 2}",
                                SeparableConvBN(width, width, (3, 3), generator, dtype))

        conv("stage1_conv1", 3, 24)
        conv("stage2_conv1", 24, 144)
        seps(2, 144, 3)
        conv("stage3_conv1", 144, 288)
        seps(3, 288, 7)
        conv("stage4_conv1", 288, 576)
        seps(4, 576, 3)

    def forward(self, x):
        for name, module in self.named_children():
            x = module(x)
            if name == "stage1_conv1":
                x = max_pool_same(x, 3, 2)
        return x


class _Dense(nn.Linear):
    """flax's ``nn.Dense``: lecun-normal kernel from the caller's generator,
    zero bias; input and kernel cast to ``dtype``, the bias added after the
    product in it."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        lecun_normal_(self.weight, generator)
        with torch.no_grad():
            self.bias.zero_()
        self.compute_dtype = dtype

    def reset_parameters(self):
        # nn.Linear's own init would draw from the global RNG
        pass

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class RoIHead(nn.Module):
    """flatten -> dense 2048 + ReLU -> ``num_classes_total`` logits and 4 box
    deltas, returned in float32. Takes channels-last crops ``[N, 7, 7, C]``."""

    def __init__(self, num_classes_total: int, in_ch: int = THIN_CHANNELS,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.roi_feat_dense = _Dense(CROP * CROP * in_ch, 2048, generator, dtype)
        self.rcnn_pconf = _Dense(2048, num_classes_total, generator, dtype)
        self.rcnn_pbbox = _Dense(2048, 4, generator, dtype)

    def forward(self, feats):
        x = torch.relu(self.roi_feat_dense(feats.reshape(feats.shape[0], -1)))
        return self.rcnn_pconf(x).float(), self.rcnn_pbbox(x).float()


class RPNSample(NamedTuple):
    """Fixed-slot RPN result feeding the RCNN stage (leading batch dims)."""

    rpn_loss: torch.Tensor      # [...]
    pos_proposal: torch.Tensor  # [..., POS_CAP, 4] corners (pixels, unclipped)
    pos_label: torch.Tensor     # [..., POS_CAP] int32
    pos_truth: torch.Tensor     # [..., POS_CAP, 4] rcnn box targets (Q12)
    pos_valid: torch.Tensor     # [..., POS_CAP] bool
    neg_proposal: torch.Tensor  # [..., TOTAL_CAP, 4]
    neg_valid: torch.Tensor     # [..., TOTAL_CAP] bool


class RPNRows(NamedTuple):
    """The sampling NMS's inputs, batched."""

    row_boxes: torch.Tensor     # [B, G+A, 4]: the gts' best anchors, then every anchor
    row_obj_prob: torch.Tensor  # [B, G+A]
    row_valid: torch.Tensor     # [B, G+A] bool
    row_anchor: torch.Tensor    # [B, G+A] int32
    row_gt: torch.Tensor        # [B, G+A] int32
    row_ce: torch.Tensor        # [B, G+A]
    chosen_pos: torch.Tensor    # [B] int32
    neg_ce: torch.Tensor        # [B, A]
    neg: torch.Tensor           # [B, A] bool
    chosen_neg: torch.Tensor    # [B] int32


def rpn_rows(pconf, anc: AnchorSet, gt) -> RPNRows:
    """Matching and the sampling NMS's inputs, up to the two NMS calls
    (``pconf [B, A, 2]``, ``gt [B, G, 5]``)."""
    g = matching.unpack_gt(gt)
    b, n_gt = gt.shape[:2]
    a = anc.y1x1.shape[0]
    iou = box_ops.pairwise_iou(g.y1x1, g.y2x2, anc.y1x1, anc.y2x2, eps=1e-8)
    iou = torch.where(g.valid[..., None], iou, 0.0)
    best_anchor = matching.best_anchor_per_gt(iou)
    other = ~matching.scatter_best_mask(best_anchor, g.valid, a)
    max_agiou, rg = matching.best_gt_per_anchor(iou, g.valid)
    pos_other = other & (max_agiou > 0.5)
    neg = other & (max_agiou < 0.3)

    dev = pconf.device
    row_anchor = torch.cat([best_anchor, torch.arange(
        a, dtype=torch.int32, device=dev).expand(b, a)], 1)
    row_gt = torch.cat([torch.arange(n_gt, dtype=torch.int32, device=dev).expand(b, n_gt),
                        rg], 1)
    row_valid = torch.cat([g.valid, pos_other], 1)
    ra = row_anchor.long()
    row_boxes = torch.cat([anc.y1x1[ra], anc.y2x2[ra]], -1)
    obj = torch.softmax(pconf, -1)[..., 0]
    labels = torch.zeros((b, a), dtype=torch.int32, device=dev)
    pos_ce = loss_ops.softmax_cross_entropy(pconf, labels)
    row_obj_prob, row_ce = matching.gather_gt_rows(row_anchor, obj, pos_ce)

    num_pos = g.count + torch.sum(pos_other.to(torch.int32), -1)
    chosen_pos = torch.clamp(num_pos, max=POS_CAP).to(torch.int32)
    neg_ce = loss_ops.softmax_cross_entropy(pconf, labels + 1)
    num_neg = torch.sum(neg.to(torch.int32), -1)
    chosen_neg = torch.minimum(num_neg, TOTAL_CAP - chosen_pos).to(torch.int32)
    return RPNRows(row_boxes, row_obj_prob, row_valid, row_anchor, row_gt, row_ce,
                   chosen_pos, neg_ce, neg, chosen_neg)


def rpn_select(rows: RPNRows, anc: AnchorSet):
    """The two sampling NMS calls through the NMS kernel's pool: positives on
    the per-row boxes by objectness, negatives on the shared anchors by their
    detached CE, IoU 0.7. Returns ``(pos_sel, pos_valid, neg_sel,
    neg_valid)``; the selection passes no gradient."""
    pos_scores = torch.where(rows.row_valid, rows.row_obj_prob.detach(), nms.NEG)
    pos = nms_kernel.batched_greedy_nms_pretopk(
        rows.row_boxes.contiguous(), pos_scores.contiguous(), rows.chosen_pos, POS_CAP,
        0.7)
    anc_corners = torch.cat([anc.y1x1, anc.y2x2], -1)
    neg_scores = torch.where(rows.neg, rows.neg_ce.detach(), nms.NEG)
    neg = nms_kernel.batched_greedy_nms_pretopk(
        anc_corners, neg_scores.contiguous(), rows.chosen_neg, TOTAL_CAP, 0.7)
    return (*pos, *neg)


def _masked_mean(values, mask_f):
    return torch.sum(values * mask_f, -1) / torch.clamp(torch.sum(mask_f, -1), min=1.0)


def _corners(yx, hw):
    return torch.cat([yx - hw / 2.0, yx + hw / 2.0], -1)


def rpn_sample(rows: RPNRows, pos_sel, pos_valid, neg_sel, neg_valid, pyx, phw,
               anc: AnchorSet, gt) -> RPNSample:
    """The RPN loss and the proposals from the NMS selections onward."""
    g = matching.unpack_gt(gt)
    pos_f, neg_f = pos_valid.to(torch.float32), neg_valid.to(torch.float32)
    row_ce, sel_anchor, sel_gt = matching.gather_gt_rows(
        pos_sel, rows.row_ce, rows.row_anchor, rows.row_gt)
    pos_conf_loss = _masked_mean(row_ce, pos_f)
    neg_loss = _masked_mean(matching.gather_gt_rows(neg_sel, rows.neg_ce)[0], neg_f)

    sa, ns = sel_anchor.long(), neg_sel.long()
    a_yx, a_hw = anc.yx[sa], anc.hw[sa]
    g_yx, g_hw, pos_label = matching.gather_gt_rows(sel_gt, g.yx, g.hw, g.label)
    g_hw = torch.clamp(g_hw, min=1e-8)
    t_yx, t_hw = box_ops.encode(g_yx, g_hw, a_yx, a_hw)
    p_yx, p_hw = matching.gather_gt_rows(sel_anchor, pyx, phw)
    coord = (torch.sum(loss_ops.smooth_l1(p_yx - t_yx), -1)
             + torch.sum(loss_ops.smooth_l1(p_hw - t_hw), -1))
    rpn_loss = neg_loss + pos_conf_loss + 10.0 * _masked_mean(coord, pos_f)

    prop_yx = a_hw * p_yx + a_yx
    prop_hw = torch.exp(p_hw) * a_hw
    # quirk Q12: the yx target divides by the proposal CENTRE, not its size
    truth_yx = (g_yx - prop_yx) / prop_yx
    truth_hw = torch.log(g_hw / torch.clamp(prop_hw, min=1e-12))
    n_yx, n_hw = matching.gather_gt_rows(neg_sel, pyx, phw)
    neg_yx = anc.hw[ns] * n_yx + anc.yx[ns]
    neg_hw = torch.exp(n_hw) * anc.hw[ns]
    return RPNSample(rpn_loss, _corners(prop_yx, prop_hw), pos_label,
                     torch.cat([truth_yx, truth_hw], -1), pos_valid,
                     _corners(neg_yx, neg_hw), neg_valid)


def rpn_loss_and_sample(pyx, phw, pconf, anc: AnchorSet, gt) -> RPNSample:
    """Batched RPN loss and proposal sampling: ``pyx``, ``phw [B, A, 2]``,
    ``pconf [B, A, 2]`` float32 over the kept anchors, ``gt [B, G, 5]``. The
    two sampling NMS calls run on the NMS kernel (plain versions for CPU
    tensors), one host sync each."""
    rows = rpn_rows(pconf, anc, gt)
    return rpn_sample(rows, *rpn_select(rows, anc), pyx, phw, anc, gt)


def rpn_image_loss_and_sample(pyx, phw, pconf, anc: AnchorSet, gt) -> RPNSample:
    """Single-image form of :func:`rpn_loss_and_sample`."""
    batched = rpn_loss_and_sample(pyx[None], phw[None], pconf[None], anc, gt[None])
    return RPNSample(*(t[0] for t in batched))


def rcnn_losses(roi_head_fn, rcnn_feat, sample: RPNSample, img_h: float, img_w: float,
                num_classes_total: int, sample_weight=None):
    """Batched RCNN stage: each image's sampled proposals clipped to ``[0, h]
    x [0, w]`` and cropped 7x7 from the NCHW thin map ``rcnn_feat [B, C, h,
    w]``, the RoI head, CE over the positive and negative rows (negatives
    take the background label ``num_classes_total - 1``) and smooth-L1 over
    the positive rows. ``sample_weight [B]`` masks batch-padding images.

    Each image's 128 + 256 proposals are cropped in one gather, so the head
    sees the rows image by image (tpudet: all positives, then all
    negatives); the two means are the same up to the order of their sums."""
    b, c = rcnn_feat.shape[:2]
    n_pos = sample.pos_proposal.shape[1]
    norm = torch.tensor([img_h, img_w, img_h, img_w], dtype=torch.float32,
                        device=rcnn_feat.device)
    boxes = torch.cat([sample.pos_proposal, sample.neg_proposal], 1)
    boxes = torch.clamp(boxes, min=torch.zeros_like(norm), max=norm)
    feats = roi.crop_and_resize(rcnn_feat, boxes / norm, CROP)  # [B, P+N, 7, 7, C]
    pconf, pbbox = roi_head_fn(feats.reshape(-1, CROP, CROP, c))
    rows = boxes.shape[1]
    pconf, pbbox = pconf.view(b, rows, -1), pbbox.view(b, rows, 4)

    neg_labels = torch.full_like(sample.neg_valid, num_classes_total - 1, dtype=torch.int32)
    labels = torch.cat([sample.pos_label, neg_labels], 1)
    valid = torch.cat([sample.pos_valid, sample.neg_valid], 1).to(torch.float32)
    pv = sample.pos_valid.to(torch.float32)
    if sample_weight is not None:
        w = sample_weight.to(torch.float32)[:, None]
        valid, pv = valid * w, pv * w
    ce = loss_ops.softmax_cross_entropy(pconf, labels)
    conf_loss = torch.sum(ce * valid) / torch.clamp(torch.sum(valid), min=1.0)
    box_l = torch.sum(loss_ops.smooth_l1(pbbox[:, :n_pos] - sample.pos_truth), -1)
    box_loss = torch.sum(box_l * pv) / torch.clamp(torch.sum(pv), min=1.0)
    return conf_loss + box_loss


def lhrcnn_rois(roi_head_fn, rcnn_feat, pyx, phw, pconf, anc: AnchorSet,
                img_h: float, img_w: float, post_nms_proposal: int):
    """The first stage of one image's decode: proposals clipped to ``[0, h] x
    [0, w]``, NMS at IoU 0.7 keeping ``post_nms_proposal`` by objectness (a
    pool of ``2 * post_nms_proposal``, run at full width when it runs out),
    and their 7x7 crops of ``rcnn_feat [C, h, w]`` through the RoI head.
    Returns ``(proposal [P, 4], sel_valid [P], rconf [P, C+1], rbbox [P,
    4])``; unused slots hold anchor 0's proposal."""
    prop_yx, prop_hw = box_ops.decode(pyx, phw, anc.yx, anc.hw)
    norm = torch.tensor([img_h, img_w, img_h, img_w], dtype=torch.float32,
                        device=pyx.device)
    proposal = torch.clamp(_corners(prop_yx, prop_hw), min=torch.zeros_like(norm), max=norm)
    obj = torch.softmax(pconf, -1)[:, 0]
    budget = torch.full((1,), post_nms_proposal, dtype=torch.int32, device=pyx.device)
    sel, sel_valid = nms_kernel.batched_greedy_nms_pretopk(
        proposal[None].contiguous(), obj[None].contiguous(), budget, post_nms_proposal,
        0.7)
    proposal = proposal[sel[0].long()]
    feats = roi.crop_and_resize(rcnn_feat[None], (proposal / norm)[None], CROP)[0]
    return (proposal, sel_valid[0], *roi_head_fn(feats))


def lhrcnn_decode(roi_head_fn, rcnn_feat, pyx, phw, pconf, anc: AnchorSet,
                  img_h: float, img_w: float, num_classes_total: int,
                  post_nms_proposal: int, score_threshold: float,
                  iou_threshold: float, max_boxes: int):
    """Single-image decode: ``rcnn_feat [C, h, w]`` and the ``[A, ...]`` RPN
    outputs of ONE image through :func:`lhrcnn_rois`, then per-class NMS
    over the valid picks whose argmax is not background, the boxes decoded
    against the proposals. Returns padded ``(scores [C*max], boxes [C*max,
    4], class_id [C*max], valid [C*max])``; the pools are exact, so there is
    no truncation flag."""
    proposal, sel_valid, rconf, rbbox = lhrcnn_rois(
        roi_head_fn, rcnn_feat, pyx, phw, pconf, anc, img_h, img_w, post_nms_proposal)
    prop_yx2 = (proposal[:, 0:2] + proposal[:, 2:4]) / 2.0
    prop_hw2 = proposal[:, 2:4] - proposal[:, 0:2]
    conf = torch.softmax(rconf, -1)
    c = num_classes_total - 1
    keep = sel_valid & (torch.argmax(conf, -1) < c)
    d_yx = rbbox[:, 0:2] * prop_hw2 + prop_yx2
    d_hw = prop_hw2 * torch.exp(rbbox[:, 2:4])
    sel_boxes, sel_scores, sel_v = nms.per_class_nms(
        _corners(d_yx, d_hw), conf[:, :c].T, score_threshold, max_boxes, iou_threshold,
        class_active=keep)
    cid = torch.arange(c, dtype=torch.int32, device=pyx.device)[:, None].expand(c, max_boxes)
    return (sel_scores.reshape(-1), sel_boxes.reshape(-1, 4), cid.reshape(-1),
            sel_v.reshape(-1))
