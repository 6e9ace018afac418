"""FCOS head: anchor-free FPN with centerness (counterpart of
``tpudet/heads/fcos.py``).

tpudet's quirks, kept:
  * Q10: gts route to the pyramid levels by ``sqrt(h * w)`` in pixels, in
    the bands [0, 64], [64, 128], [128, 256], [256, 512], [512, inf) with
    inclusive ends, so a gt exactly on an end trains both levels;
  * Q9: decode emits classes ``0 .. num_classes - 2`` only;
  * one head, applied to all five levels, so its weights are shared, and no
    per-level scale;
  * the FPN's stride-8 top-down sum adds the upsampled stride-16 SUM, not
    ``p4``;
  * the loss: strictly-inside locations, the minimum-area gt with ties
    keeping all minima, ``-log(IoU)`` regression, a binary-CE centerness over
    every location, a symmetric 0.25 focal heatmap term, each level divided
    by its ``sum(heat_gt)``, and a level that no gt covers adds 0.
``consistent_objective`` (opt-in) is the FCOS paper's loss: centerness over
the positive locations, focal alpha 0.75 on negatives, one division by the
image's positive-location count, and decode over every class.

The loss is written once, in the math of tpudet's default form
(``_level_loss_gp``, the ``[G, P]`` planes): ``heat_gt`` is the one-hot
product ``labels @ heatmask > 0``, so a label outside ``[0, C)`` adds a zero
row and never raises. The batch dimension is written out where tpudet
``vmap``s. Head outputs are NCHW float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpudet_torch.nn.backbones.resnet import PreActResNet
from tpudet_torch.nn.layers import BNActConv, resize_bilinear
from tpudet_torch.ops import losses as loss_ops
from tpudet_torch.ops import matching, nms

STRIDES = (8, 16, 32, 64, 128)
SIZE_BANDS = ((0.0, 64.0), (64.0, 128.0), (128.0, 256.0), (256.0, 512.0),
              (512.0, math.inf))
FEATURES = 256


class FCOSHead(nn.Module):
    """Class/centerness and regression towers of 4 GroupNorm pre-activation
    convs each. The class and centerness predictions' biases start at
    ``-log((1 - 0.01) / 0.01)``; the regression is ``exp`` of its conv, in
    float32. Returns float32 NCHW ``(pconf [B, C], preg [B, 4], pcenter
    [B, 1])``."""

    def __init__(self, num_classes: int, feature_size: int = FEATURES,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        bias0 = -math.log((1.0 - 0.01) / 0.01)

        def unit(filters, **kw):
            return BNActConv(feature_size, filters, 3, 1, norm="gn", generator=generator,
                             dtype=dtype, **kw)

        for j in range(4):
            self.add_module(f"cls_conv{j}", unit(feature_size))
        self.cls_pred = unit(num_classes, bias_init_const=bias0)
        self.center_pred = unit(1, bias_init_const=bias0)
        for j in range(4):
            self.add_module(f"reg_conv{j}", unit(feature_size))
        self.reg_pred = unit(4)

    def forward(self, f):
        c = f
        for j in range(4):
            c = getattr(self, f"cls_conv{j}")(c)
        r = f
        for j in range(4):
            r = getattr(self, f"reg_conv{j}")(r)
        return (self.cls_pred(c).float(), torch.exp(self.reg_pred(r).float()),
                self.center_pred(c).float())


class FCOSNet(nn.Module):
    """The GroupNorm ResNet (scope ``backone``: bottleneck ``block_list``,
    stages ``16 * 2^i`` wide), 1x1 projections of its last three stages, the
    FPN and the shared head. Returns one ``(pconf, preg, pcenter)`` for each
    of P3..P7."""

    def __init__(self, num_classes: int, block_list=(3, 4, 6, 3),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backone = PreActResNet(block_list, init_conv_filters=16, width_base=16,
                                    is_bottleneck=True, generator=generator, dtype=dtype,
                                    norm="gn")
        e3, e4, e5 = self.backone.out_channels

        def unit(in_ch, kernel, stride=1):
            return BNActConv(in_ch, FEATURES, kernel, stride, norm="gn",
                             generator=generator, dtype=dtype)

        self.c3_proj = unit(e3, 1)
        self.c4_proj = unit(e4, 1)
        self.c5_proj = unit(e5, 1)
        self.p5_conv = unit(FEATURES, 3)
        self.p4_lateral = unit(FEATURES, 1)
        self.p4_conv = unit(FEATURES, 3)
        self.p3_lateral = unit(FEATURES, 1)
        self.p3_conv = unit(FEATURES, 3)
        self.p6_conv = unit(FEATURES, 3, 2)
        self.p7_conv = unit(FEATURES, 3, 2)
        self.head = FCOSHead(num_classes, generator=generator, dtype=dtype)

    def forward(self, x):
        e3, e4, e5 = self.backone(x)
        c3, c4, c5 = self.c3_proj(e3), self.c4_proj(e4), self.c5_proj(e5)
        p5 = self.p5_conv(c5)
        lat4 = self.p4_lateral(c4)
        td4 = lat4 + resize_bilinear(p5, *lat4.shape[-2:])
        p4 = self.p4_conv(td4)
        lat3 = self.p3_lateral(c3)
        td3 = lat3 + resize_bilinear(td4, *lat3.shape[-2:])  # the sum, not p4
        p3 = self.p3_conv(td3)
        p6 = self.p6_conv(p5)
        p7 = self.p7_conv(p6)
        return [self.head(p) for p in (p3, p4, p5, p6, p7)]


def _grid(fh: int, fw: int, device):
    """Each location's ``(row, col)`` in ``(h, w)`` order, float32 ``[P]``."""
    yy, xx = torch.meshgrid(torch.arange(fh, dtype=torch.float32, device=device),
                            torch.arange(fw, dtype=torch.float32, device=device),
                            indexing="ij")
    return yy.reshape(-1), xx.reshape(-1)


def _level_loss(pconf, preg, pcenter, g: matching.GtArrays, band, stride: float,
                num_classes: int, consistent: bool = False):
    """One level's loss ``[B]`` of NCHW float32 head outputs; with
    ``consistent`` the raw terms ``(iou, heat, center, positive locations)``,
    each ``[B]``."""
    b, c, fh, fw = pconf.shape
    p = fh * fw
    size = torch.sqrt(torch.clamp(g.hw[..., 0] * g.hw[..., 1], min=0.0))
    routed = g.valid & (size >= band[0]) & (size <= band[1])            # [B, G]
    gy, gx = g.yx[..., 0] / stride, g.yx[..., 1] / stride
    gh, gw = g.hw[..., 0] / stride, g.hw[..., 1] / stride
    yy, xx = _grid(fh, fw, pconf.device)
    dist_l = xx - (gx - gw / 2.0)[..., None]                             # [B, G, P]
    dist_r = (gx + gw / 2.0)[..., None] - xx
    dist_t = yy - (gy - gh / 2.0)[..., None]
    dist_b = (gy + gh / 2.0)[..., None] - yy
    inside = (dist_t > 0.0) & (dist_b > 0.0) & (dist_l > 0.0) & (dist_r > 0.0)
    heatmask = (inside & routed[..., None]).to(torch.float32)
    dist_l, dist_r = dist_l * heatmask, dist_r * heatmask
    dist_t, dist_b = dist_t * heatmask, dist_b * heatmask
    loc = torch.amax(heatmask, 1)                                        # [B, P]
    dist_area = (dist_l + dist_r) * (dist_t + dist_b)
    area_min = torch.amin(dist_area + (1.0 - heatmask) * 1e8, 1, keepdim=True)
    dist_mask = (dist_area == area_min).to(torch.float32) * loc[:, None]  # ties: all
    dl, dr, dt, db = (torch.amax(d * dist_mask, 1)
                      for d in (dist_l, dist_r, dist_t, dist_b))         # [B, P]

    pl, pr, pt, pb = preg.reshape(b, 4, p).unbind(1)
    inter = (torch.minimum(dl, pl) + torch.minimum(dr, pr)) * \
            (torch.minimum(dt, pt) + torch.minimum(db, pb))
    union = (dl + dr) * (dt + db) + (pl + pr) * (pt + pb) - inter
    iou = inter / (union + 1e-12)
    iou_loss = torch.sum(-torch.log(iou + 1e-12) * loc, -1)

    lr_min, lr_max = torch.minimum(dl, dr), torch.maximum(dl, dr)
    tb_min, tb_max = torch.minimum(dt, db), torch.maximum(dt, db)
    center_gt = torch.sqrt(lr_min * tb_min / (lr_max * tb_max + 1e-12))
    center_ce = loss_ops.sigmoid_cross_entropy(pcenter.reshape(b, p), center_gt)
    center_loss = torch.sum(center_ce * loc if consistent else center_ce, -1)

    label_oh = loss_ops.one_hot(g.label, num_classes).transpose(1, 2)   # [B, C, G]
    heat_gt = (torch.bmm(label_oh, heatmask) > 0.0).to(torch.float32)   # [B, C, P]
    x = pconf.reshape(b, c, p)
    s = torch.sigmoid(x)
    log_s = F.logsigmoid(x)
    log_1ms = -x + log_s
    neg_alpha = 0.75 if consistent else 0.25
    pos = -0.25 * torch.square(1.0 - s) * log_s * heat_gt
    neg = -neg_alpha * torch.square(s) * log_1ms * (1.0 - heat_gt)
    heat_loss = torch.sum(pos, (1, 2)) + torch.sum(neg, (1, 2))

    if consistent:
        return iou_loss, heat_loss, center_loss, torch.sum(loc, -1)
    denom = torch.sum(heat_gt, (1, 2))
    total = (iou_loss + heat_loss + center_loss) / torch.clamp(denom, min=1e-8)
    return torch.where(routed.any(-1) & (denom > 0.0), total, 0.0)


def _images_loss(level_preds, gt, num_classes: int, consistent: bool):
    """Each image's loss ``[B]``: the sum of the levels' (``consistent``: the
    levels' terms over the image's positive-location count, at least 1)."""
    g = matching.unpack_gt(gt)
    terms = [_level_loss(*lvl, g, band, float(stride), num_classes, consistent)
             for lvl, band, stride in zip(level_preds, SIZE_BANDS, STRIDES)]
    if consistent:
        iou_l, heat_l, center_l, num_pos = (sum(t[i] for t in terms) for i in range(4))
        return (iou_l + heat_l + center_l) / torch.clamp(num_pos, min=1.0)
    return sum(terms)


def fcos_image_loss(level_preds, gt, num_classes: int, consistent: bool = False):
    """One image's loss: ``level_preds`` the five levels' ``(conf [C, H, W],
    reg [4, H, W], center [1, H, W])``, ``gt [G, 5]``."""
    return _images_loss([[t[None] for t in lvl] for lvl in level_preds], gt[None],
                        num_classes, consistent)[0]


def fcos_loss(level_preds, gt, num_classes: int, sample_weight=None,
              consistent: bool = False):
    """The mean over the batch of each image's loss (:func:`fcos_image_loss`).
    ``level_preds`` are the net's NCHW outputs, ``gt`` ``[B, G, 5]``."""
    return loss_ops.weighted_mean(_images_loss(level_preds, gt, num_classes, consistent),
                                  sample_weight)


def fcos_decode(level_preds, num_classes: int, score_threshold: float,
                iou_threshold: float, max_boxes: int, emit_all_classes: bool = False):
    """One image's levels ``(pconf [C, h, w], preg [4, h, w], pcenter [1, h,
    w])`` -> padded ``(scores, boxes, class_id, valid)`` over ``num_classes -
    1`` classes (Q9; all of them with ``emit_all_classes``), through the NMS
    kernel's pool (exact: no ``pre_topk`` to report)."""
    confs, boxes = [], []
    for (pconf, preg, pcenter), stride in zip(level_preds, STRIDES):
        _, fh, fw = pconf.shape
        conf = torch.sigmoid(pconf) * torch.sigmoid(pcenter)
        confs.append(conf.reshape(num_classes, -1))
        yy, xx = _grid(fh, fw, pconf.device)
        pl, pr, pt, pb = preg.reshape(4, -1)
        boxes.append(torch.stack([yy - pt, xx - pl, yy + pb, xx + pr], -1) * float(stride))
    c_emit = num_classes if emit_all_classes else num_classes - 1
    conf = torch.cat(confs, 1)[:c_emit]
    sel_boxes, sel_scores, sel_valid = nms.per_class_nms(
        torch.cat(boxes, 0), conf, score_threshold, max_boxes, iou_threshold)
    cid = torch.arange(c_emit, dtype=torch.int32, device=conf.device)
    cid = cid[:, None].expand(c_emit, max_boxes)
    return (sel_scores.reshape(-1), sel_boxes.reshape(-1, 4), cid.reshape(-1),
            sel_valid.reshape(-1))
