"""YOLOv2 / YOLOv3 heads: grid-cell direct regression (counterpart of
``tpudet/heads/yolo.py``).

Both losses work in grid units (gt divided by the stride); a gt's
responsible prior is the one of best IoU among the priors anchored at the
gt's cell. tpudet's quirks are kept exactly:

  * Q3: decode is additive in hw, ``hw = prior + e^p``;
  * Q4: YOLOv3's priors are divided by strides (8, 16, 32) but attached to
    the heads of stride (32, 16, 8), and decode scales the heads' boxes by
    (32, 32, 16) pixels;
  * Q5: every YOLOv3 conv, the prediction convs included, has BN + leaky;
  * Q13: YOLOv2's ``rescore_confidence`` is accepted and unused;
  * Q14: YOLOv2's passthrough is the stride-32 conv17;
  * the responsible-prior and no-object IoUs do not clamp the intersection
    at zero, and the no-object "anchor boxes" are built from swapped corner
    tensors.
``consistent_geometry`` (opt-in) decodes as training encodes and uses the
real anchor boxes; ``raw_prediction_conv`` (opt-in) makes the prediction
layer a plain conv + bias.

tpudet ``vmap``s a per-image loss over the batch; here the batch dimension is
written out. Head outputs are NCHW; :func:`split_pred` permutes them to NHWC
before the reshape, so cells stay in tpudet's ``(h, w, k)`` order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from tpudet_torch.nn.backbones.darknet import DarkNet19, DarkNet53, _DarkConv, leaky
from tpudet_torch.nn.layers import Conv, ConvBN, source_positions
from tpudet_torch.ops import losses as loss_ops
from tpudet_torch.ops import matching, nms


# --------------------------------------------------------------------- helpers
def grid_prior_arrays(fh: int, fw: int, priors_hw, device=None):
    """``(centers [fh, fw, K, 2] = cell + 0.5, prior hw [fh, fw, K, 2])`` in
    grid units, float32."""
    k = len(priors_hw)
    cy = torch.arange(fh, dtype=torch.float32, device=device) + 0.5
    cx = torch.arange(fw, dtype=torch.float32, device=device) + 0.5
    centers = torch.stack(torch.meshgrid(cy, cx, indexing="ij"), -1)[:, :, None, :]
    centers = centers.expand(fh, fw, k, 2)
    hw = torch.tensor(priors_hw, dtype=torch.float32, device=device)
    return centers, hw[None, None].expand(fh, fw, k, 2)


def _unclamped_iou(g_y1x1, g_y2x2, a_y1x1, a_y2x2, a_area):
    """IoU with tpudet's unclamped intersection (negative extents multiply)."""
    ext = torch.minimum(g_y2x2, a_y2x2) - torch.maximum(g_y1x1, a_y1x1)
    inter = ext[..., 0] * ext[..., 1]
    gext = g_y2x2 - g_y1x1
    garea = gext[..., 0] * gext[..., 1]
    return inter / (a_area + garea - inter)


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """``jnp.argmax`` over the last axis: the first maximum, and the first
    NaN where a row holds one."""
    k = x.shape[-1]
    nan = torch.isnan(x)
    hit = torch.where(nan.any(-1, keepdim=True), nan, x == torch.amax(x, -1, keepdim=True))
    cols = torch.arange(k, device=x.device)
    return torch.where(hit, cols, k).amin(-1)


def split_pred(pred: torch.Tensor, num_priors: int, num_classes: int):
    """NCHW ``[B, K*(C+5), H, W]`` -> float32 ``(pclass [B, H, W, K, C], pyx,
    phw [B, H, W, K, 2], pobj [B, H, W, K, 1])``."""
    b, _, h, w = pred.shape
    pred = pred.permute(0, 2, 3, 1).reshape(b, h, w, num_priors, num_classes + 5).float()
    return (pred[..., :num_classes], pred[..., num_classes:num_classes + 2],
            pred[..., num_classes + 2:num_classes + 4], pred[..., num_classes + 4:])


class Match(NamedTuple):
    """Each gt's cell and responsible prior on one head (no gradient: gt and
    priors only)."""

    cell: torch.Tensor     # [B, G] flat cell index cy * fw + cx
    kbest: torch.Tensor    # [B, G] the responsible prior
    iou_max: torch.Tensor  # [B, G] its IoU
    ahw: torch.Tensor      # [B, G, 2] its hw


def match(centers, prior_hw, gn_yx, gn_hw) -> Match:
    """The responsible prior of every gt ``[B, G]`` at the gt's cell, by the
    unclamped IoU of the gt against the priors anchored there."""
    fh, fw, k, _ = prior_hw.shape
    cell = torch.floor(gn_yx).to(torch.int32)
    cy = torch.clamp(cell[..., 0], 0, fh - 1).long()
    cx = torch.clamp(cell[..., 1], 0, fw - 1).long()
    r_ahw = prior_hw[cy, cx]     # [B, G, K, 2]
    r_ac = centers[cy, cx]
    a_y1x1 = r_ac - r_ahw / 2.0
    a_y2x2 = r_ac + r_ahw / 2.0
    g_y1x1 = (gn_yx - gn_hw / 2.0)[..., None, :]
    g_y2x2 = (gn_yx + gn_hw / 2.0)[..., None, :]
    iou = _unclamped_iou(g_y1x1, g_y2x2, a_y1x1, a_y2x2, r_ahw[..., 0] * r_ahw[..., 1])
    kbest = first_argmax(iou)
    ahw = torch.gather(r_ahw, -2, kbest[..., None, None].expand(*kbest.shape, 1, 2))
    return Match(cy * fw + cx, kbest, torch.amax(iou, -1), ahw[..., 0, :])


def _at(t: torch.Tensor, m: Match) -> torch.Tensor:
    """``t[b, cell, kbest]`` for per-cell head outputs ``t [B, H, W, K, c]``:
    ``[B, G, c]`` (gathers, whose backward is a scatter-add)."""
    b, h, w, k, c = t.shape
    g = m.cell.shape[1]
    rows = torch.gather(t.reshape(b, h * w, k * c), 1,
                        m.cell[..., None].expand(b, g, k * c)).reshape(b, g, k, c)
    return torch.gather(rows, 2, m.kbest[..., None, None].expand(b, g, 1, c))[:, :, 0]


def _responsible_terms(pclass, pyx, phw, pobj, m: Match, gn_yx, gn_hw, labels, valid,
                       num_classes):
    """The responsible prior's loss terms, summed over the gts of each image:
    ``(yx, hw, class, obj)``, each ``[B]``."""
    yx_t = gn_yx - torch.floor(gn_yx)
    hw_t = torch.log(torch.clamp(gn_hw, min=1e-8) / m.ahw)
    vf = valid.to(torch.float32)
    sce = loss_ops.sigmoid_cross_entropy
    yx_loss = torch.sum(sce(_at(pyx, m), yx_t), -1) * vf
    hw_loss = 0.5 * torch.sum(torch.square(_at(phw, m) - hw_t), -1) * vf
    onehot = loss_ops.one_hot(labels, num_classes)
    class_loss = torch.sum(sce(_at(pclass, m), onehot), -1) * vf
    sel_pobj = _at(pobj, m)[..., 0]
    obj_loss = sce(sel_pobj, torch.ones_like(sel_pobj)) * vf
    return (torch.sum(yx_loss, -1), torch.sum(hw_loss, -1), torch.sum(class_loss, -1),
            torch.sum(obj_loss, -1))


def _noobj_term(pobj, centers, prior_hw, gn_yx, gn_hw, valid, cell, iou_thresh,
                swapped_corners=True):
    """No-object loss ``[B]`` over the cells that hold no gt, where no prior's
    pseudo box overlaps a valid gt above ``iou_thresh``. The reference's
    pseudo boxes come from swapped corner tensors; ``swapped_corners=False``
    (``consistent_geometry``) uses the real anchor boxes. Two gts in one cell
    count twice in the cell's gt count, as tpudet's scatter-add does."""
    b = pobj.shape[0]
    fh, fw, k, _ = prior_hw.shape
    has = torch.zeros((b, fh * fw), dtype=torch.int32, device=pobj.device)
    has.scatter_add_(1, cell, valid.to(torch.int32))
    nogn = has == 0                          # [B, S]
    yx = centers.reshape(-1, k, 2)
    hw = prior_hw.reshape(-1, k, 2)
    c1 = yx - hw / 2.0                       # named 'yx_nobest' in the reference
    c2 = yx + hw / 2.0                       # named 'hw_nobest'
    if swapped_corners:
        p_y1x1 = c1 - c2 / 2.0               # swapped-corner pseudo boxes
        p_y2x2 = c1 + c2 / 2.0
    else:
        p_y1x1, p_y2x2 = c1, c2              # real anchor boxes
    pext = p_y2x2 - p_y1x1
    a_area = pext[..., 0] * pext[..., 1]     # [S, K]
    gt_y1x1 = gn_yx - gn_hw / 2.0            # [B, G, 2]
    gt_y2x2 = gn_yx + gn_hw / 2.0
    ext = (torch.minimum(p_y2x2[None, :, :, None, :], gt_y2x2[:, None, None])
           - torch.maximum(p_y1x1[None, :, :, None, :], gt_y1x1[:, None, None]))
    inter = ext[..., 0] * ext[..., 1]        # [B, S, K, G]
    gext = gt_y2x2 - gt_y1x1
    garea = gext[..., 0] * gext[..., 1]
    iou = inter / (a_area[None, :, :, None] + garea[:, None, None, :] - inter)
    iou = torch.where(valid[:, None, None, :], iou, -torch.inf)
    iou_max = torch.amax(iou, -1)            # [B, S, K]
    logits = pobj.reshape(b, -1, k)
    ce = loss_ops.sigmoid_cross_entropy(logits, torch.zeros_like(logits))
    mask = (nogn[..., None] & (iou_max <= iou_thresh)).to(torch.float32)
    return torch.sum(ce * mask, (1, 2))


def _decode_boxes(pred, priors_hw, num_classes, pixel_scale, consistent):
    """One image's head ``[K*(C+5), H, W]`` -> ``(boxes [HWK, 4] in pixels,
    conf [HWK, C])``, rows in ``(h, w, k)`` order. The reference decodes the
    center as ``cell + 0.5 + sigmoid(p)`` where training teaches
    ``sigmoid(p) = frac(gn)``; ``consistent`` drops the 0.5 and decodes hw as
    ``prior * e^p`` (Q3: ``prior + e^p``)."""
    pclass, pyx, phw, pobj = (x[0] for x in split_pred(pred[None], len(priors_hw),
                                                       num_classes))
    fh, fw = pclass.shape[0], pclass.shape[1]
    centers, prior_hw = grid_prior_arrays(fh, fw, priors_hw, pred.device)
    cyx = centers.reshape(-1, 2) - (0.5 if consistent else 0.0)
    byx = cyx + torch.sigmoid(pyx.reshape(-1, 2))
    if consistent:
        bhw = prior_hw.reshape(-1, 2) * torch.exp(phw.reshape(-1, 2))
    else:
        bhw = prior_hw.reshape(-1, 2) + torch.exp(phw.reshape(-1, 2))
    boxes = torch.cat([byx - bhw / 2.0, byx + bhw / 2.0], -1) * pixel_scale
    conf = (torch.sigmoid(pclass.reshape(-1, num_classes))
            * torch.sigmoid(pobj.reshape(-1, 1)))
    return boxes, conf


def _class_nms(boxes, conf, num_classes, score_threshold, iou_threshold, max_boxes):
    """Per-class NMS through the kernel's pool: ``(scores [C*max], boxes
    [C*max, 4], class_id [C*max], valid [C*max])``, class blocks in order."""
    sel_boxes, sel_scores, sel_valid = nms.per_class_nms(
        boxes, conf.T, score_threshold, max_boxes, iou_threshold)
    cid = torch.arange(num_classes, dtype=torch.int32, device=boxes.device)
    cid = cid[:, None].expand(num_classes, max_boxes)
    return (sel_scores.reshape(-1), sel_boxes.reshape(-1, 4), cid.reshape(-1),
            sel_valid.reshape(-1))


# --------------------------------------------------------------------- YOLOv2
def yolov2_loss(pred, priors_hw, gt, num_classes, downsampling_rate, scales,
                sample_weight=None, consistent=False):
    """The mean over the batch of each image's loss; ``scales`` = (coord,
    class, obj, noobj); ``pred`` NCHW, ``gt [B, G, 5]``."""
    pclass, pyx, phw, pobj = split_pred(pred, len(priors_hw), num_classes)
    fh, fw = pclass.shape[1], pclass.shape[2]
    centers, prior_hw = grid_prior_arrays(fh, fw, priors_hw, pred.device)
    g = matching.unpack_gt(gt)
    gn_yx = g.yx / downsampling_rate
    gn_hw = g.hw / downsampling_rate
    m = match(centers, prior_hw, gn_yx, gn_hw)
    yx_l, hw_l, cls_l, obj_l = _responsible_terms(pclass, pyx, phw, pobj, m, gn_yx,
                                                  gn_hw, g.label, g.valid, num_classes)
    noobj_l = _noobj_term(pobj, centers, prior_hw, gn_yx, gn_hw, g.valid, m.cell, 0.6,
                          swapped_corners=not consistent)
    coord_s, class_s, obj_s, noobj_s = scales
    per_image = (coord_s * (yx_l + hw_l) + class_s * cls_l + obj_s * obj_l
                 + noobj_s * noobj_l)
    return loss_ops.weighted_mean(per_image, sample_weight)


def yolov2_decode(pred, priors_hw, num_classes, downsampling_rate, score_threshold,
                  iou_threshold, max_boxes, consistent=False):
    """One image's head ``[K*(C+5), H, W]`` -> padded ``(scores, boxes,
    class_id, valid)``. The pool is exact, so there is no ``pre_topk``."""
    boxes, conf = _decode_boxes(pred, priors_hw, num_classes, downsampling_rate,
                                consistent)
    return _class_nms(boxes, conf, num_classes, score_threshold, iou_threshold, max_boxes)


# --------------------------------------------------------------------- YOLOv3
CELL_STRIDES = (32.0, 16.0, 8.0)


def yolov3_loss(preds, priors_per_head, gt, num_classes, scales, sample_weight=None,
                consistent=False):
    """``0.5 *`` the mean over the batch of each image's 3-scale loss. Head h
    takes the gt divided by ``CELL_STRIDES[h]``; ``priors_per_head`` are
    already divided (Q4). Each gt goes to the head whose responsible prior
    has the strictly largest IoU (ties to head 3); each head's no-object mask
    uses every valid gt's cell, routed there or not. Positive and negative
    terms are divided by the image's gt count (at least 1e-8)."""
    g = matching.unpack_gt(gt)
    n = torch.clamp(g.count.to(torch.float32), min=1e-8)
    heads = []
    for pred, priors_hw, stride in zip(preds, priors_per_head, CELL_STRIDES):
        parts = split_pred(pred, len(priors_hw), num_classes)
        fh, fw = parts[0].shape[1], parts[0].shape[2]
        centers, prior_hw = grid_prior_arrays(fh, fw, priors_hw, pred.device)
        gn_yx, gn_hw = g.yx / stride, g.hw / stride
        heads.append((parts, centers, prior_hw, gn_yx, gn_hw,
                      match(centers, prior_hw, gn_yx, gn_hw)))
    i1, i2, i3 = (h[-1].iou_max for h in heads)
    m1 = (i1 > i2) & (i1 > i3)
    m2 = (i2 > i1) & (i2 > i3)
    routed = (m1, m2, ~(m1 | m2))

    coord = class_l = obj_l = noobj = 0.0
    for (parts, centers, prior_hw, gn_yx, gn_hw, m), mask in zip(heads, routed):
        yx_l, hw_l, cls_l, ob_l = _responsible_terms(*parts, m, gn_yx, gn_hw, g.label,
                                                     g.valid & mask, num_classes)
        coord = coord + (yx_l + hw_l)
        class_l = class_l + cls_l
        obj_l = obj_l + ob_l
        noobj = noobj + _noobj_term(parts[3], centers, prior_hw, gn_yx, gn_hw, g.valid,
                                    m.cell, 0.5, swapped_corners=not consistent)
    coord_s, class_s, obj_s, noobj_s = scales
    pos = (coord_s * coord + class_s * class_l + obj_s * obj_l) / n
    neg = noobj_s * noobj / n
    return 0.5 * loss_ops.weighted_mean(pos + neg, sample_weight)


def yolov3_decode(preds, priors_per_head, num_classes, score_threshold, iou_threshold,
                  max_boxes, consistent=False):
    """One image's three heads ``[K*(C+5), H, W]`` -> padded ``(scores,
    boxes, class_id, valid)``. Q4's pixel scales are (32, 32, 16);
    ``consistent`` takes the true strides (32, 16, 8)."""
    pixel_scales = CELL_STRIDES if consistent else (32.0, 32.0, 16.0)
    decoded = [_decode_boxes(pred, priors_hw, num_classes, px, consistent)
               for pred, priors_hw, px in zip(preds, priors_per_head, pixel_scales)]
    boxes = torch.cat([d[0] for d in decoded], 0)
    conf = torch.cat([d[1] for d in decoded], 0)
    return _class_nms(boxes, conf, num_classes, score_threshold, iou_threshold, max_boxes)


# --------------------------------------------------------------------- networks
class YOLOv2Net(nn.Module):
    """DarkNet-19 (scope ``backone``, the reference's name) and the YOLOv2 head,
    with the stride-32 passthrough concatenated before the prediction conv."""

    def __init__(self, final_units: int, raw_pred: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backone = DarkNet19(generator, dtype)
        in_ch = self.backone.out_channels[0]
        for i, (filters, kernel) in enumerate(((1024, 3), (512, 1), (1024, 3), (512, 1),
                                               (1024, 3))):
            self.add_module(f"head_conv{i + 1}", ConvBN(
                in_ch, filters, kernel, activation=leaky, generator=generator, dtype=dtype))
            in_ch = filters
        in_ch += self.backone.out_channels[1]
        # raw_prediction_conv: plain conv + bias; the reference's prediction
        # conv has BN and no activation
        self.head_pred = (Conv if raw_pred else ConvBN)(in_ch, final_units, 1,
                                                        generator=generator, dtype=dtype)

    def forward(self, x):
        conv, passthrough = self.backone(x)
        for i in range(5):
            conv = getattr(self, f"head_conv{i + 1}")(conv)
        return self.head_pred(torch.cat([passthrough, conv], 1))


def nearest_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``tf.image.resize_nearest_neighbor`` (``align_corners=False``) of NCHW
    ``x``: source index ``floor(arange(out) * (in / out))`` in float32, read
    with ``index_select`` (whose backward is an ``index_add``)."""
    h, w = x.shape[-2:]
    yi = torch.floor(source_positions(out_h, h / out_h, x.device)).long()
    xi = torch.floor(source_positions(out_w, w / out_w, x.device)).long()
    return x.index_select(2, yi).index_select(3, xi)


class _YOLOv3Header(nn.Module):
    """Five 1x1/3x3 convs, a 3x3, and the prediction conv (Q5: BN + leaky,
    or a plain conv + bias with ``raw_pred``). With a pyramid input, a 1x1
    conv of it is upsampled to ``bottom``'s size and concatenated after
    ``bottom``. Returns ``(pred, top_down)``."""

    def __init__(self, in_ch: int, filters: int, final_units: int,
                 pyramid_ch: Optional[int] = None, raw_pred: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype)
        self.pyramid_conv = None
        if pyramid_ch is not None:
            self.pyramid_conv = _DarkConv(pyramid_ch, filters, 1, is_activation=False, **kw)
            in_ch += filters
        half = filters // 2
        self.conv1 = _DarkConv(in_ch, half, 1, **kw)
        self.conv2 = _DarkConv(half, filters, 3, **kw)
        self.conv3 = _DarkConv(filters, half, 1, **kw)
        self.conv4 = _DarkConv(half, filters, 3, **kw)
        self.conv5 = _DarkConv(filters, half, 1, **kw)
        self.conv6 = _DarkConv(half, filters, 3, **kw)
        self.pred = (Conv(filters, final_units, 1, **kw) if raw_pred
                     else _DarkConv(filters, final_units, 1, **kw))

    def forward(self, bottom, pyramid=None):
        conv = bottom
        if self.pyramid_conv is not None:
            up = self.pyramid_conv(pyramid)
            up = nearest_resize(up, bottom.shape[2], bottom.shape[3])
            conv = torch.cat([bottom, up], 1)
        c = self.conv4(self.conv3(self.conv2(self.conv1(conv))))
        top_down = self.conv5(c)
        return self.pred(self.conv6(top_down)), top_down


class YOLOv3Net(nn.Module):
    """DarkNet-53 (scope ``backone``) and three headers; returns the
    predictions at strides 32, 16 and 8."""

    def __init__(self, final_units: int, raw_pred: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(raw_pred=raw_pred, generator=generator, dtype=dtype)
        self.backone = DarkNet53(generator, dtype)
        c5, c4, c3 = self.backone.out_channels
        self.pyd1 = _YOLOv3Header(c5, 1024, final_units, **kw)
        self.pyd2 = _YOLOv3Header(c4, 256, final_units, pyramid_ch=512, **kw)
        self.pyd3 = _YOLOv3Header(c3, 128, final_units, pyramid_ch=128, **kw)

    def forward(self, x):
        b5, b4, b3 = self.backone(x)
        pred1, td = self.pyd1(b5)
        pred2, td = self.pyd2(b4, td)
        pred3, _ = self.pyd3(b3, td)
        return pred1, pred2, pred3
