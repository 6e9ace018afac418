"""RefineDet / PFPNet-R cascade head: ARM -> TCB -> ODM (counterpart of
``tpudet/heads/refine.py``). PFPNet reuses RefineDet's ARM/TCB/ODM and swaps
the feature extractor for the MSCA parallel pyramid.

Matching, as tpudet's: one assignment on the RAW anchors drives both stages.
Each valid gt's best anchor plus the other anchors with best IoU > 0.5 are
positive; the other anchors with best IoU < 0.4 are negative, so the 0.4-0.5
band is ignored (unlike SSD).
  * ARM: binary CE (object = 0, background = 1); hard negatives mined by
    greedy NMS (IoU 0.7) on their background CE, at most ``3 * num_pos``
    capped at ``neg_sel_cap``; box targets against the anchors;
  * ODM: the negatives are the ARM's picks whose ARM background LOGIT is
    < 0.99 (a logit compared with 0.99, tpudet's quirk); CE over C+1
    classes; box targets against the ARM-refined boxes, which keep their
    gradient, so the ODM's coordinate loss reaches the ARM's loc outputs.
Decode: anchors -> ARM -> ODM, dropping anchors whose ARM background
PROBABILITY is >= 0.99 or whose ODM argmax is background, then per-class NMS.

Head outputs are NCHW inside the port; :func:`flatten_preds` permutes them to
NHWC before the reshape, so anchors stay in (row, col, prior) order. The CE
terms use the plain ``[A, C]`` layout (tpudet's ``ac``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from tpudet_torch.heads import ssd as ssd_head
from tpudet_torch.heads.ssd import AnchorSet, _gather_anchors
from tpudet_torch.nn.backbones.vgg import VGG16Trunk
from tpudet_torch.nn.layers import (BatchNorm, ConvBN, L2NormScale,
                                    SameConvTranspose2d, avg_pool_same, bilinear_at,
                                    max_pool_same, source_positions)
from tpudet_torch.ops import anchors as anchor_ops
from tpudet_torch.ops import boxes as box_ops
from tpudet_torch.ops import losses as loss_ops
from tpudet_torch.ops import matching, nms
from tpudet_torch.ops.cuda import nms_kernel

ANCHOR_RATIOS = (0.5, 1.0, 2.0)
STRIDES = (8, 16, 32, 64)
NUM_ANCHORS = len(ANCHOR_RATIOS)
PFPNET_BOTTLENECK = 512 // 6  # 85 channels


def build_anchors(feat_shapes: Sequence[Sequence[int]],
                  strides: Sequence[int] = STRIDES,
                  device: torch.device | str = "cpu") -> AnchorSet:
    """3 anchors a cell of side ``4 * stride``, ratios {1/2, 1, 2}; 6375 at
    320x320 (40/20/10/5)."""
    levels = []
    for (fh, fw), stride in zip(feat_shapes, strides):
        size = 4.0 * stride
        priors = [[size * (r ** 0.5), size / (r ** 0.5)] for r in ANCHOR_RATIOS]
        levels.append(anchor_ops.grid_anchors(fh, fw, priors, stride, stride))
    arrs = anchor_ops.concat_levels(levels)
    return AnchorSet(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                       for a in arrs))


class _DeconvBN(nn.Module):
    """SAME transposed conv (k 4, stride 2) + BatchNorm, no activation."""

    def __init__(self, in_ch: int, filters: int,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dconv = SameConvTranspose2d(in_ch, filters, 4, 2, generator, dtype)
        self.bn = BatchNorm(filters)

    def forward(self, x):
        return self.bn(self.dconv(x))


class ARM(nn.Module):
    """Anchor refinement module: 4 ConvBN-ReLU, then loc (4K) and conf (2K)
    ConvBN heads."""

    def __init__(self, in_ch: int, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for j in range(4):
            self.add_module(f"conv{j + 1}", ConvBN(in_ch if j == 0 else 256, 256, 3,
                                                   activation=torch.relu,
                                                   generator=generator, dtype=dtype))
        self.loc = ConvBN(256, 4 * NUM_ANCHORS, 3, generator=generator, dtype=dtype)
        self.conf = ConvBN(256, 2 * NUM_ANCHORS, 3, generator=generator, dtype=dtype)

    def forward(self, x):
        for j in range(4):
            x = getattr(self, f"conv{j + 1}")(x)
        return self.loc(x), self.conf(x)


class TCB(nn.Module):
    """Transfer connection block; with ``has_high`` the level above joins
    through ``up`` (deconv + BN) before the last ReLU."""

    def __init__(self, in_ch: int, has_high: bool,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ConvBN(in_ch, 256, 3, activation=torch.relu, generator=generator,
                            dtype=dtype)
        self.conv2 = ConvBN(256, 256, 3, generator=generator, dtype=dtype)
        self.up = _DeconvBN(256, 256, generator, dtype) if has_high else None

    def forward(self, x, high=None):
        x = self.conv2(self.conv1(x))
        if self.up is not None:
            x = torch.relu(x + self.up(high))
        return torch.relu(x)


class ODM(nn.Module):
    """Object detection module: 4 ConvBN-ReLU, then loc (4K) and conf
    ((C+1)K) ConvBN heads."""

    def __init__(self, num_classes_total: int,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for j in range(4):
            self.add_module(f"conv{j + 1}", ConvBN(256, 256, 3, activation=torch.relu,
                                                   generator=generator, dtype=dtype))
        self.loc = ConvBN(256, 4 * NUM_ANCHORS, 3, generator=generator, dtype=dtype)
        self.conf = ConvBN(256, num_classes_total * NUM_ANCHORS, 3, generator=generator,
                           dtype=dtype)

    def forward(self, x):
        for j in range(4):
            x = getattr(self, f"conv{j + 1}")(x)
        return self.loc(x), self.conf(x)


class RefineDetExtractor(nn.Module):
    """VGG-16, a stride-1 pool5, dilated conv6, conv7 and the conv8-conv10
    extras; endpoints at strides 8/16/32/64 (conv4_3, conv5_3, conv8_2,
    conv10_2), with learned L2-norm scales 10 and 8 on the first two."""

    out_channels = (512, 512, 512, 256)

    def __init__(self, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        relu = torch.relu

        def cbn(i, o, k, **kw):
            return ConvBN(i, o, k, activation=relu, generator=generator, dtype=dtype, **kw)

        self.vgg = VGG16Trunk(generator, dtype)
        self.conv6 = cbn(512, 1024, 3, dilation=2)
        self.conv7 = cbn(1024, 1024, 1)
        self.conv8_1 = cbn(1024, 256, 1)
        self.conv8_2 = cbn(256, 512, 3, stride=2)
        self.conv9_1 = cbn(512, 256, 1)
        self.conv9_2 = cbn(256, 512, 3, stride=2)
        self.conv10_1 = cbn(512, 256, 1)
        self.conv10_2 = cbn(256, 256, 3)
        self.feat1_l2_norm = L2NormScale(10.0)
        self.feat2_l2_norm = L2NormScale(8.0)

    def forward(self, x):
        conv4_3, conv5_3 = self.vgg(x)
        p = self.conv7(self.conv6(max_pool_same(conv5_3, 3, 1)))
        conv8_2 = self.conv8_2(self.conv8_1(p))
        conv9_2 = self.conv9_2(self.conv9_1(conv8_2))
        conv10_2 = self.conv10_2(self.conv10_1(conv9_2))
        return [self.feat1_l2_norm(conv4_3), self.feat2_l2_norm(conv5_3), conv8_2,
                conv10_2]


def _resize_bilinear_align(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``tf.image.resize_bilinear(align_corners=True)`` on NCHW ``x``, for the
    MSCA downscales: a bfloat16 input gives a float32 output, as in tpudet."""
    h, w = x.shape[-2:]
    if (h, w) == (out_h, out_w):
        return x
    return bilinear_at(x, source_positions(out_h, (h - 1) / max(out_h - 1, 1), x.device),
                       source_positions(out_w, (w - 1) / max(out_w - 1, 1), x.device))


class PFPNetExtractor(nn.Module):
    """VGG through conv4_3 and the MSCA parallel pyramid: bilinear downscales
    of conv4_3 to /2, /4, /8, 1x1 bottlenecks to 85 channels, deconv-up and
    avg-pool-down cross-scale chains (the down chains' 1x1 ConvBNs have no
    activation), and four levels of 767 channels, each the concatenation of
    its own scale of conv4_3 with three bottlenecks; L2-norm scales 10 and 8
    on the first two.

    Under bfloat16 the downscales come out float32, so levels 2-4 concatenate
    to float32 (``torch.cat`` promotes as ``jnp.concatenate`` does) and the
    next convolution casts back. VGG's block 5 is built, as tpudet's tree
    holds it, but not run: its output is dropped."""

    out_channels = (512 + 3 * PFPNET_BOTTLENECK,) * 4

    _UP = ("up2_1", "up3_2", "up3_1", "up4_3", "up4_2", "up4_1")
    _DOWN = ("fl1_2", "fl1_3", "fl1_4", "fl2_3", "fl2_4", "fl3_4")

    def __init__(self, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ch = PFPNET_BOTTLENECK

        def conv1x1(i, act=True):
            return ConvBN(i, ch, 1, activation=torch.relu if act else None,
                          generator=generator, dtype=dtype)

        self.vgg = VGG16Trunk(generator, dtype)
        for name in ("fl1", "fl2", "fl3", "fl4"):
            self.add_module(name, conv1x1(512))
        for up in self._UP:
            self.add_module(up, _DeconvBN(ch, ch, generator, dtype))
            self.add_module("fl" + up[2:], conv1x1(ch))
        for name in self._DOWN:
            self.add_module(name, conv1x1(ch, act=False))
        self.feat1_l2_norm = L2NormScale(10.0)
        self.feat2_l2_norm = L2NormScale(8.0)

    def forward(self, x):
        fh1, _ = self.vgg(x, with_conv5=False)
        h, w = fh1.shape[-2:]
        fh2 = _resize_bilinear_align(fh1, h // 2, w // 2)
        fh3 = _resize_bilinear_align(fh1, h // 4, w // 4)
        fh4 = _resize_bilinear_align(fh1, h // 8, w // 8)
        fl1, fl2, fl3, fl4 = (self.fl1(fh1), self.fl2(fh2), self.fl3(fh3), self.fl4(fh4))

        def up(name, high, low):
            return getattr(self, "fl" + name[2:])(getattr(self, name)(high) + low)

        fl2_1 = up("up2_1", fl2, fl1)
        fl3_2 = up("up3_2", fl3, fl2)
        fl3_1 = up("up3_1", fl3_2, fl1)
        fl4_3 = up("up4_3", fl4, fl3)
        fl4_2 = up("up4_2", fl4_3, fl2)
        fl4_1 = up("up4_1", fl4_2, fl1)

        def down(name, x):
            return getattr(self, name)(avg_pool_same(x, 2, 2))

        fl1_2 = down("fl1_2", fl1)
        fl1_3 = down("fl1_3", fl1_2)
        fl1_4 = down("fl1_4", fl1_3)
        fl2_3 = down("fl2_3", fl2)
        fl2_4 = down("fl2_4", fl2_3)
        fl3_4 = down("fl3_4", fl3)

        feat1 = torch.cat([fh1, fl2_1, fl3_1, fl4_1], 1)
        feat2 = torch.cat([fl1_2, fh2, fl3_2, fl4_2], 1)
        feat3 = torch.cat([fl1_3, fl2_3, fh3, fl4_3], 1)
        feat4 = torch.cat([fl1_4, fl2_4, fl3_4, fh4], 1)
        return [self.feat1_l2_norm(feat1), self.feat2_l2_norm(feat2), feat3, feat4]


class RefineNet(nn.Module):
    """Extractor + ARM/TCB/ODM over 4 levels; ``extractor`` is ``"refinedet"``
    or ``"pfpnet"``. Returns ``(arms, odms)``, each four ``(loc, conf)`` pairs
    of NCHW tensors in ``dtype``."""

    def __init__(self, num_classes_total: int, extractor: str = "refinedet",
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ext_cls = {"refinedet": RefineDetExtractor, "pfpnet": PFPNetExtractor}[extractor]
        self.feature_extractor = ext_cls(generator, dtype)
        chans = ext_cls.out_channels
        for i, c in enumerate(chans):
            self.add_module(f"arm{i + 1}", ARM(c, generator, dtype))
        for i in (4, 3, 2, 1):  # flax's creation order
            self.add_module(f"tcb{i}", TCB(chans[i - 1], i < 4, generator, dtype))
        for i in range(4):
            self.add_module(f"odm{i + 1}", ODM(num_classes_total, generator, dtype))

    def forward(self, x):
        feats = self.feature_extractor(x)
        arms = [getattr(self, f"arm{i + 1}")(f) for i, f in enumerate(feats)]
        tcb4 = self.tcb4(feats[3])
        tcb3 = self.tcb3(feats[2], tcb4)
        tcb2 = self.tcb2(feats[1], tcb3)
        tcb1 = self.tcb1(feats[0], tcb2)
        odms = [getattr(self, f"odm{i + 1}")(t)
                for i, t in enumerate((tcb1, tcb2, tcb3, tcb4))]
        return arms, odms


def flatten_preds(arms, odms, num_classes_total: int):
    """Per-level ``(loc, conf)`` -> float32 ``(arm_yx, arm_hw [B, A, 2],
    arm_conf [B, A, 2], odm_yx, odm_hw [B, A, 2], odm_conf [B, A, C+1])``."""
    def _cat(preds, channels):
        locs, confs = [], []
        for ploc, pconf in preds:
            b = ploc.shape[0]
            locs.append(ploc.permute(0, 2, 3, 1).reshape(b, -1, 4))
            confs.append(pconf.permute(0, 2, 3, 1).reshape(b, -1, channels))
        return torch.cat(locs, 1).float(), torch.cat(confs, 1).float()

    arm_loc, arm_conf = _cat(arms, 2)
    odm_loc, odm_conf = _cat(odms, num_classes_total)
    return (arm_loc[..., :2], arm_loc[..., 2:], arm_conf,
            odm_loc[..., :2], odm_loc[..., 2:], odm_conf)


def _coord_loss(p_yx, p_hw, t_yx, t_hw):
    return (torch.sum(loss_ops.smooth_l1(p_yx - t_yx), -1)
            + torch.sum(loss_ops.smooth_l1(p_hw - t_hw), -1))


def _image_terms(arm_yx, arm_hw, arm_conf, odm_yx, odm_hw, odm_conf, anc: AnchorSet,
                 g: matching.GtArrays, assign: matching.Assignment,
                 num_classes_total: int):
    """Per-image terms on the precomputed assignment, batched: returns
    ``(pos_loss [B], neg_arm_ce [B, A], neg [B, A], chosen [B],
    arm_bg_logit [B, A], odm_bg_ce [B, A])``; the mining runs after."""
    best_anchor, best_iou, rg, best_set = assign
    ba = best_anchor.long()
    vmask = g.valid.to(torch.float32)
    other = ~best_set
    pos = other & (best_iou > 0.5)
    neg = other & (best_iou < 0.4)
    pos_f = pos.to(torch.float32)
    num_pos_int = g.count + torch.sum(pos.to(torch.int32), -1)
    denom = torch.clamp(num_pos_int.to(torch.float32), min=1e-8)
    ghw_safe = torch.clamp(g.hw, min=1e-8)

    def per_image(best_rows, pos_rows):
        return (torch.sum(best_rows * vmask, -1) + torch.sum(pos_rows * pos_f, -1)) / denom

    # ARM: class 0 is object, 1 background
    arm_lp = loss_ops.log_softmax(arm_conf)
    arm_conf_loss = per_image(-_gather_anchors(arm_lp, best_anchor)[..., 0],
                              -arm_lp[..., 0])
    b_anc_yx, b_anc_hw = anc.yx[ba], anc.hw[ba]
    b_arm_yx = _gather_anchors(arm_yx, best_anchor)
    b_arm_hw = _gather_anchors(arm_hw, best_anchor)
    rg_label, rg_yx, rg_hw = matching.gather_gt_rows(rg, g.label, g.yx, g.hw)
    rg_hw_safe = torch.clamp(rg_hw, min=1e-8)
    arm_coord_loss = per_image(
        _coord_loss(b_arm_yx, b_arm_hw, *box_ops.encode(g.yx, ghw_safe, b_anc_yx, b_anc_hw)),
        _coord_loss(arm_yx, arm_hw, *box_ops.encode(rg_yx, rg_hw_safe, anc.yx, anc.hw)))
    num_neg = torch.sum(neg.to(torch.int32), -1)
    chosen = torch.minimum(num_neg, 3 * num_pos_int)

    # ODM: CE over C+1 classes, box targets against the ARM-refined boxes
    best_odm_ce, pos_odm_ce, odm_bg_ce = ssd_head._conf_ce_terms(
        odm_conf, best_anchor, g.label, rg_label, num_classes_total)
    odm_conf_loss = per_image(best_odm_ce, pos_odm_ce)
    b_ref_yx, b_ref_hw = box_ops.decode(b_arm_yx, b_arm_hw, b_anc_yx, b_anc_hw)
    p_ref_yx, p_ref_hw = box_ops.decode(arm_yx, arm_hw, anc.yx, anc.hw)
    odm_coord_loss = per_image(
        _coord_loss(_gather_anchors(odm_yx, best_anchor),
                    _gather_anchors(odm_hw, best_anchor),
                    (g.yx - b_ref_yx) / b_ref_hw, torch.log(ghw_safe / b_ref_hw)),
        _coord_loss(odm_yx, odm_hw, (rg_yx - p_ref_yx) / p_ref_hw,
                    torch.log(rg_hw_safe / p_ref_hw)))

    pos_loss = arm_conf_loss + arm_coord_loss + odm_conf_loss + odm_coord_loss
    return pos_loss, -arm_lp[..., 1], neg, chosen, arm_conf[..., 1], odm_bg_ce


def refine_loss(arm_yx, arm_hw, arm_conf, odm_yx, odm_hw, odm_conf, anc: AnchorSet,
                gt, num_classes_total: int, neg_sel_cap: int = 384,
                sample_weight=None):
    """Batched RefineDet loss: the mean of the per-image losses.

    Args are the flattened float32 head outputs (:func:`flatten_preds`), the
    anchors and ``gt [B, G, 5]`` padded with -1. The assignment goes through
    the assignment kernel's wrapper and the ARM's hard-negative mining through
    the NMS kernel's pre-top-k pool (one host sync a call); both take their
    plain versions on CPU tensors. The gradient reaches the mined CE terms
    only at the picked indices.
    """
    g = matching.unpack_gt(gt)
    assign = matching.assign_batch(g.y1x1, g.y2x2, g.valid, anc.y1x1, anc.y2x2)
    pos_loss, neg_arm_ce, neg, chosen, arm_bg_logit, odm_bg_ce = _image_terms(
        arm_yx, arm_hw, arm_conf, odm_yx, odm_hw, odm_conf, anc, g, assign,
        num_classes_total)
    anc_corners = torch.cat([anc.y1x1, anc.y2x2], -1)
    mining_scores = torch.where(neg, neg_arm_ce.detach(), nms.NEG).contiguous()
    sel, sel_valid = nms_kernel.batched_greedy_nms_pretopk(
        anc_corners, mining_scores, chosen.to(torch.int32), neg_sel_cap, 0.7)
    sel = sel.long()
    sel_f = sel_valid.to(torch.float32)
    neg_arm_loss = (torch.sum(torch.gather(neg_arm_ce, 1, sel) * sel_f, -1)
                    / torch.clamp(torch.sum(sel_f, -1), min=1.0))
    # ODM negatives: the ARM's picks whose background LOGIT is < 0.99
    odm_keep = (sel_valid & (torch.gather(arm_bg_logit, 1, sel) < 0.99)).to(torch.float32)
    neg_odm_loss = (torch.sum(torch.gather(odm_bg_ce, 1, sel) * odm_keep, -1)
                    / torch.clamp(torch.sum(odm_keep, -1), min=1.0))
    return loss_ops.weighted_mean(pos_loss + neg_arm_loss + neg_odm_loss, sample_weight)


def refine_decode(arm_yx, arm_hw, arm_conf, odm_yx, odm_hw, odm_conf, anc: AnchorSet,
                  num_classes_total: int, score_threshold: float, iou_threshold: float,
                  max_boxes: int):
    """Single-image cascade decode on the ``[A, ...]`` head outputs of ONE
    image. Returns padded ``(scores [C*max], boxes [C*max, 4], class_id
    [C*max], valid [C*max])``, as :func:`heads.ssd.ssd_decode` does; the
    pool is exact, so there is no truncation flag."""
    c = num_classes_total - 1
    armp = torch.softmax(arm_conf, -1)
    odmp = torch.softmax(odm_conf, -1)
    keep = (armp[:, 1] < 0.99) & (torch.argmax(odmp, -1) < c)
    a_yx, a_hw = box_ops.decode(arm_yx, arm_hw, anc.yx, anc.hw)
    o_yx, o_hw = box_ops.decode(odm_yx, odm_hw, a_yx, a_hw)
    boxes = torch.cat(box_ops.center_to_corners(o_yx, o_hw), -1)
    sel_boxes, sel_scores, sel_valid = nms.per_class_nms(
        boxes, odmp[:, :c].T, score_threshold, max_boxes, iou_threshold,
        class_active=keep)
    class_id = torch.arange(c, dtype=torch.int32, device=boxes.device)
    class_id = class_id[:, None].expand(c, max_boxes)
    return (sel_scores.reshape(-1), sel_boxes.reshape(-1, 4), class_id.reshape(-1),
            sel_valid.reshape(-1))
