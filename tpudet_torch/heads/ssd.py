"""SSD head: anchors, prediction convs, flatten, loss and decode
(counterpart of ``tpudet/heads/ssd.py``).

Head outputs are NCHW inside the port; :func:`flatten_preds` permutes them to
NHWC before the reshape, so anchors stay in (row, col, prior) order. Each
prior's channels are ``[conf(C+1), yx(2), hw(2)]``, and background is the LAST
class (index ``C``).

Matching rules of :func:`ssd_loss`, as tpudet's:
  1. every valid gt claims its best-IoU anchor (the "best set"; a repeated
     anchor stays duplicated in the per-gt loss rows);
  2. anchors outside the best set are positive if their best gt IoU > 0.5,
     assigned to that gt; the rest are negatives;
  3. negatives are mined by greedy NMS (IoU 0.7) on their background CE,
     keeping at most ``min(num_neg, 3 * num_pos)`` capped at ``neg_sel_cap``;
     their mean CE is the negative loss;
  4. positive conf and coord losses are sums over the best and positive rows
     divided by ``num_pos``.
The conf CE uses the plain ``[A, C]`` layout (tpudet's ``ac``), not the TPU's
``[C, A]`` one.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from tpudet_torch.nn.backbones.vgg import SSDVGGExtractor
from tpudet_torch.nn.layers import ConvBN, L2NormScale
from tpudet_torch.ops import anchors as anchor_ops
from tpudet_torch.ops import boxes as box_ops
from tpudet_torch.ops import losses as loss_ops
from tpudet_torch.ops import matching, nms
from tpudet_torch.ops.cuda import nms_kernel


class AnchorSet(NamedTuple):
    y1x1: torch.Tensor  # [A, 2]
    y2x2: torch.Tensor  # [A, 2]
    yx: torch.Tensor    # [A, 2]
    hw: torch.Tensor    # [A, 2]


SSD_ASPECT_RATIOS = ([2, 1 / 2], [2, 1 / 2, 3, 1 / 3], [2, 1 / 2, 3, 1 / 3],
                     [2, 1 / 2, 3, 1 / 3], [2, 1 / 2], [2, 1 / 2])


def build_anchors(input_size: int, feat_shapes: Sequence[Sequence[int]],
                  aspect_ratios: Optional[Sequence[Sequence[float]]] = None,
                  scale_pairs: Optional[Sequence[Sequence[float]]] = None,
                  device: torch.device | str = "cpu") -> AnchorSet:
    """Anchor set over the head feature shapes. SSD300's maps are
    38/19/10/5/5/3 (conv10_2 has stride 1): 8828 anchors."""
    n = len(feat_shapes)
    if aspect_ratios is None:
        aspect_ratios = SSD_ASPECT_RATIOS[:n]
    if scale_pairs is None:
        scale_pairs = anchor_ops.ssd_scale_pairs(float(input_size), n)
    levels = []
    for (fh, fw), pair, ars in zip(feat_shapes, scale_pairs, aspect_ratios):
        priors = anchor_ops.ssd_priors(pair, ars)
        levels.append(anchor_ops.grid_anchors(
            fh, fw, priors, input_size / fh, input_size / fw))
    arrs = anchor_ops.concat_levels(levels)
    return AnchorSet(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                       for a in arrs))


def num_priors_per_level(aspect_ratios: Sequence[Sequence[float]]):
    """k = len(ratios) + 2 (two square priors + one per ratio)."""
    return [len(ars) + 2 for ars in aspect_ratios]


class SSDPredHead(nn.Module):
    """Per-level 3x3 ConvBN emitting ``k*(C+1+4)`` channels (BN on heads)."""

    def __init__(self, in_channels: Sequence[int], num_classes_total: int,
                 priors_per_level: Sequence[int],
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i, (c, k) in enumerate(zip(in_channels, priors_per_level)):
            self.add_module(f"pred{i + 1}",
                            ConvBN(c, k * (num_classes_total + 4), 3,
                                   generator=generator, dtype=dtype))

    def forward(self, feats):
        return [getattr(self, f"pred{i + 1}")(f) for i, f in enumerate(feats)]


def flatten_preds(preds, num_classes_total: int):
    """NCHW ``[B, K*(C+5), H, W]`` per level -> concatenated
    ``(pconf [B, A, C+1], pyx [B, A, 2], phw [B, A, 2])``."""
    confs, yxs, hws = [], [], []
    for p in preds:
        b = p.shape[0]
        p = p.permute(0, 2, 3, 1).reshape(b, -1, num_classes_total + 4)
        confs.append(p[..., :num_classes_total])
        yxs.append(p[..., num_classes_total:num_classes_total + 2])
        hws.append(p[..., num_classes_total + 2:])
    return (torch.cat(confs, 1).float(), torch.cat(yxs, 1).float(),
            torch.cat(hws, 1).float())


def _conf_ce_terms(pconf, best_anchor, g_label, po_label, num_classes_total: int):
    """The three CE readouts off ONE log-softmax of the ``[B, A, C]`` conf
    logits: per-gt best-anchor CE ``[B, G]``, per-anchor assigned-label CE and
    per-anchor background CE ``[B, A]``."""
    log_probs = loss_ops.log_softmax(pconf)
    best_lp = torch.gather(log_probs, 1, best_anchor.long()[..., None].expand(
        -1, -1, num_classes_total))
    best_ce = loss_ops.ce_from_log_probs(best_lp, g_label)
    po_ce = loss_ops.ce_from_log_probs(log_probs, po_label)
    neg_ce = -log_probs[..., num_classes_total - 1]
    return best_ce, po_ce, neg_ce


def _gather_anchors(t, idx):
    """``t[b, idx[b, g]]`` for ``t [B, A, k]`` and ``idx [B, G]``."""
    return torch.gather(t, 1, idx.long()[..., None].expand(-1, -1, t.shape[-1]))


def _image_terms(pyx, phw, pconf, anc: AnchorSet, g: matching.GtArrays,
                 assign: matching.Assignment, num_classes_total: int):
    """Per-image SSD matching terms on the precomputed assignment, batched:
    returns ``(pos_loss [B], neg_ce [B, A], neg_mask [B, A], chosen_num_neg [B])``."""
    best_anchor, best_agiou, rg, best_set = assign
    t_yx, t_hw = box_ops.encode(g.yx, torch.clamp(g.hw, min=1e-8),
                                anc.yx[best_anchor.long()], anc.hw[best_anchor.long()])
    best_coord = (
        torch.sum(loss_ops.smooth_l1(_gather_anchors(pyx, best_anchor) - t_yx), -1)
        + torch.sum(loss_ops.smooth_l1(_gather_anchors(phw, best_anchor) - t_hw), -1))
    vmask = g.valid.to(torch.float32)

    # other anchors: IoU > 0.5 positives / negatives
    other = ~best_set
    pos_other = other & (best_agiou > 0.5)
    neg = other & ~pos_other

    po_label, rg_yx, rg_hw = matching.gather_gt_rows(rg, g.label, g.yx, g.hw)
    best_ce, po_ce, neg_ce = _conf_ce_terms(pconf, best_anchor, g.label, po_label,
                                            num_classes_total)
    po_t_yx, po_t_hw = box_ops.encode(rg_yx, torch.clamp(rg_hw, min=1e-8),
                                      anc.yx, anc.hw)
    po_coord = (torch.sum(loss_ops.smooth_l1(pyx - po_t_yx), -1)
                + torch.sum(loss_ops.smooth_l1(phw - po_t_hw), -1))
    pos_f = pos_other.to(torch.float32)
    num_pos_int = g.count + torch.sum(pos_other.to(torch.int32), -1)
    denom = torch.clamp(num_pos_int.to(torch.float32), min=1e-8)

    pos_conf_loss = (torch.sum(best_ce * vmask, -1) + torch.sum(po_ce * pos_f, -1)) / denom
    pos_coord_loss = (torch.sum(best_coord * vmask, -1)
                      + torch.sum(po_coord * pos_f, -1)) / denom
    num_neg = torch.sum(neg.to(torch.int32), -1)
    chosen = torch.minimum(num_neg, 3 * num_pos_int)
    return pos_conf_loss + pos_coord_loss, neg_ce, neg, chosen


def ssd_loss(pconf, pyx, phw, anc: AnchorSet, gt, num_classes_total: int,
             neg_sel_cap: int = 384, sample_weight=None):
    """Batched SSD loss: the mean of the per-image losses.

    Args are the flattened float32 head outputs ``pconf [B, A, C+1]``,
    ``pyx``/``phw [B, A, 2]``, the anchors, and ``gt [B, G, 5]`` padded with -1.
    The assignment goes through the assignment kernel's wrapper and the
    hard-negative mining through the NMS kernel's pre-top-k pool (one host sync
    a call); both take their plain versions on CPU tensors.

    ``neg_sel_cap`` bounds the dynamic mining budget ``min(num_neg, 3*num_pos)``:
    picks beyond it are dropped (config key ``hard_neg_cap``, default 384).
    The gradient reaches ``neg_ce`` only at the picked indices.
    """
    g = matching.unpack_gt(gt)
    assign = matching.assign_batch(g.y1x1, g.y2x2, g.valid, anc.y1x1, anc.y2x2)
    pos_loss, neg_ce, neg, chosen = _image_terms(pyx, phw, pconf, anc, g, assign,
                                                 num_classes_total)
    anc_corners = torch.cat([anc.y1x1, anc.y2x2], -1)
    mining_scores = torch.where(neg, neg_ce.detach(), nms.NEG).contiguous()
    sel, sel_valid = nms_kernel.batched_greedy_nms_pretopk(
        anc_corners, mining_scores, chosen.to(torch.int32), neg_sel_cap, 0.7)
    sel_f = sel_valid.to(torch.float32)
    sel_ce = torch.gather(neg_ce, 1, sel.long())
    neg_loss = torch.sum(sel_ce * sel_f, -1) / torch.clamp(torch.sum(sel_f, -1), min=1.0)
    return loss_ops.weighted_mean(pos_loss + neg_loss, sample_weight)


def ssd_decode(pconf, pyx, phw, anc: AnchorSet, score_threshold: float,
               iou_threshold: float, max_boxes: int):
    """Single-image decode: softmax, the "argmax is not background" filter, box
    decode and per-class NMS, all on the tensors' device.

    Args are the ``[A, ...]`` flattened head outputs of ONE image. Returns padded
    ``(scores [C*max], boxes [C*max, 4], class_id [C*max], valid [C*max])``, the
    per-class blocks concatenated in class order.
    """
    num_classes_total = pconf.shape[-1]
    c = num_classes_total - 1
    conf = torch.softmax(pconf, dim=-1)
    not_bg = torch.argmax(conf, dim=-1) < c  # background is the last class
    class_scores = conf[:, :c].T             # [C, A]
    byx, bhw = box_ops.decode(pyx, phw, anc.yx, anc.hw)
    y1x1, y2x2 = box_ops.center_to_corners(byx, bhw)
    boxes4 = torch.cat([y1x1, y2x2], -1)
    sel_boxes, sel_scores, sel_valid = nms.per_class_nms(
        boxes4, class_scores, score_threshold, max_boxes, iou_threshold,
        class_active=not_bg)
    class_id = torch.arange(c, dtype=torch.int32, device=pconf.device)
    class_id = class_id[:, None].expand(c, max_boxes)
    return (sel_scores.reshape(-1), sel_boxes.reshape(-1, 4),
            class_id.reshape(-1), sel_valid.reshape(-1))


class SSDNet(nn.Module):
    """VGG extractor + conv4_3 L2-norm + prediction heads; returns the per-level
    NCHW prediction tensors, in ``dtype`` (the compute type)."""

    def __init__(self, num_classes_total: int,
                 aspect_ratios: Sequence[Sequence[float]] = SSD_ASPECT_RATIOS,
                 extra_widths: Sequence[int] = (512, 256, 256, 256),
                 extra_strides: Sequence[int] = (2, 2, 1, 2),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.feature_extractor = SSDVGGExtractor(extra_widths, extra_strides,
                                                 generator, dtype)
        self.l2_norm = L2NormScale(init=20.0)
        self.regressor = SSDPredHead(self.feature_extractor.out_channels,
                                     num_classes_total,
                                     num_priors_per_level(aspect_ratios), generator,
                                     dtype)

    def forward(self, x):
        feats = self.feature_extractor(x)
        feats[0] = self.l2_norm(feats[0])
        return self.regressor(feats)
