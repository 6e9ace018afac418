"""CenterNet head: keypoint heatmap, offset and size, decoded by peaks with no
box NMS (counterpart of ``tpudet/heads/centernet.py``).

Loss, as tpudet's:
  * a gaussian penalty reduction with ONE sigma an image, the minimum of all
    three CornerNet radii over all its valid gts (the reference's
    ``reduce_min`` with no axis), the third radius divided by 2 where it
    should be ``2 * a3``; a valid gt of zero size gives sigma 0 and a NaN
    loss, as in tpudet (no guard);
  * the penalty-reduced focal term: ``-(1-s)^2 log s`` at the gt center
    cells, ``-(1-gauss)^4 s^2 log(1-s)`` elsewhere, summed and divided by
    the gt count;
  * L1 offset plus 0.1 times L1 size at the center cells, each over
    ``2 * count``.
The focal block is written once, in the ``[C, P]`` planes of tpudet's
default layout; it equals both of tpudet's layouts. The center cells are
marked as tpudet's ``.at[label, cell].max`` marks them: a label in ``[-C,
-1]`` wraps to ``label + C`` and one outside ``[-C, C)`` is dropped (a torch
scatter would raise on the CPU and assert on the card); the per-class
reduction takes a label only where it equals a class, so a negative one
adds nothing there.

Decode: the class of each cell is its first maximum (``jnp.argmax``), the
3x3 SAME max-pool of the best score marks the peaks, and the ``top_k``
scores are taken in descending order with ties to the lowest index, as
``jax.lax.top_k`` takes them (``torch.topk`` on the card does not promise
that).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpudet_torch.heads.yolo import first_argmax
from tpudet_torch.nn.backbones.dla import DLABackbone, DLAUp
from tpudet_torch.nn.layers import ConvBN, max_pool_same
from tpudet_torch.ops import losses as loss_ops
from tpudet_torch.ops import matching
from tpudet_torch.ops.cuda import nms_kernel

STRIDE = 4.0


class CenterNetNet(nn.Module):
    """DLA (scope ``backone``), its upsampling neck and three ConvBN heads;
    returns float32 NCHW ``(keypoints [B, C], offset [B, 2], size [B, 2])``
    at stride 4."""

    def __init__(self, num_classes: int, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype)
        self.backone = DLABackbone(**kw)
        self.upsampling = DLAUp(DLABackbone.out_channels, **kw)
        self.keypoints = ConvBN(256, num_classes, 3, **kw)
        self.offset = ConvBN(256, 2, 3, **kw)
        self.size = ConvBN(256, 2, 3, **kw)

    def forward(self, x):
        f = self.upsampling(*self.backone(x))
        return (self.keypoints(f).float(), self.offset(f).float(), self.size(f).float())


def gaussian_sigma(h, w, valid, min_overlap: float = 0.7):
    """The global-minimum CornerNet radius of each image: ``h, w, valid
    [B, G]`` -> ``[B]`` (inf where no gt is valid)."""
    b1 = h + w
    c1 = w * h * (1.0 - min_overlap) / (1.0 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 ** 2 - 4.0 * c1, min=0.0))) / 2.0
    b2 = 2.0 * (h + w)
    c2 = (1.0 - min_overlap) * w * h
    r2 = (b2 + torch.sqrt(torch.clamp(b2 ** 2 - 16.0 * c2, min=0.0))) / 2.0
    a3 = 4.0 * min_overlap
    b3 = -2.0 * min_overlap * (h + w)
    c3 = (min_overlap - 1.0) * w * h
    # the reference divides by 2, not by 2 * a3
    r3 = (b3 + torch.sqrt(torch.clamp(b3 ** 2 - 4.0 * a3 * c3, min=0.0))) / 2.0
    all_r = torch.where(valid[None], torch.stack([r1, r2, r3]), torch.inf)
    return torch.amin(all_r, (0, 2))


def _images_loss(keypoints, offset, size, gt, stride: float):
    """Each image's loss ``[B]``; NCHW head outputs, ``gt [B, G, 5]``."""
    b, c, h, w = keypoints.shape
    p = h * w
    g = matching.unpack_gt(gt)
    nyx, nhw = g.yx / stride, g.hw / stride
    cell = torch.floor(nyx)
    cy = torch.clamp(cell[..., 0].to(torch.int32), 0, h - 1).long()
    cx = torch.clamp(cell[..., 1].to(torch.int32), 0, w - 1).long()
    flat = cy * w + cx                                                  # [B, G]
    num_g = torch.clamp(g.count.to(torch.float32), min=1e-8)

    sigma = gaussian_sigma(nhw[..., 0], nhw[..., 1], g.valid)          # [B]
    yy, xx = (t.reshape(-1) for t in torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=gt.device),
        torch.arange(w, dtype=torch.float32, device=gt.device), indexing="ij"))
    d2 = (nyx[..., 0, None] - yy) ** 2 + (nyx[..., 1, None] - xx) ** 2  # [B, G, P]
    gauss = torch.exp(-d2 / (2.0 * sigma[:, None, None] ** 2))
    gauss = torch.where(g.valid[..., None], gauss, 0.0)
    reduction = torch.stack([
        torch.amax(torch.where(((g.label == ci) & g.valid)[..., None], gauss, 0.0), 1)
        for ci in range(c)], 1)                                         # [B, C, P]
    marked = g.valid & (g.label >= -c) & (g.label < c)
    slot = torch.where(marked, torch.remainder(g.label.long(), c) * p + flat, c * p)
    gt_keyp = torch.zeros((b, c * p + 1), dtype=torch.float32, device=gt.device)
    gt_keyp = gt_keyp.scatter_(1, slot, 1.0)[:, :c * p].reshape(b, c, p)

    x = keypoints.reshape(b, c, p)
    s = torch.sigmoid(x)
    log_s = F.logsigmoid(x)
    log_1ms = -x + log_s  # log(1 - sigmoid(x))
    pos = -torch.square(1.0 - s) * log_s * gt_keyp
    neg = (-torch.pow(1.0 - reduction, 4.0) * torch.square(s) * log_1ms
           * (1.0 - gt_keyp))
    keyp_loss = (torch.sum(pos, (1, 2)) + torch.sum(neg, (1, 2))) / num_g

    index = flat[:, None, :].expand(b, 2, -1)
    off_p = torch.gather(offset.reshape(b, 2, p), 2, index).transpose(1, 2)  # [B, G, 2]
    size_p = torch.gather(size.reshape(b, 2, p), 2, index).transpose(1, 2)
    vf = g.valid[..., None].to(torch.float32)
    denom = 2.0 * num_g
    offset_loss = torch.sum(loss_ops.jnp_abs(nyx - cell - off_p) * vf, (1, 2)) / denom
    size_loss = torch.sum(loss_ops.jnp_abs(nhw - size_p) * vf, (1, 2)) / denom
    return keyp_loss + 0.1 * size_loss + offset_loss


def centernet_image_loss(keypoints, offset, size, gt, num_classes: int,
                         stride: float = STRIDE):
    """One image's loss: ``keypoints [C, h, w]``, ``offset`` and ``size [2, h,
    w]``, ``gt [G, 5]`` (the classes are ``keypoints``' channels)."""
    return _images_loss(keypoints[None], offset[None], size[None], gt[None], stride)[0]


def centernet_loss(keypoints, offset, size, gt, num_classes: int, stride: float = STRIDE,
                   sample_weight=None):
    """The mean over the batch of each image's loss
    (:func:`centernet_image_loss`); NCHW head outputs, ``gt [B, G, 5]``."""
    return loss_ops.weighted_mean(_images_loss(keypoints, offset, size, gt, stride),
                                  sample_weight)


def peak_scores(keypoints):
    """``keypoints [C, h, w]`` -> ``(scores [h * w], category [h * w])``: each
    cell's best class score where it is its 3x3 neighbourhood's peak, else 0,
    and that class (the decode's top K is taken over these scores)."""
    s = torch.sigmoid(keypoints).permute(1, 2, 0)                      # [h, w, C]
    category = first_argmax(s).reshape(-1)
    best = torch.amax(s, -1)
    peak = max_pool_same(best[None, None], 3, 1)[0, 0]
    return torch.where(best == peak, best, 0.0).reshape(-1), category


def centernet_decode(keypoints, offset, size, score_threshold: float, top_k: int,
                     stride: float = STRIDE):
    """One image's ``keypoints [C, h, w]``, ``offset``, ``size [2, h, w]`` ->
    ``(scores [K], boxes [K, 4], class_id [K] int32, valid [K])``,
    ``K = min(top_k, h * w)``, valid where the score is above the
    threshold."""
    _, h, w = keypoints.shape
    scores, category = peak_scores(keypoints)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=keypoints.device),
                            torch.arange(w, dtype=torch.float32, device=keypoints.device),
                            indexing="ij")
    byx = torch.stack([yy, xx], -1).reshape(-1, 2) + offset.permute(1, 2, 0).reshape(-1, 2)
    bhw = size.permute(1, 2, 0).reshape(-1, 2)
    boxes = torch.cat([byx - bhw / 2.0, byx + bhw / 2.0], -1) * stride
    # the head of the stable descending order (tpudet's lax.top_k): on the
    # card the select kernel where K fits it
    k = min(top_k, h * w)
    flat = scores[None].to(torch.float32).contiguous()
    if k <= nms_kernel.SORTED_SCAN_MAX_WIDTH:
        top = nms_kernel.select_top(flat, k)[0].long()
    else:
        top = nms_kernel.stable_order(flat)[0, :k].long()
    top_scores = scores[top]
    return (top_scores, boxes[top], category[top].to(torch.int32),
            top_scores > score_threshold)
