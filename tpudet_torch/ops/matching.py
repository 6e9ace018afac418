"""Fixed-shape target assignment (counterpart of ``tpudet/ops/matching.py``).

Ground truth is ``float32 [..., G, 5]`` rows of ``[y_center, x_center, h, w,
class_id]`` in input pixels, padded with -1. Every function here takes leading
batch dimensions: where tpudet ``vmap``s over the batch, the port writes the
batch dimension out.

:func:`assign_batch` computes the four assignment products through the CUDA
kernel's wrapper (``tpudet_torch/ops/cuda/assign_kernel.py``), which takes the
plain version composed from the functions below only for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpudet_torch.ops import boxes as box_ops

UNION_MIN = 1e-12  # the assignment kernel's union clamp (tpudet's assign_kernel.py:83)


def valid_gt_count(gt: torch.Tensor) -> torch.Tensor:
    """Number of real (non-padding) rows of ``gt [..., G, 5]`` as int32 ``[...]``.

    tpudet's quirk, kept: the index of the first smallest ``y_center`` (the
    first -1 padding row whenever padding exists, since real centers are >= 0),
    or G when no row is padding.
    """
    g = gt.shape[-2]
    y = gt[..., 0]
    any_pad = torch.any(y < 0.0, dim=-1)
    first_pad = torch.argmin(y, dim=-1)  # the first of equal minima
    return torch.where(any_pad, first_pad, g).to(torch.int32)


class GtArrays(NamedTuple):
    """Unpacked padded ground truth plus validity (leading batch dims kept)."""

    yx: torch.Tensor     # [..., G, 2]
    hw: torch.Tensor     # [..., G, 2]
    y1x1: torch.Tensor   # [..., G, 2]
    y2x2: torch.Tensor   # [..., G, 2]
    label: torch.Tensor  # [..., G] int32, 0 on padding rows
    valid: torch.Tensor  # [..., G] bool
    count: torch.Tensor  # [...] int32


def unpack_gt(gt: torch.Tensor) -> GtArrays:
    """Split the padded ``[..., G, 5]`` gt into components with a validity mask."""
    count = valid_gt_count(gt)
    g = gt.shape[-2]
    valid = torch.arange(g, dtype=torch.int32, device=gt.device) < count[..., None]
    yx = gt[..., 0:2]
    hw = gt[..., 2:4]
    y1x1, y2x2 = box_ops.center_to_corners(yx, hw)
    label = torch.where(valid, gt[..., 4].to(torch.int32), 0)
    return GtArrays(yx, hw, y1x1, y2x2, label, valid, count)


def masked_iou_matrix(g_y1x1, g_y2x2, g_valid, a_y1x1, a_y2x2) -> torch.Tensor:
    """``[..., G, A]`` IoU of gt corners ``[..., G, 2]`` against anchors ``[A, 2]``
    (shared) or ``[..., A, 2]`` (per image), with invalid gt rows forced to 0.

    The union is clamped at 1e-12, as in the assignment kernel; tpudet's XLA
    form has no clamp, and the two differ only where a union is below 1e-12 (a
    zero-area gt against a zero-area anchor, 0/0). Inputs must be finite.
    """
    gy1, gx1 = g_y1x1[..., :, None, 0], g_y1x1[..., :, None, 1]
    gy2, gx2 = g_y2x2[..., :, None, 0], g_y2x2[..., :, None, 1]
    ay1, ax1 = a_y1x1[..., None, :, 0], a_y1x1[..., None, :, 1]
    ay2, ax2 = a_y2x2[..., None, :, 0], a_y2x2[..., None, :, 1]
    ih = torch.clamp(torch.minimum(gy2, ay2) - torch.maximum(gy1, ay1), min=0.0)
    iw = torch.clamp(torch.minimum(gx2, ax2) - torch.maximum(gx1, ax1), min=0.0)
    inter = ih * iw
    g_area = (gy2 - gy1) * (gx2 - gx1)
    a_area = (ay2 - ay1) * (ax2 - ax1)
    iou = inter / torch.clamp(g_area + a_area - inter, min=UNION_MIN)
    return torch.where(g_valid[..., None], iou, 0.0)


def best_anchor_per_gt(iou: torch.Tensor) -> torch.Tensor:
    """Index of the highest-IoU anchor per gt row (``[..., G]`` int32); ties go
    to the lowest anchor index."""
    return torch.argmax(iou, dim=-1).to(torch.int32)


def best_gt_per_anchor(iou: torch.Tensor, gt_valid: torch.Tensor):
    """Per-anchor ``(best_iou [..., A], best_gt_idx [..., A] int32)`` over valid
    gt rows only (-1 and 0 where an image has none); ties go to the lowest gt."""
    masked = torch.where(gt_valid[..., None], iou, -1.0)
    return torch.amax(masked, dim=-2), torch.argmax(masked, dim=-2).to(torch.int32)


def scatter_best_mask(best_idx: torch.Tensor, gt_valid: torch.Tensor,
                      num_anchors: int) -> torch.Tensor:
    """``[..., A]`` bool: anchors claimed as some valid gt's best anchor."""
    cols = torch.arange(num_anchors, dtype=best_idx.dtype, device=best_idx.device)
    hit = (best_idx[..., None] == cols) & gt_valid[..., None]
    return torch.any(hit, dim=-2)


def gather_gt_rows(rg: torch.Tensor, *tables: torch.Tensor):
    """``table[rg]`` per image: ``rg [..., A]`` indexes gt tables ``[..., G]`` or
    ``[..., G, k]``. A plain take (tpudet's ``take`` branch)."""
    idx = rg.long()
    out = []
    for t in tables:
        if t.dim() == idx.dim():
            out.append(torch.gather(t, -1, idx))
        else:
            out.append(torch.gather(t, -2, idx[..., None].expand(*idx.shape, t.shape[-1])))
    return tuple(out)


class Assignment(NamedTuple):
    """Batched anchor-assignment products."""

    best_anchor: torch.Tensor  # [B, G] int32: argmax_a IoU per gt (ties -> low a)
    best_iou: torch.Tensor     # [B, A] f32: max_g IoU per anchor (no valid gt -> -1)
    rg: torch.Tensor           # [B, A] int32: argmax_g (ties -> low g)
    best_set: torch.Tensor     # [B, A] bool: claimed as some valid gt's best


def assign_plain(gt_y1x1, gt_y2x2, gt_valid, a_y1x1, a_y2x2) -> Assignment:
    """The plain PyTorch assignment (tpudet's vmapped ``_xla`` form, batch
    written out): what the CPU runs and what the CUDA kernel is held against.
    Shapes as in :func:`assign_batch`."""
    iou = masked_iou_matrix(gt_y1x1, gt_y2x2, gt_valid, a_y1x1, a_y2x2)
    best_anchor = best_anchor_per_gt(iou)
    best_iou, rg = best_gt_per_anchor(iou, gt_valid)
    best_set = scatter_best_mask(best_anchor, gt_valid, a_y1x1.shape[-2])
    return Assignment(best_anchor, best_iou, rg, best_set)


def assign_batch(gt_y1x1, gt_y2x2, gt_valid, a_y1x1, a_y2x2) -> Assignment:
    """Batched anchor assignment.

    Args:
      gt_y1x1, gt_y2x2: ``[B, G, 2]`` float32 gt corners (padding rows arbitrary
        but finite).
      gt_valid: ``[B, G]`` bool.
      a_y1x1, a_y2x2: ``[A, 2]`` shared anchors or ``[B, A, 2]`` per-image boxes.

    CUDA tensors run the assignment kernel, CPU tensors the plain version
    (:func:`assign_plain`); any other device raises. The products are
    decisions with no gradient, so the inputs are detached.
    """
    from tpudet_torch.ops.cuda import assign_kernel  # imports this module

    args = (t.detach().contiguous() for t in (gt_y1x1, gt_y2x2, gt_valid, a_y1x1, a_y2x2))
    return Assignment(*assign_kernel.assign_anchors(*args))
