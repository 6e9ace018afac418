"""Greedy non-max suppression (counterpart of ``tpudet/ops/nms.py``).

Semantics of ``tf.image.non_max_suppression``: boxes are taken in descending score
order (ties -> lowest index) and a box is suppressed when its IoU with an
already-selected box is strictly greater than ``iou_threshold``. A pick always
retires itself, so zero-area boxes (NaN IoU) cannot be picked twice. Unused
output slots hold index 0 and ``valid`` False.

:func:`batched_greedy_nms` here is the plain PyTorch version. It is what the CPU
runs and what the CUDA kernel (``tpudet_torch/ops/cuda/nms_kernel.py``) is held
against; :func:`per_class_nms` goes through the kernel's wrapper, which takes
this plain version only for CPU tensors.
"""

from __future__ import annotations

import torch

NEG = -1e30  # score of an inactive candidate; anything <= NEG/2 is never picked


def batched_greedy_nms(boxes: torch.Tensor, scores: torch.Tensor,
                       num_select: torch.Tensor, max_out: int,
                       iou_threshold: float, active: torch.Tensor | None = None):
    """Plain batched greedy NMS: every row selects independently.

    Args:
      boxes: ``[N, 4]`` (shared by all rows) or ``[B, N, 4]`` corner boxes
        (y1, x1, y2, x2), float32.
      scores: ``[B, N]`` float32, inactive entries at ``<= NEG``.
      num_select: ``[B]`` int budgets; row ``b`` stops after
        ``min(num_select[b], max_out)`` picks or when no live candidate is left.
      active: optional ``[B, N]`` bool candidate mask (inactive -> ``NEG``).

    Returns ``(sel [B, max_out] int32, valid [B, max_out] bool)``. Selection
    carries no gradient (tpudet's ``stop_gradient``): callers gather
    differentiable values with the returned indices.
    """
    b, n = scores.shape
    dev = scores.device
    scores = scores.detach()
    if active is not None:
        scores = torch.where(active, scores, NEG)
    s = scores.to(torch.float32).clone()
    bx = boxes.detach().to(torch.float32)
    if bx.dim() == 2:
        bx = bx.unsqueeze(0).expand(b, n, 4)
    y1, x1, y2, x2 = bx.unbind(-1)
    area = (y2 - y1) * (x2 - x1)
    n_sel = torch.clamp(num_select.to(dev, torch.int64), max=max_out)
    sel = torch.zeros((b, max_out), dtype=torch.int32, device=dev)
    valid = torch.zeros((b, max_out), dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)
    cols = torch.arange(n, device=dev)
    if n == 0:
        return sel, valid
    for k in range(max_out):
        best = torch.max(s, dim=1).values
        # lowest index among the maxima, spelled out so no device's reduction
        # order can change it (clamped: a NaN row finds no match and is inactive)
        j = torch.where(s == best[:, None], cols, n).min(dim=1).values.clamp(max=n - 1)
        active = (k < n_sel) & (best > NEG / 2)
        if not bool(active.any()):
            break  # an inactive row never becomes active again
        by1, bx1, by2, bx2 = (c[rows, j][:, None] for c in (y1, x1, y2, x2))
        inter = (torch.clamp(torch.minimum(y2, by2) - torch.maximum(y1, by1), min=0.0)
                 * torch.clamp(torch.minimum(x2, bx2) - torch.maximum(x1, bx1), min=0.0))
        barea = (by2 - by1) * (bx2 - bx1)
        iou = inter / (area + barea - inter)
        kill = active[:, None] & ((iou > iou_threshold) | (cols[None, :] == j[:, None]))
        s = torch.where(kill, NEG, s)
        sel[:, k] = torch.where(active, j.to(torch.int32), 0)
        valid[:, k] = active
    return sel, valid


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
               iou_threshold: float, active: torch.Tensor | None = None,
               num_select: int | None = None):
    """Single-row greedy NMS: ``boxes [N, 4]``, ``scores [N]``; optional ``active``
    ``[N]`` bool mask and ``num_select`` budget. Returns
    ``(indices [max_out] int32, valid [max_out] bool)``."""
    budget = max_out if num_select is None else num_select
    ns = torch.as_tensor([budget], dtype=torch.int32, device=scores.device)
    sel, valid = batched_greedy_nms(boxes, scores[None], ns, max_out, iou_threshold,
                                    active=None if active is None else active[None])
    return sel[0], valid[0]


def per_class_nms(boxes: torch.Tensor, class_scores: torch.Tensor,
                  score_threshold: float, max_out: int, iou_threshold: float,
                  class_active: torch.Tensor | None = None):
    """Class-parallel NMS over a shared box set, classes as the batch axis.

    Args:
      boxes: ``[N, 4]`` decoded corner boxes (shared across classes).
      class_scores: ``[C, N]`` per-class scores; candidates need
        ``score >= score_threshold``.
      class_active: optional ``[N]`` bool applied to every class (SSD's
        "argmax is not background" filter).

    Returns ``(boxes [C, max_out, 4], scores [C, max_out], valid [C, max_out])``.
    The selection goes through the pre-top-k pool of the NMS kernel, which is
    exact by construction, so unlike tpudet's vmapped CPU form there is no
    ``pre_topk`` truncation to report.
    """
    from tpudet_torch.ops.cuda import nms_kernel  # imports this module

    active = class_scores >= score_threshold
    if class_active is not None:
        active = active & class_active[None, :]
    c = class_scores.shape[0]
    masked = torch.where(active, class_scores.to(torch.float32), NEG).contiguous()
    quota = torch.full((c,), max_out, dtype=torch.int32, device=masked.device)
    sel, valid = nms_kernel.batched_greedy_nms_pretopk(boxes, masked, quota, max_out,
                                                       iou_threshold)
    sel = sel.long()
    return boxes[sel], torch.gather(masked, 1, sel), valid
