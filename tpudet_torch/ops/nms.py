"""Greedy non-max suppression (counterpart of ``tpudet/ops/nms.py``).

Semantics of ``tf.image.non_max_suppression``: boxes are taken in descending score
order (ties -> lowest index) and a box is suppressed when its IoU with an
already-selected box is strictly greater than ``iou_threshold``. A pick always
retires itself, so zero-area boxes (NaN IoU) cannot be picked twice. Unused
output slots hold index 0 and ``valid`` False.

:func:`batched_greedy_nms` here is the plain PyTorch version. It is what the CPU
runs and what the CUDA kernels (``tpudet_torch/ops/cuda/nms_kernel.py``) are held
against; :func:`greedy_nms`, :func:`topk_then_nms` and :func:`per_class_nms` go
through the kernels' wrapper on CUDA tensors and take the plain versions only
for CPU tensors.
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


def _one_row(scores, active, num_select, max_out):
    """A row's scores as ``[1, N]`` float32 with inactive entries at ``NEG``,
    and its budget as ``[1]`` int32 on the scores' device (a tensor budget
    stays on the device)."""
    masked = scores.detach().to(torch.float32)
    if active is not None:
        masked = torch.where(active, masked, NEG)
    if num_select is None:
        num_select = max_out
    if isinstance(num_select, torch.Tensor):
        ns = num_select.reshape(1).to(scores.device, torch.int32)
    else:
        ns = torch.full((1,), int(num_select), dtype=torch.int32, device=scores.device)
    return masked.reshape(1, -1).contiguous(), ns


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
               iou_threshold: float, active: torch.Tensor | None = None,
               num_select=None):
    """Single-row greedy NMS: ``boxes [N, 4]``, ``scores [N]``; optional ``active``
    ``[N]`` bool mask and ``num_select`` budget (an int or a device scalar).
    Returns ``(indices [max_out] int32, valid [max_out] bool)``.

    CUDA tensors run the NMS kernels through the pre-top-k pool
    (``nms_kernel.batched_greedy_nms_pretopk``: select, scan and, where the
    row is wider than its pool, the continuation), with no host sync; CPU
    tensors run the plain :func:`batched_greedy_nms`; any other device
    raises."""
    from tpudet_torch.ops.cuda import nms_kernel  # imports this module

    dev = scores.device.type
    if dev == "cpu":
        return plain_greedy_nms(boxes, scores, max_out, iou_threshold, active, num_select)
    if dev != "cuda":
        raise ValueError(f"no NMS implementation for device {scores.device}")
    masked, ns = _one_row(scores, active, num_select, max_out)
    sel, valid = nms_kernel.batched_greedy_nms_pretopk(
        boxes.detach().to(torch.float32).contiguous(), masked, ns, max_out, iou_threshold)
    return sel[0], valid[0]


def plain_greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
                     iou_threshold: float, active: torch.Tensor | None = None,
                     num_select=None):
    """The plain version of :func:`greedy_nms`, on any device."""
    masked, ns = _one_row(scores, active, num_select, max_out)
    sel, valid = batched_greedy_nms(boxes.detach().to(torch.float32), masked, ns, max_out,
                                    iou_threshold)
    return sel[0], valid[0]


def _top_then_nms(boxes, masked, top, max_out, iou_threshold, nms_fn):
    """Greedy NMS (``nms_fn``, :func:`greedy_nms`'s signature) over the
    candidates at ``top`` (``[k]`` positions of ``masked [N]``, in
    :func:`stable_order`); the picks' boxes and scores, ``valid``."""
    top = top.long()
    top_scores, top_boxes = masked[top], boxes[top]
    sel, valid = nms_fn(top_boxes, top_scores, max_out, iou_threshold,
                        active=top_scores > NEG / 2)
    sel = sel.long()
    return top_boxes[sel], top_scores[sel], valid


def topk_then_nms(boxes: torch.Tensor, scores: torch.Tensor, active: torch.Tensor,
                  pre_topk: int, max_out: int, iou_threshold: float):
    """tpudet's score-filtered NMS: the top ``min(pre_topk, N)`` active
    candidates (descending score, ties to the lowest index, as
    ``lax.top_k``), then greedy NMS over them.

    Returns ``(sel_boxes [max_out, 4], sel_scores [max_out], valid [max_out],
    truncated)``: ``truncated`` a bool device scalar, True when more than
    ``pre_topk`` candidates are active and ``pre_topk < N`` (the result may
    then differ from NMS of the whole row). Unused slots hold the first
    candidate's box and score.

    CUDA tensors take the top ``k`` with the select kernel and run
    :func:`greedy_nms`'s kernels over the ``[1, k]`` row, with no host sync.
    Above the select kernel's width (``SORTED_SCAN_MAX_WIDTH``) the whole row
    goes to the kernels with the candidates outside the top ``k`` made
    inactive: with ``k = N`` that is the row itself, else the top ``k`` are
    those of :func:`~tpudet_torch.ops.cuda.nms_kernel.stable_order` (a
    stable sort on the card). CPU tensors take the same steps through the
    wrappers' plain versions (the head of ``stable_order``,
    :func:`batched_greedy_nms`); :func:`plain_topk_then_nms` is the plain
    version on any device.
    """
    from tpudet_torch.ops.cuda import nms_kernel  # imports this module

    n = scores.shape[-1]
    k = min(pre_topk, n)
    dev = scores.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no NMS implementation for device {dev}")
    if k <= 0:  # no candidate: nothing to launch
        return plain_topk_then_nms(boxes, scores, active, pre_topk, max_out,
                                   iou_threshold)
    masked = _one_row(scores, active, None, max_out)[0]
    truncated = _truncated(active, k, n)
    boxes = boxes.detach().to(torch.float32).contiguous()
    if k <= nms_kernel.SORTED_SCAN_MAX_WIDTH:
        top = nms_kernel.select_top(masked, k)[0]
        return _top_then_nms(boxes, masked[0], top, max_out, iou_threshold,
                             greedy_nms) + (truncated,)
    first = nms_kernel.select_top(masked, 1)[0].long()
    keep = None
    if k < n:
        keep = torch.zeros(n, dtype=torch.bool, device=dev).index_fill_(
            0, nms_kernel.stable_order(masked)[0, :k].long(), True)  # no host copy
    sel, valid = greedy_nms(boxes, masked[0], max_out, iou_threshold, active=keep)
    pick = torch.where(valid, sel.long(), first)
    return boxes[pick], masked[0, pick], valid, truncated


def _truncated(active, k, n):
    if k < n:
        return torch.sum(active) > k
    return torch.zeros((), dtype=torch.bool, device=active.device)


def plain_topk_then_nms(boxes: torch.Tensor, scores: torch.Tensor, active: torch.Tensor,
                        pre_topk: int, max_out: int, iou_threshold: float):
    """The plain version of :func:`topk_then_nms`, on any device: the head of
    :func:`~tpudet_torch.ops.cuda.nms_kernel.stable_order`, then
    :func:`batched_greedy_nms` over it."""
    from tpudet_torch.ops.cuda import nms_kernel  # imports this module

    n = scores.shape[-1]
    k = min(pre_topk, n)
    truncated = _truncated(active, k, n)
    if k <= 0:
        return (boxes.new_zeros((max_out, 4), dtype=torch.float32),
                scores.new_zeros((max_out,), dtype=torch.float32),
                torch.zeros(max_out, dtype=torch.bool, device=scores.device), truncated)
    masked = _one_row(scores, active, None, max_out)[0]
    top = nms_kernel.stable_order(masked)[0, :k]
    return _top_then_nms(boxes.detach().to(torch.float32), masked[0], top, max_out,
                         iou_threshold, plain_greedy_nms) + (truncated,)


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
